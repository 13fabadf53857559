"""LS-PLM as a CTR head on a transformer backbone, trained with the
paper's OWLQN+ for structured sparsity, in the PyTorch port.

The port's counterpart of ``examples/lsplm_head_on_backbone.py``, with
its reduced llama backbone, synthetic data and settings, plus
``--device`` (the card unless ``cpu`` is asked for):

    PYTHONPATH=src python examples/lsplm_head_on_backbone_torch.py --device cpu

A reduced llama-family backbone embeds 'ad text' token sequences; the
LS-PLM head (``repro_torch.core.head``) predicts clicks from a fixed
projection of its last position. OWLQN+ applies L1 + L2,1 over the
head's (embed_dim x 2m) parameters, so feature selection prunes backbone
channels (each embedding channel is a group). On the card the Eq. 9
direction is B3 and the head's probabilities (``head_proba``) are B5.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.head import head_nll, head_proba, init_head
from repro_torch.core.lsplm import params_from_theta
from repro_torch.device import resolve_device
from repro_torch.eval.metrics import auc
from repro_torch.models import forward, init_model
from repro_torch.optim.owlqn_plus import OWLQNPlus


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config("llama3.2-1b").reduced()
    backbone = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    rng = np.random.default_rng(0)

    # synthetic 'ad text' + clicks whose truth depends nonlinearly on a
    # subset of embedding channels
    B, S = 512, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(
        dev, torch.int32)
    with torch.no_grad():
        logits, _ = forward(backbone, tokens=tokens, remat=False)
        # last-position logits' top slice as a fixed random projection
        h = torch.tanh(logits[:, -1, :cfg.d_model].float() * 0.1)
    d = h.shape[-1]
    w_true = rng.normal(size=(16,))
    sel = rng.choice(d, size=16, replace=False)
    logit_true = np.tanh(h.cpu().numpy()[:, sel] @ w_true) * 3.0
    y = torch.from_numpy((rng.random(B) < 1 / (1 + np.exp(-logit_true)))
                         .astype(np.float32)).to(dev)

    m = 6
    head0 = init_head(torch.Generator(device=dev).manual_seed(1), d,
                      num_regions=m)
    theta0 = torch.cat([head0.u, head0.w], dim=1)

    def loss_and_grad(theta):
        leaf = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            # head_nll is the mean; OWLQN+ takes the sum, as the reference
            loss = B * head_nll(params_from_theta(leaf), h, y)
        (grad,) = torch.autograd.grad(loss, leaf)
        return loss.detach(), grad

    opt = OWLQNPlus(loss_and_grad, lam=0.3, beta=0.05)
    theta, trace = opt.run(theta0, max_iters=60)

    p = head_proba(params_from_theta(theta), h)
    a = auc(y.cpu().numpy(), p.cpu().numpy())
    rows_kept = int((theta.abs().sum(1) > 0).sum())
    print(f"train AUC = {a:.4f}")
    print(f"backbone channels kept by L2,1: {rows_kept}/{d} "
          f"(truth uses 16 channels)")
    print(f"iterations: {len(trace)}, final nnz = {int(trace[-1].nnz)}")


if __name__ == "__main__":
    main()
