"""Quickstart on the PyTorch/CUDA port: train LS-PLM on nonlinear CTR
data, compare with LR.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port of ``examples/quickstart.py``, on ``repro_torch``'s ``core``,
``data`` and ``optim``: LR underfits the nonlinear click distribution;
LS-PLM (Eq. 2) fits it; L1+L2,1 (Eq. 4) keeps the model sparse;
Algorithm 1 (OWLQN+) optimises the non-convex non-smooth objective. The
data and theta0 come from the reference's numpy seeds, so both packages
start from the same bits.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CTRBatch, predict_proba, regularizers
from repro_torch.core.lsplm import params_from_theta
from repro_torch.core.objective import smooth_loss_and_grad
from repro_torch.data import CTRDataConfig, auc, generate, to_dense_batch
from repro_torch.device import resolve_device
from repro_torch.optim.owlqn_plus import OWLQNPlus


def fit(tb: CTRBatch, d: int, m: int, lam: float, beta: float, iters: int):
    """OWLQN+ from theta0 = 0.01 N(0, 1) (numpy seed 0) on ``tb``'s
    device: (theta, trace)."""
    theta0 = torch.from_numpy((0.01 * np.random.default_rng(0).normal(
        size=(d, 2 * m))).astype(np.float32)).to(tb.x.device)
    opt = OWLQNPlus(lambda t: smooth_loss_and_grad(t, tb), lam=lam, beta=beta)
    return opt.run(theta0, max_iters=iters)


def run(device, sessions: int = 4000, test_sessions: int = 800,
        lr_iters: int = 30, iters: int = 70) -> dict:
    """The example's runs: the LR baseline (m = 1, L1) and LS-PLM (m = 12,
    L1 + L2,1), trained on ``sessions`` sessions and scored on
    ``test_sessions``. Returns their iterations, test AUCs, final f, and
    LS-PLM's sparsity."""
    cfg = CTRDataConfig(num_user_features=24, num_ad_features=24,
                        noise_features=8, true_regions=4, seed=0)
    train = to_dense_batch(generate(cfg, sessions, seed=1, device=device,
                                    with_dense=False)[0])
    test = to_dense_batch(generate(cfg, test_sessions, seed=2, device=device,
                                   with_dense=False)[0])
    y_test = test.y.cpu().numpy()
    out = {"num_features": cfg.num_features,
           "noise_features": cfg.noise_features}
    theta_lr, tr = fit(train, cfg.num_features, m=1, lam=0.0, beta=1.0,
                       iters=lr_iters)
    p_lr = predict_proba(params_from_theta(theta_lr), test.x)
    out["lr"] = {"iters": len(tr), "f": float(tr[-1].f_new),
                 "auc": auc(y_test, p_lr.cpu().numpy())}
    theta, tr = fit(train, cfg.num_features, m=12, lam=1.0, beta=1.0,
                    iters=iters)
    p = predict_proba(params_from_theta(theta), test.x)
    out["lsplm"] = {
        "iters": len(tr), "f": float(tr[-1].f_new),
        "auc": auc(y_test, p.cpu().numpy()),
        "nnz": int(regularizers.nonzero_count(theta)),
        "size": theta.numel(),
        "features": int(regularizers.nonzero_feature_count(theta)),
        "noise_nnz": int((theta[-cfg.noise_features:] != 0).sum())}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args()
    r = run(resolve_device(args.device))
    print("== LR baseline (m=1, L1) ==")
    print(f"  iters={r['lr']['iters']}  test AUC = {r['lr']['auc']:.4f}")
    s = r["lsplm"]
    print("== LS-PLM (m=12, L1 + L2,1 — the paper's production setting) ==")
    print(f"  iters={s['iters']}  test AUC = {s['auc']:.4f}")
    print(f"  sparsity: {s['nnz']}/{s['size']} non-zero params, "
          f"{s['features']}/{r['num_features']} features kept")
    print("  (noise features pruned by the L2,1 group penalty: "
          f"last {r['noise_features']} rows nnz = {s['noise_nnz']})")


if __name__ == "__main__":
    main()
