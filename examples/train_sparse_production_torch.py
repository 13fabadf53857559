"""Production-regime LS-PLM on the port: 1M sparse feature columns, 8M
parameters.

    PYTHONPATH=src python examples/train_sparse_production_torch.py
    PYTHONPATH=src python examples/train_sparse_production_torch.py \
        --device cpu

The port of ``examples/train_sparse_production.py``. Dense (B, d)
features are impossible at this width (a 2048-sample batch would be
8 TB); the padded-COO sparse path (``repro_torch.data.sparse``) stores
only active ids, the paper's one-hot regime, and OWLQN+ trains Theta
(1e6 x 8) with L1+L2,1 sparsity. On the card every step runs B1 (the
fused sparse forward) and B2 (the plan-driven dTheta segment sum) on the
batch's transpose plans, built once on the host; on the CPU their plain
versions. The batches and theta0 come from the reference's numpy seeds,
so both packages train from the same bits.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.sparse import (
    generate_sparse,
    sparse_loss_and_grad,
    sparse_predict,
)
from repro_torch.device import resolve_device
from repro_torch.eval.metrics import report
from repro_torch.optim.owlqn_plus import OWLQNPlus

D = 1_000_000
M = 4


def run(device, d: int = D, m: int = M, sessions: int = 2048,
        test_sessions: int = 128, iters: int = 40) -> dict:
    """Train on ``sessions`` sessions for ``iters`` OWLQN+ iterations and
    score ``test_sessions``: the trace's f, the test report, the
    surviving rows and the wall."""
    # the user ids' range: generate_sparse's default (600,000, 1,000,000)
    # at d = 10^6, the same share of a narrower d
    users = (3 * d // 5, d)
    train = generate_sparse(num_features=d, num_user_features_range=users,
                            sessions=sessions, seed=1, device=device)
    test = generate_sparse(num_features=d, num_user_features_range=users,
                           sessions=test_sessions, seed=2, device=device)
    theta0 = torch.from_numpy((0.01 * np.random.default_rng(0).normal(
        size=(d, 2 * m))).astype(np.float32)).to(device)
    opt = OWLQNPlus(lambda t: sparse_loss_and_grad(t, train), lam=0.05,
                    beta=0.05)
    t0 = time.perf_counter()
    theta, trace = opt.run(theta0, max_iters=iters)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    p = sparse_predict(theta, test).cpu().numpy()
    return {"samples": train.ad_ids.shape[0], "params": theta0.numel(),
            "ad_unique": train.ad_plan.num_unique,
            "user_unique": train.user_plan.num_unique,
            "ad_ids_mb": train.ad_ids.numel() * 4 / 2**20,
            "iters": len(trace), "f": [float(s.f_new) for s in trace],
            "f0": float(trace[0].f), "seconds": dt,
            "report": report(test.y.cpu().numpy(), p),
            "alive_rows": int((theta.abs().sum(1) > 0).sum())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args()
    device = resolve_device(args.device)
    r = run(device)
    path = ("B1 forward + B2 plan-driven dTheta" if device.type == "cuda"
            else "their plain PyTorch versions")
    print(f"sparse execution path on {device}: {path}, transpose plans "
          f"({r['ad_unique']:,} unique ad ids, {r['user_unique']:,} unique "
          f"user ids)")
    print(f"features d = {D:,}; params = {r['params']:,} (this batch dense: "
          f"{r['samples'] * D * 4 / 2**30:.1f} GiB; one of the paper's "
          f"1.4e9-sample days dense: {1.4e9 * D * 4 / 2**50:.1f} PiB — "
          f"sparse batch here: {r['ad_ids_mb']:.1f} MB)")
    print(f"trained {r['iters']} iters in {r['seconds']:.1f}s  f "
          f"{r['f0']:.1f} -> {r['f'][-1]:.1f}")
    rep = r["report"]
    print(f"test: AUC={rep['auc']:.4f} NE={rep['normalized_entropy']:.4f} "
          f"calibration={rep['calibration']:.3f}")
    print(f"sparsity: {r['alive_rows']:,}/{D:,} feature rows non-zero "
          "(only ids seen in training can survive)")


if __name__ == "__main__":
    main()
