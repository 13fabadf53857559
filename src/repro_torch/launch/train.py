"""Training driver: sparse LS-PLM with OWLQN+ (Algorithm 1), on the card
by default.

The port's counterpart of ``repro/launch/train.py`` (its single-device
``--sparse`` path). Padded-COO ids/vals over ``--sparse-features``
columns, the common-feature trick (Eq. 13), one transpose plan per id
tensor built on the host once and moved to the device once, then
``--iters`` OWLQN+ steps:

  PYTHONPATH=src python -m repro_torch.launch.train --sparse \\
      --sparse-features 1000000 --regions 12 --sessions 4000 \\
      --lam 0.05 --beta 0.05 --iters 10 --ckpt /tmp/lsplm.npz

On a CUDA device every loss evaluation runs the fused sparse forward
(B1), every gradient its run-length scatter backward (B2), and every step
the Eq. 9 direction kernel (B3); ``--device cpu`` runs their plain
versions. Each iteration prints one line rendered from its ``train_iter``
record (objective, step, non-zero count, wall; test AUC every 5
iterations and at the last). ``--ckpt`` saves ``{"theta": ...}`` in the
reference's npz layout, which ``repro_torch.launch.serve --ckpt`` (and
the reference's loaders) read.

Not ported yet, and refused: the dense default (queue item A13),
``--stream`` (A9), ``--mesh-data``/``--mesh-model`` (A12), the tuning
flags (A10) and ``--drift-ref`` (A11).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.objective import nll_sparse, smooth_loss_and_grad
from repro_torch.data.sparse import (
    SparseCTRBatch,
    generate_sparse,
    sparse_predict,
)
from repro_torch.device import resolve_device
from repro_torch.eval.metrics import auc
from repro_torch.io import checkpoint
from repro_torch.optim.owlqn_plus import OWLQNPlus

# flags of the reference driver whose paths are not ported yet -> the
# ROADMAP queue item each waits for
_NOT_PORTED = {
    "stream": "--stream waits for the streaming port (ROADMAP A9)",
    "mesh_data": "--mesh-data/--mesh-model wait for the sharding port "
                 "(ROADMAP A12)",
    "mesh_model": "--mesh-data/--mesh-model wait for the sharding port "
                  "(ROADMAP A12)",
    "block_n": "the tuning flags wait for the tuning port (ROADMAP A10)",
    "block_k": "the tuning flags wait for the tuning port (ROADMAP A10)",
    "chunk": "the tuning flags wait for the tuning port (ROADMAP A10)",
    "tune": "the tuning flags wait for the tuning port (ROADMAP A10)",
    "drift_ref": "--drift-ref waits for the drift monitor's port "
                 "(ROADMAP A11)",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--sparse", action="store_true",
                    help="train on padded-COO sparse features (the only "
                         "path ported so far)")
    ap.add_argument("--sparse-features", type=int, default=1_000_000,
                    help="d, feature columns")
    ap.add_argument("--regions", type=int, default=12, help="m (Fig. 4)")
    ap.add_argument("--sessions", type=int, default=4000)
    ap.add_argument("--lam", type=float, default=1.0, help="L2,1 weight")
    ap.add_argument("--beta", type=float, default=1.0, help="L1 weight")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="save {'theta': ...} here after training")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    # refused until their paths are ported (see _NOT_PORTED)
    ap.add_argument("--stream", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-data", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-model", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--block-n", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--block-k", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--chunk", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tune", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--drift-ref", default=None, help=argparse.SUPPRESS)
    obs.add_flags(ap)
    return ap


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


def run(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, train, and return the run's report: one record per
    iteration (f, f_new, alpha, ls_iters, grad_norm, nnz, wall_s, and
    test_auc where evaluated), the final test AUC, the walls and the
    checkpoint path."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(why)
    if not args.sparse:
        raise SystemExit("the dense path waits for its port (ROADMAP A13); "
                         "pass --sparse")
    device = resolve_device(args.device)
    session = obs.configure_from_args(args, driver="repro_torch.launch.train",
                                      device=device, argv=argv, mode="sparse")
    try:
        return _train_sparse(args, device)
    finally:
        session.close()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _user_range(d: int) -> tuple[int, int]:
    return max(1, int(0.6 * d)), d


def sparse_problem(d: int, m: int, sessions: int, *, lam: float, beta: float,
                   seed: int, batch_seed: int, device,
                   dtype: torch.dtype = torch.float32
                   ) -> tuple[SparseCTRBatch, torch.Tensor, OWLQNPlus]:
    """The sparse OWLQN+ problem the drivers train: a generated batch of
    ``sessions`` sessions over ``d`` columns (seeded by ``batch_seed``,
    plans attached, on ``device``), Theta0 = 0.01 N(0, 1) of shape
    (d, 2m) from ``seed``, and the optimizer over the batch's smooth NLL
    with the L2,1 and L1 weights ``lam`` and ``beta``. ``dtype`` is that
    of Theta0 and of the batch's values: the kernels take float32, and
    float64 on the CPU gives a near-exact trajectory to compare with."""
    batch = generate_sparse(num_features=d,
                            num_user_features_range=_user_range(d),
                            sessions=sessions, seed=batch_seed, device=device)
    if dtype != torch.float32:
        batch = batch._replace(user_vals=batch.user_vals.to(dtype),
                               ad_vals=batch.ad_vals.to(dtype))
    theta0 = torch.from_numpy(
        (0.01 * np.random.default_rng(seed).normal(size=(d, 2 * m)))
        .astype(np.float32)).to(device=device, dtype=dtype)
    opt = OWLQNPlus(lambda t: smooth_loss_and_grad(t, batch), lam=lam,
                    beta=beta, loss=lambda t: nll_sparse(t, batch))
    return batch, theta0, opt


def sparse_test_batch(d: int, sessions: int, *, seed: int,
                      device) -> SparseCTRBatch:
    """The held-out batch the training driver scores for its test AUC:
    a fifth of the training sessions (at least 32), no plans."""
    return generate_sparse(num_features=d,
                           num_user_features_range=_user_range(d),
                           sessions=max(sessions // 5, 32), seed=seed,
                           with_plans=False, device=device)


def _train_sparse(args, device: torch.device) -> dict:
    d, m = args.sparse_features, args.regions
    t0 = time.perf_counter()
    train, theta0, opt = sparse_problem(
        d, m, args.sessions, lam=args.lam, beta=args.beta, seed=args.seed,
        batch_seed=args.seed + 1, device=device)
    test = sparse_test_batch(d, args.sessions, seed=args.seed + 2,
                             device=device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    kern = ("CUDA kernels: fused forward B1, run-length scatter B2, Eq. 9 "
            "direction B3" if device.type == "cuda" else "plain versions")
    obs.log(f"sparse mode: d={d:,} columns, Theta {tuple(theta0.shape)} "
            f"({theta0.numel():,} params), device={device} ({kern}); "
            f"batch + plans + Theta0 in {setup_s:.2f}s")
    report: dict = {"device": str(device), "num_features": d, "regions": m,
                    "sessions": args.sessions, "setup_s": setup_s,
                    "plans": {}, "iters": []}
    for side, plan in (("user", train.user_plan), ("ad", train.ad_plan)):
        report["plans"][side] = {"entries": plan.num_kept,
                                 "unique": plan.num_unique,
                                 "pieces": plan.piece_run.numel()}
        obs.log(f"  {side} transpose plan: {plan.num_kept:,} entries, "
                f"{plan.num_unique:,} unique ids, "
                f"{len(plan.class_width)} popularity classes, "
                f"{plan.piece_run.numel():,} scatter pieces")

    state = opt.init(theta0)
    del theta0
    tracer = obs.get_tracer()
    y_test = test.y.cpu().numpy()
    train_s = 0.0
    for k in range(args.iters):
        t0 = time.perf_counter()
        with tracer.step_span("train/iter", k):
            state, stats = opt.step(state)
            _sync(device)
        dt = time.perf_counter() - t0
        train_s += dt
        rec = dict(step=k, **stats._asdict(), wall_s=dt)
        if k % 5 == 0 or k == args.iters - 1:
            p = sparse_predict(state.theta, test).cpu().numpy()
            rec["test_auc"] = float(auc(y_test, p))
        report["iters"].append(rec)
        obs.log(obs.render_train_iter(rec), kind="train_iter", **rec)
    report["train_s"] = train_s
    report["s_per_iter"] = train_s / max(1, args.iters)
    report["test_auc"] = (report["iters"][-1]["test_auc"]
                          if report["iters"] else None)
    obs.log(f"trained {args.iters} OWLQN+ iterations in {train_s:.2f}s "
            f"({report['s_per_iter'] * 1e3:.1f} ms/iter)")
    if args.ckpt:
        report["ckpt"] = checkpoint.save(args.ckpt, {"theta": state.theta})
        obs.log(f"checkpoint -> {report['ckpt']}")
    return report


if __name__ == "__main__":
    raise SystemExit(main())
