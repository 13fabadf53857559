"""Training driver: LS-PLM with OWLQN+ (Algorithm 1), on the card by
default.

The port's counterpart of ``repro/launch/train.py`` (its single-device
paths). Three modes:

* dense (the default, the reference's ``train_dense``): the synthetic
  common-feature workload of ``data/synthetic_ctr`` (user columns once
  per session, ad and noise columns per sample; §3.2 storage), OWLQN+ on
  the Eq. 13 objective ``nll_common_feature``, test AUC on the dense
  test rows through ``core.lsplm.predict_proba``::

    PYTHONPATH=src python -m repro_torch.launch.train --sessions 4000 \
        --user-features 64 --ad-features 48 --noise-features 16 \
        --regions 12 --lam 1.0 --beta 1.0 --iters 60 --ckpt /tmp/lsplm.npz

  On a CUDA device every step runs the Eq. 9 direction kernel (B3) and
  every test-AUC evaluation the dense fused forward (B5); the fp32
  products of the loss and its gradient are ``torch.matmul`` (cuBLAS),
  as the reference leaves them to XLA.

* ``--sparse``: padded-COO ids/vals over ``--sparse-features`` columns,
  the common-feature trick (Eq. 13), one transpose plan per id tensor
  built on the host once and moved to the device once::

    PYTHONPATH=src python -m repro_torch.launch.train --sparse \
        --sparse-features 1000000 --regions 12 --sessions 4000 \
        --lam 0.05 --beta 0.05 --iters 10 --ckpt /tmp/lsplm.npz

  On a CUDA device every loss evaluation runs the fused sparse forward
  (B1), every gradient its run-length scatter backward (B2), and every
  step the Eq. 9 direction kernel (B3).

* ``--stream``: the production cadence (``repro_torch.stream``). A
  day-sliced stream with id-traffic drift; per day the last ``--window``
  days are re-planned on the host and copied to the card on a side
  stream, overlapped with the previous window's device iterations, and
  OWLQN+ runs ``--inner-iters`` warm-started steps; each day prints its
  line and the held-out NEXT day's NLL and AUC::

    PYTHONPATH=src python -m repro_torch.launch.train --stream \
        --days 8 --window 2 --inner-iters 5 --sessions 256 \
        --sparse-features 100000 --regions 4 --ckpt /tmp/stream.npz

  ``--ckpt`` saves the resumable stream state (Theta + L-BFGS history +
  day cursor, in the reference's layout) after every window;
  ``--resume`` continues from it. ``--sync-planner`` builds each window
  inline (same results, serial schedule).

``--device cpu`` runs the plain versions. Each iteration prints one line
rendered from its ``train_iter`` record (objective, step, non-zero
count, wall; test AUC every 5 iterations and at the last). ``--ckpt``
saves ``{"theta": ...}`` in the reference's npz layout, which
``repro_torch.launch.serve --ckpt`` (and the reference's loaders) read.
``--drift-ref PATH`` (``--sparse`` or ``--stream``) captures a drift
reference from the held-out scores (the test batch, or the last next
day) that ``repro_torch.launch.serve --monitor --drift-ref`` arms.

``--block-n``/``--chunk`` (``--sparse`` or ``--stream``) pin a kernel
knob and ``--tune`` sweeps the job's own shapes first
(``repro_torch.launch.tuning``; the results are bitwise those of an
untuned run); ``--block-k`` is refused, B1 having no K tile on the card.

``--mesh-data D --mesh-model M`` (all three modes) runs the paper's
worker/server split on a (data, model) mesh of D * M ranks
(``repro_torch.launch.mesh``, ``repro_torch.dist``, ``repro_torch.shard``):
samples over ``data``, Theta's rows over ``model`` by id range. Sparse:
equal ranges, the batch routed on the host and its plans sliced per cell,
each rank running B1, B2 and B3 on its own rows; dense: x's columns over
``model``; stream: every window on the sharded loss. Both flags go
together, and ``--sessions`` must divide by ``--mesh-data``::

    PYTHONPATH=src python -m repro_torch.launch.train --sparse \
        --sparse-features 1000000 --sessions 4000 --lam 0.05 --beta 0.05 \
        --iters 10 --mesh-data 2 --mesh-model 2

Without ``RANK``/``WORLD_SIZE`` in the environment the driver starts the
D * M ranks itself (spawned processes, a ``FileStore`` rendezvous in a
temporary directory; on a card it builds the kernels once first); under
``torchrun`` it joins the world it is given, which must hold D * M ranks.
Ranks share the cards round-robin; NCCL joins them when each has a card of
its own, gloo otherwise. Rank 0 alone logs, scores the test batch, writes
the ledger, report and checkpoint; the checkpoint holds the unpadded
Theta, so it loads in either package and unsharded. ``--tune`` is refused
with the mesh flags (each rank would sweep on a shared card).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.lsplm import params_from_theta, predict_proba
from repro_torch.core.objective import (
    CommonFeatureBatch,
    CTRBatch,
    nll_common_feature,
    nll_sparse,
    smooth_loss_and_grad,
)
from repro_torch.data.common_feature import pad_to_multiple
from repro_torch.data.sparse import (
    SparseCTRBatch,
    generate_sparse,
    sparse_predict,
)
from repro_torch.data.synthetic_ctr import (
    CTRDataConfig,
    generate,
    to_dense_batch,
)
from repro_torch.device import resolve_device
from repro_torch.eval.metrics import auc
from repro_torch.io import checkpoint
from repro_torch.launch.tuning import (
    add_tuning_flags,
    apply_tuning_flags,
    tune_job_shapes,
    tuning_flags_set,
    tuning_scope,
)
from repro_torch.optim.owlqn_plus import OWLQNPlus


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--sparse", action="store_true",
                    help="train on padded-COO sparse features (default: "
                         "the dense common-feature path)")
    ap.add_argument("--sparse-features", type=int, default=1_000_000,
                    help="d for --sparse, feature columns")
    ap.add_argument("--user-features", type=int, default=64,
                    help="dense: common (user) columns d_c")
    ap.add_argument("--ad-features", type=int, default=48,
                    help="dense: per-sample (ad) columns")
    ap.add_argument("--noise-features", type=int, default=16,
                    help="dense: per-sample columns without signal")
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
    ap.add_argument("--stream", action="store_true",
                    help="streaming day-by-day training on the sparse path "
                         "(repro_torch.stream): sliding-window minibatch "
                         "OWLQN+ with an overlapped host re-planner")
    ap.add_argument("--days", type=int, default=8,
                    help="--stream: days in the synthetic stream")
    ap.add_argument("--window", type=int, default=2,
                    help="--stream: sliding window width (days)")
    ap.add_argument("--inner-iters", type=int, default=5,
                    help="--stream: OWLQN+ iterations per window")
    ap.add_argument("--history", choices=("reset", "carry"), default="reset",
                    help="--stream: L-BFGS history policy at window "
                         "boundaries (Theta always carries)")
    ap.add_argument("--drift", type=float, default=0.02,
                    help="--stream: per-day id-traffic drift fraction")
    ap.add_argument("--active-user", type=int, default=16,
                    help="--stream: user ids per session (DayStream's K)")
    ap.add_argument("--active-ad", type=int, default=8,
                    help="--stream: ad ids per sample")
    ap.add_argument("--sync-planner", action="store_true",
                    help="--stream: build each window inline instead of "
                         "in the background (same results, serial "
                         "schedule)")
    ap.add_argument("--resume", action="store_true",
                    help="--stream: resume from --ckpt if it exists")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data extent of the (data, model) mesh: workers "
                         "(0 = single device)")
    ap.add_argument("--mesh-model", type=int, default=0,
                    help="model extent: Theta row shards (parameter "
                         "servers)")
    add_tuning_flags(ap)
    obs.add_flags(ap)
    return ap


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


def run(argv: list[str] | None = None, *, prebuilt: tuple | None = None
        ) -> dict:
    """Parse ``argv``, train, and return the run's report: one record per
    iteration (f, f_new, alpha, ls_iters, grad_norm, nnz, wall_s, and
    test_auc where evaluated), the final test AUC, the walls and the
    checkpoint path. ``prebuilt`` = ``(problem, test)``, as
    ``sparse_problem``/``dense_problem`` and ``sparse_test_batch``/
    ``dense_test_batch`` build them for the same flags, replaces the
    set-up for a caller that already holds them."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    sharded = _check_mesh_flags(args)
    if tuning_flags_set(args) and not (args.sparse or args.stream):
        raise SystemExit(
            "--block-n/--block-k/--chunk/--tune steer the sparse kernels; "
            "combine them with --sparse or --stream (the dense path has "
            "no tunable block sizes)")
    mode = "stream" if args.stream else "sparse" if args.sparse else "dense"
    if args.drift_ref and mode == "dense":
        raise SystemExit(
            "--drift-ref captures a sparse-id traffic reference; combine "
            "it with --sparse or --stream (the dense path has no feature "
            "ids to histogram)")
    device = resolve_device(args.device)
    if sharded:
        if prebuilt is not None:
            raise ValueError("prebuilt problems are single-device only")
        return _run_sharded(args, argv, device)
    session = obs.configure_from_args(args, driver="repro_torch.launch.train",
                                      device=device, argv=argv, mode=mode)
    try:
        with tuning_scope():
            if tuning_flags_set(args):
                apply_tuning_flags(args)  # the values, before any set-up
            if args.stream:
                return _train_stream(args, device)
            if args.sparse:
                return _train_sparse(args, device, prebuilt)
            return _train_dense(args, device, prebuilt)
    finally:
        session.close()


def _check_mesh_flags(args) -> bool:
    """The reference's checks of ``--mesh-data``/``--mesh-model``; True
    when they ask for a mesh."""
    if (args.mesh_data > 0) != (args.mesh_model > 0):
        raise SystemExit(
            "--mesh-data and --mesh-model must be set together (the job "
            "shards samples x Theta rows as one (data, model) mesh)")
    if args.mesh_data < 0 or args.mesh_model < 0:
        raise SystemExit("--mesh-data/--mesh-model must be >= 0")
    if args.mesh_data == 0:
        return False
    if args.sessions % args.mesh_data:
        raise SystemExit(f"--sessions {args.sessions} must divide by "
                         f"--mesh-data {args.mesh_data}")
    if args.tune:
        raise SystemExit(
            "--tune sweeps on one device; with --mesh-data/--mesh-model "
            "pin the knobs with --block-n/--chunk (or tune unsharded)")
    return True


def _run_sharded(args, argv: list[str], device: torch.device) -> dict:
    """Run the job on a (--mesh-data, --mesh-model) mesh: in this
    process for 1 x 1, in the world ``torchrun`` started when ``RANK`` is
    set, else on spawned ranks. Returns rank 0's report, with every rank's
    own summary under ``"ranks"``."""
    from repro_torch.launch import mesh as meshlib

    world = args.mesh_data * args.mesh_model
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, size, dev = meshlib.init_from_env(device)
        if size != world:
            raise SystemExit(f"torchrun started {size} ranks, the mesh "
                             f"needs --mesh-data x --mesh-model = {world}")
        report = _rank_main(rank, dev, argv)
        report["ranks"] = [report.pop("rank")]  # this rank's own
        return report
    if world == 1:
        report = _rank_main(0, device, argv)
        report["ranks"] = [report.pop("rank")]
        return report
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()  # once, before the ranks start
    reports = meshlib.run_ranks(_rank_main, world, argv, device=device)
    report = reports[0]
    report["ranks"] = [r["rank"] for r in reports]
    del report["rank"]
    return report


def _to_host(obj):
    """``obj`` with every tensor moved to the CPU (a rank's report
    crosses a process boundary)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    return obj


def _kernel_launches() -> dict[str, int]:
    """This process's launches of the sparse training kernels so far."""
    from repro_torch.kernels.lsplm_fused import lsplm_fused as b5
    from repro_torch.kernels.lsplm_sparse_fused import lsplm_sparse_fused as b1
    from repro_torch.kernels.lsplm_sparse_scatter import (
        lsplm_sparse_scatter as b2,
    )
    from repro_torch.kernels.owlqn_direction import owlqn_direction as b3

    return {**b1.LAUNCHES, **b2.LAUNCHES, **b3.LAUNCHES, **b5.LAUNCHES}


def _rank_main(rank: int, dev: torch.device, argv: list[str]) -> dict:
    """One rank of a sharded job: its mesh, its share of the set-up and
    the iterations. Rank 0 keeps the driver's outputs; the others print
    nothing and write nothing."""
    from repro_torch.launch.mesh import Mesh

    args = _parser().parse_args(argv)
    dev = resolve_device(dev)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
        for flag in ("metrics_out", "trace_out", "ledger_out", "report_out"):
            setattr(args, flag, None)
        args.monitor, args.monitor_rules = False, None
    mesh = Mesh(args.mesh_data, args.mesh_model)
    mode = "stream" if args.stream else "sparse" if args.sparse else "dense"
    session = obs.configure_from_args(args, driver="repro_torch.launch.train",
                                      device=dev, argv=argv, mode=mode)
    try:
        with tuning_scope():
            if tuning_flags_set(args):
                apply_tuning_flags(args)
            if args.stream:
                report = _train_stream(args, dev, mesh)
            elif args.sparse:
                report = _train_sparse_sharded(args, dev, mesh)
            else:
                report = _train_dense_sharded(args, dev, mesh)
    finally:
        session.close()
    report["rank"] = {
        "rank": mesh.rank, "data_rank": mesh.data_rank,
        "model_rank": mesh.model_rank, "device": str(dev),
        "backend": mesh.backend, "collectives": mesh.collective_counts(),
        "launches": _kernel_launches() if dev.type == "cuda" else {},
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "iters": [{k: r[k] for k in ("f", "f_new", "alpha", "nnz")}
                  for r in report.get("iters", [])],
        "windows": [{k: w[k] for k in ("fs", "alpha", "nnz")}
                    for w in report.get("windows", [])]}
    return _to_host(report)


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
    theta0 = _theta0(d, m, seed, device, dtype)
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


def _theta0(d: int, m: int, seed: int, device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Theta0 = 0.01 N(0, 1) of shape (d, 2m) from numpy's ``seed``, cast
    to float32 first (the reference's draw)."""
    return torch.from_numpy(
        (0.01 * np.random.default_rng(seed).normal(size=(d, 2 * m)))
        .astype(np.float32)).to(device=device, dtype=dtype)


def dense_problem(cfg: CTRDataConfig, m: int, sessions: int, *, lam: float,
                  beta: float, seed: int, device
                  ) -> tuple[CommonFeatureBatch, torch.Tensor, OWLQNPlus]:
    """The dense OWLQN+ problem the drivers train, as the reference's
    ``train_dense`` sets it up: ``sessions`` generated sessions (data
    seed 1, the compressed batch only, on ``device``) with weights of one
    (``pad_to_multiple(batch, 1)``), Theta0 = 0.01 N(0, 1) of shape
    (d, 2m) from ``seed``, and the optimizer over the Eq. 13 NLL with the
    L2,1 and L1 weights ``lam`` and ``beta``."""
    train, _ = generate(cfg, sessions, seed=1, device=device,
                        with_dense=False)
    batch = pad_to_multiple(train, 1)
    theta0 = _theta0(cfg.num_features, m, seed, device)
    opt = OWLQNPlus(
        lambda t: smooth_loss_and_grad(t, batch, common_feature=True),
        lam=lam, beta=beta, loss=lambda t: nll_common_feature(t, batch))
    return batch, theta0, opt


def dense_test_batch(cfg: CTRDataConfig, sessions: int, *,
                     device) -> CTRBatch:
    """The held-out dense rows the driver scores for its test AUC: a
    fifth of the training sessions (at least 64, data seed 2), made dense
    on ``device``."""
    test, _ = generate(cfg, max(sessions // 5, 64), seed=2, device=device,
                       with_dense=False)
    return to_dense_batch(test)


def _train_dense(args, device: torch.device, prebuilt=None) -> dict:
    cfg = CTRDataConfig(num_user_features=args.user_features,
                        num_ad_features=args.ad_features,
                        noise_features=args.noise_features, seed=args.seed)
    d, m = cfg.num_features, args.regions
    t0 = time.perf_counter()
    built = "handed in" if prebuilt else "in {:.2f}s"
    if prebuilt is None:
        prebuilt = (dense_problem(cfg, m, args.sessions, lam=args.lam,
                                  beta=args.beta, seed=args.seed,
                                  device=device),
                    dense_test_batch(cfg, args.sessions, device=device))
    (train, theta0, opt), test = prebuilt
    _sync(device)
    setup_s = time.perf_counter() - t0
    kern = ("CUDA kernels: Eq. 9 direction B3, dense fused forward B5 for "
            "the test AUC; fp32 products on torch.matmul"
            if device.type == "cuda" else "plain versions")
    samples, sessions = train.y.shape[0], train.x_common.shape[0]
    obs.log(f"dense mode: d={d:,} columns ({cfg.num_user_features:,} "
            f"common + {cfg.num_ad_features + cfg.noise_features:,} "
            f"per sample), {samples:,} samples in {sessions:,} sessions, "
            f"Theta {tuple(theta0.shape)} ({theta0.numel():,} params), "
            f"device={device} ({kern}); batch + Theta0 + "
            f"{test.x.shape[0]:,} test rows {built.format(setup_s)}")
    report: dict = {"mode": "dense", "device": str(device),
                    "num_features": d, "regions": m, "sessions": sessions,
                    "samples": samples, "test_rows": test.x.shape[0],
                    "setup_s": setup_s}

    def predict(theta):
        return predict_proba(params_from_theta(theta), test.x)

    return _iterate(args, device, opt, theta0, predict, test.y, report,
                    nnz_width=7)


def _train_sparse(args, device: torch.device, prebuilt=None) -> dict:
    d, m = args.sparse_features, args.regions
    t0 = time.perf_counter()
    built = "handed in" if prebuilt else "in {:.2f}s"
    if prebuilt is None:
        prebuilt = (sparse_problem(d, m, args.sessions, lam=args.lam,
                                   beta=args.beta, seed=args.seed,
                                   batch_seed=args.seed + 1, device=device),
                    sparse_test_batch(d, args.sessions, seed=args.seed + 2,
                                      device=device))
    (train, theta0, opt), test = prebuilt
    _sync(device)
    setup_s = time.perf_counter() - t0
    ku, ka = train.user_ids.shape[-1], train.ad_ids.shape[-1]
    apply_tuning_flags(args, batch_n=train.ad_ids.shape[0],
                       batch_k=max(ku, ka))
    if args.tune:
        tune_job_shapes([(train.user_ids.shape[0], ku, d, m),
                         (train.ad_ids.shape[0], ka, d, m)], device=device,
                        log=obs.log)
    kern = ("CUDA kernels: fused forward B1, run-length scatter B2, Eq. 9 "
            "direction B3" if device.type == "cuda" else "plain versions")
    obs.log(f"sparse mode: d={d:,} columns, Theta {tuple(theta0.shape)} "
            f"({theta0.numel():,} params), device={device} ({kern}); "
            f"batch + plans + Theta0 {built.format(setup_s)}")
    report: dict = {"mode": "sparse", "device": str(device),
                    "num_features": d, "regions": m,
                    "sessions": args.sessions, "setup_s": setup_s,
                    "plans": {}}
    for side, plan in (("user", train.user_plan), ("ad", train.ad_plan)):
        report["plans"][side] = {"entries": plan.num_kept,
                                 "unique": plan.num_unique,
                                 "pieces": plan.piece_run.numel()}
        obs.log(f"  {side} transpose plan: {plan.num_kept:,} entries, "
                f"{plan.num_unique:,} unique ids, "
                f"{len(plan.class_width)} popularity classes, "
                f"{plan.piece_run.numel():,} scatter pieces")

    def drift_ref(theta):
        p = sparse_predict(theta, test).cpu().numpy()
        ids = np.concatenate([test.user_ids.cpu().numpy().ravel(),
                              test.ad_ids.cpu().numpy().ravel()])
        report["drift_ref"] = _capture_drift_ref(
            args.drift_ref, p, test.y.cpu().numpy(), ids, d,
            f"held-out test, {p.shape[0]} scores")

    return _iterate(args, device, opt, theta0,
                    lambda theta: sparse_predict(theta, test), test.y,
                    report, trained=drift_ref if args.drift_ref else None)


def _mesh_line(mesh, part, extra: str) -> str:
    return (f"mesh: data={mesh.data} x model={mesh.model} (workers x "
            f"parameter servers), {mesh.size} rank(s), backend="
            f"{mesh.backend or 'none (one rank)'}; Theta rows id-range "
            f"sharded, {part.rows_per_shard:,} rows/shard{extra}")


def sharded_sparse_problem(d: int, m: int, sessions: int, *, lam: float,
                           beta: float, seed: int, batch_seed: int, mesh,
                           device, partition=None):
    """:func:`sparse_problem` on a mesh, for this rank: ``(routed,
    partition, cell, theta0, opt)``. The same batch is generated on the
    host and routed over ``partition`` (default: equal ranges over
    ``model``) with its plans sliced per cell (``routed``, on the host);
    ``cell`` is this rank's, on ``device``; ``theta0`` this rank's rows of
    the same Theta0 in the padded layout; ``opt`` OWLQN+ over the sharded
    loss, reducing over the mesh."""
    from repro_torch.dist import shard_sparse_batch
    from repro_torch.shard.partition import make_partition
    from repro_torch.shard.step import make_sharded_sparse_loss

    part = make_partition(d, mesh.model) if partition is None else partition
    routed = generate_sparse(num_features=d,
                             num_user_features_range=_user_range(d),
                             sessions=sessions, seed=batch_seed, shards=part,
                             data_shards=mesh.data, device="cpu")
    cell = shard_sparse_batch(mesh, routed, device)
    theta0 = part.shard_rows(part.pad_rows(_theta0(d, m, seed, "cpu")),
                             mesh.model_rank).to(device, copy=True)
    loss_and_grad, loss = make_sharded_sparse_loss(cell, mesh)
    opt = OWLQNPlus(loss_and_grad, lam=lam, beta=beta, loss=loss,
                    reduce=mesh.sum_model)
    return routed, part, cell, theta0, opt


def _train_sparse_sharded(args, device: torch.device, mesh) -> dict:
    """``--sparse`` on the mesh: the driver's batch generated on the host,
    routed over equal id ranges with its plans sliced per cell; this rank
    trains its rows on its cell (B1, B2, B3 on local ids), rank 0 scores
    the test batch on the gathered Theta."""
    d, m = args.sparse_features, args.regions
    t0 = time.perf_counter()
    routed, part, cell, theta0, opt = sharded_sparse_problem(
        d, m, args.sessions, lam=args.lam, beta=args.beta, seed=args.seed,
        batch_seed=args.seed + 1, mesh=mesh, device=device)
    test = (sparse_test_batch(d, args.sessions, seed=args.seed + 2,
                              device=device) if mesh.rank == 0 else None)
    _sync(device)
    setup_s = time.perf_counter() - t0
    b = cell.batch
    ku, ka = b.user_ids.shape[-1], b.ad_ids.shape[-1]
    apply_tuning_flags(args, batch_n=b.ad_ids.shape[0], batch_k=max(ku, ka))
    kern = ("CUDA kernels: fused forward B1, run-length scatter B2, Eq. 9 "
            "direction B3" if device.type == "cuda" else "plain versions")
    entries = {side: [int((ids != part.rows_per_shard).sum())
                      for ids in routed_ids]
               for side, routed_ids in (("user", routed.user_ids),
                                        ("ad", routed.ad_ids))}
    obs.log(f"sparse mode: d={d:,} columns, Theta ({d:,}, {2 * m}) "
            f"({d * 2 * m:,} params), device={device} ({kern}); batch + "
            f"routing + plans + Theta0 in {setup_s:.2f}s")
    obs.log(_mesh_line(mesh, part, f", routed K user={ku} ad={ka}; entries "
                       f"per shard user={entries['user']} "
                       f"ad={entries['ad']}"))
    report: dict = {"mode": "sparse", "device": str(device),
                    "num_features": d, "regions": m,
                    "sessions": args.sessions, "setup_s": setup_s,
                    "mesh": mesh.shape, "bounds": part.bounds.tolist(),
                    "entries_per_shard": entries,
                    "routed_k": {"user": ku, "ad": ka}}

    def unshard(block):
        return part.unpad_rows(mesh.gather_rows(block))

    def drift_ref(theta):
        p = sparse_predict(theta, test).cpu().numpy()
        ids = np.concatenate([test.user_ids.cpu().numpy().ravel(),
                              test.ad_ids.cpu().numpy().ravel()])
        report["drift_ref"] = _capture_drift_ref(
            args.drift_ref, p, test.y.cpu().numpy(), ids, d,
            f"held-out test, {p.shape[0]} scores")

    return _iterate(args, device, opt, theta0,
                    lambda theta: sparse_predict(theta, test),
                    None if test is None else test.y, report,
                    trained=drift_ref if args.drift_ref else None,
                    mesh=mesh, unshard=unshard)


def _train_dense_sharded(args, device: torch.device, mesh) -> dict:
    """The dense path on the mesh: the driver's compressed batch padded
    to a multiple of ``--mesh-data`` samples, this rank's sessions and
    the x columns of its id range; one sum of the xTheta partials over
    ``model``. Rank 0 scores the test rows (B5 on a card) on the gathered
    Theta."""
    from repro_torch.dist import make_sharded_dense_loss, shard_batch
    from repro_torch.shard.partition import make_partition

    cfg = CTRDataConfig(num_user_features=args.user_features,
                        num_ad_features=args.ad_features,
                        noise_features=args.noise_features, seed=args.seed)
    d, m = cfg.num_features, args.regions
    t0 = time.perf_counter()
    train, _ = generate(cfg, args.sessions, seed=1, device="cpu",
                        with_dense=False)
    batch = pad_to_multiple(train, mesh.data)
    part = make_partition(d, mesh.model)
    local = shard_batch(mesh, batch, common_feature=True, partition=part,
                        device=device)
    theta0 = part.shard_rows(part.pad_rows(_theta0(d, m, args.seed, "cpu")),
                             mesh.model_rank).to(device, copy=True)
    test = (dense_test_batch(cfg, args.sessions, device=device)
            if mesh.rank == 0 else None)
    loss_and_grad, loss = make_sharded_dense_loss(local, mesh,
                                                  common_feature=True)
    opt = OWLQNPlus(loss_and_grad, lam=args.lam, beta=args.beta, loss=loss,
                    reduce=mesh.sum_model)
    _sync(device)
    setup_s = time.perf_counter() - t0
    kern = ("CUDA kernels: Eq. 9 direction B3, dense fused forward B5 for "
            "the test AUC; fp32 products on torch.matmul"
            if device.type == "cuda" else "plain versions")
    obs.log(f"dense mode: d={d:,} columns ({cfg.num_user_features:,} "
            f"common + {cfg.num_ad_features + cfg.noise_features:,} per "
            f"sample), {batch.y.shape[0]:,} samples in "
            f"{batch.x_common.shape[0]:,} sessions, device={device} "
            f"({kern}); batch + Theta0 in {setup_s:.2f}s")
    obs.log(_mesh_line(mesh, part, f"; this rank: "
                       f"{local.x_common.shape[0]:,} sessions, "
                       f"{local.y.shape[0]:,} samples, "
                       f"{local.x_common.shape[1]} + "
                       f"{local.x_noncommon.shape[1]} columns"))
    report: dict = {"mode": "dense", "device": str(device),
                    "num_features": d, "regions": m,
                    "sessions": batch.x_common.shape[0],
                    "samples": batch.y.shape[0], "setup_s": setup_s,
                    "mesh": mesh.shape, "bounds": part.bounds.tolist()}

    def unshard(block):
        return part.unpad_rows(mesh.gather_rows(block))

    def predict(theta):
        return predict_proba(params_from_theta(theta), test.x)

    return _iterate(args, device, opt, theta0, predict,
                    None if test is None else test.y, report, nnz_width=7,
                    mesh=mesh, unshard=unshard)


def _capture_drift_ref(path: str, scores, labels, ids, d: int,
                       what: str) -> str:
    ref = obs.capture_reference(scores, labels, ids, num_features=d)
    written = obs.save_drift_reference(path, ref)
    obs.log(f"drift reference ({what}, ratio={ref.ratio:.3f}) -> {written}")
    return written


def _train_stream(args, device: torch.device, mesh=None) -> dict:
    """Day-by-day streaming training (``repro_torch.stream``): per day the
    last ``--window`` days are re-planned on the host and copied to the
    device, overlapped with the previous window's device iterations, and
    OWLQN+ runs ``--inner-iters`` warm-started steps. ``--ckpt`` saves the
    resumable stream state after every window; ``--resume`` continues
    from it. Returns the run's report: one record per window, the
    planner's accounting, the walls, the paths written and the final
    Theta. On a ``mesh`` every window trains the sharded path over equal
    id ranges; the held-out day is scored by rank 0 on the gathered
    Theta."""
    from repro_torch.stream import DayStream, StreamTrainer
    from repro_torch.stream.planner import to_device

    # np.savez appends .npz to suffix-less paths; normalise up front so
    # the --resume existence probe and the printed path match the file
    ckpt = args.ckpt and (args.ckpt if args.ckpt.endswith(".npz")
                          else args.ckpt + ".npz")
    d, m = args.sparse_features, args.regions
    stream = DayStream(args.days, sessions_per_day=args.sessions,
                       num_features=d, active_user=args.active_user,
                       active_ad=args.active_ad, drift=args.drift,
                       seed=args.seed)
    root = mesh is None or mesh.rank == 0
    theta0 = _theta0(d, m, args.seed, device if mesh is None else "cpu")
    if tuning_flags_set(args):
        day0 = stream.day(0)
        ku, ka = day0.user_ids.shape[-1], day0.ad_ids.shape[-1]
        apply_tuning_flags(args, batch_k=max(ku, ka))
        if args.tune:
            g, b, w = day0.user_ids.shape[0], day0.ad_ids.shape[0], args.window
            tune_job_shapes({(g, ku, d, m), (b, ka, d, m),
                             (g * w, ku, d, m), (b * w, ka, d, m)},
                            device=device, log=obs.log)
    trainer = StreamTrainer(
        stream, lam=args.lam, beta=args.beta, window=args.window,
        inner_iters=args.inner_iters, history=args.history,
        overlap=not args.sync_planner, device=device, mesh=mesh)
    kern = ("CUDA kernels: fused forward B1, run-length scatter B2, Eq. 9 "
            "direction B3" if device.type == "cuda" else "plain versions")
    obs.log(f"stream: {args.days} days x {args.sessions} sessions, d={d:,}, "
            f"window={args.window}, {args.inner_iters} inner iters/window, "
            f"history={args.history}, planner="
            f"{'synchronous' if args.sync_planner else 'overlapped'}, "
            f"device={device} ({kern})")
    if mesh is not None:
        obs.log(_mesh_line(mesh, trainer.partition, " (fixed across "
                           "windows)"))
    report: dict = {"mode": "stream", "device": str(device),
                    "num_features": d, "regions": m, "days": args.days,
                    "sessions": args.sessions, "windows": []}
    if args.resume and ckpt and os.path.exists(ckpt):
        state = trainer.load(ckpt, theta0)
        obs.log(f"resumed from {ckpt} at day {state.day}")
        report["resumed_at"] = state.day
    else:
        state = trainer.init(theta0)
    del theta0
    mon = obs.get_monitor()
    last_eval: dict = {}  # scores/labels/ids of the newest held-out day

    def cb(t, ws, st):
        rec = {"day": t, "days_in_window": ws.days_in_window,
               "fs": list(ws.fs), "alpha": ws.alpha, "nnz": ws.nnz,
               "build_s": ws.build_seconds, "step_s": ws.step_seconds}
        msg = obs.render_stream_day(rec)
        if t + 1 < stream.num_days:  # held-out NEXT-day quality
            theta = trainer.theta(st)  # a collective on a mesh
        if t + 1 < stream.num_days and root:
            nxt, _ = to_device(stream.day(t + 1), device)
            nll = float(nll_sparse(theta, nxt)) / nxt.y.shape[0]
            p = sparse_predict(theta, nxt).cpu().numpy()
            y = nxt.y.cpu().numpy()
            a = float(auc(y, p))
            rec.update(next_day_nll=nll, next_day_auc=a)
            msg += f"  next-day nll={nll:.4f} auc={a:.4f}"
            obs.log(msg, kind="stream_eval", day=t, next_day_nll=nll,
                    next_day_auc=a)
            mon.observe_predictions(p, y)
            if args.drift_ref:
                last_eval.update(scores=p, labels=y, ids=np.concatenate(
                    [nxt.user_ids.cpu().numpy().ravel(),
                     nxt.ad_ids.cpu().numpy().ravel()]))
        else:
            obs.log(msg)
        report["windows"].append(rec)
        if ckpt:  # every window is a resumable checkpoint
            trainer.save(ckpt, st)

    t0 = time.perf_counter()
    days_left = stream.num_days - state.day
    state, _ = trainer.run(state, callback=cb)
    wall = time.perf_counter() - t0
    ps = trainer.planner_stats
    report.update(wall_s=wall, planner=ps._asdict(),
                  overlap_ratio=ps.overlap_ratio, final_day=state.day,
                  theta=trainer.theta(state))
    obs.log(f"trained {days_left} windows in {wall:.1f}s; planner: "
            f"{ps.build_seconds:.2f}s host build, {ps.wait_seconds:.2f}s "
            f"exposed, overlap ratio {ps.overlap_ratio:.2f}")
    if args.drift_ref and root:
        if not last_eval:
            raise SystemExit(
                "--drift-ref needs at least one held-out next-day eval; "
                "run with --days >= 2 (or resume earlier in the stream)")
        report["drift_ref"] = _capture_drift_ref(
            args.drift_ref, last_eval["scores"], last_eval["labels"],
            last_eval["ids"], d,
            f"last held-out day, {last_eval['scores'].shape[0]} scores")
    if ckpt:
        report["ckpt"] = ckpt
        obs.log(f"stream checkpoint -> {ckpt} (resume with --resume)")
    if mon.enabled:
        report["monitor"] = mon.summary()
    return report


def _counts_delta(before: dict, after: dict) -> dict:
    return {a: {k: after[a][k] - before[a][k] for k in after[a]}
            for a in after}


def _iterate(args, device: torch.device, opt: OWLQNPlus,
             theta0: torch.Tensor, predict, y_test: torch.Tensor | None,
             report: dict, nnz_width: int = 8, trained=None, mesh=None,
             unshard=None) -> dict:
    """``--iters`` OWLQN+ steps from ``theta0``, one ``train_iter``
    record each (test AUC of ``predict(theta)`` every 5 iterations and at
    the last), then the walls, ``trained(theta)`` (when given) and the
    checkpoint into ``report``. On a mesh ``theta0`` is this rank's block,
    ``unshard`` (a collective) gives the global Theta, each record carries
    the step's all-reduces, and rank 0 alone (``y_test`` given) scores and
    writes."""
    state = opt.init(theta0)
    del theta0
    tracer = obs.get_tracer()
    y_test = None if y_test is None else y_test.cpu().numpy()
    report["iters"] = []
    train_s = 0.0

    def global_theta():
        return state.theta if unshard is None else unshard(state.theta)

    for k in range(args.iters):
        before = None if mesh is None else mesh.collective_counts()
        t0 = time.perf_counter()
        with tracer.step_span("train/iter", k):
            state, stats = opt.step(state)
            _sync(device)
        dt = time.perf_counter() - t0
        train_s += dt
        rec = dict(step=k, **stats._asdict(), wall_s=dt)
        if mesh is not None:
            rec["collectives"] = _counts_delta(before,
                                               mesh.collective_counts())
        if k % 5 == 0 or k == args.iters - 1:
            theta = global_theta()
            if y_test is not None:
                p = predict(theta).cpu().numpy()
                rec["test_auc"] = float(auc(y_test, p))
        report["iters"].append(rec)
        obs.log(obs.render_train_iter(rec, nnz_width=nnz_width),
                kind="train_iter", **rec)
    report["train_s"] = train_s
    report["s_per_iter"] = train_s / max(1, args.iters)
    report["test_auc"] = (report["iters"][-1].get("test_auc")
                          if report["iters"] else None)
    obs.log(f"trained {args.iters} OWLQN+ iterations in {train_s:.2f}s "
            f"({report['s_per_iter'] * 1e3:.1f} ms/iter)")
    theta = global_theta() if (trained or args.ckpt) else None
    root = mesh is None or mesh.rank == 0
    if trained is not None and root:
        trained(theta)
    if args.ckpt and root:
        report["ckpt"] = checkpoint.save(args.ckpt, {"theta": theta})
        obs.log(f"checkpoint -> {report['ckpt']}")
    return report


if __name__ == "__main__":
    raise SystemExit(main())
