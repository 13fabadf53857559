"""Serving driver: load -> prune -> engine replay (the §4 deploy path as
one command), on the card by default.

The port's counterpart of ``repro/launch/serve.py``. Serve a training
checkpoint (``{"theta": ...}``, as saved by ``repro_torch.launch.train
--ckpt`` or ``repro.launch.train --ckpt``):

  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt /tmp/lsplm.npz \\
      --requests 512 --int8 --load-qps 500,2000 --coalesce

Without ``--ckpt`` the driver first trains a small sparse model with
OWLQN+ (``--sparse-features``, ``--regions``, ``--sessions``, ``--lam``,
``--beta``, ``--train-iters``: the training driver's path), so the
artifact carries real L2,1 sparsity, not a synthetic mask.

The driver prints the prune ledger (rows alive, MiB shipped), proves
pruned-vs-full scores bitwise equal on a probe batch, then replays ragged
synthetic bundles through the
:class:`~repro_torch.serve.engine.ScoringEngine` — one request per
dispatch AND stacked same-envelope G>1 dispatches (bitwise equal) — and
asserts that nothing after the warm-up built a new envelope entry.

``--int8`` quantises the artifact (int8 rows + per-row fp32 scale),
round-trips it through save/load and serves THAT int8-native, printing
the size win and the probability drift vs fp32 (gated at 1e-2).
``--load-qps`` replays open-loop Poisson arrivals at the given rate(s)
through the micro-batching queue (p50/p99 latency, achieved QPS,
candidates/sec); ``--coalesce`` merges due per-envelope groups into one
dispatch; ``--real-clock`` also replays each rate through the wall-clock
pump. ``--monitor`` runs the health monitor over the dispatches
(``obs.monitor``) and prints its summary line; ``--drift-ref PATH`` (a
reference ``repro_torch.launch.train --drift-ref`` captured, standalone or
embedded in an artifact) arms its drift and calibration detectors, and
needs ``--monitor``. ``--block-n``/``--chunk`` pin a kernel knob and
``--tune`` sweeps the traffic's own envelopes before the warm-up
(``repro_torch.launch.tuning``; the scores are bitwise those of an
untuned run); ``--block-k`` is refused. ``--device cpu`` runs the plain
versions on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.convert import theta_from_numpy
from repro_torch.device import resolve_device
from repro_torch.io import checkpoint
from repro_torch.launch.train import sparse_problem
from repro_torch.launch.tuning import (
    add_tuning_flags,
    apply_tuning_flags,
    tune_job_shapes,
    tuning_scope,
)
from repro_torch.serve.compress import (
    compress,
    load_artifact,
    quantize,
    save_artifact,
)
from repro_torch.serve.engine import (
    ScoringEngine,
    envelope_closure,
    synthetic_requests,
)
from repro_torch.serve.score import as_model, score_sparse
from repro_torch.serve.traffic import (
    MicroBatchQueue,
    QueueConfig,
    RealClockPump,
    poisson_arrivals,
    replay_open_loop,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--ckpt", default=None,
                    help="training checkpoint with a 'theta' entry; "
                         "omitted -> train a small sparse model first")
    ap.add_argument("--train-iters", type=int, default=10)
    ap.add_argument("--sparse-features", type=int, default=20_000)
    ap.add_argument("--sessions", type=int, default=256)
    ap.add_argument("--regions", type=int, default=4)
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--beta", type=float, default=0.05)
    ap.add_argument("--artifact", default=None,
                    help="write the pruned serving artifact here")
    ap.add_argument("--requests", type=int, default=256,
                    help="ragged synthetic bundles to replay")
    ap.add_argument("--int8", action="store_true",
                    help="quantise the artifact (int8 rows + fp32 row "
                         "scales), round-trip through save/load, serve that")
    ap.add_argument("--load-qps", default=None,
                    help="traffic mode: comma-separated offered QPS rates "
                         "for the open-loop Poisson replay through the "
                         "micro-batching queue")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="queue full-flush size (requests per dispatch)")
    ap.add_argument("--max-delay-us", type=float, default=3_000.0,
                    help="queue deadline: max micro-batching delay")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="admission control: shed load past this backlog")
    ap.add_argument("--coalesce", action="store_true",
                    help="merge several due per-envelope groups into one "
                         "dispatch at the widest due envelope")
    ap.add_argument("--real-clock", action="store_true",
                    help="also replay each --load-qps rate through the "
                         "wall-clock RealClockPump front door")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    add_tuning_flags(ap)
    obs.add_flags(ap)
    return ap


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


def run(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, serve, and return the run's report: the prune
    numbers, the engine stats, the single-request replay's scores and one
    queue report per offered rate."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.drift_ref and not args.monitor:
        raise SystemExit(
            "--drift-ref arms the health monitor's drift detectors; "
            "combine it with --monitor")
    if args.real_clock and not args.load_qps:
        raise SystemExit("--real-clock paces the queue with wall-time "
                         "Poisson arrivals; combine it with --load-qps")
    device = resolve_device(args.device)
    session = obs.configure_from_args(args, driver="repro_torch.launch.serve",
                                      device=device, argv=argv)
    try:
        with tuning_scope():
            apply_tuning_flags(args)  # value check up front; geometry later
            return _serve(args, device)
    finally:
        session.close()


def _real_clock_smoke(engine, requests, *, qps: float, config: QueueConfig,
                      seed: int) -> dict:
    """Poisson-paced REAL sleeps feed a :class:`RealClockPump`, whose timer
    thread fires the deadline flushes; ``stop()`` joins then drains, so
    every accepted request must have a completion."""
    queue = MicroBatchQueue(engine, config)
    arrivals = poisson_arrivals(len(requests), qps, seed)
    gaps = np.diff(np.concatenate([[0.0], arrivals]))
    before = engine.stats.compiles
    t0 = time.perf_counter()
    accepted = 0
    with RealClockPump(queue) as pump:
        for gap, req in zip(gaps, requests):
            time.sleep(gap)
            if pump.submit(req) is not None:
                accepted += 1
    wall = time.perf_counter() - t0
    comps = queue.completions
    if len(comps) != accepted:
        raise RuntimeError(f"pump drained {len(comps)} of {accepted} "
                           "accepted requests")
    if engine.stats.compiles != before:
        raise RuntimeError("real-clock replay built a new envelope entry")
    lat = np.array([c.latency_us for c in comps]) if comps else np.zeros(1)
    fl = queue.stats.flushes
    rep = {"qps": qps, "accepted": accepted,
           "latency_p50_us": float(np.percentile(lat, 50)),
           "latency_p99_us": float(np.percentile(lat, 99))}
    obs.log(f"real-clock {qps:,.0f} qps: {accepted}/{len(requests)} accepted,"
            f" all drained in {wall:.2f}s wall; "
            f"p50 {rep['latency_p50_us']:,.0f} us, "
            f"p99 {rep['latency_p99_us']:,.0f} us "
            f"({fl['full']} full / {fl['deadline']} deadline / "
            f"{fl['drain']} drain / {fl['coalesced']} coalesced)")
    return rep


def _trained_theta(args, device: torch.device) -> torch.Tensor:
    """--ckpt loads a saved Theta; otherwise train a small sparse model
    (the path of ``repro_torch.launch.train --sparse``)."""
    if args.ckpt:
        data = checkpoint.load_nested(args.ckpt)
        if "theta" not in data:
            raise SystemExit(f"--ckpt {args.ckpt!r} has no 'theta' entry")
        theta = theta_from_numpy(data["theta"], device)
        obs.log(f"loaded theta {tuple(theta.shape)} from {args.ckpt} onto "
                f"{device}")
        return theta
    # the reference's serve driver seeds the batch with --seed itself
    _, theta0, opt = sparse_problem(
        args.sparse_features, args.regions, args.sessions, lam=args.lam,
        beta=args.beta, seed=args.seed, batch_seed=args.seed, device=device)
    t0 = time.perf_counter()
    theta, trace = opt.run(theta0, max_iters=args.train_iters)
    obs.log(f"trained {len(trace)} OWLQN+ iters on "
            f"d={args.sparse_features:,} in "
            f"{time.perf_counter() - t0:.1f}s (f={trace[-1].f_new:.2f}, "
            f"nnz={trace[-1].nnz:,})")
    return theta


def _serve(args, device: torch.device) -> dict:
    theta = _trained_theta(args, device)
    d = theta.shape[0]
    report: dict = {"device": str(device), "num_features": d,
                    "regions": theta.shape[1] // 2}

    art = compress(theta)
    full_mb = theta.numel() * 4 / 2**20
    art_mb = (art.theta.numel() + art.remap.numel()
              + art.alive_ids.numel()) * 4 / 2**20
    report["rows_alive"] = art.num_alive
    obs.log(f"pruned: {art.num_alive:,}/{d:,} rows alive "
            f"({art.compression:.2%}); ship {art_mb:.2f} MiB vs "
            f"{full_mb:.2f} MiB full")
    if args.artifact:
        obs.log(f"artifact -> {save_artifact(args.artifact, art)}")

    # pruned-vs-full parity probe (bit-identical on the sparse path)
    rng = np.random.default_rng(args.seed + 7)
    ids = torch.tensor(rng.integers(0, d, (512, 16)), dtype=torch.int32)
    vals = torch.tensor(rng.normal(size=(512, 16)).astype(np.float32))
    p_art = score_sparse(as_model(art), ids, vals).cpu()
    if not torch.equal(score_sparse(as_model(theta), ids, vals).cpu(), p_art):
        raise RuntimeError("pruned scoring differs from full-Theta scoring")
    del theta
    obs.log("parity: pruned scoring bit-identical to full Theta (512 probes)")

    model = art
    if args.int8:
        q = quantize(art)
        with tempfile.TemporaryDirectory() as tmp:
            model = load_artifact(save_artifact(f"{tmp}/art_int8", q), device)
        dp = float((score_sparse(model, ids, vals).cpu() - p_art).abs().max())
        if not dp <= 1e-2:
            raise RuntimeError(f"int8 moved p by {dp:.2e} (> 1e-2)")
        report["int8_max_dp"] = dp
        rows_i8 = q.codes.numel() + q.scales.numel() * 4
        obs.log(f"int8-native: rows payload {rows_i8:,} B vs "
                f"{art.theta.numel() * 4:,} B fp32 "
                f"({art.theta.numel() * 4 / rows_i8:.1f}x smaller rows and "
                f"row-gather bytes); round-tripped save/load; serving the "
                f"codes directly (scale fused into the gather); "
                f"max |dp| = {dp:.1e} vs fp32")

    engine = ScoringEngine(model, device=device)
    mon = obs.get_monitor()
    if args.drift_ref:
        ref = obs.load_drift_reference(args.drift_ref)
        mon.arm_drift(ref)
        obs.log(f"monitor armed from {args.drift_ref}: "
                f"{ref.num_bins} score bins, top-{ref.top_ids.shape[0]} id "
                f"traffic, reference calibration ratio {ref.ratio:.3f}")
    requests = synthetic_requests(args.requests, num_features=d,
                                  seed=args.seed + 1)
    # deploy-time warm-up: build the traffic's bucket set (all batch
    # sizes the G>1 path can round onto), then the replay is steady state
    envelopes = {engine.envelope(r) for r in requests}
    # the engine pads K/N up to its buckets before the kernels run, so
    # the geometry the knobs must fit is the PADDED envelope set
    kmax = max(max(ku, ka) for ku, ka, _n in envelopes)
    nmax = engine.max_batch * max(n for _ku, _ka, n in envelopes)
    apply_tuning_flags(args, batch_n=nmax, batch_k=kmax)
    if args.tune:
        m = report["regions"]
        gs = (1, engine.max_batch)
        tune_job_shapes(
            {(g * n, ka, d, m) for _ku, ka, n in envelopes for g in gs}
            | {(g, ku, d, m) for ku, _ka, _n in envelopes for g in gs},
            device=device, log=obs.log)
    if args.coalesce:
        # coalesced flushes dispatch at the elementwise max of merged
        # envelopes: warm the closure so they never build an entry either
        envelopes = envelope_closure(envelopes)
    engine.warm(envelopes, batch_sizes=engine.g_buckets)
    warm_builds = engine.stats.compiles
    single = engine.score_many(requests)
    batched = engine.score_batch(requests)
    for p_one, p_many in zip(single, batched):
        if not np.array_equal(p_one, p_many):
            raise RuntimeError("batched scores differ from single scores")
    s = engine.stats
    if s.compiles != warm_builds:
        raise RuntimeError(f"steady state built envelope entries: "
                           f"{s.compiles} != {warm_builds}")
    report["engine"] = s.as_dict()
    report["scores"] = np.concatenate(single)
    obs.log(f"engine: {s.requests} requests / {s.candidates} candidates "
            f"over {len(s.bucket_hits)} buckets; {s.compiles} envelope "
            f"builds ({s.compile_seconds:.2f}s, all in warm-up), steady "
            f"state 0 new builds; single-vs-batched scores bit-identical; "
            f"{s.latency_us:.0f} us/request, {s.candidates_per_sec:,.0f} "
            f"ads/s, batched occupancy {s.occupancy:.2f}")

    report["load"] = []
    report["real_clock"] = []
    if args.load_qps:
        cfg = QueueConfig(max_batch=args.max_batch,
                          max_delay_us=args.max_delay_us,
                          max_pending=args.max_pending,
                          coalesce=args.coalesce)
        for qps in (float(x) for x in args.load_qps.split(",") if x.strip()):
            before = engine.stats.compiles
            rep = replay_open_loop(engine, requests, qps=qps, config=cfg,
                                   seed=args.seed + 2)
            if engine.stats.compiles != before:
                raise RuntimeError("queue replay built a new envelope entry")
            report["load"].append(rep)
            obs.log(f"load {qps:,.0f} qps offered: "
                    f"p50 {rep['latency_p50_us']:,.0f} us, "
                    f"p99 {rep['latency_p99_us']:,.0f} us, "
                    f"achieved {rep['achieved_qps']:,.0f} qps, "
                    f"{rep['candidates_per_sec']:,.0f} ads/s, "
                    f"occupancy {rep['occupancy']:.2f}, "
                    f"{rep['dispatches']} dispatches "
                    f"({rep['flushes']['full']} full / "
                    f"{rep['flushes']['deadline']} deadline / "
                    f"{rep['flushes']['drain']} drain / "
                    f"{rep['flushes']['coalesced']} coalesced"
                    + (f" merging {rep['coalesced_groups']} groups"
                       if rep["flushes"]["coalesced"] else "")
                    + f"), rejected {rep['rejected']}")
            if args.real_clock:
                report["real_clock"].append(_real_clock_smoke(
                    engine, requests, qps=qps, config=cfg,
                    seed=args.seed + 3))

    if mon.enabled:
        mon.evaluate()  # settle the last partial eval_every window
        summ = mon.summary()
        report["monitor"] = summ
        active = ", ".join(summ["active"]) if summ["active"] else "none"
        drift = {k: v for k, v in summ["signals"].items()
                 if k.startswith(("drift.", "calib."))}
        obs.log(f"monitor: {summ['alerts']} alert state changes, "
                f"active: {active}"
                + (f"; drift signals: "
                   + ", ".join(f"{k}={v:.4f}"
                               for k, v in sorted(drift.items()))
                   if drift else ""))
    return report


if __name__ == "__main__":
    raise SystemExit(main())
