#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, drives the serving
main path (``repro_torch.launch.serve``) at paper width (d = 1,000,000
features, m = 12 regions) in int8 and fp32, shows that path launched both
kernels, times the kernels beside their plain versions, their memory
bound and one library call, and ends with one JSON line::

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

It exits non-zero, printing no result, when a phase fails, when
``torch.cuda.is_available()`` is false, or when the port is not beside it.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
D_FEATURES = 1_000_000  # paper width (examples/train_sparse_production.py)
REGIONS = 12  # m: 2m = 24 columns
ALIVE_FRACTION = 0.02  # rows surviving L2,1 pruning (paper Table 2 regime)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
Z_RTOL, Z_ATOL, P_ATOL = 1e-5, 1e-6, 1e-6
TIMED_RUNS, WARM_RUNS = 30, 3
SPIN_CYCLES = 10_000_000  # ~5 ms of device spin ahead of each timed run
SOURCE = "src/repro_torch/kernels/lsplm_sparse_fused/csrc/lsplm_sparse_fused.cu"
REPLACES = {
    "lsplm_sparse_fused_forward":
        "src/repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py:73",
    "lsplm_sparse_fused_int8_forward":
        "src/repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py:151",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------ phase 1
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.nvcc()})")
    for path in libs.values():
        log = path.with_name(path.name + ".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


# ------------------------------------------------------------ phase 2
def _batch(rng, n, k, d_rows, pad_every=8):
    """ids/vals with pad slots, a duplicate pair and a triple per row."""
    ids = rng.integers(0, d_rows - 1, (n, k)).astype(np.int32)
    if k >= 4:
        ids[:, 1] = ids[:, 0]
        ids[:, 3] = ids[:, 0]
    ids[:, ::pad_every] = d_rows - 1
    vals = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    return ids, vals


def _z_ok(z, z_ref):
    return bool(((z - z_ref).abs() <= Z_ATOL + Z_RTOL * z_ref.abs()).all())


def phase_kernels(torch, dev, theta, codes, scales):
    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        lsplm_sparse_fused_forward,
        lsplm_sparse_fused_int8_forward,
    )

    rng = np.random.default_rng(SEED + 1)
    d_rows = theta.shape[0]
    deq = codes.to(torch.float32) * scales[:, None]
    err = {"lsplm_sparse_fused_forward": 0.0,
           "lsplm_sparse_fused_int8_forward": 0.0}
    bitwise = True
    for n in (1, 37, 4096):
        for k in (8, 24, 64):
            ids_np, vals_np = _batch(rng, n, k, d_rows)
            ids = torch.from_numpy(ids_np).to(dev)
            vals = torch.from_numpy(vals_np).to(dev)
            z_ref = ops._chunked_zmap(ids, vals, theta)
            p_ref = ops.finalize_p(z_ref)
            zi_ref = ops._chunked_zmap_int8(ids, vals, codes, scales)
            pi_ref = ops.finalize_p(zi_ref)
            for dedup in (True, False):
                ki, kv = ((ops.dedup_tile_ids(ids, vals, d_rows - 1))
                          if dedup else (ids, vals))
                p, z = lsplm_sparse_fused_forward(ki, kv, theta)
                pi, zi = lsplm_sparse_fused_int8_forward(ki, kv, codes, scales)
                pd, zd = lsplm_sparse_fused_forward(ki, kv, deq)
                torch.cuda.synchronize()
                tag = f"N={n} K={k} dedup={dedup}"
                check(_z_ok(z, z_ref), f"B1 z vs plain at {tag}")
                check(float((p - p_ref).abs().max()) <= P_ATOL,
                      f"B1 p vs plain at {tag}")
                check(_z_ok(zi, zi_ref), f"B4 z vs plain int8 at {tag}")
                check(float((pi - pi_ref).abs().max()) <= P_ATOL,
                      f"B4 p vs plain int8 at {tag}")
                check(_z_ok(zi, zd) and float((pi - pd).abs().max()) <= P_ATOL,
                      f"B4 vs B1 on the dequantised Theta at {tag}")
                bitwise &= bool(torch.equal(zi, zd) and torch.equal(pi, pd))
                err["lsplm_sparse_fused_forward"] = max(
                    err["lsplm_sparse_fused_forward"],
                    float((z - z_ref).abs().max()),
                    float((p - p_ref).abs().max()))
                err["lsplm_sparse_fused_int8_forward"] = max(
                    err["lsplm_sparse_fused_int8_forward"],
                    float((zi - zi_ref).abs().max()),
                    float((pi - pi_ref).abs().max()))
    print(f"phase 2: kernels agree with their plain versions at d={d_rows - 1:,}"
          f", 2m={theta.shape[1]}, N in (1, 37, 4096), K in (8, 24, 64), "
          f"dedup on/off (z rtol {Z_RTOL}/atol {Z_ATOL}, p atol {P_ATOL}); "
          f"max |err| fp32 {err['lsplm_sparse_fused_forward']:.3e}, "
          f"int8 {err['lsplm_sparse_fused_int8_forward']:.3e}; int8 kernel "
          f"vs fp32 kernel on the dequantised Theta: "
          f"{'bitwise equal' if bitwise else 'within 1e-6, not bitwise'}")
    return err, bitwise


# ------------------------------------------------------------ phase 3
def phase_main_path(torch, tmp: Path):
    from repro_torch.io import checkpoint
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES,
    )
    from repro_torch.launch import serve
    from repro_torch.serve.compress import compress
    from repro_torch.serve.engine import ScoringEngine, synthetic_requests

    rng = np.random.default_rng(SEED)
    theta = np.zeros((D_FEATURES, 2 * REGIONS), np.float32)
    alive = rng.random(D_FEATURES) < ALIVE_FRACTION
    theta[alive] = (rng.normal(size=(int(alive.sum()), 2 * REGIONS))
                    * 0.3).astype(np.float32)
    ckpt = checkpoint.save(str(tmp / "theta.npz"), {"theta": theta})
    common = ["--ckpt", ckpt, "--requests", "512", "--load-qps", "2000,20000",
              "--coalesce", "--seed", str(SEED)]
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    rep_i8 = serve.run(common + ["--int8"])
    rep_fp = serve.run(common)
    launches = dict(LAUNCHES)
    wall = time.perf_counter() - t0
    for name, count in launches.items():
        check(count > 0, f"the main path never launched {name}")
    print(f"phase 3: serving main path (int8 then fp32) at d={D_FEATURES:,}, "
          f"m={REGIONS}, {rep_fp['rows_alive']:,} rows alive, in {wall:.1f} s; "
          f"driver asserts held (pruned == full bitwise, single == batched "
          f"bitwise, 0 envelope builds after warm-up, int8 max |dp| "
          f"{rep_i8['int8_max_dp']:.2e}); launches {launches}")
    for tag, rep in (("int8", rep_i8), ("fp32", rep_fp)):
        eng = rep["engine"]
        print(f"  {tag} engine: {eng['candidates_per_sec']:,.0f} candidates/s, "
              f"{eng['latency_us']:.0f} us/request mean, "
              f"{eng['dispatches']} dispatches")
        for load in rep["load"]:
            print(f"  {tag} load {load['offered_qps']:,.0f} qps offered: "
                  f"p50 {load['latency_p50_us']:,.0f} us, p99 "
                  f"{load['latency_p99_us']:,.0f} us, achieved "
                  f"{load['achieved_qps']:,.0f} qps, "
                  f"{load['candidates_per_sec']:,.0f} candidates/s")

    # the card's scores against the plain versions on the CPU, small input
    art = compress(theta)
    reqs = synthetic_requests(8, num_features=D_FEATURES, seed=SEED + 5)
    gpu = ScoringEngine(art, device="cuda").score_batch(reqs)
    cpu = ScoringEngine(art, device="cpu").score_batch(reqs)
    for r, a, b in zip(reqs, gpu, cpu):
        check(a.shape == (r.ad_ids.shape[0],) and np.isfinite(a).all(),
              "engine scores have the wrong shape or are not finite")
        check(float(np.abs(a - b).max()) <= P_ATOL,
              "engine scores on the card differ from the CPU's")
    print("  engine scores on the card match the plain CPU path "
          f"(8 requests, |dp| <= {P_ATOL})")
    _profile_dispatches(torch, art)
    return launches, rep_i8, rep_fp


def _profile_dispatches(torch, art) -> None:
    """Where a dispatch's time goes: host wall per dispatch against the
    device's kernel time (torch.profiler), for G=1 and batched replays."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ScoringEngine, synthetic_requests

    reqs = synthetic_requests(128, num_features=D_FEATURES, seed=SEED + 6)
    engine = ScoringEngine(art, device="cuda")
    engine.warm({engine.envelope(r) for r in reqs},
                batch_sizes=engine.g_buckets)
    for tag, fn in (("G=1", lambda: engine.score_many(reqs[:32])),
                    ("batched", lambda: engine.score_batch(reqs))):
        before = engine.stats.dispatches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_us = (time.perf_counter() - t0) * 1e6
        dispatches = engine.stats.dispatches - before
        kernels: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.name] = (kernels.get(e.name, 0.0)
                                   + e.time_range.elapsed_us())
        busy_us = sum(kernels.values())
        if not kernels:
            print(f"  profile {tag}: {wall_us / dispatches:,.0f} us wall per "
                  "dispatch; device time not measured (no device events)")
            continue
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        print(f"  profile {tag}: {dispatches} dispatches, "
              f"{wall_us / dispatches:,.1f} us wall and "
              f"{busy_us / dispatches:,.1f} us of device kernels per "
              f"dispatch (device idle {1 - busy_us / wall_us:.1%}); top: "
              + "; ".join(f"{name[:60]} {us / dispatches:.1f} us"
                          for name, us in top))


# ------------------------------------------------------------ phase 4
def _time_ms(torch, fn, flush) -> float:
    """Median milliseconds of ``fn`` over TIMED_RUNS launches, each after
    an L2 flush, timed by CUDA events. A spin kernel keeps the card busy
    while the host enqueues the events and ``fn``, so the events time
    the device work and not the host's launch path."""
    for _ in range(WARM_RUNS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(torch, ids, pad_id, row_bytes, m2, ops_per_elem):
    """Least time for the work: bytes each read/written once (ids, vals,
    the distinct live rows, p and z), and ops at the fp32 peak."""
    n, k = ids.shape
    live = ids[ids != pad_id]
    rows = int(torch.unique(live).numel())
    nbytes = n * k * 8 + rows * row_bytes + n * (m2 + 1) * 4
    ops = int(live.numel()) * m2 * ops_per_elem
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_times(torch, dev, theta, codes, scales):
    import torch.nn.functional as F

    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        lsplm_sparse_fused_forward,
        lsplm_sparse_fused_int8_forward,
    )

    rng = np.random.default_rng(SEED + 2)
    d_rows, m2 = theta.shape
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    out = {}
    for n in (512, 65_536):
        k = 24
        ids = torch.from_numpy(
            rng.integers(0, d_rows - 1, (n, k)).astype(np.int32)).to(dev)
        vals = torch.from_numpy(
            (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)).to(dev)
        z_lib = F.embedding_bag(ids, theta, per_sample_weights=vals,
                                mode="sum", padding_idx=d_rows - 1)
        lib_err = float((z_lib - ops._chunked_zmap(ids, vals, theta))
                        .abs().max())
        cases = {
            "lsplm_sparse_fused_forward": dict(
                kernel=lambda: lsplm_sparse_fused_forward(ids, vals, theta),
                plain=lambda: ops.finalize_p(
                    ops._chunked_zmap(ids, vals, theta)),
                library=lambda: F.embedding_bag(
                    ids, theta, per_sample_weights=vals, mode="sum",
                    padding_idx=d_rows - 1),
                bound=_bound(torch, ids, d_rows - 1, m2 * 4, m2, 2)),
            "lsplm_sparse_fused_int8_forward": dict(
                kernel=lambda: lsplm_sparse_fused_int8_forward(
                    ids, vals, codes, scales),
                plain=lambda: ops.finalize_p(
                    ops._chunked_zmap_int8(ids, vals, codes, scales)),
                library=None,
                bound=_bound(torch, ids, d_rows - 1, m2 + 4, m2, 3)),
        }
        for name, c in cases.items():
            bound_ms, bound_by = c["bound"]
            row = {
                "n": n, "k": k,
                "ms": _time_ms(torch, c["kernel"], flush),
                "plain_ms": _time_ms(torch, c["plain"], flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": (None if c["library"] is None
                               else _time_ms(torch, c["library"], flush)),
            }
            out.setdefault(name, []).append(row)
            lib = ("n/a" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms (embedding_bag, "
                        f"max |dz| vs plain {lib_err:.1e})")
            print(f"phase 4: {name} N={n} K={k}: kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}, {row['bound_ms'] / row['ms']:.1%} of it "
                  f"reached), library {lib}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.device import resolve_device
        from repro_torch.serve.compress import compress, quantize
    except ImportError as e:
        raise SmokeFailure(f"the port is not beside this script: {e}") from e
    dev = resolve_device("cuda")
    phase_device(torch)

    rng = np.random.default_rng(SEED + 3)
    theta_np = (rng.normal(size=(D_FEATURES, 2 * REGIONS)) * 0.3).astype(
        np.float32)
    art = compress(theta_np)  # every row alive: (d+1, 2m) with the pad row
    q = quantize(art)
    theta = art.theta.to(dev)
    codes, scales = q.codes.to(dev), q.scales.to(dev)
    del theta_np, art, q

    err, _ = phase_kernels(torch, dev, theta, codes, scales)
    with tempfile.TemporaryDirectory() as tmp:
        launches, _, _ = phase_main_path(torch, Path(tmp))
    times = phase_times(torch, dev, theta, codes, scales)

    kernels = []
    for name in ("lsplm_sparse_fused_forward",
                 "lsplm_sparse_fused_int8_forward"):
        main_shape, large = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": [main_shape["n"], main_shape["k"]], "large": large,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
