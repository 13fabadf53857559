#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, drives the serving
main path (``repro_torch.launch.serve``) at paper width (d = 1,000,000
features, m = 12 regions) in int8 and fp32, the sparse training main path
(``repro_torch.launch.train --sparse``, OWLQN+ at the same width, then
serving the Theta it trained), the dense one (``repro_torch.launch.
train``, common-feature OWLQN+ at d = 32,768, then scoring its test rows
through ``serve.predict``) and the LM serving path (``repro_torch.models``:
llama3.2-1b at full width, prefill of 4 x 4,096 tokens, 32 greedy tokens
through ``models.generate``, prefill of 1 x 32,768) and the SSM serving
path (falcon-mamba-7b at full width and depth, the same three runs),
shows that each path launched its kernels, holds the card's OWLQN+
trajectories and a reduced LM of each family against the CPU's, times
the kernels beside their plain versions, their bound and one library
call where there is one, and ends with one JSON line::

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

It exits non-zero, printing no result, when a phase fails, when
``torch.cuda.is_available()`` is false, or when the port is not beside it.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import re
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
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores, fp32 sums
Z_RTOL, Z_ATOL, P_ATOL = 1e-5, 1e-6, 1e-6
TIMED_RUNS, WARM_RUNS = 30, 3
SPIN_CYCLES = 10_000_000  # ~5 ms of device spin ahead of each timed run
SESSIONS = 4000  # launch default of the training driver
TRAIN_ITERS = 10
LAM = BETA = 0.05
B2_REL, B2_ABS = 1e-5, 1e-6  # |err| <= B2_REL * sum |terms| + B2_ABS
B3_RTOL, B3_ATOL = 1e-5, 1e-6
TRAJ_F_RTOL, TRAJ_RTOL, TRAJ_ATOL = 2e-4, 2e-3, 2e-5
PATTERN_SHARE = 1e-5  # zero-pattern flips allowed at paper width
# the dense path: the batch of launch/dryrun_lsplm.py's production stand-in
# (2^12 sessions x 4 ads = 2^14 samples, d_c = d / 2, m = 12) with d cut
# from 2^19 to 2^15, the width the reference generator's host arrays allow
DENSE_SESSIONS = 4096
DENSE_USER, DENSE_AD, DENSE_NOISE = 16_384, 16_368, 16
DENSE_D = DENSE_USER + DENSE_AD + DENSE_NOISE  # 32,768
DENSE_LAM = DENSE_BETA = 0.1  # lam = beta = 1.0 zeroes every row there
DENSE_ITERS = 10
DENSE_STEPS = 6  # card vs CPU steps at the launch defaults
LOSS_RTOL, GRAD_ATOL = 2e-5, 3e-5  # gradient after / max(1, max |g|)
B5_TOL, B5_BF16_TOL = 1e-5, 2e-2  # tests/test_kernels.py:46,59
# the LM path: llama3.2-1b at full width (16 layers, d 2048, 32 heads over
# 8 KV heads, hd 64, vocab 128,256); the train_4k sequence length at 4
# prompts, and the prefill_32k length with its batch cut from 32 to 1
LM_ARCH = "llama3.2-1b"
LM_PARAMS = 1_235_814_400
LM_BATCH, LM_SEQ, LM_NEW = 4, 4096, 32
LM_LONG = 32768
LM_TOL = 5e-2  # bf16 logits, B6 vs plain attention (tests/test_archs_smoke.py:137)
LM_CPU_TOL = 1e-4  # fp32 logits, card vs CPU
B6_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py:133
LONG_RUNS = 5  # timed runs of B6 at S = 32,768
# the SSM path: falcon-mamba-7b at full width and depth (64 Mamba1 layers,
# d 4,096, d_inner 8,192, state 16, conv 4, dt rank 256, vocab 65,024,
# untied head), at the LM path's prompt shapes and decode length
SSM_ARCH = "falcon-mamba-7b"
SSM_PARAMS = 7_272_665_088
SSM_SHORT = 512  # prompt length of the B7-vs-plain-scan model comparison
B7_TOL = 2e-5  # y and hT, tests/test_kernels.py:175
SFU_EXP_PER_S = 16 * 132 * 1.98e9  # 16 a clock per SM (CC 9.0) x 132 SMs
B7_PLAIN_RUNS = 2  # timed runs of the plain scan at S >= 4,096
_FUSED = "src/repro_torch/kernels/lsplm_sparse_fused/csrc/lsplm_sparse_fused.cu"
SOURCES = {
    "lsplm_sparse_fused_forward": _FUSED,
    "lsplm_sparse_fused_int8_forward": _FUSED,
    "lsplm_sparse_scatter_compact":
        "src/repro_torch/kernels/lsplm_sparse_scatter/csrc/"
        "lsplm_sparse_scatter.cu",
    "owlqn_direction":
        "src/repro_torch/kernels/owlqn_direction/csrc/owlqn_direction.cu",
    "lsplm_fused_forward":
        "src/repro_torch/kernels/lsplm_fused/csrc/lsplm_fused.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "mamba1_scan": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
}
REPLACES = {
    "lsplm_sparse_fused_forward":
        "src/repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py:73",
    "lsplm_sparse_fused_int8_forward":
        "src/repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py:151",
    "lsplm_sparse_scatter_compact":
        "src/repro/kernels/lsplm_sparse_scatter/lsplm_sparse_scatter.py:50",
    "owlqn_direction":
        "src/repro/kernels/owlqn_direction/owlqn_direction.py:23",
    "lsplm_fused_forward": "src/repro/kernels/lsplm_fused/lsplm_fused.py:27",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:29",
    "mamba1_scan": "src/repro/kernels/mamba_scan/mamba_scan.py:32",
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
    for name, path in sorted(libs.items()):
        log = path.with_name(path.name + ".log").read_text()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        print(f"  ptxas {name}: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, spill stores in "
              f"{sum(b > 0 for b in spills)} (at most {max(spills, default=0)}"
              f" bytes)")


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
    _check_planned_p(torch, theta, *(torch.from_numpy(a).to(dev)
                                     for a in _batch(rng, 37, 24, d_rows)))
    print(f"phase 2: kernels agree with their plain versions at d={d_rows - 1:,}"
          f", 2m={theta.shape[1]}, N in (1, 37, 4096), K in (8, 24, 64), "
          f"dedup on/off (z rtol {Z_RTOL}/atol {Z_ATOL}, p atol {P_ATOL}); "
          f"max |err| fp32 {err['lsplm_sparse_fused_forward']:.3e}, "
          f"int8 {err['lsplm_sparse_fused_int8_forward']:.3e}; int8 kernel "
          f"vs fp32 kernel on the dequantised Theta: "
          f"{'bitwise equal' if bitwise else 'within 1e-6, not bitwise'}; "
          f"planned score_sparse / predict_proba_sparse bitwise equal to "
          f"unplanned and to B1's p, planned gradient within rtol 1e-5 / "
          f"atol 1e-6 of unplanned and of the CPU's")
    return err, bitwise


def _check_planned_p(torch, theta, ids, vals):
    """A planned ``score_sparse`` / ``predict_proba_sparse`` returns B1's
    own p, bit for bit the unplanned call's, and its gradient (through
    the batch's transpose plan) agrees with the unplanned one and with
    the CPU's plain one within rtol 1e-5 / atol 1e-6 (the reference's
    bars for planned gradients). ``theta`` is the padded Theta."""
    from repro_torch.core.lsplm import params_from_theta, predict_proba_sparse
    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        lsplm_sparse_fused_forward,
    )
    from repro_torch.kernels.lsplm_sparse_scatter.plan import (
        build_transpose_plan,
    )
    from repro_torch.serve.score import score_sparse

    pad = theta.shape[0] - 1
    vals = torch.where(ids == pad, 0.0, vals)  # padded COO: pad values 0
    plan = build_transpose_plan(ids, theta.shape[0], pad_id=pad).to(
        theta.device)
    full = theta[:-1]
    bare = score_sparse(full, ids, vals)
    p_b1 = lsplm_sparse_fused_forward(
        *ops._kernel_inputs(ids, vals, pad, True), theta)[0]
    check(torch.equal(bare, p_b1), "score_sparse is not B1's p")
    check(torch.equal(score_sparse(full, ids, vals, plan=plan), bare),
          "planned score_sparse differs from the unplanned call's bits")
    check(torch.equal(predict_proba_sparse(params_from_theta(full), ids, vals,
                                           plan=plan), bare),
          "planned predict_proba_sparse differs from score_sparse's bits")
    weights = torch.linspace(-1.0, 1.0, ids.shape[0], device=theta.device)
    grads = []
    for th, i, v, pl, w in ((theta, ids, vals, plan, weights),
                            (theta, ids, vals, None, weights),
                            (theta.cpu(), ids.cpu(), vals.cpu(), None,
                             weights.cpu())):
        th = th.clone().requires_grad_(True)
        (w * ops.lsplm_sparse_forward(i, v, th, plan=pl)).sum().backward()
        grads.append(th.grad.cpu())
    for g, tag in ((grads[0], "planned"), (grads[1], "unplanned")):
        check(bool(((g - grads[2]).abs()
                    <= 1e-6 + 1e-5 * grads[2].abs()).all()),
              f"the card's {tag} p-level gradient vs the CPU's")
    check(bool(((grads[0] - grads[1]).abs()
                <= 1e-6 + 1e-5 * grads[1].abs()).all()),
          "the card's planned vs unplanned p-level gradient")


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
def _time_ms(torch, fn, flush, runs=TIMED_RUNS, warm=WARM_RUNS) -> float:
    """Median milliseconds of ``fn`` over ``runs`` launches, each after
    an L2 flush, timed by CUDA events. A spin kernel keeps the card busy
    while the host enqueues the events and ``fn``, so the events time
    the device work and not the host's launch path."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
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


# ------------------------------------------------------------ phase 5
def _scatter_cases(torch, dev, rng):
    """(tag, ids (N, K) int32, vals, num_rows): a small batch with pad
    slots, one of all-unique ids, and one with a hot run of 600 entries
    (cut into three pieces)."""
    d_rows = 1001
    pads = rng.integers(0, d_rows - 1, (300, 8)).astype(np.int32)
    pads[:, ::3] = d_rows - 1
    unique = rng.permutation(d_rows - 1)[:960].astype(np.int32).reshape(
        120, 8)
    hot = rng.integers(0, d_rows - 1, (300, 8)).astype(np.int32)
    hot[:, :2] = 17
    cases = []
    for tag, ids in (("pad ids", pads), ("all-unique ids", unique),
                     ("one hot run", hot)):
        vals = rng.normal(size=ids.shape).astype(np.float32)
        vals[ids == d_rows - 1] = 0.0
        cases.append((tag, torch.from_numpy(ids).to(dev),
                      torch.from_numpy(vals).to(dev), d_rows))
    return cases


def _check_scatter(torch, sops, plan, vals, dz, tag):
    """B2 against its plain version (the class gathers) on the card:
    within B2_REL of the summed |terms|, bitwise repeatable, untouched and
    pad rows exactly 0. Returns the max abs error."""
    got = sops.scatter_add_planned(plan, vals, dz)
    again = sops.scatter_add_planned(plan, vals, dz)
    plain = sops._compact_classes(plan, vals, dz).index_select(
        0, plan.inv_compact)
    scale = sops._compact_classes(plan, vals.abs(), dz.abs()).index_select(
        0, plan.inv_compact)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"B2 not bitwise repeatable ({tag})")
    err = (got - plain).abs()
    check(bool((err <= B2_REL * scale + B2_ABS).all()),
          f"B2 vs plain beyond {B2_REL} x sum|terms| + {B2_ABS} ({tag}): "
          f"max |err| {float(err.max()):.3e}")
    untouched = plan.inv_sorted == plan.num_unique
    check(bool(untouched[-1]) and bool((got[untouched] == 0).all()),
          f"B2 left a non-zero pad or untouched row ({tag})")
    return float(err.max())


def _direction_inputs(rng, d_rows, m2):
    theta = rng.normal(size=(d_rows, m2)).astype(np.float32)
    theta[rng.random((d_rows, m2)) < 0.4] = 0.0
    theta[rng.random((d_rows, m2)) < 0.05] = -0.0
    theta[rng.random(d_rows) < 0.2] = 0.0  # whole zero rows (case c)
    grad = rng.normal(size=(d_rows, m2)).astype(np.float32)
    grad[rng.random((d_rows, m2)) < 0.05] = 0.0
    return theta, grad


def _check_b3(torch, theta, grad, lam, beta, tag) -> float:
    """B3 against its plain version on the same inputs: within rtol
    B3_RTOL/atol B3_ATOL, zero pattern equal. Returns the max abs error."""
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        owlqn_direction,
    )
    from repro_torch.kernels.owlqn_direction.ref import owlqn_direction_ref

    got = owlqn_direction(theta, grad, lam, beta)
    want = owlqn_direction_ref(theta, grad, lam, beta)
    torch.cuda.synchronize()
    tag = f"{tag} lam={lam} beta={beta}"
    check(bool(((got - want).abs() <= B3_ATOL + B3_RTOL * want.abs()).all()),
          f"B3 vs plain beyond rtol {B3_RTOL}/atol {B3_ATOL} at {tag}")
    check(torch.equal(got == 0, want == 0),
          f"B3 zero pattern differs from the plain version at {tag}")
    return float((got - want).abs().max())


def _b1_at_training_shapes(torch, batches, theta):
    """B1 against its plain version at the shapes the training path gives
    it: both id tensors of each batch, after the dedup pre-pass, on the
    padded Theta. Returns (max abs error, the shapes checked)."""
    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        lsplm_sparse_fused_forward,
    )

    tp = ops.pad_theta(theta)
    pad = tp.shape[0] - 1
    err, shapes = 0.0, []
    for tag, batch in batches:
        for side, ids, vals in (("user", batch.user_ids, batch.user_vals),
                                ("ad", batch.ad_ids, batch.ad_vals)):
            ki, kv = ops.dedup_tile_ids(ids, vals, pad)
            p, z = lsplm_sparse_fused_forward(ki, kv, tp)
            z_ref = ops._chunked_zmap(ids, vals, tp)
            p_ref = ops.finalize_p(z_ref)
            torch.cuda.synchronize()
            where = f"{tag} {side} ids {tuple(ids.shape)}"
            check(_z_ok(z, z_ref), f"B1 z vs plain at the {where}")
            check(float((p - p_ref).abs().max()) <= P_ATOL,
                  f"B1 p vs plain at the {where}")
            err = max(err, float((z - z_ref).abs().max()),
                      float((p - p_ref).abs().max()))
            shapes.append(f"{tag} {side} {tuple(ids.shape)}")
    return err, shapes


def phase_training_kernels(torch, dev, train, test, theta0):
    from repro_torch.kernels.lsplm_sparse_scatter import ops as sops
    from repro_torch.kernels.lsplm_sparse_scatter.plan import (
        build_transpose_plan,
    )

    e, shapes = _b1_at_training_shapes(
        torch, (("training", train), ("test", test)), theta0)
    print(f"phase 5: B1 vs plain at the training path's shapes "
          f"({', '.join(shapes)}; u**10 Zipf ids, dedup on, the driver's "
          f"dense Theta0): z rtol {Z_RTOL}/atol {Z_ATOL}, p atol {P_ATOL}; "
          f"max |err| {e:.3e}")
    rng = np.random.default_rng(SEED + 7)
    err = {"lsplm_sparse_fused_forward": e,
           "lsplm_sparse_scatter_compact": 0.0, "owlqn_direction": 0.0}
    lines = []
    for side, vals, plan in (("user", train.user_vals, train.user_plan),
                             ("ad", train.ad_vals, train.ad_plan)):
        dz = torch.from_numpy(rng.normal(size=(vals.shape[0], 2 * REGIONS))
                              .astype(np.float32)).to(dev)
        e = _check_scatter(torch, sops, plan, vals, dz, f"{side} side")
        err["lsplm_sparse_scatter_compact"] = max(
            err["lsplm_sparse_scatter_compact"], e)
        lines.append(f"{side} side E'={plan.num_kept:,} U={plan.num_unique:,}"
                     f" pieces={plan.piece_run.numel():,} max|err| {e:.2e}")
    for tag, ids, vals, d_rows in _scatter_cases(torch, dev, rng):
        plan = build_transpose_plan(ids, d_rows, pad_id=d_rows - 1).to(dev)
        dz = torch.from_numpy(rng.normal(size=(ids.shape[0], 2 * REGIONS))
                              .astype(np.float32)).to(dev)
        e = _check_scatter(torch, sops, plan, vals, dz, tag)
        unplanned = sops.scatter_add_unplanned(ids, vals, dz, d_rows,
                                               d_rows - 1)
        check(torch.equal(unplanned, sops.scatter_add_planned(plan, vals, dz)),
              f"B2 on the card-sorted entries differs from the plan's ({tag})")
        err["lsplm_sparse_scatter_compact"] = max(
            err["lsplm_sparse_scatter_compact"], e)
        lines.append(f"{tag} max|err| {e:.2e}")
    print("phase 5: B2 (run-length dTheta scatter) vs the plain class "
          f"gathers on the card, |err| <= {B2_REL} x sum|terms| + {B2_ABS}, "
          "bitwise repeatable, pad and untouched rows exactly 0, the "
          "card-sorted (unplanned) layout bitwise equal: " + "; ".join(lines))

    lines = []
    # the sparse and the dense training paths' shapes and weights
    pairs = ((0.5, 0.3), (0.0, 0.3), (0.2, 0.0), (LAM, BETA),
             (DENSE_LAM, DENSE_BETA))
    for d_rows, m2 in ((1000, 2 * REGIONS), (1000, 70),
                       (D_FEATURES, 2 * REGIONS), (DENSE_D, 2 * REGIONS)):
        theta_np, grad_np = _direction_inputs(rng, d_rows, m2)
        theta = torch.from_numpy(theta_np).to(dev)
        grad = torch.from_numpy(grad_np).to(dev)
        for lam, beta in pairs:
            err["owlqn_direction"] = max(
                err["owlqn_direction"],
                _check_b3(torch, theta, grad, lam, beta,
                          f"D={d_rows:,} 2m={m2}"))
        lines.append(f"D={d_rows:,} 2m={m2}")
    print(f"phase 5: B3 (Eq. 9 direction) vs plain on the card at "
          f"{', '.join(lines)}, {len(pairs)} (lam, beta) pairs, with exact "
          f"zeros, -0.0 and zero rows: within rtol {B3_RTOL}/atol {B3_ATOL}, "
          f"zero pattern equal; max |err| {err['owlqn_direction']:.2e}")
    return err


# ------------------------------------------------------------ phase 6
def _reset(counters):
    for launches in counters:
        for name in launches:
            launches[name] = 0


def phase_training(torch, dev, problem, test, setup_s, tmp: Path):
    from repro_torch.io import checkpoint
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES as B1,
    )
    from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
        LAUNCHES as B2,
    )
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        LAUNCHES as B3,
    )
    from repro_torch.launch import serve, train as train_driver

    ckpt = str(tmp / "trained.npz")
    argv = ["--sparse", "--sparse-features", str(D_FEATURES), "--regions",
            str(REGIONS), "--sessions", str(SESSIONS), "--lam", str(LAM),
            "--beta", str(BETA), "--iters", str(TRAIN_ITERS), "--seed",
            str(SEED), "--ckpt", ckpt, "--device", str(dev)]
    _reset((B1, B2, B3))
    t0 = time.perf_counter()
    rep = train_driver.run(argv, prebuilt=(problem, test))
    wall = time.perf_counter() - t0
    launches = {"lsplm_sparse_fused_forward": B1["lsplm_sparse_fused_forward"],
                **B2, **B3}
    for name, count in launches.items():
        check(count > 0, f"the training path never launched {name}")
    its = rep["iters"]
    check(len(its) == TRAIN_ITERS, "the training driver stopped early")
    check(all(np.isfinite([r["f_new"] for r in its])), "f is not finite")
    check(its[-1]["f_new"] < its[0]["f"],
          f"f did not fall: {its[0]['f']:.2f} -> {its[-1]['f_new']:.2f}")
    check(its[-1]["nnz"] < its[0]["nnz"],
          f"nnz did not fall: {its[0]['nnz']:,} -> {its[-1]['nnz']:,}")
    check(rep["test_auc"] > 0.5, f"test AUC {rep['test_auc']:.4f} <= 0.5")
    ls = sum(r["ls_iters"] for r in its)
    print(f"phase 6: training main path (OWLQN+, d={D_FEATURES:,}, "
          f"m={REGIONS}, {SESSIONS:,} sessions, lam=beta={LAM}, "
          f"{TRAIN_ITERS} iterations) in {wall:.2f} s wall "
          f"(set-up {setup_s:.2f} s before it, iterations "
          f"{rep['train_s']:.3f} s"
          f" = {rep['s_per_iter'] * 1e3:.1f} ms/iter, median "
          f"{np.median([r['wall_s'] for r in its]) * 1e3:.1f} ms, {ls} "
          f"line-search "
          f"trials); f {its[0]['f']:.2f} -> {its[-1]['f_new']:.2f}, nnz "
          f"{its[0]['nnz']:,} -> {its[-1]['nnz']:,}, test AUC "
          f"{rep['test_auc']:.4f}; launches {launches} (expected: B1 2 per "
          f"loss evaluation = {2 * (TRAIN_ITERS + ls)}, plus 2 per test-AUC "
          f"evaluation = {2 * sum('test_auc' in r for r in its)}; B2 2 per "
          f"gradient = {2 * TRAIN_ITERS}; B3 1 per step = {TRAIN_ITERS})")
    print("  per iteration (ms): " + ", ".join(
        f"{r['wall_s'] * 1e3:.1f}" for r in its))

    train, _, opt = problem
    theta = checkpoint.load(ckpt, {"theta": torch.zeros(
        (D_FEATURES, 2 * REGIONS), device=dev)})["theta"]
    b1_err, _ = _b1_at_training_shapes(
        torch, (("training", train), ("test", test)), theta)
    print(f"phase 6: B1 vs plain on the trained Theta "
          f"({int((theta != 0).sum()):,} non-zeros) at the same four shapes: "
          f"max |err| {b1_err:.3e}")
    _profile_step(torch, opt, theta)

    _reset((B1,))
    t0 = time.perf_counter()
    srep = serve.run(["--ckpt", ckpt, "--requests", "128", "--seed",
                      str(SEED), "--device", str(dev)])
    serve_launches = B1["lsplm_sparse_fused_forward"]
    check(serve_launches > 0, "serving the trained Theta never launched B1")
    eng = srep["engine"]
    print(f"phase 6: served the trained checkpoint in "
          f"{time.perf_counter() - t0:.1f} s: {srep['rows_alive']:,} rows "
          f"alive of {D_FEATURES:,}, {eng['requests']} requests, "
          f"{eng['candidates_per_sec']:,.0f} candidates/s, driver asserts "
          f"held (pruned == full, single == batched bitwise); B1 launches "
          f"{serve_launches}")
    return launches, b1_err


SPARSE_STEP_KERNELS = ("fused_forward_kernel", "piece_sums_kernel",
                       "run_sums_kernel", "owlqn_direction_kernel")


def _device_profile(torch, fn):
    """Run ``fn`` once under torch.profiler, synchronised. Returns (its
    result, host wall in us, {device kernel name: [us, launches]})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    return out, wall_us, kernels


def _profile_step(torch, opt, theta, labels=SPARSE_STEP_KERNELS) -> None:
    """Where one OWLQN+ step's time goes (torch.profiler): host wall
    against the device's kernel time, the hand-written kernels (device
    events whose names hold one of ``labels``) and the top kernels."""
    state, _ = opt.step(opt.init(theta))  # a history pair for the next
    (state, stats), wall_us, kernels = _device_profile(
        torch, lambda: opt.step(state))
    busy_us = sum(v[0] for v in kernels.values())
    if not kernels:
        print(f"  profile of one OWLQN+ step: {wall_us / 1e3:.2f} ms wall; "
              "device time not measured (no device events)")
        return
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    ours: dict[str, list] = {}
    for label in labels:
        for name, (us, n) in kernels.items():
            if label in name:
                k = ours.setdefault(label, [0.0, 0])
                k[0] += us
                k[1] += n
    ours_us = sum(v[0] for v in ours.values())
    print(f"  profile of one OWLQN+ step ({stats.ls_iters} line-search "
          f"trials, under torch.profiler): {wall_us / 1e3:.2f} ms wall, "
          f"{busy_us / 1e3:.2f} ms of device kernels in "
          f"{sum(v[1] for v in kernels.values())} launches (device idle "
          f"{1 - busy_us / wall_us:.1%}); the hand-written kernels "
          f"{ours_us / 1e3:.3f} ms ({ours_us / busy_us:.1%} of device time: "
          + ", ".join(f"{label} x{n} {us / 1e3:.3f} ms"
                      for label, (us, n) in ours.items())
          + "); top: "
          + "; ".join(f"{name[:70]} x{n} {us / 1e3:.3f} ms"
                      for name, (us, n) in top))


# ------------------------------------------------------------ phase 7
def _trajectory(torch, opt, theta0, steps):
    state = opt.init(theta0)
    fs, zeros, wall = [], [], 0.0
    for _ in range(steps):
        t0 = time.perf_counter()
        state, stats = opt.step(state)  # ends in host syncs
        wall += time.perf_counter() - t0
        fs.append(stats.f_new)
        zeros.append((state.theta == 0).cpu().numpy())
    return state.theta.cpu().numpy(), fs, zeros, wall


def _beyond_bar(theta, ref):
    ref = ref.astype(np.float64)
    return ~(np.abs(theta - ref) <= TRAJ_ATOL + TRAJ_RTOL * np.abs(ref))


def _witness(card, cpu, exact) -> str:
    """Which side the float64 trajectory follows where the card's and the
    CPU's float32 trajectories part: in each step's zero pattern, in f,
    and in the elements beyond the Theta bar."""
    (t_card, f_card, z_card, _), (t_cpu, f_cpu, z_cpu, _) = card, cpu
    t_64, f_64, z_64, _ = exact
    with_card = with_cpu = apart = 0
    for a, b, c in zip(z_card, z_cpu, z_64):
        flip = a != b
        with_card += int((flip & (c == a)).sum())
        with_cpu += int((flip & (c == b)).sum())
        apart += int((~flip & (c != a)).sum())
    parts = []
    for tag, t, f in (("card", t_card, f_card), ("CPU", t_cpu, f_cpu)):
        out = _beyond_bar(t, t_64)
        diff = np.abs(t.astype(np.float64) - t_64)
        f_rel = float(np.max(np.abs(np.subtract(f, f_64)) / np.abs(f_64)))
        parts.append(f"{tag} f rel {f_rel:.2e}, Theta beyond the bar in "
                     f"{int(out.sum())} elements (max |diff| "
                     f"{float(diff.max()):.2e})")
    return (f"float64 CPU witness: of the (element, step) pairs where the "
            f"card's and the CPU's zero patterns part, it follows the card "
            f"in {with_card} and the CPU in {with_cpu}; it parts from both "
            f"where they agree in {apart}; against it: " + "; ".join(parts))


def phase_trajectory(torch, dev, problem):
    """The port's OWLQN+ on the card (kernels) against the CPU (plain
    versions) on one batch and Theta0.

    fp32 sums reassociate between the two, so an element that lands
    within an ulp of zero can be zeroed by the orthant projection on one
    side only (a flip); a flip changes its row's Eq. 9 case, and the
    row's later values with it. At d = 50,000 no flip and no element
    beyond the Theta bar is allowed. At paper width at most
    PATTERN_SHARE of the elements may flip at some step, and as many may
    lie beyond the Theta bar, flipped rows included. There a float64
    trajectory on the CPU shows which side the flips follow."""
    from repro_torch.launch.train import sparse_problem

    kw = dict(lam=LAM, beta=BETA, seed=SEED, batch_seed=SEED + 1)
    for d, sessions, steps, seen_only, share in (
            (50_000, 256, 6, True, 0.0),
            (D_FEATURES, SESSIONS, 3, False, PATTERN_SHARE)):
        _, theta0, card_opt = (
            problem if d == D_FEATURES
            else sparse_problem(d, REGIONS, sessions, **kw, device=dev))
        cpu_batch, _, cpu_opt = sparse_problem(d, REGIONS, sessions, **kw,
                                               device="cpu")
        theta0 = theta0.cpu()
        if seen_only:  # rows no id touches start at exact zero
            seen = torch.zeros(d, dtype=torch.bool)
            for ids in (cpu_batch.user_ids, cpu_batch.ad_ids):
                seen[ids[ids < d].long()] = True
            theta0 = theta0 * seen[:, None]
        card = _trajectory(torch, card_opt, theta0.to(dev), steps)
        cpu = _trajectory(torch, cpu_opt, theta0, steps)
        (t_card, f_card, z_card, w_card), (t_cpu, f_cpu, z_cpu, w_cpu) = (
            card, cpu)
        allowed = int(share * t_cpu.size)
        tag = f"d={d:,}, {sessions} sessions, {steps} steps"
        f_err = float(np.max(np.abs(np.subtract(f_card, f_cpu))
                             / np.abs(f_cpu)))
        check(f_err <= TRAJ_F_RTOL, f"f card vs CPU rtol {f_err:.2e} at {tag}")
        flipped = np.zeros(t_cpu.shape, bool)
        for a, b in zip(z_card, z_cpu):
            flipped |= a != b
        flips = int(flipped.sum())
        rows = flipped.any(axis=1)
        check(flips <= allowed,
              f"zero pattern card vs CPU differs in {flips} elements at {tag}"
              f" (allowed {allowed})")
        beyond = _beyond_bar(t_card, t_cpu)
        check(int(beyond.sum()) <= allowed,
              f"Theta card vs CPU beyond rtol {TRAJ_RTOL}/atol {TRAJ_ATOL} "
              f"in {int(beyond.sum())} elements at {tag} (allowed {allowed})")
        diff = np.abs(t_card - t_cpu)
        print(f"phase 7: OWLQN+ card vs CPU at {tag}, m={REGIONS}: f max "
              f"rel diff {f_err:.2e} (bar {TRAJ_F_RTOL}); zero pattern "
              f"flipped at some step in {flips} of {t_cpu.size:,} elements, "
              f"{int((z_card[-1] != z_cpu[-1]).sum())} differ at the end, in "
              f"{int(rows.sum())} rows; Theta beyond rtol {TRAJ_RTOL}/atol "
              f"{TRAJ_ATOL} in {int(beyond.sum())} elements "
              f"({int((beyond & rows[:, None]).sum())} in flipped rows; "
              f"allowed {allowed} flips and {allowed} elements beyond), max "
              f"|diff| {float(diff.max()):.2e} (outside flipped rows "
              f"{float(diff[~rows].max(initial=0.0)):.2e}); nnz "
              f"{int((t_card != 0).sum()):,}; step wall card {w_card:.2f} s, "
              f"CPU {w_cpu:.2f} s")
        if share:
            _, theta0_64, opt_64 = sparse_problem(
                d, REGIONS, sessions, **kw, device="cpu", dtype=torch.float64)
            check(torch.equal(theta0_64.float(), theta0),
                  "the float64 witness starts from another Theta0")
            exact = _trajectory(torch, opt_64, theta0_64, steps)
            print(f"  {_witness(card, cpu, exact)}; its steps took "
                  f"{exact[3]:.2f} s")


# ------------------------------------------------------------ timings
def phase_training_times(torch, dev, train, theta0):
    """B1 and B2 at both sides of the launch-default batch and B3 at
    D = 1,000,000, each beside its plain version, its bound and the
    library call computing the same function (B1 ``embedding_bag``, B2
    ``index_add_``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        lsplm_sparse_fused_forward,
    )
    from repro_torch.kernels.lsplm_sparse_scatter import ops as sops
    from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
        lsplm_sparse_scatter_compact,
    )
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        owlqn_direction,
    )
    from repro_torch.kernels.owlqn_direction.ref import owlqn_direction_ref

    rng = np.random.default_rng(SEED + 8)
    m2 = 2 * REGIONS
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    out = {}
    tp = ops.pad_theta(theta0)
    pad = tp.shape[0] - 1
    for side, ids, vals in (("ad", train.ad_ids, train.ad_vals),
                            ("user", train.user_ids, train.user_vals)):
        ki, kv = ops.dedup_tile_ids(ids, vals, pad)  # as the main path does
        bound_ms, bound_by = _bound(torch, ki, pad, m2 * 4, m2, 2)
        row = {"side": side, "n": ids.shape[0], "k": ids.shape[1],
               "ms": _time_ms(
                   torch, lambda: lsplm_sparse_fused_forward(ki, kv, tp),
                   flush),
               "plain_ms": _time_ms(torch, lambda: ops.finalize_p(
                   ops._chunked_zmap(ki, kv, tp)), flush),
               "library_ms": _time_ms(torch, lambda: F.embedding_bag(
                   ki, tp, per_sample_weights=kv, mode="sum",
                   padding_idx=pad), flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        out.setdefault("lsplm_sparse_fused_forward", []).append(row)
        print(f"phase 8: lsplm_sparse_fused_forward training {side} side "
              f"(N={row['n']:,} K={row['k']}, after dedup, Theta0): kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, "
              f"{bound_ms / row['ms']:.1%} of it reached), library "
              f"{row['library_ms']:.4f} ms (embedding_bag)")
    for side, vals, plan in (("ad", train.ad_vals, train.ad_plan),
                             ("user", train.user_vals, train.user_plan)):
        n, e, u = vals.shape[0], plan.num_kept, plan.num_unique
        dz = torch.from_numpy(rng.normal(size=(n, m2)).astype(np.float32)
                              ).to(dev)
        vals_sorted = vals.reshape(-1).index_select(0, plan.order)
        counts = torch.unique_consecutive(plan.row_ids, return_counts=True)[1]
        run_of_entry = torch.repeat_interleave(
            torch.arange(u, device=dev), counts)

        def kernel():
            return lsplm_sparse_scatter_compact(
                plan.piece_start, plan.piece_run, plan.run_piece_start,
                plan.sample_sorted, vals_sorted, dz)

        def library():
            return torch.zeros((u + 1, m2), device=dev).index_add_(
                0, run_of_entry,
                vals_sorted[:, None] * dz.index_select(0, plan.sample_sorted))

        lib_err = float((library() - kernel()).abs().max())
        nbytes = e * 12 + n * m2 * 4 + (u + 1) * m2 * 4
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = e * m2 * 2 / FP32_OPS_PER_S
        row = {"side": side, "entries": e, "unique": u, "n": n,
               "ms": _time_ms(torch, kernel, flush),
               "plain_ms": _time_ms(
                   torch, lambda: sops._compact_classes(plan, vals, dz),
                   flush),
               "library_ms": _time_ms(torch, library, flush),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out.setdefault("lsplm_sparse_scatter_compact", []).append(row)
        print(f"phase 8: lsplm_sparse_scatter_compact {side} side (E'={e:,},"
              f" U={u:,}, N={n:,}): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of it "
              f"reached), library {row['library_ms']:.4f} ms (index_add_, "
              f"max |diff| vs kernel {lib_err:.1e})")

    theta_np, grad_np = _direction_inputs(rng, D_FEATURES, m2)
    theta = torch.from_numpy(theta_np).to(dev)
    grad = torch.from_numpy(grad_np).to(dev)
    nbytes = 3 * D_FEATURES * m2 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 16 * D_FEATURES * m2 / FP32_OPS_PER_S  # ~16 flops per element
    row = {"d": D_FEATURES, "m2": m2,
           "ms": _time_ms(torch, lambda: owlqn_direction(theta, grad, LAM,
                                                         BETA), flush),
           "plain_ms": _time_ms(torch, lambda: owlqn_direction_ref(
               theta, grad, LAM, BETA), flush),
           "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    out["owlqn_direction"] = [row]
    print(f"phase 8: owlqn_direction D={D_FEATURES:,} 2m={m2}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
          f"{row['bound_ms'] / row['ms']:.1%} of it reached), library n/a "
          f"(no single PyTorch call)")
    return out


# ------------------------------------------------------------ phase 9
def _b5_inputs(torch, dev, rng, b, d, m, dtype):
    """x = 0.3 N(0, 1) (b, d) and one Theta = 0.1 N(0, 1) (d, 2m) whose
    halves are U and W, in ``dtype`` on the card."""
    x = torch.from_numpy((0.3 * rng.normal(size=(b, d))).astype(np.float32))
    theta = torch.from_numpy(
        (0.1 * rng.normal(size=(d, 2 * m))).astype(np.float32))
    return x.to(dev, dtype), theta.to(dev, dtype)


def _check_b5(torch, x, theta, tol, tag):
    """B5 against its plain version on the card at rtol = atol = ``tol``,
    bitwise repeatable, a row's bits independent of its batch (17 rows
    alone), and the same bits from U, W as separate tensors as from the
    halves of one Theta. Returns the max abs error (in float32)."""
    from repro_torch.kernels.lsplm_fused.lsplm_fused import (
        lsplm_fused_forward,
    )
    from repro_torch.kernels.lsplm_fused.ref import lsplm_forward_ref

    m = theta.shape[1] // 2
    u, w = theta[:, :m], theta[:, m:]
    got = lsplm_fused_forward(x, u, w)
    again = lsplm_fused_forward(x, u, w)
    rows = torch.linspace(0, x.shape[0] - 1, min(17, x.shape[0]),
                          device=x.device).long().unique()
    alone = lsplm_fused_forward(x.index_select(0, rows), u, w)
    apart = lsplm_fused_forward(x, u.contiguous(), w.contiguous())
    want = lsplm_forward_ref(x, u, w)
    torch.cuda.synchronize()
    check(got.dtype == x.dtype and got.shape == (x.shape[0],),
          f"B5 output dtype/shape at {tag}")
    err = (got.float() - want.float()).abs()
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"B5 vs plain beyond rtol = atol = {tol} at {tag}: max |err| "
          f"{float(err.max()):.3e}")
    check(torch.equal(got, again), f"B5 not bitwise repeatable at {tag}")
    check(torch.equal(alone, got.index_select(0, rows)),
          f"B5 rows scored alone differ from the batch's at {tag}")
    check(torch.equal(apart, got),
          f"B5 on separate U, W differs from Theta's halves at {tag}")
    return float(err.max())


def phase_dense_kernel(torch, dev, x_test):
    """B5 (dense fused forward) against its plain version on the card:
    the reference test's shapes and the chip run's (the 3,276 dense test
    rows of the dense main path, and their first 512), fp32 and bf16."""
    rng = np.random.default_rng(SEED + 9)
    f32, bf16 = torch.float32, torch.bfloat16
    err, lines = 0.0, []
    for b, d, m, dtypes in ((64, 128, 12, (f32, bf16)), (128, 256, 4,
                            (f32, bf16)), (32, 512, 1, (f32, bf16)),
                            (50, 100, 5, (f32,)), (1, 7, 5, (f32,)),
                            (33, 130, 5, (f32,)), (257, 513, 5, (f32,)),
                            (70, 300, 64, (f32,)), (40, 200, 128, (f32,))):
        for dtype in dtypes:
            x, theta = _b5_inputs(torch, dev, rng, b, d, m, dtype)
            tol = B5_TOL if dtype == f32 else B5_BF16_TOL
            e = _check_b5(torch, x, theta, tol, f"B={b} d={d} m={m} {dtype}")
            if dtype == f32:
                err = max(err, e)
        lines.append(f"({b}, {d}, m={m})")
    d = x_test.shape[1]
    theta = torch.from_numpy((0.1 * rng.normal(size=(d, 2 * REGIONS)))
                             .astype(np.float32)).to(dev)
    for rows in (x_test.shape[0], 512, 33, 1):
        e = _check_b5(torch, x_test[:rows], theta, B5_TOL,
                      f"the dense test rows {rows} x {d:,}")
        err = max(err, e)
        lines.append(f"test rows {rows} x {d:,} (max |err| {e:.2e})")
    e16 = 0.0
    for rows in (x_test.shape[0], 33, 1):
        e16 = max(e16, _check_b5(torch, x_test[:rows].to(bf16),
                                 theta.to(bf16), B5_BF16_TOL,
                                 f"the dense test rows {rows} x {d:,} bf16"))
    print(f"phase 9: B5 (dense fused forward) vs plain on the card at "
          f"{', '.join(lines)}; fp32 within rtol = atol = {B5_TOL}, bf16 "
          f"within {B5_BF16_TOL} (the reference shapes and the "
          f"{x_test.shape[0]}, 33 and 1 test rows, max |err| {e16:.2e}); "
          f"every "
          f"case bitwise repeatable, rows scored alone equal to the same "
          f"rows in their batch, separate U, W equal to Theta's halves; max"
          f" |err| fp32 {err:.3e}")
    return err


# ------------------------------------------------------------ phase 10
def _float64_on_cpu(batch):
    """The same batch on the CPU, its floating fields in float64."""
    return batch._replace(**{
        f: None if t is None else t.cpu().double()
        if t.is_floating_point() else t.cpu()
        for f, t in batch._asdict().items()})


def _dense_step_inputs(torch, batch, batch64, theta, tag):
    """The Eq. 13 loss and gradient of the dense batch at ``theta`` on
    the card against a float64 evaluation of the same batch on the CPU
    (``batch64``; loss rtol LOSS_RTOL, gradient atol GRAD_ATOL after
    dividing by max(1, max |g|)), then B3 on that Theta and gradient at
    the driver's weights against its plain version. Returns (loss rel
    err, scaled gradient err, B3 max abs err)."""
    from repro_torch.core.objective import smooth_loss_and_grad

    loss, grad = smooth_loss_and_grad(theta, batch, common_feature=True)
    loss64, grad64 = smooth_loss_and_grad(theta.cpu().double(), batch64,
                                          common_feature=True)
    loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    scale = max(1.0, float(grad64.abs().max()))
    grad_err = float((grad.cpu().double() - grad64).abs().max()) / scale
    check(loss_err <= LOSS_RTOL, f"dense loss on the card {loss_err:.2e} "
          f"from float64 at {tag}")
    check(grad_err <= GRAD_ATOL, f"dense gradient on the card {grad_err:.2e}"
          f" (over max |g|) from float64 at {tag}")
    b3 = _check_b3(torch, theta, grad, DENSE_LAM, DENSE_BETA,
                   f"the dense driver's {tag} and its gradient")
    return loss_err, grad_err, b3


def phase_dense_training(torch, dev, problem, test, setup_s, tmp: Path):
    """The dense main path: the training driver's default mode at
    d = 32,768, then its checkpoint served through ``serve.predict`` as
    a full Theta, a pruned artifact and an int8 one. Around the run, the
    loss and gradient at Theta0 and at the trained Theta against float64
    on the CPU, and B3 on each Theta and its gradient against plain."""
    from repro_torch import serve
    from repro_torch.io import checkpoint
    from repro_torch.kernels.lsplm_fused.lsplm_fused import LAUNCHES as B5
    from repro_torch.kernels.lsplm_fused.ref import lsplm_forward_ref
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES as B1,
    )
    from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
        LAUNCHES as B2,
    )
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        LAUNCHES as B3,
    )
    from repro_torch.launch import train as train_driver

    batch, theta0, opt = problem
    t0 = time.perf_counter()
    batch64 = _float64_on_cpu(batch)
    checks = [_dense_step_inputs(torch, batch, batch64, theta0, "Theta0")]
    check_s = time.perf_counter() - t0
    ckpt = str(tmp / "dense.npz")
    argv = ["--sessions", str(DENSE_SESSIONS), "--user-features",
            str(DENSE_USER), "--ad-features", str(DENSE_AD),
            "--noise-features", str(DENSE_NOISE), "--regions", str(REGIONS),
            "--lam", str(DENSE_LAM), "--beta", str(DENSE_BETA), "--iters",
            str(DENSE_ITERS), "--seed", str(SEED), "--ckpt", ckpt,
            "--device", str(dev)]
    _reset((B1, B2, B3, B5))
    t0 = time.perf_counter()
    rep = train_driver.run(argv, prebuilt=(problem, test))
    wall = time.perf_counter() - t0
    launches = {**B5, **B3}
    its = rep["iters"]
    evals = sum("test_auc" in r for r in its)
    check(len(its) == DENSE_ITERS, "the dense training driver stopped early")
    check(B5["lsplm_fused_forward"] == evals,
          f"B5 launched {B5['lsplm_fused_forward']} times for {evals} "
          f"test-AUC evaluations")
    check(B3["owlqn_direction"] == DENSE_ITERS,
          f"B3 launched {B3['owlqn_direction']} times in {DENSE_ITERS} steps")
    check(sum(B1.values()) + sum(B2.values()) == 0,
          "the dense path launched a sparse kernel")
    check(all(np.isfinite([r["f_new"] for r in its])), "f is not finite")
    check(its[-1]["f_new"] < its[0]["f"],
          f"f did not fall: {its[0]['f']:.2f} -> {its[-1]['f_new']:.2f}")
    check(its[-1]["nnz"] < its[0]["nnz"],
          f"nnz did not fall: {its[0]['nnz']:,} -> {its[-1]['nnz']:,}")
    check(rep["test_auc"] > 0.5, f"test AUC {rep['test_auc']:.4f} <= 0.5")
    steady = [r["wall_s"] * 1e3 for r in its[1:]]
    ls = sum(r["ls_iters"] for r in its)
    print(f"phase 10: dense main path (repro_torch.launch.train, OWLQN+ on "
          f"the Eq. 13 objective, d={rep['num_features']:,} = "
          f"{DENSE_USER:,} common + {DENSE_AD + DENSE_NOISE:,} per sample, "
          f"m={REGIONS}, {rep['samples']:,} samples in {rep['sessions']:,} "
          f"sessions, lam=beta={DENSE_LAM}, {DENSE_ITERS} iterations) in "
          f"{wall:.2f} s wall (set-up {setup_s:.2f} s before it, iterations "
          f"{rep['train_s']:.3f} s; iteration 0 {its[0]['wall_s'] * 1e3:.1f}"
          f" ms, iterations 1-{DENSE_ITERS - 1} median "
          f"{np.median(steady):.2f} ms, mean {np.mean(steady):.2f} ms; {ls} "
          f"line-search trials); f {its[0]['f']:.2f} -> "
          f"{its[-1]['f_new']:.2f}, nnz {its[0]['nnz']:,} -> "
          f"{its[-1]['nnz']:,}, test AUC " + ", ".join(
              f"{r['test_auc']:.4f}" for r in its if "test_auc" in r)
          + f" ({rep['test_rows']:,} rows); launches {launches} (expected: "
          f"B5 1 per test-AUC evaluation = {evals}, B3 1 per step = "
          f"{DENSE_ITERS}; B1 and B2 none)")
    print("  per iteration (ms): " + ", ".join(
        f"{r['wall_s'] * 1e3:.2f}" for r in its))

    theta = checkpoint.load(ckpt, {"theta": torch.zeros(
        (rep["num_features"], 2 * REGIONS), device=dev)})["theta"]
    t0 = time.perf_counter()
    checks.append(_dense_step_inputs(torch, batch, batch64, theta,
                                     "trained Theta"))
    del batch64
    check_s += time.perf_counter() - t0
    loss_err, grad_err, b3_err = (max(c) for c in zip(*checks))
    print(f"phase 10: the Eq. 13 loss and gradient on the card at Theta0 "
          f"and at the trained Theta against float64 on the CPU: loss max "
          f"rel diff {loss_err:.2e} (bar {LOSS_RTOL}), gradient max |diff| "
          f"/ max(1, max |g|) {grad_err:.2e} (bar {GRAD_ATOL}); B3 on each "
          f"Theta and its gradient, lam=beta={DENSE_LAM}, vs plain: max |err|"
          f" {b3_err:.2e}, zero pattern equal; {check_s:.1f} s for both")
    _profile_step(torch, opt, theta, labels=("owlqn_direction_kernel",))

    art = serve.compress(theta)
    quant = serve.quantize(art)
    _reset((B5,))
    t0 = time.perf_counter()
    p_full = serve.predict(theta, test.x)
    p_pruned = serve.predict(art, test.x)
    p_int8 = serve.predict(quant, test.x)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve_launches = B5["lsplm_fused_forward"]
    check(serve_launches == 3, f"serving the dense rows launched B5 "
          f"{serve_launches} times, not once per model form")
    for tag, p in (("full", p_full), ("pruned", p_pruned), ("int8", p_int8)):
        check(p.shape == (test.x.shape[0],) and bool(torch.isfinite(p).all())
              and bool(((p >= 0) & (p <= 1)).all()),
              f"dense scores of the {tag} model are not probabilities")
    d_pruned = float((p_pruned - p_full).abs().max())
    d_int8 = float((p_int8 - p_full).abs().max())
    check(d_pruned <= P_ATOL, f"pruned dense scores {d_pruned:.2e} from full")
    check(d_int8 <= 1e-2, f"int8 dense scores {d_int8:.2e} from fp32")
    from repro_torch.eval.metrics import auc

    served_auc = float(auc(test.y.cpu().numpy(), p_full.cpu().numpy()))
    check(served_auc == rep["test_auc"],
          f"served AUC {served_auc} differs from the driver's "
          f"{rep['test_auc']}")
    rows = slice(0, 64)
    theta_cpu = theta.cpu()
    p_cpu = lsplm_forward_ref(test.x[rows].cpu(), theta_cpu[:, :REGIONS],
                              theta_cpu[:, REGIONS:])
    d_cpu = float((p_full[rows].cpu() - p_cpu).abs().max())
    check(d_cpu <= P_ATOL, f"dense scores on the card {d_cpu:.2e} from the "
          "plain version on the CPU")
    print(f"phase 10: served the trained checkpoint's {test.x.shape[0]:,} "
          f"test rows through serve.predict as full Theta, pruned artifact "
          f"({art.num_alive:,} rows alive of {rep['num_features']:,}) and "
          f"int8 artifact in {serve_ms:.1f} ms: pruned max |dp| "
          f"{d_pruned:.2e} (bar {P_ATOL}), int8 {d_int8:.2e} (bar 1e-2), "
          f"served AUC {served_auc:.4f} equal to the driver's, 64 rows "
          f"within {d_cpu:.1e} of the plain version on the CPU; B5 launches "
          f"{serve_launches}")
    return {"dense_train": launches, "dense_serve": serve_launches,
            "b3_err": b3_err}


# ------------------------------------------------------------ phase 11
def phase_dense_trajectory(torch, dev):
    """The dense OWLQN+ on the card against the CPU at the launch
    defaults (d = 128, 4,000 sessions, lam = beta = 1.0): f, Theta and
    the zero pattern of every step."""
    from repro_torch.data.synthetic_ctr import CTRDataConfig
    from repro_torch.launch.train import dense_problem

    cfg = CTRDataConfig(num_user_features=64, num_ad_features=48,
                        noise_features=16, seed=SEED)  # launch defaults
    runs = []
    for device in (dev, "cpu"):
        _, theta0, opt = dense_problem(cfg, REGIONS, SESSIONS, lam=1.0,
                                       beta=1.0, seed=SEED, device=device)
        runs.append(_trajectory(torch, opt, theta0, DENSE_STEPS))
    (t_card, f_card, z_card, w_card), (t_cpu, f_cpu, z_cpu, w_cpu) = runs
    tag = f"d={cfg.num_features}, {SESSIONS} sessions, {DENSE_STEPS} steps"
    f_err = float(np.max(np.abs(np.subtract(f_card, f_cpu))
                         / np.abs(f_cpu)))
    check(f_err <= TRAJ_F_RTOL, f"dense f card vs CPU rtol {f_err:.2e} at "
          f"{tag}")
    flips = sum(int((a != b).sum()) for a, b in zip(z_card, z_cpu))
    check(flips == 0, f"dense zero pattern card vs CPU differs in {flips} "
          f"(element, step) pairs at {tag}")
    beyond = _beyond_bar(t_card, t_cpu)
    check(not beyond.any(), f"dense Theta card vs CPU beyond rtol "
          f"{TRAJ_RTOL}/atol {TRAJ_ATOL} in {int(beyond.sum())} elements at "
          f"{tag}")
    print(f"phase 11: dense OWLQN+ card vs CPU at {tag}, m={REGIONS}, "
          f"lam=beta=1.0: f max rel diff {f_err:.2e} (bar {TRAJ_F_RTOL}); "
          f"zero pattern equal at every step; Theta max |diff| "
          f"{float(np.abs(t_card - t_cpu).max()):.2e} (bar rtol "
          f"{TRAJ_RTOL}/atol {TRAJ_ATOL}); nnz {int((t_card != 0).sum()):,} "
          f"of {t_card.size:,}; step wall card {w_card:.2f} s, CPU "
          f"{w_cpu:.2f} s")


# ------------------------------------------------------------ phase 12
def phase_dense_times(torch, dev, x_test, theta):
    """B5 at the dense main path's shapes (the 3,276 test rows, the first
    512 of them, and the 3,276 rows in bf16; then 33 rows and 1, a small
    serving batch and a single request, in fp32 and bf16) beside its
    plain version, its bound and the contraction alone on cuBLAS
    (``x @ Theta``, the nearest single PyTorch call; none fuses the
    head)."""
    from repro_torch.kernels.lsplm_fused.lsplm_fused import (
        lsplm_fused_forward,
    )
    from repro_torch.kernels.lsplm_fused.ref import lsplm_forward_ref

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    out = []
    for rows, dtype in ((x_test.shape[0], torch.float32),
                        (512, torch.float32),
                        (x_test.shape[0], torch.bfloat16),
                        (33, torch.float32), (1, torch.float32),
                        (33, torch.bfloat16), (1, torch.bfloat16)):
        x = x_test[:rows].to(dtype)
        th = theta.to(dtype)
        u, w = th[:, :REGIONS], th[:, REGIONS:]
        b, d = x.shape
        size = x.element_size()
        nbytes = (b * d + d * 2 * REGIONS + b) * size
        t_bytes = nbytes / HBM_BYTES_PER_S
        peak = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        t_ops = 2 * b * d * 2 * REGIONS / peak
        row = {"n": b, "d": d, "m": REGIONS, "dtype": str(dtype),
               "ms": _time_ms(torch, lambda: lsplm_fused_forward(x, u, w),
                              flush),
               "plain_ms": _time_ms(torch, lambda: lsplm_forward_ref(x, u, w),
                                    flush),
               "library_ms": _time_ms(torch, lambda: x @ th, flush),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out.append(row)
        print(f"phase 12: lsplm_fused_forward {b:,} x {d:,}, m={REGIONS}, "
              f"{dtype}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of it "
              f"reached), library {row['library_ms']:.4f} ms (x @ Theta on "
              f"cuBLAS, the contraction alone)")
    return out

# ------------------------------------------------------------ phase 13
def _b6_inputs(torch, dev, rng, B, S, H, kvh, hd, dtype):
    """q (B, S, H, hd), k and v (B, S, kvh, hd) ~ N(0, 1) in ``dtype``."""
    def draw(heads):
        return torch.from_numpy(rng.normal(size=(B, S, heads, hd)).astype(
            np.float32)).to(dev, dtype)

    return draw(H), draw(kvh), draw(kvh)


def _check_b6(torch, q, k, v, causal, tag):
    """B6 against its plain version on the card at rtol = atol = the
    dtype's bar, bitwise repeatable. Returns the max abs error."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ops import plain_attention

    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    want = plain_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = B6_TOL[str(q.dtype).removeprefix("torch.")]
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"B6 output dtype/shape at {tag}")
    err = (got.float() - want.float()).abs()
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"B6 vs plain beyond rtol = atol = {tol} at {tag}: max |err| "
          f"{float(err.max()):.3e}")
    check(torch.equal(got, again), f"B6 not bitwise repeatable at {tag}")
    return float(err.max())


def _b6_float64_witness(torch, q, k, v, rows):
    """Causal attention of q's ``rows`` in float64 on the card, and how
    far B6 and its plain version (both fp32) are from it there: max |err|
    over the early rows (fewer than 4,096 keys) and over the rest."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ops import plain_attention
    from repro_torch.models.layers import repeat_kv

    rep = q.shape[2] // k.shape[2]
    idx = torch.as_tensor(rows, device=q.device)
    q64 = q[:, idx].double()
    k64, v64 = (repeat_kv(t, rep).double() for t in (k, v))
    s = torch.einsum("brhd,bshd->bhrs", q64, k64) * q.shape[-1] ** -0.5
    s = s.masked_fill(torch.arange(k.shape[1], device=q.device)[None, :]
                      > idx[:, None], float("-inf"))
    exact = torch.einsum("bhrs,bshd->brhd", torch.softmax(s, -1), v64)
    del s, k64, v64
    early = idx < 4096
    out = {}
    for tag, fn in (("B6", flash_attention), ("plain", plain_attention)):
        err = (fn(q, k, v)[:, idx].double() - exact).abs()
        out[tag] = (float(err[:, early].max()), float(err[:, ~early].max()))
    return out


def phase_attention_kernel(torch, dev):
    """B6 (flash attention) against its plain version on the card: the
    reference tests' shapes (hd 16 and 8), causal and not, fp32 and bf16;
    GQA with odd S; hd 128; hd 80 (zamba2-2.7b's head dim) with S ragged
    against the 128-row tile; llama's shape at S = 4,096. bf16 at hd 16,
    64, 80 and 128 runs the tensor-core body, fp32 and hd 8 the CUDA-core
    one."""
    rng = np.random.default_rng(SEED + 13)
    f32, bf16 = torch.float32, torch.bfloat16
    err = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(2, S, 3, 3, 16) for S in (32, 64, 48)] + [
        (1, 32, 2, 2, 8), (2, 37, 8, 2, 64), (1, 1, 4, 2, 64),
        (1, 130, 4, 1, 128), (3, 577, 8, 8, 128), (2, 577, 32, 8, 80),
        (LM_BATCH, LM_SEQ, 32, 8, 64)]
    for B, S, H, kvh, hd in cases:
        for dtype in (f32, bf16):
            q, k, v = _b6_inputs(torch, dev, rng, B, S, H, kvh, hd, dtype)
            for causal in (True, False):
                if S == LM_SEQ and not causal:
                    continue  # the model's attention is causal
                e = _check_b6(torch, q, k, v, causal,
                              f"(B, S, H, KVH, hd) = {(B, S, H, kvh, hd)} "
                              f"{dtype} causal={causal}")
                name = str(dtype).removeprefix("torch.")
                err[name] = max(err[name], e)
            del q, k, v
    print(f"phase 13: B6 (flash attention) vs plain on the card at (B, S, "
          f"H, KVH, hd) in {cases}, fp32 and bf16, causal and not (llama's "
          f"shape causal only); within rtol = atol = {B6_TOL['float32']} "
          f"(fp32) and {B6_TOL['bfloat16']} (bf16), every case bitwise "
          f"repeatable; max |err| fp32 {err['float32']:.3e}, bf16 "
          f"{err['bfloat16']:.3e}")
    return max(err.values())


# ------------------------------------------------------------ phase 14
LM_KERNELS = ("wgmma_attention_kernel", "fma_attention_kernel")


def _print_profile(title, wall_us, kernels, labels=LM_KERNELS, tag="B6"):
    busy_us = sum(v[0] for v in kernels.values())
    if not kernels:
        print(f"  profile of {title}: {wall_us / 1e3:.2f} ms wall; device "
              "time not measured (no device events)")
        return
    ours = [(n, us, c) for n, (us, c) in kernels.items()
            if any(label in n for label in labels)]
    ours_us = sum(us for _, us, _ in ours)
    gemm_us = sum(us for n, (us, _) in kernels.items()
                  if any(g in n.lower() for g in ("nvjet", "gemm", "xmma")))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"  profile of {title} (under torch.profiler): "
          f"{wall_us / 1e3:.2f} ms wall, {busy_us / 1e3:.2f} ms of device "
          f"kernels in {sum(v[1] for v in kernels.values())} launches "
          f"(device idle {1 - busy_us / wall_us:.1%}); {tag} x"
          f"{sum(c for _, _, c in ours)} {ours_us / 1e3:.3f} ms "
          f"({ours_us / busy_us:.1%} of device time); cuBLAS GEMMs "
          f"{gemm_us / 1e3:.3f} ms ({gemm_us / busy_us:.1%}); the rest "
          f"{(busy_us - ours_us - gemm_us) / 1e3:.3f} ms; top: "
          + "; ".join(f"{name[:60]} x{n} {us / 1e3:.3f} ms"
                      for name, (us, n) in top))


def _op_label(name: str) -> str:
    """A short label for a device kernel's name: the op inside a PyTorch
    elementwise, reduction or copy kernel, else the kernel's own name."""
    m = re.search(r"(\w+_kernel(?:_cuda)?)\(at::TensorIterator", name)
    if m:
        return m.group(1)
    functors = re.findall(r"(\w*Functor\w*)", name)
    if functors:
        return functors[-1]
    m = re.search(r"(\w+Ops)<", name)
    if m:
        return m.group(1)
    m = re.search(r"native::(?:\(anonymous namespace\)::)?(\w+)", name)
    return m.group(1) if m else name[:40]


def _print_elementwise(kernels, labels) -> None:
    """The profile's device time outside the GEMMs and our kernels, by
    op (``_op_label``), largest first."""
    busy_us = sum(v[0] for v in kernels.values())
    ops: dict[str, list] = {}
    for name, (us, n) in kernels.items():
        if any(label in name for label in labels) or any(
                g in name.lower() for g in ("nvjet", "gemm", "xmma")):
            continue
        k = ops.setdefault(_op_label(name), [0.0, 0])
        k[0] += us
        k[1] += n
    if not busy_us:
        return
    rest_us = sum(us for us, _ in ops.values())
    print(f"  the rest by op ({rest_us / 1e3:.3f} ms, "
          f"{rest_us / busy_us:.1%} of device time): " + "; ".join(
              f"{op} x{n} {us / 1e3:.3f} ms ({us / busy_us:.1%})"
              for op, (us, n) in sorted(ops.items(), key=lambda kv:
                                        -kv[1][0])))


def phase_lm(torch, dev):
    """The LM serving path at full width: llama3.2-1b from a seeded
    torch.Generator, prompts from the token stream; (a) prefill 4 x 4,096,
    (b) greedy generate of 32 tokens after it, (c) prefill 1 x 32,768.
    B6 launches once per layer per prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )
    from repro_torch.kernels.flash_attention.ops import plain_attention
    from repro_torch.models import (
        decode_step,
        init_caches,
        init_model,
        prefill,
    )
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    from repro_torch.models.generate import generate

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == LM_PARAMS, f"{LM_ARCH} has {n_params:,} parameters, "
          f"not {LM_PARAMS:,}")
    stream = TokenStream(cfg.vocab_size, seed=SEED)
    prompts = torch.from_numpy(
        stream.batch(LM_BATCH, LM_SEQ + 1)["tokens"]).to(dev)
    long_prompt = torch.from_numpy(
        stream.batch(1, LM_LONG + 1)["tokens"]).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prefill(model, tokens=prompts)  # first use: cuBLAS handles, modules

    launches = {}
    _reset((B6,))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(model, tokens=prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches["prefill"] = B6["flash_attention"]
    t0 = time.perf_counter()
    out = generate(model, prompts, LM_NEW, temperature=0.0)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches["generate"] = B6["flash_attention"] - launches["prefill"]
    t0 = time.perf_counter()
    long_logits, long_caches = prefill(model, tokens=long_prompt)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    launches["prefill_32k"] = (B6["flash_attention"] - launches["prefill"]
                               - launches["generate"])
    total = B6["flash_attention"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for step, count in launches.items():
        check(count == cfg.num_layers, f"B6 launched {count} times in "
              f"{step}, not once per layer ({cfg.num_layers})")
    check(logits.shape == (LM_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          "prefill logits have the wrong shape or are not finite")
    check(caches["k"].shape == (cfg.num_layers, LM_BATCH, LM_SEQ,
                                cfg.num_kv_heads, cfg.resolved_head_dim),
          f"prefill caches have shape {tuple(caches['k'].shape)}")
    check(out.shape == (LM_BATCH, LM_NEW) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size,
          "generated tokens have the wrong shape or are out of range")
    check(torch.equal(out[:, 0], logits.argmax(-1).to(out.dtype)),
          "the first greedy token is not the prefill logits' argmax")
    check(long_logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(long_logits.float()).all()),
          "32k prefill logits have the wrong shape or are not finite")
    del long_caches

    # the same model with B6's plain version in every layer: the model's
    # attention hook is swapped for this one call
    b6_attention = transformer.attention_ops.causal_attention
    transformer.attention_ops.causal_attention = plain_attention
    try:
        plain_logits, _ = prefill(model, tokens=prompts)
        torch.cuda.synchronize()
    finally:
        transformer.attention_ops.causal_attention = b6_attention
    lerr = (logits.float() - plain_logits.float()).abs()
    lbar = float((lerr / (LM_TOL + LM_TOL * plain_logits.float().abs()))
                 .max())
    check(lbar <= 1.0, f"prefill logits with B6 differ from plain "
          f"attention's beyond rtol = atol = {LM_TOL}: max |err| "
          f"{float(lerr.max()):.3e}, {lbar:.2f} of the bar")
    agree = float((logits.argmax(-1) == plain_logits.argmax(-1)).float()
                  .mean())
    # witness: both bf16 runs against the same weights computed in fp32
    model32 = transformer.Transformer(
        dataclasses.replace(cfg, dtype="float32"), device=dev)
    model32.load_state_dict(model.state_dict())
    logits32, _ = prefill(model32, tokens=prompts)
    del model32
    w_b6 = float((logits.float() - logits32).abs().max())
    w_plain = float((plain_logits.float() - logits32).abs().max())

    # layer 0's q, k, v of the 32k prompt: B6 against plain there
    blk = model.layers[0]
    h = transformer.embed_tokens(model, long_prompt)
    q, k, v = blk.attn.qkv(L.apply_norm(h, blk.norm1, cfg))
    rope = transformer._rope(torch.arange(LM_LONG, device=dev), cfg)
    q, k = L.apply_rope(q, *rope), L.apply_rope(k, *rope)
    long_err = _check_b6(torch, q, k, v, True,
                         f"layer 0 of the {LM_LONG:,}-token prompt")
    # the same q, k, v widened to fp32, held at the fp32 bar: late rows
    # average ~S/e keys, so their outputs are small against bf16's bar
    q, k, v = q.float(), k.float(), v.float()
    long_err32 = _check_b6(torch, q, k, v, True,
                           f"layer 0 of the {LM_LONG:,}-token prompt in "
                           "fp32")
    rows = list(range(0, LM_LONG, 512)) + [LM_LONG - 1]
    wit64 = _b6_float64_witness(torch, q, k, v, rows)
    del h, q, k, v

    # decode: greedy steps from (a)'s caches, timed and profiled
    dec = init_caches(cfg, LM_BATCH, LM_SEQ + LM_NEW, device=dev)
    for name in dec:
        dec[name][:, :, :LM_SEQ] = caches[name]
    del caches
    tok = logits.argmax(-1).to(torch.int32)
    decode_step(model, dec, token=tok, pos=LM_SEQ)  # first use
    torch.cuda.synchronize()
    steps = LM_NEW // 2
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        lg, dec = decode_step(model, dec, token=tok, pos=LM_SEQ + i)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"phase 14: LM main path ({LM_ARCH}, {n_params:,} parameters, "
          f"bf16 weights from a seeded torch.Generator, set-up {setup_s:.2f}"
          f" s): (a) prefill {LM_BATCH} x {LM_SEQ:,} in "
          f"{prefill_s * 1e3:.1f} ms = {LM_BATCH * LM_SEQ / prefill_s:,.0f} "
          f"tokens/s; (b) greedy generate of {LM_NEW} tokens after it in "
          f"{generate_s:.2f} s (its prefill included), tokens in range; (c) "
          f"prefill 1 x {LM_LONG:,} in {long_s:.2f} s = "
          f"{LM_LONG / long_s:,.0f} tokens/s; peak memory {peak_gb:.2f} GB; "
          f"B6 launches {launches} ({total} in all, one per layer per "
          f"prefill)")
    print(f"  prefill logits with B6 (P rounded once to bf16 for its P.V "
          f"product) vs with plain attention (P.V in fp32) in every layer: "
          f"{lbar:.3f} of the bar (rtol = atol = {LM_TOL}), max |err| "
          f"{float(lerr.max()):.3e}, argmax agreement "
          f"{agree:.0%}; against the same weights in fp32 (B6 in fp32): "
          f"bf16 with B6 max |err| {w_b6:.3e}, bf16 with plain attention "
          f"{w_plain:.3e}; B6 vs plain on layer 0's q, k, v "
          f"at S = {LM_LONG:,}: max |err| {long_err:.3e} in bf16 (bar "
          f"{B6_TOL['bfloat16']}), {long_err32:.3e} widened to fp32 (bar "
          f"{B6_TOL['float32']}); against float64 on {len(rows)} of "
          f"those rows (max |err| on rows < 4,096, then the rest): "
          + ", ".join(f"{t} {a:.3e} / {b:.3e}" for t, (a, b) in
                      wit64.items())
          + "; decode "
          f"{decode_ms:.2f} ms/token at batch {LM_BATCH} (mean of {steps} "
          f"greedy steps, host wall, cache of {LM_SEQ + LM_NEW:,} slots)")
    pos = LM_SEQ + steps + 1
    _, wall_us, kernels = _device_profile(
        torch, lambda: decode_step(model, dec, token=tok, pos=pos))
    _print_profile("one decode step", wall_us, kernels)
    del dec
    _, wall_us, kernels = _device_profile(
        torch, lambda: prefill(model, tokens=prompts))
    _print_profile(f"one {LM_BATCH} x {LM_SEQ:,} prefill", wall_us, kernels)
    del model
    torch.cuda.empty_cache()
    return total, launches, long_err, {
        "prefill_tokens_per_s": LM_BATCH * LM_SEQ / prefill_s,
        "prefill_32k_tokens_per_s": LM_LONG / long_s,
        "decode_ms_per_token": decode_ms}


# ------------------------------------------------------------ phase 15
def phase_lm_card_vs_cpu(torch, dev, arch=LM_ARCH, phase=15, kernel="B6"):
    """A reduced ``arch`` in fp32 on the card (its kernel) and on the CPU
    (the plain version), on the same weights: prefill logits within
    LM_CPU_TOL and greedy tokens equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import Transformer, init_model, prefill
    from repro_torch.models.generate import generate

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cpu = init_model(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    card = Transformer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    prompts = TokenStream(cfg.vocab_size, seed=SEED).batch(2, 97)["tokens"]
    lc, _ = prefill(card, tokens=torch.from_numpy(prompts).to(dev))
    lh, _ = prefill(cpu, tokens=torch.from_numpy(prompts))
    err = (lc.cpu() - lh).abs()
    check(bool((err <= LM_CPU_TOL + LM_CPU_TOL * lh.abs()).all()),
          f"reduced LM prefill logits, card vs CPU, beyond {LM_CPU_TOL}: "
          f"max |err| {float(err.max()):.3e}")
    new = 16
    tc = generate(card, torch.from_numpy(prompts).to(dev), new,
                  temperature=0.0).cpu()
    th = generate(cpu, torch.from_numpy(prompts), new, temperature=0.0)
    check(torch.equal(tc, th), "greedy tokens differ between card and CPU")
    print(f"phase {phase}: reduced {arch} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, family {cfg.family}, fp32) card ({kernel}) vs "
          f"CPU (plain): prefill logits of 2 x "
          f"{prompts.shape[1]} max |err| {float(err.max()):.3e} (bar "
          f"{LM_CPU_TOL}); {new} greedy tokens equal")


# ------------------------------------------------------------ phase 16
def phase_attention_times(torch, dev):
    """B6 at the LM path's shapes (4 x 4,096 and 1 x 32,768, 32 heads
    over 8, hd 64, bf16, causal) and at zamba2-2.7b's (4 x 4,096, 32
    heads, hd 80) beside its plain version, its bound and torch's
    scaled_dot_product_attention (the library column only)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ops import plain_attention

    rng = np.random.default_rng(SEED + 16)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    out = []
    for B, S, H, kvh, hd, runs, warm in (
            (LM_BATCH, LM_SEQ, 32, 8, 64, TIMED_RUNS, WARM_RUNS),
            (1, LM_LONG, 32, 8, 64, LONG_RUNS, 1),
            (LM_BATCH, LM_SEQ, 32, 32, 80, TIMED_RUNS, WARM_RUNS)):
        q, k, v = _b6_inputs(torch, dev, rng, B, S, H, kvh, hd,
                             torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes = B * S * (2 * H + 2 * kvh) * hd * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2 * B * H * S * S * hd / BF16_OPS_PER_S
        row = {"b": B, "s": S, "h": H, "kvh": kvh, "hd": hd,
               "dtype": "bfloat16", "causal": True,
               "ms": _time_ms(torch, lambda: flash_attention(q, k, v), flush,
                              runs, warm),
               "plain_ms": _time_ms(torch, lambda: plain_attention(q, k, v),
                                    flush, runs, warm),
               "library_ms": _time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True),
                   flush, runs, warm),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out.append(row)
        print(f"phase 16: flash_attention {B} x {S:,} x {H} heads (KV "
              f"{kvh}) x {hd}, bf16, causal: kernel {row['ms']:.3f} ms, "
              f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of "
              f"it reached; {2 * B * H * S * S * hd / row['ms'] / 1e9:.1f} "
              f"TFLOP/s), library {row['library_ms']:.3f} ms "
              f"(scaled_dot_product_attention); median of {runs}")
        del q, k, v, qt, kt, vt
    return out


# ------------------------------------------------------------ phase 17
def _b7_inputs(torch, dev, gen, B, S, di, N, dtype, h0, R=7):
    """The scan's inputs as the model gives them: dt = softplus(N(0, 1))
    fp32; x ~ N(0, 1) in ``dtype``; B and C the column slices [R, R+N) and
    [R+N, R+2N) of one (B, S, R+2N) tensor in ``dtype``; A = -exp(N(0,
    1)/2), D ~ N(0, 1) fp32; h0 ~ N(0, 1) fp32 or None."""
    def randn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    dt = torch.nn.functional.softplus(randn(B, S, di))
    xdb = randn(B, S, R + 2 * N, dt=dtype)
    return (dt, randn(B, S, di, dt=dtype), xdb[..., R:R + N],
            xdb[..., R + N:], -torch.exp(0.5 * randn(di, N)), randn(di),
            randn(B, di, N) if h0 else None)


def _b7_gated_inputs(torch, dev, gen, B, S, di, N, dtype, h0, R=7):
    """The gated scan's inputs as the model gives them, in ``dtype``:
    dt_raw ~ 3 N(0, 1) with every 13th value above softplus's threshold
    (20); x ~ N(0, 1); B and C the column slices [R, R+N) and [R+N, R+2N)
    of one (B, S, R+2N) tensor; z the second half of one (B, S, 2 di)
    tensor; dt_bias ~ N(0, 1) - 3, A_log ~ N(0, 1)/2, D ~ N(0, 1) fp32;
    h0 ~ N(0, 1) fp32 or None."""
    def randn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    dt_raw = 3 * randn(B, S, di)
    dt_raw.view(-1)[::13] = 21 + dt_raw.view(-1)[::13].abs()
    xdb = randn(B, S, R + 2 * N, dt=dtype)
    xz = randn(B, S, 2 * di, dt=dtype)
    return (dt_raw.to(dtype), randn(di) - 3, randn(B, S, di, dt=dtype),
            xdb[..., R:R + N], xdb[..., R + N:], 0.5 * randn(di, N),
            randn(di), xz[..., di:], randn(B, di, N) if h0 else None)


def _chained(torch, scan, args, seq_args, state_at, group):
    """``scan`` over the two halves of the sequence, the first half's hT
    as the second's h0: (y of both halves, the last hT)."""
    cut = args[seq_args[0]].shape[1] // 2 + 1
    halves = []
    h = args[state_at]
    for sl in (slice(0, cut), slice(cut, None)):
        part = list(args)
        for i in seq_args:
            part[i] = args[i][:, sl]
        part[state_at] = h
        y, h = scan(*part, group=group)
        halves.append(y)
    return torch.cat(halves, dim=1), h


def _check_b7(torch, args, tag, chained=True):
    """B7 in the reference's contract against its plain version on the
    card at every G (threads per channel): y and hT within rtol = atol =
    B7_TOL and bitwise equal, two identical calls bitwise equal, and
    (``chained``) the two halves of the sequence, chained through hT,
    bitwise equal to one call. Returns the max abs error."""
    from repro_torch.kernels.mamba_scan.mamba_scan import GROUPS, mamba1_scan
    from repro_torch.kernels.mamba_scan.ops import plain_scan

    py, ph = plain_scan(*args)
    B, S, di = args[1].shape
    err = 0.0
    for g in (g for g in GROUPS if g <= args[2].shape[2]):
        y, h = mamba1_scan(*args, group=g)
        y2, h2 = mamba1_scan(*args, group=g)
        torch.cuda.synchronize()
        check(y.dtype == h.dtype == torch.float32 and y.shape == (B, S, di)
              and h.shape == ph.shape, f"B7 output dtype/shape at {tag}")
        for got, want, what in ((y, py, "y"), (h, ph, "hT")):
            e = (got - want).abs()
            check(bool((e <= B7_TOL + B7_TOL * want.abs()).all()),
                  f"B7 {what} vs plain beyond rtol = atol = {B7_TOL} at "
                  f"{tag}, G={g}: max |err| {float(e.max()):.3e}")
            check(torch.equal(got, want), f"B7 {what} not bitwise equal to "
                  f"plain at {tag}, G={g}: {int((got != want).sum())} "
                  f"elements differ, max |err| {float(e.max()):.3e}")
            err = max(err, float(e.max()))
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"B7 not bitwise repeatable at {tag}, G={g}")
        if chained and S > 1:
            yc, hc = _chained(torch, mamba1_scan, args, (0, 1, 2, 3), 6, g)
            torch.cuda.synchronize()
            check(torch.equal(yc, y) and torch.equal(hc, h),
                  f"B7 chained halves differ from one call at {tag}, G={g}")
    return err


def _check_b7_gated(torch, args, tag, chained=True):
    """B7's gated mode against its plain version (the model's unfused
    composition: softplus, -exp(A_log), the plain scan, the silu(z)
    gate) on the card at every G: y (in x's dtype) and hT bitwise equal,
    bitwise repeatable, and (``chained``) chained halves bitwise equal to
    one call."""
    from repro_torch.kernels.mamba_scan.mamba_scan import (
        GROUPS,
        mamba1_scan_gated,
    )
    from repro_torch.kernels.mamba_scan.ops import plain_gated_scan

    py, ph = plain_gated_scan(*args)
    S = args[2].shape[1]
    for g in (g for g in GROUPS if g <= args[3].shape[2]):
        y, h = mamba1_scan_gated(*args, group=g)
        y2, h2 = mamba1_scan_gated(*args, group=g)
        torch.cuda.synchronize()
        check(y.dtype == args[2].dtype and y.shape == py.shape
              and h.dtype == torch.float32 and h.shape == ph.shape,
              f"gated B7 output dtype/shape at {tag}")
        for got, want, what in ((y, py, "y"), (h, ph, "hT")):
            if not torch.equal(got, want):
                e = (got.float() - want.float()).abs()
                raise SmokeFailure(
                    f"gated B7 {what} not bitwise equal to the composition "
                    f"at {tag}, G={g}: {int((got != want).sum())} elements "
                    f"differ, max |err| {float(e.max()):.3e}")
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"gated B7 not bitwise repeatable at {tag}, G={g}")
        if chained and S > 1:
            yc, hc = _chained(torch, mamba1_scan_gated, args,
                              (0, 2, 3, 4, 7), 8, g)
            torch.cuda.synchronize()
            check(torch.equal(yc, y) and torch.equal(hc, h),
                  f"gated B7 chained halves differ from one call at {tag}, "
                  f"G={g}")


def phase_scan_kernel(torch, dev):
    """B7 (the Mamba1 selective scan) against its plain version on the
    card, in both modes and at every G <= N: the reference tests' shapes,
    ragged di, N in {4, 8, 16, 32}, S = 1 from a carried state, and
    falcon-mamba's (4, 4,096, 8,192, 16); x, B and C in fp32 and bf16, B
    and C strided slices of one tensor (and z of another)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    cases = [(2, 16, 32, 8, False), (2, 32, 64, 16, True),
             (2, 8, 16, 4, False), (3, 37, 100, 16, True),
             (1, 70, 40, 32, True), (2, 300, 257, 4, False),
             (LM_BATCH, 1, 8192, 16, True),
             (LM_BATCH, LM_SEQ, 8192, 16, False)]
    err = {"float32": 0.0, "bfloat16": 0.0}
    for B, S, di, N, h0 in cases:
        for dtype in (torch.float32, torch.bfloat16):
            R = 256 if di == 8192 else 7
            name = str(dtype).removeprefix("torch.")
            tag = f"(B, S, di, N) = {(B, S, di, N)} {name} h0={h0}"
            args = _b7_inputs(torch, dev, gen, B, S, di, N, dtype, h0, R=R)
            err[name] = max(err[name], _check_b7(torch, args, tag))
            del args
            args = _b7_gated_inputs(torch, dev, gen, B, S, di, N, dtype, h0,
                                    R=R)
            _check_b7_gated(torch, args, tag)
            del args
    print(f"phase 17: B7 (Mamba1 selective scan) vs plain on the card at "
          f"(B, S, di, N, h0) in {cases}, x/B/C in fp32 and bf16 (B, C "
          f"strided slices of one projection), at G = 1, 2 and 4 "
          f"threads per channel (G <= N): the reference's contract within "
          f"rtol = atol = {B7_TOL} and bitwise equal to plain (max |err| fp32 "
          f"{err['float32']:.3e}, bf16 {err['bfloat16']:.3e}); the gated "
          f"mode (softplus, -exp(A_log), silu(z) gate fused) bitwise equal "
          f"to the unfused composition; every case bitwise repeatable and "
          f"its chained halves bitwise equal to one call, in both modes")
    return max(err.values())


# ------------------------------------------------------------ phase 18
SSM_KERNELS = ("mamba1_scan_kernel",)


def _first_scan_inputs(torch, model, tokens):
    """Layer 0's gated-scan inputs for ``tokens``, as the model builds
    them: one prefill with ``ssm.ops.gated_selective_scan`` wrapped to
    keep its first call's arguments (every call still runs the kernel)."""
    from repro_torch.models import prefill
    from repro_torch.models import ssm

    seen = []
    scan = ssm.ops.gated_selective_scan

    def keep_first(*args):
        if not seen:
            seen.append(args)
        return scan(*args)

    ssm.ops.gated_selective_scan = keep_first
    try:
        prefill(model, tokens=tokens)
    finally:
        ssm.ops.gated_selective_scan = scan
    return seen[0]


def _contract_args(torch, gated_args):
    """The reference contract's scan inputs (dt after softplus, A) that
    the gated mode's inputs stand for, as the plain composition makes
    them."""
    import torch.nn.functional as F

    dt_raw, dt_bias, x, B_in, C_in, A_log, D, _, h0 = gated_args
    dt = F.softplus(dt_raw.float() + dt_bias)
    return dt, x, B_in, C_in, -torch.exp(A_log), D, h0


def _within(torch, got, want, tol):
    """(max |err|, the worst element's share of rtol = atol = tol)."""
    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err / (tol + tol * want.float().abs()))
                                   .max())


def phase_ssm_lm(torch, dev):
    """The SSM serving path at full width and depth: falcon-mamba-7b from
    a seeded torch.Generator, prompts from the token stream; (a) prefill
    4 x 4,096, (b) greedy generate of 32 tokens after it, (c) prefill 1 x
    32,768. B7 launches once per layer per prefill and per decode step.
    Gates: B7 against plain on layer 0's real inputs, the model with B7
    against the model on the plain scan, and (in fp32, the bf16 run
    printed beside it) decode after prefill against the forward."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.mamba_scan.mamba_scan import LAUNCHES as B7
    from repro_torch.kernels.mamba_scan.ops import plain_gated_scan
    from repro_torch.models import (
        decode_step,
        forward,
        init_caches,
        init_model,
        prefill,
    )
    from repro_torch.models import ssm, transformer
    from repro_torch.models.generate import generate

    cfg = get_config(SSM_ARCH)
    nl = cfg.num_layers
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == SSM_PARAMS, f"{SSM_ARCH} has {n_params:,} parameters, "
          f"not {SSM_PARAMS:,}")
    stream = TokenStream(cfg.vocab_size, seed=SEED)
    batch = stream.batch(LM_BATCH, LM_SEQ + 1)
    prompts = torch.from_numpy(batch["tokens"]).to(dev)
    nxt = torch.from_numpy(batch["labels"][:, -1]).to(dev)  # token 4,097
    long_prompt = torch.from_numpy(
        stream.batch(1, LM_LONG + 1)["tokens"]).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prefill(model, tokens=prompts[:, :SSM_SHORT])  # first use

    launches = {}
    _reset((B7,))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(model, tokens=prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches["prefill"] = B7["mamba1_scan_gated"]
    t0 = time.perf_counter()
    out = generate(model, prompts, LM_NEW, temperature=0.0)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches["generate"] = B7["mamba1_scan_gated"] - launches["prefill"]
    t0 = time.perf_counter()
    long_logits, long_caches = prefill(model, tokens=long_prompt)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    launches["prefill_32k"] = (B7["mamba1_scan_gated"]
                               - sum(launches.values()))
    total = B7["mamba1_scan_gated"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for step, count in (("prefill", launches["prefill"]),
                        ("prefill_32k", launches["prefill_32k"]),
                        ("generate", launches["generate"] / LM_NEW)):
        check(count == nl, f"gated B7 launched {count} times per {step} "
              f"step, not once per layer ({nl})")
    check(B7["mamba1_scan"] == 0, f"the model path launched B7's contract "
          f"mode {B7['mamba1_scan']} times (the gated mode serves it)")
    check(logits.shape == (LM_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          "prefill logits have the wrong shape or are not finite")
    check(caches["conv"].shape == (nl, LM_BATCH, cfg.ssm_conv - 1,
                                   cfg.d_inner)
          and caches["ssm"].shape == (nl, LM_BATCH, cfg.d_inner,
                                      cfg.ssm_state)
          and caches["ssm"].dtype == torch.float32,
          f"prefill states have shapes {tuple(caches['conv'].shape)} / "
          f"{tuple(caches['ssm'].shape)}")
    check(out.shape == (LM_BATCH, LM_NEW) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size,
          "generated tokens have the wrong shape or are out of range")
    check(torch.equal(out[:, 0], logits.argmax(-1).to(out.dtype)),
          "the first greedy token is not the prefill logits' argmax")
    check(long_logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(long_logits.float()).all())
          and bool(torch.isfinite(long_caches["ssm"]).all()),
          "32k prefill logits or states are not finite")
    del long_caches

    # B7 against plain on layer 0's real inputs of (a) and of (c): the
    # gated mode against the unfused composition, and the contract mode
    # on the dt and A that composition makes
    layer0 = {}
    for tag, toks in (("a", prompts), ("c", long_prompt)):
        args = _first_scan_inputs(torch, model, toks)
        _check_b7_gated(torch, args, f"layer 0 of prompt ({tag})")
        layer0[tag] = _check_b7(torch, _contract_args(torch, args),
                                f"layer 0 of prompt ({tag})")
        del args

    # the whole model with B7's plain version in every layer, on a shorter
    # prompt: the model's scan hook is swapped for this one call
    short = prompts[:, :SSM_SHORT]
    b7_logits, _ = prefill(model, tokens=short)
    b7_scan = ssm.ops.gated_selective_scan
    ssm.ops.gated_selective_scan = plain_gated_scan
    try:
        plain_logits, _ = prefill(model, tokens=short)
        torch.cuda.synchronize()
    finally:
        ssm.ops.gated_selective_scan = b7_scan
    perr, pbar = _within(torch, b7_logits, plain_logits, LM_TOL)
    check(pbar <= 1.0, f"prefill logits with B7 differ from the plain scan's "
          f"beyond rtol = atol = {LM_TOL}: max |err| {perr:.3e}, {pbar:.2f} "
          "of the bar")
    check(torch.equal(b7_logits.argmax(-1), plain_logits.argmax(-1)),
          "prefill argmax differs between B7 and the plain scan")

    # prefill of 4,096 tokens, then one decode step, against the forward
    # of the 4,097 tokens at the last position: in bf16 (the main path;
    # printed, not gated) and, gated, the same weights in fp32. At 64
    # random bf16 layers one-ulp differences (cuBLAS rounds some of a
    # product's outputs differently at M = 4 than at M = 16,388: the
    # share is printed) move the logits by more than the bar, and the
    # bf16 forward is itself further than that from the fp32 one (the
    # witness below); in fp32 a state handed over wrongly still shows at
    # O(1).
    def handoff(m, caches_after_prompt):
        dec = init_caches(m.cfg, LM_BATCH, LM_SEQ + LM_NEW,
                          dtype=caches_after_prompt["conv"].dtype, device=dev)
        for name in dec:
            dec[name].copy_(caches_after_prompt[name])
        before = B7["mamba1_scan_gated"]
        step_logits, dec = decode_step(m, dec, token=nxt, pos=LM_SEQ)
        torch.cuda.synchronize()
        launched = B7["mamba1_scan_gated"] - before
        check(launched == nl, f"gated B7 launched {launched} times in a "
              f"decode step, not {nl}")
        hidden, _ = forward(m, tokens=torch.cat([prompts, nxt[:, None]], 1),
                            return_hidden=True)
        return (step_logits, transformer.lm_logits(m, hidden[:, -1]), dec,
                launched)

    step_logits, fwd_logits, dec, launches["decode_step"] = handoff(
        model, caches)
    del caches
    derr16, dbar16 = _within(torch, step_logits, fwd_logits, LM_TOL)
    model32 = transformer.Transformer(
        dataclasses.replace(cfg, dtype="float32"), device=dev)
    model32.load_state_dict(model.state_dict())
    _, caches32 = prefill(model32, tokens=prompts)
    step32, fwd32, dec32, _ = handoff(model32, caches32)
    del model32, caches32, dec32
    torch.cuda.empty_cache()
    derr, dbar = _within(torch, step32, fwd32, LM_TOL)
    check(dbar <= 1.0, f"fp32 decode after prefill differs from the forward "
          f"of {LM_SEQ + 1:,} tokens beyond rtol = atol = {LM_TOL}: max "
          f"|err| {derr:.3e}, {dbar:.2f} of the bar")
    check(torch.equal(step32.argmax(-1), fwd32.argmax(-1)),
          "fp32 decode after prefill: argmax differs from the forward's")
    w_out = model.layers[0].mamba.out_proj
    rows = torch.randn((LM_BATCH, LM_SEQ, cfg.d_inner), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           SEED + 18)).to(w_out.dtype)
    gemm_flips = float(((rows @ w_out)[:, -1] != rows[:, -1] @ w_out).float()
                       .mean())
    del rows
    w_fwd = float((fwd_logits.float() - fwd32).abs().max())
    w_step = float((step_logits.float() - fwd32).abs().max())
    dagree = float((step_logits.argmax(-1) == fwd_logits.argmax(-1)).float()
                   .mean())

    # decode: greedy steps from the states after token 4,097, timed
    tok = step_logits.argmax(-1).to(torch.int32)
    steps = LM_NEW // 2
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        lg, dec = decode_step(model, dec, token=tok, pos=LM_SEQ + i)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"phase 18: SSM main path ({SSM_ARCH}, {n_params:,} parameters, "
          f"bf16 weights from a seeded torch.Generator, set-up {setup_s:.2f}"
          f" s): (a) prefill {LM_BATCH} x {LM_SEQ:,} in "
          f"{prefill_s * 1e3:.1f} ms = {LM_BATCH * LM_SEQ / prefill_s:,.0f} "
          f"tokens/s; (b) greedy generate of {LM_NEW} tokens after it in "
          f"{generate_s:.2f} s (its prefill included), tokens in range; (c) "
          f"prefill 1 x {LM_LONG:,} in {long_s:.2f} s = "
          f"{LM_LONG / long_s:,.0f} tokens/s; peak memory {peak_gb:.2f} GB; "
          f"B7 launches {launches} ({total} in the three runs: one per "
          "layer per prefill and per decode step)")
    print(f"  B7 vs plain on layer 0's scan inputs at G = 1, 2 and 4: gated "
          f"mode bitwise equal to the unfused composition; contract mode "
          f"bitwise equal to plain (max |err| {layer0['a']:.3e} at "
          f"{LM_BATCH} x {LM_SEQ:,}, {layer0['c']:.3e} at 1 x {LM_LONG:,}, "
          f"bar {B7_TOL}); both modes repeatable and chained halves equal "
          f"to one call; prefill logits of {LM_BATCH}"
          f" x {SSM_SHORT} with B7 vs the plain scan in every layer: max "
          f"|err| {perr:.3e} ({pbar:.2f} of the rtol = atol = {LM_TOL} bar),"
          f" argmax equal; decode of token {LM_SEQ + 1:,} after prefill vs "
          f"the forward of {LM_SEQ + 1:,} tokens: fp32 max |err| "
          f"{derr:.3e} ({dbar:.2f} of the bar), argmax equal; bf16 (not "
          f"gated) max |err| {derr16:.3e} ({dbar16:.2f} of the bar), argmax "
          f"agreement {dagree:.0%}, and against the fp32 forward: bf16 "
          f"forward {w_fwd:.3e}, bf16 decode {w_step:.3e} (layer 0's "
          f"out_proj at M = {LM_BATCH} rounds {gemm_flips:.2%} of its bf16 "
          f"outputs otherwise than the same rows at M = "
          f"{LM_BATCH * LM_SEQ:,}); decode "
          f"{decode_ms:.2f} ms/token at batch {LM_BATCH} (mean of {steps} "
          "greedy steps, host wall)")
    _, wall_us, kernels = _device_profile(
        torch, lambda: decode_step(model, dec, token=tok, pos=LM_SEQ + steps))
    _print_profile("one decode step", wall_us, kernels, SSM_KERNELS, "B7")
    del dec
    _, wall_us, kernels = _device_profile(
        torch, lambda: prefill(model, tokens=prompts))
    _print_profile(f"one {LM_BATCH} x {LM_SEQ:,} prefill", wall_us, kernels,
                   SSM_KERNELS, "B7")
    _print_elementwise(kernels, SSM_KERNELS)
    del model
    torch.cuda.empty_cache()
    return total, launches, max(layer0.values()), {
        "prefill_tokens_per_s": LM_BATCH * LM_SEQ / prefill_s,
        "prefill_32k_tokens_per_s": LM_LONG / long_s,
        "decode_ms_per_token": decode_ms}


# ------------------------------------------------------------ phase 20
def _sass_step_block(lib_path: Path, kernel_re: str):
    """The straight-line SASS block of B7 that holds the most MUFU.EX2
    (the scan of one group of steps), from ``cuobjdump -sass`` of the
    built library, for the kernel whose mangled name matches
    ``kernel_re``: (its instruction count, {mnemonic: count}), or None
    when cuobjdump is missing or nothing matches."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).with_name(
        "cuobjdump"))
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for body in re.split(r"Function : ", sass)[1:]:
        if not re.match(kernel_re, body):
            continue
        code = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body)]
        targets = {int(t, 16) for t in re.findall(r"BRA\s+(0x[0-9a-f]+)",
                                                  body)}
        blocks, cur = [], []
        for addr, text in code:
            if addr in targets and cur:
                blocks.append(cur)
                cur = []
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            cur.append(op if op.startswith("MUFU") else op.split(".")[0])
            if op in ("BRA", "EXIT", "RET"):
                blocks.append(cur)
                cur = []
        best = max(blocks + [cur], key=lambda b: b.count("MUFU.EX2"))
        if "MUFU.EX2" not in best:
            return None
        mix: dict[str, int] = {}
        for op in best:
            mix[op] = mix.get(op, 0) + 1
        return len(best), mix
    return None


def _scan_bound(torch, args, gated):
    """Least time of one scan: each input read once and each output
    written once at the memory rate, against its SFU operations (N
    exponentials per (b, s, channel); the gated mode 4 more: softplus's
    exp and log, silu's exp and reciprocal) at the SFU rate."""
    x = args[2] if gated else args[1]
    B, S, di = x.shape
    N = args[3].shape[2] if gated else args[2].shape[2]
    y_bytes = x.element_size() if gated else 4
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None) + B * S * di * y_bytes + B * di * N * 4
    ops = B * S * di * (N + (4 if gated else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SFU_EXP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_scan_times(torch, dev):
    """B7 at the SSM path's shapes (prefill 4 x 4,096 and 1 x 32,768, a
    decode step at batch 4; di 8,192, N 16, bf16 as the model gives
    them), in the gated mode the model runs and in the reference's
    contract, beside the plain version and the bound, at the G the
    wrapper picks and at each G. No single PyTorch call computes the
    selective scan, so there is no library column. Returns the rows, the
    gated 4 x 4,096 one first."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan.mamba_scan import (
        GROUPS,
        _sm_count,
        mamba1_scan,
        mamba1_scan_gated,
        threads_per_channel,
    )
    from repro_torch.kernels.mamba_scan.ops import plain_gated_scan, plain_scan

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    di, N = 8192, 16
    rows = {True: [], False: []}
    for gated, kernel, plain, inputs in (
            (True, mamba1_scan_gated, plain_gated_scan, _b7_gated_inputs),
            (False, mamba1_scan, plain_scan, _b7_inputs)):
        mode = "gated" if gated else "contract"
        for B, S, h0, runs, plain_runs in (
                (LM_BATCH, LM_SEQ, False, TIMED_RUNS, B7_PLAIN_RUNS),
                (1, LM_LONG, False, LONG_RUNS, B7_PLAIN_RUNS),
                (LM_BATCH, 1, True, TIMED_RUNS, TIMED_RUNS)):
            args = inputs(torch, dev, gen, B, S, di, N, torch.bfloat16, h0,
                          R=256)
            bound_ms, bound_by, nbytes, ops = _scan_bound(torch, args, gated)
            by_group = {g: _time_ms(torch, lambda: kernel(*args, group=g),
                                    flush, runs) for g in GROUPS}
            picked = threads_per_channel(B * di, S, _sm_count(dev), N)
            row = {"mode": mode, "b": B, "s": S, "di": di, "n": N,
                   "dtype": "bfloat16", "group": picked,
                   "ms": _time_ms(torch, lambda: kernel(*args), flush, runs),
                   "ms_by_group": by_group,
                   "plain_ms": _time_ms(torch, lambda: plain(*args), flush,
                                        plain_runs, 1),
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            rows[gated].append(row)
            print(f"phase 20: B7 {mode} (B, S, di, N) = {(B, S, di, N)}, "
                  f"bf16{', from h0' if h0 else ''}: kernel "
                  f"{row['ms']:.4f} ms at G={picked} (median of {runs}; by "
                  f"G: " + ", ".join(f"{g}: {ms:.4f}" for g, ms in
                                     by_group.items())
                  + f"), plain {row['plain_ms']:.3f} ms (median of "
                  f"{plain_runs}), bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{nbytes / 1e9:.3f} GB, {ops:.3e} SFU operations; "
                  f"{bound_ms / row['ms']:.1%} of it reached); library n/a "
                  "(no single PyTorch call)")
            del args
    lib = _build.build_all(["mamba_scan"])["mamba_scan"]
    for gated in (True, False):
        for g in GROUPS:
            found = _sass_step_block(
                lib, rf"\S*mamba1_scan_kernelILi{N}ELi{g}ELb{int(gated)}E"
                r"13__nv_bfloat16")
            mode = "gated" if gated else "contract"
            if found is None:
                print(f"  SASS of B7 {mode} N={N} G={g}: not measured "
                      "(cuobjdump missing or no block found)")
                continue
            count, mix = found
            m = N // g
            k = 4 if m >= 8 else 8  # the kernel's group_steps<M>()
            print(f"  SASS of B7 {mode} N={N} G={g} bf16: the straight-line "
                  f"block of one group of steps holds {count} instructions "
                  f"and {mix.get('MUFU.EX2', 0)} MUFU.EX2; per (channel, "
                  f"state, step) on one thread, for {k} steps x {m} "
                  f"states: {count / (k * m):.1f}; mix " + ", ".join(
                      f"{op} {n}" for op, n in sorted(
                          mix.items(), key=lambda kv: -kv[1])[:10]))
    return rows[True] + rows[False]


SCAN_PHASES = (17, 18, 19, 20)  # the SSM path's phases, runnable alone


def _run_only(torch, dev, only, t_start) -> int:
    """Phase 1 and the given SSM phases alone (``--only``): a partial
    run, so it prints no kernels line and no result line."""
    for phase in sorted(only):
        if phase == 17:
            phase_scan_kernel(torch, dev)
        elif phase == 18:
            phase_ssm_lm(torch, dev)
        elif phase == 19:
            phase_lm_card_vs_cpu(torch, dev, SSM_ARCH, 19, "B7")
        else:
            phase_scan_times(torch, dev)
    print(f"phases 1 and {sorted(only)} passed in "
          f"{time.perf_counter() - t_start:.1f} s (partial run: no result)")
    return 0


def main(argv: list[str]) -> int:
    """``chip_smoke.py`` runs every phase; ``chip_smoke.py --only 17,20``
    runs phase 1 and the named phases of the SSM path (17-20) alone."""
    import torch

    only = set()
    if argv:
        if len(argv) != 2 or argv[0] != "--only":
            raise SmokeFailure(f"usage: chip_smoke.py [--only "
                               f"{','.join(map(str, SCAN_PHASES))}]")
        only = {int(p) for p in argv[1].split(",")}
        if not only <= set(SCAN_PHASES):
            raise SmokeFailure(f"--only takes phases of {SCAN_PHASES}")

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
    t_start = time.perf_counter()
    phase_device(torch)
    if only:
        return _run_only(torch, dev, only, t_start)

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
        serve_launches, _, _ = phase_main_path(torch, Path(tmp))
    times = phase_times(torch, dev, theta, codes, scales)
    del theta, codes, scales

    from repro_torch.launch.train import sparse_problem, sparse_test_batch

    # the training driver's batch, Theta0 and optimizer at its launch
    # defaults (batch seed --seed + 1, test batch --seed + 2)
    t0 = time.perf_counter()
    problem = sparse_problem(D_FEATURES, REGIONS, SESSIONS, lam=LAM,
                             beta=BETA, seed=SEED, batch_seed=SEED + 1,
                             device=dev)
    train, theta0, _ = problem
    test = sparse_test_batch(D_FEATURES, SESSIONS, seed=SEED + 2, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for name, e in phase_training_kernels(torch, dev, train, test,
                                          theta0).items():
        err[name] = max(err.get(name, 0.0), e)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, b1_err = phase_training(torch, dev, problem, test,
                                                setup_s, Path(tmp))
    err["lsplm_sparse_fused_forward"] = max(
        err["lsplm_sparse_fused_forward"], b1_err)
    phase_trajectory(torch, dev, problem)
    train_times = phase_training_times(torch, dev, train, theta0)
    # B1's first shape is the training path's, whose launches it reports
    times["lsplm_sparse_fused_forward"][:0] = train_times.pop(
        "lsplm_sparse_fused_forward")
    times.update(train_times)
    del problem, train, theta0, test

    from repro_torch.data.synthetic_ctr import CTRDataConfig
    from repro_torch.launch.train import dense_problem, dense_test_batch

    # the dense driver's batch, Theta0, optimizer and test rows at the
    # configuration phase 10 trains (data seeds 1 and 2, as the driver's)
    dense_cfg = CTRDataConfig(num_user_features=DENSE_USER,
                              num_ad_features=DENSE_AD,
                              noise_features=DENSE_NOISE, seed=SEED)
    t0 = time.perf_counter()
    dense = dense_problem(dense_cfg, REGIONS, DENSE_SESSIONS, lam=DENSE_LAM,
                          beta=DENSE_BETA, seed=SEED, device=dev)
    dense_test = dense_test_batch(dense_cfg, DENSE_SESSIONS, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"dense problem built in {setup_s:.1f} s: "
          f"x_common {tuple(dense[0].x_common.shape)}, x_noncommon "
          f"{tuple(dense[0].x_noncommon.shape)}, test rows "
          f"{tuple(dense_test.x.shape)}")
    err["lsplm_fused_forward"] = phase_dense_kernel(torch, dev,
                                                    dense_test.x)
    with tempfile.TemporaryDirectory() as tmp:
        dense_launches = phase_dense_training(torch, dev, dense, dense_test,
                                              setup_s, Path(tmp))
    err["owlqn_direction"] = max(err["owlqn_direction"],
                                 dense_launches["b3_err"])
    phase_dense_trajectory(torch, dev)
    times["lsplm_fused_forward"] = phase_dense_times(
        torch, dev, dense_test.x, dense[1])
    del dense, dense_test

    err["flash_attention"] = phase_attention_kernel(torch, dev)
    lm_total, lm_launches, long_err, lm_metrics = phase_lm(torch, dev)
    err["flash_attention"] = max(err["flash_attention"], long_err)
    phase_lm_card_vs_cpu(torch, dev)
    times["flash_attention"] = phase_attention_times(torch, dev)

    err["mamba1_scan"] = phase_scan_kernel(torch, dev)
    ssm_total, ssm_launches, ssm_err, ssm_metrics = phase_ssm_lm(torch, dev)
    err["mamba1_scan"] = max(err["mamba1_scan"], ssm_err)
    phase_lm_card_vs_cpu(torch, dev, SSM_ARCH, 19, "B7")
    times["mamba1_scan"] = phase_scan_times(torch, dev)

    kernels = []
    for name in ("lsplm_sparse_fused_forward",
                 "lsplm_sparse_fused_int8_forward",
                 "lsplm_sparse_scatter_compact", "owlqn_direction",
                 "lsplm_fused_forward", "flash_attention", "mamba1_scan"):
        main_shape, *others = times[name]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train_launches.get(name, 0),
                   "dense_train": dense_launches["dense_train"].get(name, 0)}
        if name == "lsplm_fused_forward":
            by_path["dense_serve"] = dense_launches["dense_serve"]
        if name == "flash_attention":
            by_path = {"lm_serve": lm_total, **{
                f"lm_serve/{step}": n for step, n in lm_launches.items()}}
        if name == "mamba1_scan":
            by_path = {"lm_serve_ssm": ssm_total, **{
                f"lm_serve_ssm/{step}": n
                for step, n in ssm_launches.items()}}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": next((by_path[path] for path in (
                "lm_serve_ssm", "lm_serve", "train", "serve",
                "dense_train")
                if by_path.get(path)), 0),
            "launches_by_path": by_path,
            "max_abs_err": err[name], "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": {k: v for k, v in main_shape.items()
                      if k in ("n", "k", "side", "entries", "unique", "d",
                               "m2", "m", "dtype", "b", "s", "h", "kvh",
                               "hd", "causal", "di", "n", "mode",
                               "group")},
            "other_shapes": others,
        })
    print(f"LM serving ({LM_ARCH}): " + json.dumps(lm_metrics))
    print(f"SSM serving ({SSM_ARCH}): " + json.dumps(ssm_metrics))
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
