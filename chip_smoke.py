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
through ``models.generate``, prefill of 1 x 32,768), the SSM serving
path (falcon-mamba-7b at full width and depth, the same three runs) and
the hybrid and MoE ones (zamba2-2.7b and granite-moe-1b-a400m at full
width and depth, the same three runs each) and the streaming training
path (``repro_torch.launch.train --stream`` at d = 1,000,000, m = 12:
8 days of 4,000 sessions, window 2, 5 inner iterations, overlapped and
synchronous; then its gates, the drift reference arming
``launch.serve --monitor``, and the jax-free ``cuda`` tests) and the LM
training path (``repro_torch.models.make_train_step``: llama3.2-1b
trainable at full width and depth, 4 x 4,096 tokens a step, B6 in the
forward and its checkpointed recompute, the plain attention backward,
AdamW; then a reduced model of each family against the CPU and B6's and
B7's autograd Functions against their plain versions' gradients) and the
Mamba1 training path (``make_train_step`` on falcon-mamba-7b at full
width and 16 of its 64 layers, 4 x 4,096 tokens a step, B7 in the forward
and its recompute and B7's backward kernel in the backward, against its
plain version on layer 0's real inputs) and the
autotuning path (``repro_torch.tune.sweep`` over B1, B4 and B2 at the
reference's sweep shapes, every config parity-gated, the committed
``cuda-sm90.json`` held to ``check_table``; then ``--tune``,
``--block-n`` and ``--block-k`` through the drivers) and the sharded
training path (``repro_torch.launch.train --mesh-data --mesh-model``:
the paper-width sparse problem on 2 x 2, 1 x 2 and 2 x 1 meshes of
ranks sharing the one card, B1, B2 and B3 on each rank's rows, against
the unsharded run; then the three drivers on a 2 x 2 mesh) and the
sharded LM serving path (``repro_torch.models`` with ``mesh=``: llama3.2-1b,
granite-moe-1b-a400m (both MoE plans) and zamba2-2.7b on 2 x 2, llama,
granite, falcon-mamba-7b and zamba2 on 1 x 2, at full width, prompts 4 x
512 and 3 greedy tokens, B6 on each rank's heads and B7 on its d_inner
channels, against one rank, and llama on 1 x 2 under ``seq_parallel``
and ``attn_shard="head_dim"``; then reduced models on a 2 x 2 mesh
against the CPU's) and the sharded LM training path (``make_train_step``
with ``mesh=``: llama3.2-1b trainable at full width on 2 x 2, FSDP over
data, 4 x 512, and zamba2-2.7b on 1 x 2, 4 x 256, against one rank, with
the roofline of a rank's step; then reduced llama, granite,
falcon-mamba and zamba2 on 2 x 2, llama and falcon-mamba under
``seq_parallel`` and llama under ``attn_shard="head_dim"`` on 1 x 2,
and zamba2 on 2 x 1, against the CPU's ranks) and the dry run
(``repro_torch.launch.dryrun``, in a process of its own: llama3.2-1b's
train step, falcon-mamba-7b's prefill and llama's fp32 step on a fake 2 x
2 mesh and falcon-mamba-7b's 16-layer step, traced on fake tensors and
held against the peaks, launches and collectives those steps measured on
the card), shows that each path
launched its kernels, holds the card's OWLQN+
trajectories and a reduced LM of each family against the CPU's, times
the kernels beside their plain versions, their bound and one library
call where there is one, and ends with one JSON line::

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

It exits non-zero, printing no result, when a phase fails, when
``torch.cuda.is_available()`` is false, or when the port is not beside it.
It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
D_FEATURES = 1_000_000  # paper width (examples/train_sparse_production.py)
REGIONS = 12  # m: 2m = 24 columns
ALIVE_FRACTION = 0.02  # rows surviving L2,1 pruning (paper Table 2 regime)
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# the card's device memory rate and dense bf16 peak (fp32 sums): the
# port's roofline constants (repro_torch/launch/mesh.py), where it is
# beside this script (main() refuses to run without it)
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_OPS_PER_S
except ImportError:
    HBM_BYTES_PER_S = BF16_OPS_PER_S = None
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
# phase 42 trains SSM_TRAIN_LAYERS of the 64 layers (fp32 AdamW at 64 needs
# ~116 GB); one layer's parameters: norm 4,096, in_proj 4,096 x 16,384,
# conv 4 x 8,192 + 8,192, x_proj 8,192 x 288, dt_proj 256 x 8,192,
# dt_bias, A_log 8,192 x 16, D, out_proj 8,192 x 4,096
SSM_TRAIN_LAYERS = 16
SSM_LAYER_PARAMS = 105_312_256
B7_TOL = 2e-5  # y and hT, tests/test_kernels.py:175
SFU_EXP_PER_S = 16 * 132 * 1.98e9  # 16 a clock per SM (CC 9.0) x 132 SMs
B7_PLAIN_RUNS = 1  # timed runs of the plain scan at S >= 4,096
# the hybrid path: zamba2-2.7b at full width and depth (54 Mamba2 layers,
# d 2,560, d_inner 5,120 in 80 heads of 64, state 64, conv 4, in 9 groups
# of 6, each followed by the one shared attention + MLP block: 32 heads
# of hd 80, d_ff 10,240; vocab 32,000), at the LM path's prompt shapes
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_PARAMS = 2_422_670_240
# the MoE path: granite-moe-1b-a400m at full width and depth (24 layers,
# d 1,024, 16 heads over 8 KV heads, hd 64, 32 experts of d_ff 512, top
# 8, vocab 49,155), likewise
MOE_ARCH = "granite-moe-1b-a400m"
MOE_PARAMS = 1_384_963_072
# phase 22's reduced hybrid: two groups, so the shared caches' group index
# is exercised, and a prompt the SSD chunk (64) divides
HYBRID_CPU = {"over": {"num_layers": 4, "shared_attn_every": 2},
              "prompt_len": 128}
_FUSED = "src/repro_torch/kernels/lsplm_sparse_fused/csrc/lsplm_sparse_fused.cu"
SOURCES = {
    "lsplm_sparse_fused_forward": _FUSED,
    "lsplm_sparse_fused_int8_forward": _FUSED,
    "lsplm_sparse_scatter":
        "src/repro_torch/kernels/lsplm_sparse_scatter/csrc/"
        "lsplm_sparse_scatter.cu",
    "owlqn_direction":
        "src/repro_torch/kernels/owlqn_direction/csrc/owlqn_direction.cu",
    "lsplm_fused_forward":
        "src/repro_torch/kernels/lsplm_fused/csrc/lsplm_fused.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "mamba1_scan": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
    "mamba1_scan_gated_backward":
        "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu",
}
REPLACES = {
    "lsplm_sparse_fused_forward":
        "src/repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py:73",
    "lsplm_sparse_fused_int8_forward":
        "src/repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py:151",
    "lsplm_sparse_scatter":
        "src/repro/kernels/lsplm_sparse_scatter/lsplm_sparse_scatter.py:50",
    "owlqn_direction":
        "src/repro/kernels/owlqn_direction/owlqn_direction.py:23",
    "lsplm_fused_forward": "src/repro/kernels/lsplm_fused/lsplm_fused.py:27",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:29",
    "mamba1_scan": "src/repro/kernels/mamba_scan/mamba_scan.py:32",
    # B7's gradient: the reference's Pallas scan has no VJP, and its model
    # trains through the lax.scan of src/repro/models/ssm.py:64 (:87)
    "mamba1_scan_gated_backward":
        "src/repro/kernels/mamba_scan/mamba_scan.py:32",
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
PHASE2_N, PHASE2_K = (1, 37, 4096), (8, 24, 40, 64, 65, 200)
DEDUP_RUNS = (2, 3, 5, 17)  # runs of equal ids per row, where K allows
# the serving dispatch shapes: (G, user K, candidates a page view, ad K)
DISPATCHES = ((1, 24, 32, 16), (8, 24, 32, 16))


def _batch(rng, n, k, d_rows, pad_every=8):
    """ids/vals with pad slots, runs of 2, 3, 5 and 17 equal ids (those
    that fit), a slot holding the pad id and, for n > 1, one all-pad row."""
    ids = rng.integers(0, d_rows - 1, (n, k)).astype(np.int32)
    start = 0
    for run in DEDUP_RUNS:
        if start + run > k:
            break
        ids[:, start:start + run] = rng.integers(0, d_rows - 1, (n, 1))
        start += run
    ids[:, ::pad_every] = d_rows - 1
    vals = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    if n > 1:
        ids[-1] = d_rows - 1
        vals[-1] = 0.0
    return ids, vals


def _dispatch_batch(torch, dev, rng, g, ku, n, ka, d_rows):
    """One dispatch as the engine builds it: G page views of Ku 12-24 user
    ids and N candidates of Ka 6-12 ids (synthetic_requests' ranges),
    padded to the (ku, ka) envelope with the pad id, and the session ids.
    Returns device tensors (ui, uv, ai, av, session)."""
    ui = np.full((g, ku), d_rows - 1, np.int32)
    uv = np.zeros((g, ku), np.float32)
    ai = np.full((g * n, ka), d_rows - 1, np.int32)
    av = np.zeros((g * n, ka), np.float32)
    for r in range(g):
        k = int(rng.integers(12, min(24, ku) + 1))
        ui[r, :k] = rng.integers(0, d_rows - 1, k)
        uv[r, :k] = rng.normal(size=k) / np.sqrt(k)
    for r in range(g * n):
        k = int(rng.integers(6, min(12, ka) + 1))
        ai[r, :k] = rng.integers(0, d_rows - 1, k)
        av[r, :k] = rng.normal(size=k) / np.sqrt(k)
    session = torch.arange(g, device=dev).repeat_interleave(n)
    return (*(torch.from_numpy(a).to(dev) for a in (ui, uv, ai, av)),
            session)


def _z_ok(z, z_ref):
    return bool(((z - z_ref).abs() <= Z_ATOL + Z_RTOL * z_ref.abs()).all())


def _check_bundles(torch, dev, rng, theta, codes, scales):
    """The bundle addend at the dispatch shapes: ``ops.bundle_forward`` is
    two launches whose z is bitwise ``z_user.index_select(0, session) +
    z_ad`` and whose p is within P_ATOL of ``finalize_p``, for B1 and B4."""
    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES,
        lsplm_sparse_fused_forward,
        lsplm_sparse_fused_int8_forward,
    )

    err = 0.0
    for g, ku, n, ka in DISPATCHES:
        ui, uv, ai, av, session = _dispatch_batch(torch, dev, rng, g, ku, n,
                                                  ka, theta.shape[0])
        for rows, kernel, kw in (
                ((theta,), lsplm_sparse_fused_forward, dict(theta=theta)),
                ((codes, scales), lsplm_sparse_fused_int8_forward,
                 dict(codes=codes, scales=scales))):
            before = sum(LAUNCHES.values())
            p, z = ops.bundle_forward(ui, uv, ai, av, session, **kw)
            check(sum(LAUNCHES.values()) - before == 2,
                  "bundle_forward is not two launches")
            want = (kernel(ui, uv, *rows, dedup=True)[1].index_select(
                0, session) + kernel(ai, av, *rows, dedup=True)[1])
            torch.cuda.synchronize()
            tag = f"G={g} user {tuple(ui.shape)} ad {tuple(ai.shape)}"
            check(torch.equal(z, want),
                  f"{kernel.__name__} addend z is not index_select + add "
                  f"bitwise at {tag}")
            e = float((p - ops.finalize_p(want)).abs().max())
            check(e <= P_ATOL, f"{kernel.__name__} bundle p vs finalize_p "
                  f"at {tag}: {e:.2e}")
            err = max(err, e)
    return err


FAILURES = Path(os.environ.get("CHIP_SMOKE_FAILURES",
                               ROOT / "build" / "failures"))


def _save_case(torch, name: str, *, ids, theta, codes, scales, deq,
               **arrays) -> Path:
    """Save a failed phase-2 case for a replay: its ids and every other
    tensor given, with Theta, the codes, the scales and the dequantised
    rows cut to the rows the ids read (``rows``; the pad row included).
    The directory is ``$CHIP_SMOKE_FAILURES``, else ``build/failures``."""
    rows = torch.unique(torch.cat([ids.reshape(-1), torch.tensor(
        [theta.shape[0] - 1], device=ids.device, dtype=ids.dtype)]))
    cut = {"rows": rows, "ids": ids, "theta_rows": theta[rows.long()],
           "codes_rows": codes[rows.long()],
           "scales_rows": scales[rows.long()], "deq_rows": deq[rows.long()]}
    out = {key: (t.cpu().numpy() if hasattr(t, "cpu") else t)
           for key, t in {**cut, **arrays}.items()}
    FAILURES.mkdir(parents=True, exist_ok=True)
    path = FAILURES / f"{name}.npz"
    np.savez(path, **out)
    return path


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
    for n in PHASE2_N:
        for k in PHASE2_K:
            ids_np, vals_np = _batch(rng, n, k, d_rows)
            ids = torch.from_numpy(ids_np).to(dev)
            vals = torch.from_numpy(vals_np).to(dev)
            z_ref = ops._chunked_zmap(ids, vals, theta)
            p_ref = ops.finalize_p(z_ref)
            zi_ref = ops._chunked_zmap_int8(ids, vals, codes, scales)
            pi_ref = ops.finalize_p(zi_ref)
            pre_ids, pre_vals = ops.dedup_tile_ids(ids, vals, d_rows - 1)
            for dedup in (True, False):
                p, z = lsplm_sparse_fused_forward(ids, vals, theta,
                                                  dedup=dedup)
                pi, zi = lsplm_sparse_fused_int8_forward(
                    ids, vals, codes, scales, dedup=dedup)
                pd, zd = lsplm_sparse_fused_forward(ids, vals, deq,
                                                    dedup=dedup)
                torch.cuda.synchronize()
                tag = f"N={n} K={k} dedup={dedup}"
                check(_z_ok(z, z_ref), f"B1 z vs plain at {tag}")
                check(float((p - p_ref).abs().max()) <= P_ATOL,
                      f"B1 p vs plain at {tag}")
                check(_z_ok(zi, zi_ref), f"B4 z vs plain int8 at {tag}")
                check(float((pi - pi_ref).abs().max()) <= P_ATOL,
                      f"B4 p vs plain int8 at {tag}")
                if not (_z_ok(zi, zd)
                        and float((pi - pd).abs().max()) <= P_ATOL):
                    zd_plain = ops._chunked_zmap(ids, vals, deq)
                    saved = _save_case(
                        torch, f"phase2_b4_vs_b1_n{n}_k{k}_dedup{int(dedup)}",
                        ids=ids, vals=vals, theta=theta, codes=codes,
                        scales=scales, deq=deq, z=z, p=p, zi=zi, pi=pi,
                        zd=zd, pd=pd, zd_plain=zd_plain,
                        dedup=np.array(dedup))
                    check(False, f"B4 vs B1 on the dequantised Theta at "
                          f"{tag}: max |dz| {float((zi - zd).abs().max()):.3e}"
                          f", |dp| {float((pi - pd).abs().max()):.3e}; B1 "
                          f"vs plain on that Theta: max |dz| "
                          f"{float((zd - zd_plain).abs().max()):.3e}; the "
                          f"case is saved to {saved}")
                bitwise &= bool(torch.equal(zi, zd) and torch.equal(pi, pd))
                if dedup:  # the fused dedup is the pre-pass, bit for bit
                    pp, zp = lsplm_sparse_fused_forward(pre_ids, pre_vals,
                                                        theta)
                    ppi, zpi = lsplm_sparse_fused_int8_forward(
                        pre_ids, pre_vals, codes, scales)
                    torch.cuda.synchronize()
                    check(torch.equal(z, zp) and torch.equal(p, pp),
                          f"B1's fused dedup differs from dedup_tile_ids + "
                          f"B1 at {tag}")
                    check(torch.equal(zi, zpi) and torch.equal(pi, ppi),
                          f"B4's fused dedup differs from dedup_tile_ids + "
                          f"B4 at {tag}")
                err["lsplm_sparse_fused_forward"] = max(
                    err["lsplm_sparse_fused_forward"],
                    float((z - z_ref).abs().max()),
                    float((p - p_ref).abs().max()))
                err["lsplm_sparse_fused_int8_forward"] = max(
                    err["lsplm_sparse_fused_int8_forward"],
                    float((zi - zi_ref).abs().max()),
                    float((pi - pi_ref).abs().max()))
    bundle_err = _check_bundles(torch, dev, rng, theta, codes, scales)
    _check_planned_p(torch, theta, *(torch.from_numpy(a).to(dev)
                                     for a in _batch(rng, 37, 24, d_rows)))
    print(f"phase 2: kernels agree with their plain versions at d={d_rows - 1:,}"
          f", 2m={theta.shape[1]}, N in {PHASE2_N}, K in {PHASE2_K} (runs of "
          f"{DEDUP_RUNS} equal ids, pad ids, an all-pad row), dedup on/off "
          f"(z rtol {Z_RTOL}/atol {Z_ATOL}, p atol {P_ATOL}); max |err| fp32 "
          f"{err['lsplm_sparse_fused_forward']:.3e}, "
          f"int8 {err['lsplm_sparse_fused_int8_forward']:.3e}; int8 kernel "
          f"vs fp32 kernel on the dequantised Theta: "
          f"{'bitwise equal' if bitwise else 'within 1e-6, not bitwise'}; "
          f"the fused dedup bitwise equal to dedup_tile_ids + the kernel "
          f"(z and p, B1 and B4, every case); the bundle addend at the "
          f"dispatch shapes {DISPATCHES} (G, Ku, N, Ka): z bitwise "
          f"index_select + add, p vs finalize_p max |err| "
          f"{bundle_err:.2e}, two launches a bundle; planned score_sparse / "
          f"predict_proba_sparse bitwise equal to unplanned and to B1's p, "
          f"planned gradient within rtol 1e-5 / atol 1e-6 of unplanned and "
          f"of the CPU's")
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
    p_b1 = lsplm_sparse_fused_forward(ids, vals, theta, dedup=True)[0]
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


DEDUP_OPS = ("sort", "catarray")  # kernels only the torch pre-pass ran


def _profile_dispatches(torch, art) -> None:
    """Where a dispatch's time goes: host wall per dispatch against the
    device's kernel time (torch.profiler), for G=1 and batched replays,
    with the device launches per dispatch (kernels and copies apart). A
    G=1 dispatch must launch exactly two B1/B4 kernels and no op of the
    torch dedup pre-pass."""
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
        kernels: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kernels.setdefault(e.name, [0.0, 0])
                k[0] += e.time_range.elapsed_us()
                k[1] += 1
        busy_us = sum(v[0] for v in kernels.values())
        if not kernels:
            print(f"  profile {tag}: {wall_us / dispatches:,.0f} us wall per "
                  "dispatch; device time not measured (no device events)")
            continue
        copies = sum(v[1] for name, v in kernels.items()
                     if name.startswith(("Memcpy", "Memset")))
        launches = sum(v[1] for v in kernels.values()) - copies
        ours = sum(v[1] for name, v in kernels.items()
                   if "fused_forward_kernel" in name)
        dedup_ops = sorted(name[:60] for name in kernels
                           if any(op in name.lower() for op in DEDUP_OPS))
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
        print(f"  profile {tag}: {dispatches} dispatches, "
              f"{wall_us / dispatches:,.1f} us wall and "
              f"{busy_us / dispatches:,.1f} us of device work per "
              f"dispatch (device idle {1 - busy_us / wall_us:.1%}); "
              f"{launches / dispatches:g} kernel launches (B1/B4 "
              f"{ours / dispatches:g}) and {copies / dispatches:g} copies per "
              f"dispatch; per dispatch: "
              + "; ".join(f"{name[:60]} x{v[1] / dispatches:g} "
                          f"{v[0] / dispatches:.1f} us" for name, v in top))
        if tag == "G=1":
            check(ours == 2 * dispatches,
                  f"a G=1 dispatch launched {ours / dispatches:g} B1/B4 "
                  "kernels, not 2")
            check(not dedup_ops, f"a G=1 dispatch ran the torch dedup "
                  f"pre-pass: {dedup_ops}")


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


def _bundle_bound(torch, ui, ai, pad_id, row_bytes, m2, ops_per_elem):
    """The bound of a whole bundle: both sides' ids and vals, the distinct
    live rows of the two sides together, the user rows' z written and
    read back once, the session ids, z and p written; ops at fp32 peak."""
    live = torch.cat([ui[ui != pad_id], ai[ai != pad_id]])
    rows = int(torch.unique(live).numel())
    g, b = ui.shape[0], ai.shape[0]
    nbytes = ((ui.numel() + ai.numel()) * 8 + rows * row_bytes
              + 2 * g * m2 * 4 + b * 8 + b * (m2 + 1) * 4)
    ops = int(live.numel()) * m2 * ops_per_elem + b * m2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _dispatch_times(torch, dev, rng, theta, codes, scales, flush):
    """B1 and B4 at the serving dispatch shapes, dedup on: the bundle as
    the card path runs it now (``ops.bundle_forward``, two launches)
    against PR 17's composition of the same function in the same call
    (``dedup_tile_ids`` and the kernel on each side, index_select, add,
    ``finalize_p``), the plain versions and the bound."""
    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        lsplm_sparse_fused_forward,
        lsplm_sparse_fused_int8_forward,
    )

    d_rows, m2 = theta.shape
    pad = d_rows - 1
    out = {}
    one = torch.zeros(1, device=dev)
    floor_ms = _time_ms(torch, lambda: one.add_(1.0), flush)
    print(f"phase 4: launch floor: one 1-element add_ timed the same way "
          f"takes {floor_ms:.4f} ms")
    for g, ku, n, ka in DISPATCHES:
        ui, uv, ai, av, session = _dispatch_batch(torch, dev, rng, g, ku, n,
                                                  ka, d_rows)
        for name, kernel, rows, kw, plain_z, row_bytes, per in (
                ("lsplm_sparse_fused_forward", lsplm_sparse_fused_forward,
                 (theta,), dict(theta=theta),
                 lambda i, v: ops._chunked_zmap(i, v, theta), m2 * 4, 2),
                ("lsplm_sparse_fused_int8_forward",
                 lsplm_sparse_fused_int8_forward, (codes, scales),
                 dict(codes=codes, scales=scales),
                 lambda i, v: ops._chunked_zmap_int8(i, v, codes, scales),
                 m2 + 4, 3)):

            def composition(kernel=kernel, rows=rows):
                z_user = kernel(*ops.dedup_tile_ids(ui, uv, pad), *rows)[1]
                z_ad = kernel(*ops.dedup_tile_ids(ai, av, pad), *rows)[1]
                return ops.finalize_p(z_user.index_select(0, session) + z_ad)

            bound_ms, bound_by = _bundle_bound(torch, ui, ai, pad, row_bytes,
                                               m2, per)
            row = {"dispatch": f"G={g}", "n": ai.shape[0], "k": ka,
                   "user": list(ui.shape), "ad": list(ai.shape),
                   "ms": _time_ms(torch, lambda kw=kw: ops.bundle_forward(
                       ui, uv, ai, av, session, **kw), flush),
                   "composition_ms": _time_ms(torch, composition, flush),
                   "plain_ms": _time_ms(torch, lambda plain_z=plain_z: (
                       ops.finalize_p(plain_z(ui, uv).index_select(0, session)
                                      + plain_z(ai, av))), flush),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "launch_floor_ms": floor_ms}
            out.setdefault(name, []).append(row)
            print(f"phase 4: {name} bundle G={g}, user {tuple(ui.shape)}, ad "
                  f"{tuple(ai.shape)}, dedup on: fused (2 launches) "
                  f"{row['ms']:.4f} ms, PR 17's composition (torch dedup + "
                  f"kernel, index_select, add, head) "
                  f"{row['composition_ms']:.4f} ms in the same call, plain "
                  f"{row['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by}, {bound_ms / row['ms']:.1%} of it reached; "
                  f"the composition {bound_ms / row['composition_ms']:.1%})"
                  f", library n/a (no single PyTorch call)")
    return out


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
                dedup=lambda: lsplm_sparse_fused_forward(ids, vals, theta,
                                                         dedup=True),
                plain=lambda: ops.finalize_p(
                    ops._chunked_zmap(ids, vals, theta)),
                library=lambda: F.embedding_bag(
                    ids, theta, per_sample_weights=vals, mode="sum",
                    padding_idx=d_rows - 1),
                bound=_bound(torch, ids, d_rows - 1, m2 * 4, m2, 2)),
            "lsplm_sparse_fused_int8_forward": dict(
                kernel=lambda: lsplm_sparse_fused_int8_forward(
                    ids, vals, codes, scales),
                dedup=lambda: lsplm_sparse_fused_int8_forward(
                    ids, vals, codes, scales, dedup=True),
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
                "dedup_ms": _time_ms(torch, c["dedup"], flush),
                "plain_ms": _time_ms(torch, c["plain"], flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": (None if c["library"] is None
                               else _time_ms(torch, c["library"], flush)),
            }
            out.setdefault(name, []).append(row)
            lib = ("n/a" if row["library_ms"] is None
                   else f"{row['library_ms']:.4f} ms (embedding_bag, "
                        f"max |dz| vs plain {lib_err:.1e})")
            print(f"phase 4: {name} N={n} K={k}: kernel {row['ms']:.4f} ms "
                  f"(with the in-kernel dedup {row['dedup_ms']:.4f} ms), "
                  f"plain {row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}, {row['bound_ms'] / row['ms']:.1%} of it "
                  f"reached), library {lib}")
    for name, rows in _dispatch_times(torch, dev, rng, theta, codes, scales,
                                      flush).items():
        out[name] += rows
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
    """B2 against its plain versions on the card: bitwise
    ``scatter_runs_ref`` (B2's association), within B2_REL of the summed
    |terms| of the class gathers, bitwise repeatable, untouched and pad
    rows exactly 0, its run tickets back at 0. Returns the max abs error
    against the class gathers."""
    from repro_torch.kernels.lsplm_sparse_scatter import lsplm_sparse_scatter
    from repro_torch.kernels.lsplm_sparse_scatter.ref import scatter_runs_ref

    got = sops.scatter_add_planned(plan, vals, dz)
    again = sops.scatter_add_planned(plan, vals, dz)
    runs = scatter_runs_ref(plan, vals, dz, plan.num_rows)
    plain = sops._compact_classes(plan, vals, dz).index_select(
        0, plan.inv_compact)
    scale = sops._compact_classes(plan, vals.abs(), dz.abs()).index_select(
        0, plan.inv_compact)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"B2 not bitwise repeatable ({tag})")
    check(torch.equal(got, runs),
          f"B2 differs from scatter_runs_ref ({tag}): max |diff| "
          f"{float((got - runs).abs().max()):.3e}")
    check(not any(bool(t.any())
                  for t in lsplm_sparse_scatter._TICKETS.values()),
          f"B2 left a run ticket set ({tag})")
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


def _check_b3(torch, theta, grad, lam, beta, tag, exact=False) -> float:
    """B3 against its plain version on the same inputs: within rtol
    B3_RTOL/atol B3_ATOL (``exact``: bit for bit), zero pattern equal.
    Returns the max abs error."""
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
    err = float((got - want).abs().max())
    check(not exact or err == 0.0,
          f"B3 not bitwise its plain version at {tag}: max |err| {err:.3e}")
    return err


def _b1_at_training_shapes(torch, batches, theta):
    """B1 against its plain version at the shapes the training path gives
    it: both id tensors of each batch, with the in-kernel dedup as the
    main path runs it (and bitwise the ``dedup_tile_ids`` pre-pass
    followed by B1), on the padded Theta. Returns (max abs error, the
    shapes checked)."""
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
            p, z = lsplm_sparse_fused_forward(ids, vals, tp, dedup=True)
            pp, zp = lsplm_sparse_fused_forward(
                *ops.dedup_tile_ids(ids, vals, pad), tp)
            z_ref = ops._chunked_zmap(ids, vals, tp)
            p_ref = ops.finalize_p(z_ref)
            torch.cuda.synchronize()
            where = f"{tag} {side} ids {tuple(ids.shape)}"
            check(torch.equal(z, zp) and torch.equal(p, pp),
                  f"B1's fused dedup differs from the pre-pass at the {where}")
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
          f"({', '.join(shapes)}; u**10 Zipf ids, the in-kernel dedup, "
          f"bitwise the pre-pass + B1; the driver's dense Theta0): z rtol "
          f"{Z_RTOL}/atol {Z_ATOL}, p atol {P_ATOL}; "
          f"max |err| {e:.3e}")
    rng = np.random.default_rng(SEED + 7)
    err = {"lsplm_sparse_fused_forward": e,
           "lsplm_sparse_scatter": 0.0, "owlqn_direction": 0.0}
    lines = []
    for side, ids, vals, plan in (
            ("user", train.user_ids, train.user_vals, train.user_plan),
            ("ad", train.ad_ids, train.ad_vals, train.ad_plan)):
        dz = torch.from_numpy(rng.normal(size=(vals.shape[0], 2 * REGIONS))
                              .astype(np.float32)).to(dev)
        e = _check_scatter(torch, sops, plan, vals, dz, f"{side} side")
        unplanned = sops.scatter_add_unplanned(ids, vals, dz, plan.num_rows,
                                               plan.num_rows - 1)
        check(torch.equal(unplanned, sops.scatter_add_planned(plan, vals, dz)),
              f"B2 on the card-sorted entries differs from the plan's "
              f"({side} side)")
        err["lsplm_sparse_scatter"] = max(err["lsplm_sparse_scatter"], e)
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
        err["lsplm_sparse_scatter"] = max(err["lsplm_sparse_scatter"], e)
        lines.append(f"{tag} max|err| {e:.2e}")
    print("phase 5: B2 (run-length dTheta scatter, the dense dTheta) bitwise "
          "scatter_runs_ref and vs the plain class gathers on the card, "
          f"|err| <= {B2_REL} x sum|terms| + {B2_ABS}, bitwise repeatable, "
          "pad and untouched rows exactly 0, the card-sorted (unplanned) "
          "layout bitwise equal: " + "; ".join(lines))

    lines = []
    # the sparse and the dense training paths' shapes and weights
    pairs = ((0.5, 0.3), (0.0, 0.3), (0.2, 0.0), (LAM, BETA),
             (DENSE_LAM, DENSE_BETA))
    for d_rows in (1000, D_FEATURES, DENSE_D):
        for m2 in (2 * REGIONS, 70):
            theta_np, grad_np = _direction_inputs(rng, d_rows, m2)
            theta = torch.from_numpy(theta_np).to(dev)
            grad = torch.from_numpy(grad_np).to(dev)
            for lam, beta in pairs:
                err["owlqn_direction"] = max(
                    err["owlqn_direction"],
                    _check_b3(torch, theta, grad, lam, beta,
                              f"D={d_rows:,} 2m={m2}", exact=True))
            lines.append(f"D={d_rows:,} 2m={m2}")
    print(f"phase 5: B3 (Eq. 9 direction) bitwise its plain version on the "
          f"card at {', '.join(lines)}, {len(pairs)} (lam, beta) pairs, with "
          f"exact zeros, -0.0 and zero rows, zero pattern equal; max |err| "
          f"{err['owlqn_direction']:.2e}")
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
    prof = _profile_step(torch, opt, theta)
    # a kernel that writes the dense dTheta takes at least its write bound
    # (the gather that densified the compact design's result took ~0.6 ms)
    dense_write_us = D_FEATURES * 2 * REGIONS * 4 / HBM_BYTES_PER_S * 1e6
    check(prof is not None, "the profiled step showed no device time")
    gathers = {name: us for name, us in prof["gather_us"].items()
               if us >= dense_write_us}
    check(not gathers, f"a gather as long as a dTheta write "
                       f"({dense_write_us:.1f} us) in the profiled step: "
                       f"{gathers}")
    check(prof["launches"] <= STEP_LAUNCHES,
          f"the profiled step made {prof['launches']} launches (at most "
          f"{STEP_LAUNCHES}: the compact design's 215 less each side's vals "
          f"and densify gathers)")
    print(f"  the profiled step: {prof['device_us'] / 1e3:.3f} ms of device "
          f"in {prof['launches']} launches, {prof['wall_us'] / 1e3:.2f} ms "
          f"of wall; no gather writes dTheta (longest gather "
          f"{max(prof['gather_us'].values(), default=0.0):.1f} us against "
          f"the {dense_write_us:.1f} us a dTheta write takes at least)")

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


SPARSE_STEP_KERNELS = ("fused_forward_kernel", "scatter_runs_kernel",
                       "owlqn_direction")
STEP_LAUNCHES = 211  # most launches of the profiled sparse OWLQN+ step


def _device_profile(torch, fn, longest=None):
    """Run ``fn`` once under torch.profiler, synchronised. Returns (its
    result, host wall in us, {device kernel name: [us, launches]}); fills
    ``longest`` (when given) with {name: the longest single launch, us}."""
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
            if longest is not None:
                longest[e.name] = max(longest.get(e.name, 0.0),
                                      e.time_range.elapsed_us())
    return out, wall_us, kernels


def _profile_step(torch, opt, theta, labels=SPARSE_STEP_KERNELS):
    """Where one OWLQN+ step's time goes (torch.profiler): host wall
    against the device's kernel time, the hand-written kernels (device
    events whose names hold one of ``labels``) and the top kernels.
    Returns {wall_us, device_us, launches, longest_us (per kernel name, its
    longest launch), gather_us (the same for gathers)}, or None when the
    profiler saw no device event."""
    state, _ = opt.step(opt.init(theta))  # a history pair for the next
    longest = {}
    (state, stats), wall_us, kernels = _device_profile(
        torch, lambda: opt.step(state), longest)
    busy_us = sum(v[0] for v in kernels.values())
    if not kernels:
        print(f"  profile of one OWLQN+ step: {wall_us / 1e3:.2f} ms wall; "
              "device time not measured (no device events)")
        return None
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
    return {"wall_us": wall_us, "device_us": busy_us,
            "launches": sum(v[1] for v in kernels.values()),
            "longest_us": longest,
            "gather_us": {n: us for n, us in longest.items()
                          if "gather" in n or "indexSelect" in n}}


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
    a dense ``index_add_``); the densify gather of B2's former compact
    design and B3's warp-per-row design timed in the same call."""
    import torch.nn.functional as F

    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        lsplm_sparse_fused_forward,
    )
    from repro_torch.kernels.lsplm_sparse_scatter import ops as sops
    from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
        lsplm_sparse_scatter,
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
        ki, kv = ops.dedup_tile_ids(ids, vals, pad)  # PR 17's main path
        bound_ms, bound_by = _bound(torch, ki, pad, m2 * 4, m2, 2)
        row = {"side": side, "n": ids.shape[0], "k": ids.shape[1],
               "ms": _time_ms(torch, lambda: lsplm_sparse_fused_forward(
                   ids, vals, tp, dedup=True), flush),
               "prededup_ms": _time_ms(
                   torch, lambda: lsplm_sparse_fused_forward(ki, kv, tp),
                   flush),
               "composition_ms": _time_ms(
                   torch, lambda: lsplm_sparse_fused_forward(
                       *ops.dedup_tile_ids(ids, vals, pad), tp), flush),
               "plain_ms": _time_ms(torch, lambda: ops.finalize_p(
                   ops._chunked_zmap(ki, kv, tp)), flush),
               "library_ms": _time_ms(torch, lambda: F.embedding_bag(
                   ki, tp, per_sample_weights=kv, mode="sum",
                   padding_idx=pad), flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        out.setdefault("lsplm_sparse_fused_forward", []).append(row)
        print(f"phase 8: lsplm_sparse_fused_forward training {side} side "
              f"(N={row['n']:,} K={row['k']}, Theta0): kernel with the "
              f"in-kernel dedup {row['ms']:.4f} ms (PR 17's main path, "
              f"dedup_tile_ids + kernel: {row['composition_ms']:.4f} ms; "
              f"the kernel alone on pre-deduplicated ids "
              f"{row['prededup_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms"
              f", bound "
              f"{bound_ms:.4f} ms ({bound_by}, "
              f"{bound_ms / row['ms']:.1%} of it reached), library "
              f"{row['library_ms']:.4f} ms (embedding_bag)")
    for side, vals, plan in (("ad", train.ad_vals, train.ad_plan),
                             ("user", train.user_vals, train.user_plan)):
        n, e, u = vals.shape[0], plan.num_kept, plan.num_unique
        p, rows = plan.piece_run.numel(), plan.num_rows
        dz = torch.from_numpy(rng.normal(size=(n, m2)).astype(np.float32)
                              ).to(dev)
        flat = vals.reshape(-1)
        vals_sorted = flat.index_select(0, plan.order)
        row_ids = plan.row_ids.long()
        # the former compact design's densify: its (U+1, 2m) result,
        # gathered through inv_sorted into the dense dTheta (its last row is
        # the zero row)
        compact = torch.zeros((u + 1, m2), device=dev)
        compact[:u] = torch.from_numpy(
            rng.normal(size=(u, m2)).astype(np.float32)).to(dev)

        def kernel():
            return lsplm_sparse_scatter(plan, flat, dz)

        def library():
            return torch.zeros((rows, m2), device=dev).index_add_(
                0, row_ids,
                vals_sorted[:, None] * dz.index_select(0, plan.sample_sorted))

        lib_err = float((library() - kernel()).abs().max())
        # each input read once, the dense output written once: the entries
        # (order, sample, vals), dz, inv_sorted, the piece and task tables
        # and a row id per piece
        nbytes = (rows * m2 * 4 + e * 12 + n * m2 * 4 + rows * 4
                  + (2 * p + u + plan.task_piece_start.numel() + 2) * 4
                  + p * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = e * m2 * 2 / FP32_OPS_PER_S
        zeros = torch.empty((rows, m2), device=dev)
        row = {"side": side, "entries": e, "unique": u, "n": n, "rows": rows,
               "ms": _time_ms(torch, kernel, flush),
               "write_floor_ms": _time_ms(torch, zeros.zero_, flush),
               "densify_ms": _time_ms(
                   torch, lambda: compact.index_select(0, plan.inv_sorted),
                   flush),
               "plain_ms": _time_ms(
                   torch, lambda: sops._compact_classes(
                       plan, vals, dz).index_select(0, plan.inv_compact),
                   flush),
               "library_ms": _time_ms(torch, library, flush),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out.setdefault("lsplm_sparse_scatter", []).append(row)
        print(f"phase 8: lsplm_sparse_scatter {side} side (E'={e:,}, "
              f"U={u:,}, N={n:,}, dense dTheta {rows:,} x {m2}): kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it reached), library "
              f"{row['library_ms']:.4f} ms (dense index_add_, max |diff| vs "
              f"kernel {lib_err:.1e}); the compact design's densify gather "
              f"alone "
              f"(compact.index_select(0, inv_sorted)) {row['densify_ms']:.4f}"
              f" ms in the same call; the dense write alone (zero_ of the "
              f"same shape) {row['write_floor_ms']:.4f} ms")

    theta_np, grad_np = _direction_inputs(rng, D_FEATURES, m2)
    theta = torch.from_numpy(theta_np).to(dev)
    grad = torch.from_numpy(grad_np).to(dev)
    # the same values one float off 16-byte alignment: B3 then runs its
    # warp-per-row design, the one the tiles replaced at 2m = 24
    buf = torch.empty(2 * theta.numel() + 2, device=dev)
    theta_u = buf[1:theta.numel() + 1].view(theta.shape)
    grad_u = buf[theta.numel() + 2:].view(grad.shape)
    theta_u.copy_(theta)
    grad_u.copy_(grad)
    nbytes = 3 * D_FEATURES * m2 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 16 * D_FEATURES * m2 / FP32_OPS_PER_S  # ~16 flops per element
    row = {"d": D_FEATURES, "m2": m2,
           "ms": _time_ms(torch, lambda: owlqn_direction(theta, grad, LAM,
                                                         BETA), flush),
           "warp_design_ms": _time_ms(torch, lambda: owlqn_direction(
               theta_u, grad_u, LAM, BETA), flush),
           "copy_floor_ms": _time_ms(torch, lambda: torch.add(
               theta, grad, out=theta_u), flush),
           "plain_ms": _time_ms(torch, lambda: owlqn_direction_ref(
               theta, grad, LAM, BETA), flush),
           "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    out["owlqn_direction"] = [row]
    print(f"phase 8: owlqn_direction D={D_FEATURES:,} 2m={m2}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
          f"{row['bound_ms'] / row['ms']:.1%} of it reached), library n/a "
          f"(no single PyTorch call); the warp-per-row design it replaced "
          f"(on views one float off alignment) "
          f"{row['warp_design_ms']:.4f} ms in the same call "
          f"({row['bound_ms'] / row['warp_design_ms']:.1%}); the same bytes "
          f"through one torch.add (two reads, one write) "
          f"{row['copy_floor_ms']:.4f} ms")
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
    _profile_step(torch, opt, theta, labels=("owlqn_direction",))

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


def _twin(model, **over):
    """The model's weights under its config with the fields ``over``
    replaced, on its device: shared where the dtype stays (an int8 KV
    cache), copied and widened where it changes (``dtype="float32"``)."""
    import dataclasses

    from repro_torch.models import Transformer

    cfg = dataclasses.replace(model.cfg, **over)
    if cfg.dtype == model.cfg.dtype:
        twin = Transformer(cfg, device="meta")
        twin.load_state_dict(model.state_dict(), assign=True)
    else:
        twin = Transformer(cfg, device=model.device)
        twin.load_state_dict(model.state_dict())
    return twin


# ------------------------------------------------------------ phase 14
LM_KERNELS = ("wgmma_attention_kernel", "fma_attention_kernel")
GEMM_NAMES = ("nvjet", "gemm", "xmma")  # cuBLAS kernels' names hold one


def _is_gemm(name: str) -> bool:
    return any(g in name.lower() for g in GEMM_NAMES)


def _print_profile(title, wall_us, kernels, labels=LM_KERNELS, tag="B6"):
    busy_us = sum(v[0] for v in kernels.values())
    if not kernels:
        print(f"  profile of {title}: {wall_us / 1e3:.2f} ms wall; device "
              "time not measured (no device events)")
        return
    ours = [(n, us, c) for n, (us, c) in kernels.items()
            if any(label in n for label in labels)]
    ours_us = sum(us for _, us, _ in ours)
    gemm_us = sum(us for n, (us, _) in kernels.items() if _is_gemm(n))
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
        if any(label in name for label in labels) or _is_gemm(name):
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
    model32 = _twin(model, dtype="float32")
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
def _embeddings(torch, cfg, rows, n, seed):
    """(rows, n, d) frame or patch embeddings from a numpy seed, at the
    embedding table's scale (N(0, 1) d^-0.5), fp32 on the host."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(
        (rows, n, cfg.d_model), dtype=np.float32) * cfg.d_model ** -0.5))


def _greedy_decode(torch, model, logits, caches, pos, steps, embeds=None):
    """``steps`` decode steps after a prefill of ``pos`` positions whose
    last logits and caches these are, into decode buffers of pos + steps
    slots in the model's activation dtype (``fill_caches``, as
    ``generate``, whose caches are bf16): each step feeds the last
    step's argmax, or with ``embeds`` (B, steps, d) its row of them (the
    audio family). Returns the (B, steps) tokens (the argmax of every
    logits, the prefill's first) and each step's logits."""
    from repro_torch.models import decode_step, init_caches
    from repro_torch.models.generate import fill_caches

    B = logits.shape[0]
    dec = fill_caches(init_caches(model.cfg, B, pos + steps,
                                  dtype=getattr(torch, model.cfg.dtype),
                                  device=model.device), caches)
    toks, seen = [logits.argmax(-1).to(torch.int32)], []
    for i in range(steps):
        fed = ({"embed": embeds[:, i]} if embeds is not None
               else {"token": toks[-1]})
        lg, dec = decode_step(model, dec, pos=pos + i, **fed)
        seen.append(lg)
        toks.append(lg.argmax(-1).to(torch.int32))
    return torch.stack(toks[:steps], 1), seen


def phase_lm_card_vs_cpu(torch, dev, arch=LM_ARCH, phase=15, kernel="B6",
                         over=None, prompt_len=96):
    """A reduced ``arch`` (with the fields ``over`` replaced) in fp32 on
    the card (its kernel) and on the CPU (the plain version), on the same
    weights: prefill logits of 2 prompts of ``prompt_len`` positions
    within LM_CPU_TOL and 16 greedy tokens equal (``generate``). A model
    that takes embeddings gets them from a numpy seed: the vlm's prefix
    (``num_prefix_embeds`` patches in front of the tokens) decodes its
    greedy tokens step by step, the audio family prefills frame
    embeddings and decodes 16 more through ``decode_step(embed=)``, each
    step's logits within LM_CPU_TOL and its argmax equal. Returns the CPU
    model, the card's and the prompts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import Transformer, init_model, prefill
    from repro_torch.models.generate import generate

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **(over or {}))
    cpu = init_model(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    card = Transformer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    P, new = cfg.num_prefix_embeds, 16
    prompts = TokenStream(cfg.vocab_size, seed=SEED).batch(
        2, prompt_len - P + 1)["tokens"]
    feed = {"tokens": torch.from_numpy(prompts)}
    if cfg.embeds_in:
        feed = {"embeds": _embeddings(torch, cfg, 2, prompt_len + new,
                                      SEED + phase)}
        prompts, steps = feed["embeds"][:, :prompt_len], \
            feed["embeds"][:, prompt_len:]
        feed["embeds"] = prompts
    elif P:
        feed["prefix_embeds"] = _embeddings(torch, cfg, 2, P, SEED + phase)
    lc, cc = prefill(card, **{k: v.to(dev) for k, v in feed.items()})
    lh, ch = prefill(cpu, **feed)
    err = (lc.cpu() - lh).abs()
    check(bool((err <= LM_CPU_TOL + LM_CPU_TOL * lh.abs()).all()),
          f"reduced {arch} prefill logits, card vs CPU, beyond "
          f"{LM_CPU_TOL}: max |err| {float(err.max()):.3e}")
    if cfg.embeds_in or P:  # decode step by step, each step held
        emb = steps if cfg.embeds_in else None
        tc, sc = _greedy_decode(torch, card, lc, cc, prompt_len, new,
                                None if emb is None else emb.to(dev))
        th, sh = _greedy_decode(torch, cpu, lh, ch, prompt_len, new, emb)
        derr = max(float((a.cpu() - b).abs().max()) for a, b in zip(sc, sh))
        check(all(bool(((a.cpu() - b).abs()
                        <= LM_CPU_TOL + LM_CPU_TOL * b.abs()).all())
                  for a, b in zip(sc, sh)),
              f"reduced {arch} decode logits, card vs CPU, beyond "
              f"{LM_CPU_TOL}: max |err| {derr:.3e}")
        tc = tc.cpu()
        how = (f"{new} decode steps on seeded frame embeddings "
               f"(decode_step(embed=)) within it (max |err| {derr:.3e}), "
               f"argmax equal" if cfg.embeds_in else
               f"after {P} patch embeddings in front of the tokens, {new} "
               f"greedy decode steps within it (max |err| {derr:.3e}) and "
               "tokens equal")
    else:
        tc = generate(card, torch.from_numpy(prompts).to(dev), new,
                      temperature=0.0).cpu()
        th = generate(cpu, torch.from_numpy(prompts), new, temperature=0.0)
        how = f"{new} greedy tokens equal"
    check(torch.equal(tc, th), f"reduced {arch}: greedy tokens differ "
          "between card and CPU")
    print(f"phase {phase}: reduced {arch} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, H {cfg.num_heads} x hd {cfg.resolved_head_dim}, "
          f"family {cfg.family}, fp32) card ({kernel}) vs CPU (plain): "
          f"prefill logits of 2 x {prompt_len} positions max |err| "
          f"{float(err.max()):.3e} (bar {LM_CPU_TOL}); {how}")
    return cpu, card, prompts


# ------------------------------------------------------------ phase 16
def _b6_time_row(torch, dev, rng, flush, B, S, H, kvh, hd, runs, warm,
                 phase):
    """B6 on random bf16 q, k, v of one causal shape beside its plain
    version, its bound and torch's scaled_dot_product_attention (the
    library column only): the row, printed."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ops import plain_attention

    q, k, v = _b6_inputs(torch, dev, rng, B, S, H, kvh, hd, torch.bfloat16)
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
    print(f"phase {phase}: flash_attention {B} x {S:,} x {H} heads (KV "
          f"{kvh}) x {hd}, bf16, causal: kernel {row['ms']:.3f} ms, "
          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} "
          f"ms ({row['bound_by']}, {row['bound_ms'] / row['ms']:.1%} of "
          f"it reached; {2 * B * H * S * S * hd / row['ms'] / 1e9:.1f} "
          f"TFLOP/s), library {row['library_ms']:.3f} ms "
          f"(scaled_dot_product_attention, {row['ms'] / row['library_ms']:.2f}x"
          f" faster than the kernel); median of {runs}")
    return row


def phase_attention_times(torch, dev):
    """B6 at the LM path's shapes (4 x 4,096 and 1 x 32,768, 32 heads
    over 8, hd 64, bf16, causal) and at zamba2-2.7b's (4 x 4,096, 32
    heads, hd 80) beside its plain version, its bound and torch's
    scaled_dot_product_attention (the library column only)."""
    rng = np.random.default_rng(SEED + 16)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    return [_b6_time_row(torch, dev, rng, flush, *shape, 16)
            for shape in ((LM_BATCH, LM_SEQ, 32, 8, 64, TIMED_RUNS,
                           WARM_RUNS),
                          (1, LM_LONG, 32, 8, 64, LONG_RUNS, 1),
                          (LM_BATCH, LM_SEQ, 32, 32, 80, TIMED_RUNS,
                           WARM_RUNS))]


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
    prefill_peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
    model32 = _twin(model, dtype="float32")
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
          f"{LM_LONG / long_s:,.0f} tokens/s; peak memory {peak_gb:.2f} GB "
          f"({prefill_peak_gb:.2f} GB in (a)); B7 launches {launches} "
          f"({total} in the three runs: one per layer per prefill and per "
          "decode step)")
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
        "decode_ms_per_token": decode_ms, "prefill_peak_gb": prefill_peak_gb}


# ------------------------------------------------------------ phase 20
@functools.lru_cache(maxsize=None)
def _sass_dump(lib_path: Path):
    """``cuobjdump -sass`` of a built library (run once a library: it
    takes seconds), or None when cuobjdump is missing or fails."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).with_name(
        "cuobjdump"))
    try:
        return subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None


def _sass_step_block(lib_path: Path, kernel_re: str):
    """The straight-line SASS block of B7 that holds the most MUFU.EX2
    (the scan of one group of steps), from ``cuobjdump -sass`` of the
    built library, for the kernel whose mangled name matches
    ``kernel_re``: (its instruction count, {mnemonic: count}), or None
    when cuobjdump is missing or nothing matches."""
    sass = _sass_dump(lib_path)
    if sass is None:
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
        # the plain scan at S >= 4,096 is a host loop of S steps: timed
        # once, without a warm-up run (its first call is no faster)
        for B, S, h0, runs, plain_runs, plain_warm in (
                (LM_BATCH, LM_SEQ, False, TIMED_RUNS, B7_PLAIN_RUNS, 0),
                (1, LM_LONG, False, LONG_RUNS, B7_PLAIN_RUNS, 0),
                (LM_BATCH, 1, True, TIMED_RUNS, TIMED_RUNS, 1)):
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
                                        plain_runs, plain_warm),
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


# ------------------------------------------------------------ phase 21
def _first_attention_inputs(torch, model, tokens=None, **feed):
    """The first full-sequence attention call's q, k, v for ``tokens``
    (or the embeddings in ``feed``), as the model makes them (layer 0's,
    or the hybrid's shared block in group 0): one prefill with
    ``attention_ops.causal_attention`` wrapped to keep its first call's
    arguments (every call still runs the kernel)."""
    from repro_torch.models import prefill, transformer

    seen = []
    attention = transformer.attention_ops.causal_attention

    def keep_first(q, k, v, **kw):
        if not seen:
            seen.append((q, k, v))
        return attention(q, k, v, **kw)

    transformer.attention_ops.causal_attention = keep_first
    try:
        prefill(model, tokens=tokens, **feed)
    finally:
        transformer.attention_ops.causal_attention = attention
    return seen[0]


def _with_plain_attention(fn):
    """``fn()`` with B6's plain version in place of the model's attention
    hook (``transformer.attention_ops.causal_attention``) for this one
    call."""
    from repro_torch.kernels.flash_attention.ops import plain_attention
    from repro_torch.models import transformer

    b6_attention = transformer.attention_ops.causal_attention
    transformer.attention_ops.causal_attention = plain_attention
    try:
        return fn()
    finally:
        transformer.attention_ops.causal_attention = b6_attention


def _serving_runs(torch, model, prompts, long_prompt, warm):
    """The LM main path's three runs on ``model``, B6's count set to 0
    just before and read after each: (a) prefill of ``prompts``, (b)
    greedy generate of LM_NEW tokens after it (its own prefill
    included), (c) prefill of ``long_prompt``; after one first-use
    prefill of ``warm``. Returns {run: launches}, the outputs and the
    host seconds of each run, and the peak memory in GB."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )
    from repro_torch.models import prefill
    from repro_torch.models.generate import generate

    prefill(model, tokens=warm)  # first use: cuBLAS handles, modules
    torch.cuda.synchronize()
    runs = {"prefill": lambda: prefill(model, tokens=prompts),
            "generate": lambda: generate(model, prompts, LM_NEW,
                                         temperature=0.0),
            "prefill_32k": lambda: prefill(model, tokens=long_prompt)}
    launches, outs, secs = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for run, fn in runs.items():
        _reset((B6,))
        t0 = time.perf_counter()
        outs[run] = fn()
        torch.cuda.synchronize()
        secs[run] = time.perf_counter() - t0
        launches[run] = B6["flash_attention"]
    return launches, outs, secs, torch.cuda.max_memory_allocated() / 1e9


def _check_serving_outputs(torch, cfg, outs, launches, per_prefill):
    """Gates every serving phase shares: B6 ``per_prefill`` times in each
    run (decode attention is plain PyTorch, as in the reference),
    finite logits of the right shapes, tokens in range, and the first
    greedy token the prefill logits' argmax."""
    logits, _ = outs["prefill"]
    out = outs["generate"]
    long_logits, _ = outs["prefill_32k"]
    for run, count in launches.items():
        check(count == per_prefill, f"B6 launched {count} times in {run}, "
              f"not {per_prefill}")
    check(logits.shape == (LM_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          "prefill logits have the wrong shape or are not finite")
    check(out.shape == (LM_BATCH, LM_NEW) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size,
          "generated tokens have the wrong shape or are out of range")
    check(torch.equal(out[:, 0], logits.argmax(-1).to(out.dtype)),
          "the first greedy token is not the prefill logits' argmax")
    check(long_logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(long_logits.float()).all()),
          "32k prefill logits have the wrong shape or are not finite")


def _timed_decode(torch, model, dec, tok, pos):
    """LM_NEW // 2 greedy decode steps from ``dec`` at positions pos + 1,
    ...: (ms per token, host wall, the last token, the caches)."""
    from repro_torch.models import decode_step

    steps = LM_NEW // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        lg, dec = decode_step(model, dec, token=tok, pos=pos + i)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, tok, dec


def _main_path_line(phase, what, arch, n_params, setup_s, secs, peak_gb,
                    launches, per):
    print(f"phase {phase}: {what} main path ({arch}, {n_params:,} "
          f"parameters, bf16 weights from a seeded torch.Generator, set-up "
          f"{setup_s:.2f} s): (a) prefill {LM_BATCH} x {LM_SEQ:,} in "
          f"{secs['prefill'] * 1e3:.1f} ms = "
          f"{LM_BATCH * LM_SEQ / secs['prefill']:,.0f} tokens/s; (b) greedy "
          f"generate of {LM_NEW} tokens after it in "
          f"{secs['generate']:.2f} s (its prefill included), tokens in "
          f"range; (c) prefill 1 x {LM_LONG:,} in "
          f"{secs['prefill_32k']:.2f} s = "
          f"{LM_LONG / secs['prefill_32k']:,.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB; B6 launches {launches} "
          f"({sum(launches.values())} in all, {per})")


def phase_hybrid_lm(torch, dev):
    """The hybrid serving path at full width and depth: zamba2-2.7b from
    a seeded torch.Generator, prompts from the token stream; (a) prefill
    4 x 4,096, (b) greedy generate of 32 tokens after it, (c) prefill 1
    x 32,768. B6 launches once per group (the shared block) per prefill.
    Gates: the caches' shapes, B6 against plain on the shared block's
    real q, k, v, and (in fp32, the bf16 runs printed beside them) the
    model with B6 against the model on plain attention and decode after
    prefill against the forward of the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import (
        decode_step,
        forward,
        init_caches,
        init_model,
        prefill,
    )
    from repro_torch.models import transformer

    cfg = get_config(HYBRID_ARCH)
    nl, J = cfg.num_layers, transformer.num_groups(cfg)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == HYBRID_PARAMS, f"{HYBRID_ARCH} has {n_params:,} "
          f"parameters, not {HYBRID_PARAMS:,}")
    stream = TokenStream(cfg.vocab_size, seed=SEED)
    # the handoff gate's forward runs LM_SEQ + one chunk: the SSD needs a
    # length the chunk divides, so decode of token LM_SEQ is held against
    # the forward of LM_SEQ + ssd_chunk tokens at that position
    ext = torch.from_numpy(stream.batch(
        LM_BATCH, LM_SEQ + cfg.ssd_chunk + 1)["tokens"]).to(dev)
    prompts = ext[:, :LM_SEQ]
    long_prompt = torch.from_numpy(
        stream.batch(1, LM_LONG + 1)["tokens"]).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    launches, outs, secs, peak_gb = _serving_runs(
        torch, model, prompts, long_prompt, prompts[:, :SSM_SHORT])
    _check_serving_outputs(torch, cfg, outs, launches, J)
    logits, caches = outs["prefill"]
    K, N, p = cfg.ssm_conv, cfg.ssm_state, cfg.ssm_headdim
    want = {"conv": ((nl, LM_BATCH, K - 1, cfg.d_inner + 2 * N),
                     torch.bfloat16),
            "ssm": ((nl, LM_BATCH, cfg.d_inner // p, p, N), torch.float32),
            "k": ((J, LM_BATCH, LM_SEQ, cfg.num_kv_heads,
                   cfg.resolved_head_dim), torch.bfloat16)}
    want["v"] = want["k"]
    for name, (shape, dtype) in want.items():
        check(tuple(caches[name].shape) == shape
              and caches[name].dtype == dtype,
              f"prefill cache {name} is {tuple(caches[name].shape)} "
              f"{caches[name].dtype}, not {shape} {dtype}")
    check(not torch.equal(caches["k"][0], caches["k"][J - 1]),
          "the shared block's k of the first and last group are equal")
    check(bool(torch.isfinite(outs["prefill_32k"][1]["ssm"]).all()),
          "32k prefill states are not finite")
    del outs

    # B6 against plain on the shared block's q, k, v of group 0 at (a)
    q, k, v = _first_attention_inputs(torch, model, prompts)
    b6_err = _check_b6(torch, q, k, v, True, "the shared block's q, k, v "
                       f"(group 0, {LM_BATCH} x {LM_SEQ:,})")
    del q, k, v
    # the whole model with B6's plain version in every group, and both
    # against the same weights in fp32: gated in fp32, printed in bf16
    # (B6 rounds P to bf16 for its P.V product, plain attention does not;
    # 54 bf16 Mamba2 layers carry that past the bar on their own
    # rounding, as phase 18's 64 carry a decode step's)
    plain_logits, _ = _with_plain_attention(
        lambda: prefill(model, tokens=prompts))
    perr16, pbar16 = _within(torch, logits, plain_logits, LM_TOL)
    agree16 = float((logits.argmax(-1) == plain_logits.argmax(-1)).float()
                    .mean())
    model32 = _twin(model, dtype="float32")
    logits32, caches32 = prefill(model32, tokens=prompts)
    plain32, _ = _with_plain_attention(
        lambda: prefill(model32, tokens=prompts))
    perr, pbar = _within(torch, logits32, plain32, LM_TOL)
    check(pbar <= 1.0, f"fp32 prefill logits with B6 differ from plain "
          f"attention's beyond rtol = atol = {LM_TOL}: max |err| "
          f"{perr:.3e}, {pbar:.2f} of the bar")
    check(torch.equal(logits32.argmax(-1), plain32.argmax(-1)),
          "fp32 prefill argmax differs between B6 and plain attention")
    w_b6 = float((logits.float() - logits32).abs().max())
    w_plain = float((plain_logits.float() - logits32).abs().max())
    del plain32

    # decode of token LM_SEQ after prefill of LM_SEQ tokens against the
    # forward of LM_SEQ + ssd_chunk tokens at position LM_SEQ: gated in
    # fp32, printed in bf16, likewise
    def handoff(m, caches_after_prompt):
        dec = init_caches(m.cfg, LM_BATCH, LM_SEQ + LM_NEW,
                          dtype=caches_after_prompt["conv"].dtype,
                          device=dev)
        for name in dec:
            dec[name][:, :, :caches_after_prompt[name].shape[2]] = \
                caches_after_prompt[name]
        step_logits, dec = decode_step(m, dec, token=ext[:, LM_SEQ],
                                       pos=LM_SEQ)
        hidden, _ = forward(m, tokens=ext, return_hidden=True)
        return (step_logits, transformer.lm_logits(m, hidden[:, LM_SEQ]),
                dec)

    step_logits, fwd_logits, dec = handoff(model, caches)
    del caches
    derr16, dbar16 = _within(torch, step_logits, fwd_logits, LM_TOL)
    step32, fwd32, _ = handoff(model32, caches32)
    del model32, caches32
    torch.cuda.empty_cache()
    derr, dbar = _within(torch, step32, fwd32, LM_TOL)
    check(dbar <= 1.0, f"fp32 decode after prefill differs from the forward "
          f"at position {LM_SEQ:,} beyond rtol = atol = {LM_TOL}: max "
          f"|err| {derr:.3e}, {dbar:.2f} of the bar")
    check(torch.equal(step32.argmax(-1), fwd32.argmax(-1)),
          "fp32 decode after prefill: argmax differs from the forward's")
    dagree = float((step_logits.argmax(-1) == fwd_logits.argmax(-1)).float()
                   .mean())
    w_fwd = float((fwd_logits.float() - fwd32).abs().max())

    decode_ms, tok, dec = _timed_decode(
        torch, model, dec, step_logits.argmax(-1).to(torch.int32), LM_SEQ)
    _main_path_line(21, "hybrid", HYBRID_ARCH, n_params, setup_s, secs,
                    peak_gb, launches, "once per group of "
                    f"{cfg.shared_attn_every} Mamba2 layers per prefill, "
                    f"J = {J}")
    print(f"  caches conv {want['conv'][0]}, ssm {want['ssm'][0]} fp32, "
          f"k/v {want['k'][0]} (slot j the shared block's run in group j);"
          f" B6 vs plain on the shared block's q, k, v (hd "
          f"{cfg.resolved_head_dim}, {cfg.num_heads} heads): max |err| "
          f"{b6_err:.3e} (bar {B6_TOL['bfloat16']}), repeatable; prefill "
          f"logits with B6 vs plain attention in every group: fp32 max "
          f"|err| {perr:.3e} ({pbar:.2f} of the rtol = atol = {LM_TOL} "
          f"bar), argmax equal; bf16 (not gated) max |err| {perr16:.3e} "
          f"({pbar16:.2f} of the bar), argmax agreement {agree16:.0%}, and "
          f"against the fp32 logits: bf16 with B6 {w_b6:.3e}, bf16 with "
          f"plain attention {w_plain:.3e}; decode of token {LM_SEQ + 1:,} "
          "after prefill vs "
          f"the forward of {LM_SEQ + cfg.ssd_chunk:,} tokens at that "
          f"position: fp32 max |err| {derr:.3e} ({dbar:.2f} of the bar), "
          f"argmax equal; bf16 (not gated) max |err| {derr16:.3e} "
          f"({dbar16:.2f} of the bar), argmax agreement {dagree:.0%}, bf16 "
          f"forward vs fp32 forward {w_fwd:.3e}; decode {decode_ms:.2f} "
          f"ms/token at batch {LM_BATCH} (mean of {LM_NEW // 2} greedy "
          "steps, host wall)")
    pos = LM_SEQ + LM_NEW // 2
    _, wall_us, kernels = _device_profile(
        torch, lambda: decode_step(model, dec, token=tok, pos=pos + 1))
    _print_profile("one decode step", wall_us, kernels)
    del dec
    _, wall_us, kernels = _device_profile(
        torch, lambda: prefill(model, tokens=prompts))
    _print_profile(f"one {LM_BATCH} x {LM_SEQ:,} prefill", wall_us, kernels)
    _print_elementwise(kernels, LM_KERNELS)
    del model
    torch.cuda.empty_cache()
    return launches, b6_err, {
        "prefill_tokens_per_s": LM_BATCH * LM_SEQ / secs["prefill"],
        "prefill_32k_tokens_per_s": LM_LONG / secs["prefill_32k"],
        "decode_ms_per_token": decode_ms}


# ------------------------------------------------------------ phase 23
def _recording(module, name, keep):
    """Wrap ``module.name`` so each call's result is also handed to
    ``keep``; returns the original, which the caller puts back."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        keep(out)
        return out

    setattr(module, name, wrapped)
    return fn


def phase_moe_lm(torch, dev):
    """The MoE serving path at full width and depth: granite-moe-1b-a400m
    from a seeded torch.Generator, prompts from the token stream; (a)
    prefill 4 x 4,096, (b) greedy generate of 32 tokens after it, (c)
    prefill 1 x 32,768. B6 launches once per layer per prefill. Gates:
    two prefills of (a) bitwise equal, B6 against plain on layer 0's real
    q, k, v, and the model with B6 against the model on plain attention
    (in bf16 when no token's routing changes between the two, else in
    fp32 with the changes counted)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import (
        decode_step,
        init_caches,
        init_model,
        moe,
        prefill,
    )

    cfg = get_config(MOE_ARCH)
    nl = cfg.num_layers
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == MOE_PARAMS, f"{MOE_ARCH} has {n_params:,} parameters,"
          f" not {MOE_PARAMS:,}")
    stream = TokenStream(cfg.vocab_size, seed=SEED)
    prompts = torch.from_numpy(
        stream.batch(LM_BATCH, LM_SEQ + 1)["tokens"]).to(dev)
    long_prompt = torch.from_numpy(
        stream.batch(1, LM_LONG + 1)["tokens"]).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    launches, outs, secs, peak_gb = _serving_runs(
        torch, model, prompts, long_prompt, prompts[:, :SSM_SHORT])
    _check_serving_outputs(torch, cfg, outs, launches, nl)
    logits, caches = outs["prefill"]
    check(tuple(caches["k"].shape) == (nl, LM_BATCH, LM_SEQ,
                                       cfg.num_kv_heads,
                                       cfg.resolved_head_dim),
          f"prefill caches have shape {tuple(caches['k'].shape)}")
    del outs

    # (a) again, recording each layer's routing and kept assignments:
    # bitwise the first run's logits
    routes, plans = [], []
    route = _recording(moe, "route", lambda out: routes.append(out[1]))
    plan = _recording(moe, "dispatch_plan", lambda out: plans.append(
        int((~out.keep).sum())))
    try:
        again, _ = prefill(model, tokens=prompts)
        torch.cuda.synchronize()
    finally:
        moe.route, moe.dispatch_plan = route, plan
    check(torch.equal(again, logits), "two prefills of the same prompts "
          "give different logits")
    check(len(plans) == nl, f"{len(plans)} MoE dispatches in a prefill, "
          f"not {nl}")
    cap = moe.capacity_for(LM_BATCH * LM_SEQ, cfg.num_experts, cfg.top_k)

    # B6 against plain on layer 0's q, k, v at (a)
    q, k, v = _first_attention_inputs(torch, model, prompts)
    b6_err = _check_b6(torch, q, k, v, True, f"layer 0's q, k, v ("
                       f"{LM_BATCH} x {LM_SEQ:,})")
    del q, k, v

    # the whole model on plain attention: routing changes counted as
    # tokens whose top-k set differs in a layer
    def plain_run(m):
        seen = []
        fn = _recording(moe, "route", lambda out: seen.append(out[1]))
        try:
            out, _ = _with_plain_attention(lambda: prefill(m, tokens=prompts))
        finally:
            moe.route = fn
        return out, seen

    def changed(a, b):
        return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1)
                       .sum()) for x, y in zip(a, b))

    plain_logits, plain_routes = plain_run(model)
    flips16 = changed(routes, plain_routes)
    perr16, pbar16 = _within(torch, logits, plain_logits, LM_TOL)
    agree16 = float((logits.argmax(-1) == plain_logits.argmax(-1)).float()
                    .mean())
    del routes, plain_routes
    if flips16:
        model32 = _twin(model, dtype="float32")
        r32 = []
        fn = _recording(moe, "route", lambda out: r32.append(out[1]))
        try:
            b6_32, _ = prefill(model32, tokens=prompts)
        finally:
            moe.route = fn
        plain32, p32 = plain_run(model32)
        flips = changed(r32, p32)
        del model32, r32, p32
        torch.cuda.empty_cache()
        perr, pbar = _within(torch, b6_32, plain32, LM_TOL)
        argmax_equal = torch.equal(b6_32.argmax(-1), plain32.argmax(-1))
        gated = "fp32"
    else:
        flips, perr, pbar, gated = 0, perr16, pbar16, "bf16"
        argmax_equal = torch.equal(logits.argmax(-1),
                                   plain_logits.argmax(-1))
    check(pbar <= 1.0, f"{gated} prefill logits with B6 differ from plain "
          f"attention's beyond rtol = atol = {LM_TOL}: max |err| "
          f"{perr:.3e}, {pbar:.2f} of the bar")
    check(argmax_equal, f"{gated} prefill argmax differs between B6 and "
          "plain attention")

    dec = init_caches(cfg, LM_BATCH, LM_SEQ + LM_NEW, device=dev)
    for name in dec:
        dec[name][:, :, :LM_SEQ] = caches[name]
    del caches
    decode_ms, tok, dec = _timed_decode(
        torch, model, dec, logits.argmax(-1).to(torch.int32), LM_SEQ - 1)
    _main_path_line(23, "MoE", MOE_ARCH, n_params, setup_s, secs, peak_gb,
                    launches, "one per layer per prefill")
    print(f"  {cfg.num_experts} experts, top {cfg.top_k}, capacity {cap:,} "
          f"at {LM_BATCH} x {LM_SEQ:,} tokens; dropped assignments per "
          f"layer in (a): {plans} ({sum(plans):,} of "
          f"{nl * LM_BATCH * LM_SEQ * cfg.top_k:,}); a second prefill of "
          f"(a) bitwise equal; B6 vs plain on layer 0's q, k, v: max |err| "
          f"{b6_err:.3e} (bar {B6_TOL['bfloat16']}), repeatable; prefill "
          f"logits with B6 vs plain attention in every layer: bf16 max "
          f"|err| {perr16:.3e} ({pbar16:.2f} of the rtol = atol = {LM_TOL} "
          f"bar), argmax agreement {agree16:.0%}, with {flips16:,} "
          f"(token, layer) routings changed of {nl * LM_BATCH * LM_SEQ:,}; "
          + (f"so gated in fp32: max |err| {perr:.3e} ({pbar:.2f} of the "
             f"bar), argmax equal, {flips:,} routings changed; "
             if gated == "fp32" else "gated there, argmax equal; ")
          + f"decode {decode_ms:.2f} ms/token at batch {LM_BATCH} (mean of "
          f"{LM_NEW // 2} greedy steps, host wall)")
    pos = LM_SEQ - 1 + LM_NEW // 2
    _, wall_us, kernels = _device_profile(
        torch, lambda: decode_step(model, dec, token=tok, pos=pos + 1))
    _print_profile("one decode step", wall_us, kernels)
    del dec
    _, wall_us, kernels = _device_profile(
        torch, lambda: prefill(model, tokens=prompts))
    _print_profile(f"one {LM_BATCH} x {LM_SEQ:,} prefill", wall_us, kernels)
    _print_elementwise(kernels, LM_KERNELS)
    del model
    torch.cuda.empty_cache()
    return launches, b6_err, {
        "prefill_tokens_per_s": LM_BATCH * LM_SEQ / secs["prefill"],
        "prefill_32k_tokens_per_s": LM_LONG / secs["prefill_32k"],
        "decode_ms_per_token": decode_ms,
        "dropped_per_layer": plans}


# ------------------------------------------------------------ phase 24
def phase_moe_card_vs_cpu(torch, dev):
    """Phase 15's check on a reduced granite-moe-1b-a400m, with each MoE
    dispatch's kept assignments recorded on both sides and held equal;
    then layer 0's experts on the prompts' embeddings at a tight capacity
    (factor 0.25, where assignments are dropped) on both sides: the same
    drops, outputs within LM_CPU_TOL."""
    from repro_torch.models import moe, transformer

    kept = {"cuda": [], "cpu": []}
    plan = _recording(moe, "dispatch_plan", lambda out: kept[
        out.keep.device.type].append(out.keep.cpu()))
    try:
        cpu, card, prompts = phase_lm_card_vs_cpu(torch, dev, MOE_ARCH, 24)
        tight = {}
        for name, m in (("cpu", cpu), ("cuda", card)):
            x = transformer.embed_tokens(m, torch.from_numpy(prompts))
            tight[name] = moe.moe_ffn(x, m.layers[0].ffn, m.cfg,
                                      capacity_factor=0.25)[0].cpu()
    finally:
        moe.dispatch_plan = plan
    check(len(kept["cuda"]) == len(kept["cpu"]) > 0
          and all(torch.equal(a, b) for a, b in zip(kept["cuda"],
                                                    kept["cpu"])),
          "the card and the CPU keep different MoE assignments")
    drops = int((~kept["cpu"][-1]).sum())
    check(drops > 0, "the tight-capacity dispatch dropped nothing")
    err = (tight["cuda"] - tight["cpu"]).abs()
    check(bool((err <= LM_CPU_TOL + LM_CPU_TOL * tight["cpu"].abs()).all()),
          f"tight-capacity MoE outputs, card vs CPU, beyond {LM_CPU_TOL}: "
          f"max |err| {float(err.max()):.3e}")
    print(f"  the same kept assignments on both sides in all "
          f"{len(kept['cpu'])} dispatches ("
          f"{sum(int((~k).sum()) for k in kept['cpu'][:-1])} dropped by the "
          f"model's); layer 0's experts at capacity factor 0.25: the same "
          f"{drops} of {kept['cpu'][-1].numel()} assignments dropped, "
          f"outputs max |err| {float(err.max()):.3e} (bar {LM_CPU_TOL})")


# ------------------------------------------------------------ phase 25
# the streaming path: the --sparse phase's width and weights, 8 days of
# 4,000 sessions x 4 ads with the paper path's K (24 user, 12 ad ids),
# window 2, 5 inner iterations, drift 0.02, the "reset" history policy
STREAM_DAYS, STREAM_WINDOW, STREAM_INNER = 8, 2, 5
STREAM_DRIFT = 0.02
STREAM_K = (24, 12)
STREAM_GATE_D, STREAM_GATE_SESSIONS = 50_000, 1000  # phase 26's stream
DEMO = dict(d=400, m=4, days=6, sessions=192, k=(8, 5), drift=0.06,
            lam=0.25)  # the reference's streaming NLL gate


def _stream_argv(dev, d, sessions, days, *extra, m=REGIONS):
    return ["--stream", "--sparse-features", str(d), "--regions", str(m),
            "--sessions", str(sessions), "--days", str(days), "--window",
            str(STREAM_WINDOW), "--inner-iters", str(STREAM_INNER),
            "--drift", str(STREAM_DRIFT), "--active-user", str(STREAM_K[0]),
            "--active-ad", str(STREAM_K[1]), "--lam", str(LAM), "--beta",
            str(BETA), "--history", "reset", "--seed", str(SEED),
            "--device", str(dev), *extra]


def _stream_kernels(torch, dev, batch, theta):
    """B1, B2 and B3 against their plain versions at the shapes the
    streaming path gives them: one window's two days of DayStream's
    drifting ids, its transpose plans, and the gradient of its loss at
    the stream's Theta, with phase 5's bars. Returns the max abs errors."""
    from repro_torch.core.objective import smooth_loss_and_grad
    from repro_torch.kernels.lsplm_sparse_scatter import ops as sops

    e, shapes = _b1_at_training_shapes(torch, (("stream window", batch),),
                                       theta)
    err = {"lsplm_sparse_fused_forward": e, "lsplm_sparse_scatter": 0.0}
    rng = np.random.default_rng(SEED + 25)
    lines = []
    for side, ids, vals, plan in (
            ("user", batch.user_ids, batch.user_vals, batch.user_plan),
            ("ad", batch.ad_ids, batch.ad_vals, batch.ad_plan)):
        dz = torch.from_numpy(rng.normal(size=(vals.shape[0], 2 * REGIONS))
                              .astype(np.float32)).to(dev)
        e = _check_scatter(torch, sops, plan, vals, dz,
                           f"stream window {side} side")
        unplanned = sops.scatter_add_unplanned(ids, vals, dz, plan.num_rows,
                                               plan.num_rows - 1)
        check(torch.equal(unplanned, sops.scatter_add_planned(plan, vals, dz)),
              f"B2 on the card-sorted entries differs from the plan's "
              f"(stream window {side} side)")
        err["lsplm_sparse_scatter"] = max(err["lsplm_sparse_scatter"], e)
        lines.append(f"{side} side E'={plan.num_kept:,} U={plan.num_unique:,}"
                     f" pieces={plan.piece_run.numel():,} max|err| {e:.2e}")
    _, grad = smooth_loss_and_grad(theta, batch)
    err["owlqn_direction"] = _check_b3(
        torch, theta, grad, LAM, BETA,
        f"the stream window's gradient D={theta.shape[0]:,}", exact=True)
    print(f"  kernels vs plain at the streaming path's shapes: B1 "
          f"({', '.join(shapes)}; the stream's final Theta, in-kernel dedup, "
          f"bitwise the pre-pass + B1) z rtol {Z_RTOL}/atol {Z_ATOL}, p atol "
          f"{P_ATOL}, max |err| {err['lsplm_sparse_fused_forward']:.3e}; B2 "
          f"(bitwise scatter_runs_ref and the card-sorted layout, |err| <= "
          f"{B2_REL} x sum|terms| + {B2_ABS} vs the class gathers): "
          + "; ".join(lines) + f"; B3 bitwise its plain version on the "
          f"window's gradient at the stream's Theta, max |err| "
          f"{err['owlqn_direction']:.2e}")
    return err


def phase_stream(torch, dev, tmp: Path):
    """``launch.train --stream`` at paper width with ``--sync-planner``
    and overlapped, in turns (synchronous, overlapped, overlapped,
    synchronous) after a small warm-up run: bitwise equal runs, the
    kernels' launches (the first overlapped run), each mode's walls and
    overlap ratio; then a window's host build split into its parts, B1,
    B2 and B3 against their plain versions at that window's shapes, one
    window's steps profiled and the "reset" history's allocation timed.
    Returns the counted run's launches and the kernels' max errors."""
    from repro_torch.core.objective import nll_sparse, smooth_loss_and_grad
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
    from repro_torch.obs.ledger import read_jsonl
    from repro_torch.optim.owlqn_plus import OWLQNPlus
    from repro_torch.stream import DayStream, plan_window, to_device

    t_phase = t0 = time.perf_counter()
    train_driver.run(_stream_argv(dev, STREAM_GATE_D, STREAM_GATE_SESSIONS,
                                  2))  # loads the kernels and cuBLAS
    warm_s = time.perf_counter() - t0
    runs = []
    for mode in ("synchronous", "overlapped", "overlapped", "synchronous"):
        ledger = tmp / f"stream_{len(runs)}.jsonl"
        extra = ("--sync-planner",) if mode == "synchronous" else ()
        _reset((B1, B2, B3))
        t0 = time.perf_counter()
        rep = train_driver.run(_stream_argv(
            dev, D_FEATURES, SESSIONS, STREAM_DAYS, "--ledger-out",
            str(ledger), *extra))
        wall = time.perf_counter() - t0
        launches = {"lsplm_sparse_fused_forward":
                    B1["lsplm_sparse_fused_forward"], **B2, **B3}
        recs = read_jsonl(str(ledger))
        runs.append(dict(mode=mode, rep=rep, wall=wall, launches=launches,
                         wins=[r for r in recs
                               if r["kind"] == "stream_window"],
                         iters=[r for r in recs
                                if r["kind"] == "train_iter"]))
    over, sync = runs[1], runs[0]
    wins = over["rep"]["windows"]
    check(len(wins) == STREAM_DAYS, f"{len(wins)} windows, not {STREAM_DAYS}")
    check(all(np.isfinite(w["fs"]).all() and w["fs"][-1] <= w["fs"][0]
              for w in wins), "a window's f is not finite or rose")
    nlls = [w["next_day_nll"] for w in wins[:-1]]
    check(all(np.isfinite(nlls)) and all(0 < v < 2 for v in nlls),
          f"next-day NLL out of range: {nlls}")
    for run in runs:
        check([w["fs"] for w in run["rep"]["windows"]]
              == [w["fs"] for w in wins],
              "the overlapped and the synchronous planner give other f "
              "traces")
        check(torch.equal(run["rep"]["theta"], over["rep"]["theta"]),
              "the overlapped and the synchronous planner give another "
              "Theta")
    launches = over["launches"]
    for name, count in launches.items():
        check(count > 0, f"the streaming path never launched {name}")
    steps = len(over["iters"])
    trials = sum(r["ls_iters"] for r in over["iters"])
    check(launches["lsplm_sparse_scatter"] == 2 * steps,
          f"B2 launched {launches['lsplm_sparse_scatter']} times, not 2 per "
          f"gradient ({2 * steps})")
    check(launches["owlqn_direction"] == steps,
          f"B3 launched {launches['owlqn_direction']} times, not once per "
          f"step ({steps})")
    check(over["rep"]["overlap_ratio"] > 0,
          "the overlapped planner hid none of its build time")
    check(all(run["rep"]["overlap_ratio"] == 0.0 and not any(
        w["prefetched"] for w in run["wins"]) for run in runs
        if run["mode"] == "synchronous"),
        "the synchronous planner prefetched a window")
    print(f"phase 25: streaming main path (launch.train --stream) at "
          f"d={D_FEATURES:,}, m={REGIONS}, {STREAM_DAYS} days x {SESSIONS:,} "
          f"sessions x 4 ads (K {STREAM_K[0]}/{STREAM_K[1]}), window "
          f"{STREAM_WINDOW}, {STREAM_INNER} inner iterations, drift "
          f"{STREAM_DRIFT}, reset (after a {warm_s:.1f} s warm-up run at "
          f"d={STREAM_GATE_D:,}): synchronous, overlapped, overlapped, "
          f"synchronous all bitwise equal (f traces of {STREAM_DAYS} "
          f"windows and the final Theta, "
          f"{int((over['rep']['theta'] != 0).sum()):,} non-zeros); f "
          f"{wins[0]['fs'][0]:.2f} -> {wins[-1]['fs'][-1]:.2f}; next-day "
          f"NLL " + ", ".join(f"{v:.4f}" for v in nlls))
    print(f"  launches {launches} over {steps} steps with {trials} "
          f"line-search trials: per window B1 "
          f"{launches['lsplm_sparse_fused_forward'] / STREAM_DAYS:.1f} "
          f"(2 per loss evaluation = {2 * (steps + trials)} in all, plus "
          f"the next-day evaluations), B2 "
          f"{launches['lsplm_sparse_scatter'] / STREAM_DAYS:.0f}, B3 "
          f"{launches['owlqn_direction'] / STREAM_DAYS:.0f}")
    for run in runs:
        ws = run["wins"]
        pre = [w for w in ws if w["prefetched"]]
        print(f"  {run['mode']}: {run['wall']:.2f} s driver wall, "
              f"{run['rep']['wall_s'] / STREAM_DAYS * 1e3:.1f} ms per window "
              f"(trainer with next-day eval); step median "
              f"{np.median([w['step_s'] for w in ws]) * 1e3:.1f} ms; build "
              f"{sum(w['build_s'] for w in ws) * 1e3:.1f} ms in all (median "
              f"{np.median([w['build_s'] for w in ws]) * 1e3:.1f}), exposed "
              f"wait {sum(w['wait_s'] for w in ws) * 1e3:.1f} ms "
              f"({sum(w['wait_s'] for w in pre) * 1e3:.1f} ms on "
              f"{len(pre)} prefetched windows); overlap ratio "
              f"{run['rep']['overlap_ratio']:.4f}")
    walls = {mode: [r["rep"]["wall_s"] for r in runs if r["mode"] == mode]
             for mode in ("synchronous", "overlapped")}
    print(f"  synchronous / overlapped trainer wall: "
          f"{sum(walls['synchronous']) / sum(walls['overlapped']):.3f}x "
          f"over the two runs of each (printed, not gated)")

    # one window's step, profiled, and the reset's history allocation
    stream = DayStream(STREAM_DAYS, sessions_per_day=SESSIONS,
                       num_features=D_FEATURES, active_user=STREAM_K[0],
                       active_ad=STREAM_K[1], drift=STREAM_DRIFT, seed=SEED)
    side = torch.cuda.Stream(dev)
    for rnd in ("first", "again"):  # "again": days cached, pinned blocks held
        t0 = time.perf_counter()
        raw = stream.window(STREAM_DAYS - 1, STREAM_WINDOW)
        t1 = time.perf_counter()
        planned = plan_window(raw)
        t2 = time.perf_counter()
        batch, ready = to_device(planned, dev, side)
        t3 = time.perf_counter()
        torch.cuda.synchronize(dev)
        t4 = time.perf_counter()
        print(f"  a window's host build, split ({rnd}, synchronous): slide "
              f"{(t1 - t0) * 1e3:.1f} ms (drawing its days when not "
              f"cached), plans {(t2 - t1) * 1e3:.1f} ms, pin + enqueue the "
              f"copies {(t3 - t2) * 1e3:.1f} ms, copies landing "
              f"{(t4 - t3) * 1e3:.1f} ms")
    torch.cuda.current_stream().wait_event(ready)
    theta = over["rep"]["theta"]
    err = _stream_kernels(torch, dev, batch, theta)
    opt = OWLQNPlus(lambda th: smooth_loss_and_grad(th, batch), lam=LAM,
                    beta=BETA, loss=lambda th: nll_sparse(th, batch))
    reset_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = opt.init(theta)
        torch.cuda.synchronize()
        reset_ms.append((time.perf_counter() - t0) * 1e3)

    def window_steps():
        st = state
        for _ in range(STREAM_INNER):
            st, _ = opt.step(st)
        return st

    _, wall_us, kernels = _device_profile(torch, window_steps)
    check(bool(kernels), "the profiled window showed no device time")
    busy = sum(v[0] for v in kernels.values())
    n = sum(v[1] for v in kernels.values())
    ours = {label: [sum(us for name, (us, _) in kernels.items()
                        if label in name),
                    sum(k for name, (_, k) in kernels.items()
                        if label in name)]
            for label in SPARSE_STEP_KERNELS}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"  one window's {STREAM_INNER} steps (day {STREAM_DAYS - 1}, "
          f"{batch.ad_ids.shape[0]:,} samples, under torch.profiler): "
          f"{wall_us / 1e3:.2f} ms wall, {busy / 1e3:.3f} ms of device in "
          f"{n} launches (device idle {1 - busy / wall_us:.1%}); "
          + ", ".join(f"{label} x{k} {us / 1e3:.3f} ms"
                      for label, (us, k) in ours.items())
          + "; top: " + "; ".join(f"{name[:60]} x{k} {us / 1e3:.3f} ms"
                                  for name, (us, k) in top))
    print(f"  the reset's fresh history and Theta copies (opt.init at "
          f"d={D_FEATURES:,}: {2 * 10 * theta.numel() * 4 / 1e9:.2f} GB of "
          f"zeros): " + ", ".join(f"{ms:.2f}" for ms in reset_ms) + " ms")
    print(f"phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err


# ------------------------------------------------------------ phase 26
def _seen_theta0(stream, days, m):
    """0.01 N(0, 1) from ``SEED`` with the rows that no id of the stream's
    first ``days`` days touches at exact zero (as phase 7's d = 50,000
    start)."""
    d = stream.num_features
    theta = (0.01 * np.random.default_rng(SEED).normal(size=(d, 2 * m))
             ).astype(np.float32)
    seen = np.zeros(d, bool)
    for t in range(days):
        b = stream.day(t)
        for ids in (b.user_ids.numpy(), b.ad_ids.numpy()):
            seen[ids[ids < d]] = True
    return theta * seen[:, None]


def phase_stream_gates(torch, dev, tmp: Path):
    """The streaming gates on the card: full window == full batch bitwise,
    card vs CPU at the bars, --ckpt/--resume exact, the demo stream beats
    train-once, and the drift reference arming the monitored serving
    driver (int8 and fp32). Returns the monitored runs' B1/B4 launches."""
    from repro_torch import obs
    from repro_torch.core.objective import nll_sparse, smooth_loss_and_grad
    from repro_torch.data.sparse import sparse_predict
    from repro_torch.io import checkpoint
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES as B1,
    )
    from repro_torch.launch import serve, train as train_driver
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.optim.owlqn_plus import OWLQNPlus
    from repro_torch.stream import (
        DayStream,
        StreamTrainer,
        plan_window,
        to_device,
    )

    t_phase = time.perf_counter()
    d, g = STREAM_GATE_D, STREAM_GATE_SESSIONS
    kw = dict(sessions_per_day=g, num_features=d, active_user=STREAM_K[0],
              active_ad=STREAM_K[1], drift=STREAM_DRIFT, seed=SEED)
    # (a) window = the whole dataset under reset == full-batch OWLQN+
    days = 2
    s = DayStream(days, **kw)
    theta0 = torch.from_numpy(_seen_theta0(s, days, REGIONS)).to(dev)
    full, _ = to_device(plan_window(s.window(days - 1, days)), dev)
    opt = OWLQNPlus(lambda th: smooth_loss_and_grad(th, full), lam=LAM,
                    beta=BETA, loss=lambda th: nll_sparse(th, full))
    st, fs = opt.init(theta0), []
    for _ in range(STREAM_INNER):
        st, stats = opt.step(st)
        fs.append(stats.f_new)
    tr = StreamTrainer(s, lam=LAM, beta=BETA, window=days,
                       inner_iters=STREAM_INNER, device=dev)
    state, trace = tr.run(tr.init(theta0)._replace(day=days - 1), days=1)
    check(list(trace[0].fs) == fs and torch.equal(state.opt.theta, st.theta),
          "the full-window stream differs from full-batch OWLQN+")
    print(f"phase 26: full window ({days} days, d={d:,}, {STREAM_INNER} "
          f"steps, reset) == full-batch OWLQN+ bitwise on the card (f "
          f"{fs[0]:.4f} -> {fs[-1]:.4f})")

    # (b) card vs CPU, 3 windows x 2 steps
    days = 3
    traj = {}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        s = DayStream(days, **kw)
        tr = StreamTrainer(s, lam=LAM, beta=BETA, window=STREAM_WINDOW,
                           inner_iters=2, device=where)
        t0 = time.perf_counter()
        state, trace = tr.run(tr.init(_seen_theta0(s, days, REGIONS)))
        traj[tag] = (state.opt.theta.cpu().numpy(),
                            np.array([w.fs for w in trace]),
                            time.perf_counter() - t0)
    (t_card, f_card, w_card), (t_cpu, f_cpu, w_cpu) = traj["card"], traj["cpu"]
    f_err = float(np.max(np.abs(f_card - f_cpu) / np.abs(f_cpu)))
    beyond = _beyond_bar(t_card, t_cpu)
    flips = int(((t_card == 0) != (t_cpu == 0)).sum())
    check(f_err <= TRAJ_F_RTOL, f"stream f card vs CPU rtol {f_err:.2e}")
    check(not beyond.any(), f"stream Theta card vs CPU beyond the bar in "
                            f"{int(beyond.sum())} elements")
    check(flips == 0, f"stream zero pattern card vs CPU differs in {flips}")
    print(f"  card vs CPU stream ({days} windows x 2 steps, d={d:,}, {g:,} "
          f"sessions a day): f max rel diff {f_err:.2e} (bar {TRAJ_F_RTOL}),"
          f" Theta max |diff| {float(np.abs(t_card - t_cpu).max()):.2e} "
          f"within rtol {TRAJ_RTOL}/atol {TRAJ_ATOL}, zero pattern equal "
          f"({int((t_card != 0).sum()):,} non-zeros); wall card "
          f"{w_card:.2f} s, CPU {w_cpu:.2f} s")

    # (c) --ckpt then --resume continues exactly, and the drift reference
    ckpt, dref = str(tmp / "stream.npz"), str(tmp / "dref.npz")
    straight = train_driver.run(_stream_argv(
        dev, d, g, 4, "--drift-ref", dref, "--monitor"))
    train_driver.run(_stream_argv(dev, d, g, 2, "--ckpt", ckpt))
    resumed = train_driver.run(_stream_argv(dev, d, g, 4, "--ckpt", ckpt,
                                            "--resume"))
    check(resumed["resumed_at"] == 2 and [w["day"] for w in
                                          resumed["windows"]] == [2, 3],
          "--resume did not continue from day 2")
    check([w["fs"] for w in resumed["windows"]]
          == [w["fs"] for w in straight["windows"][2:]]
          and torch.equal(resumed["theta"], straight["theta"]),
          "the resumed stream differs from the uninterrupted one")
    print(f"  --ckpt after day 1, then --resume: days 2-3 and the final "
          f"Theta bitwise the uninterrupted 4-day run's (d={d:,})")

    # (d) the demo stream beats train-once on next-day NLL
    s = DayStream(DEMO["days"] + 1, sessions_per_day=DEMO["sessions"],
                  num_features=DEMO["d"], active_user=DEMO["k"][0],
                  active_ad=DEMO["k"][1], drift=DEMO["drift"],
                  head_width=0.06, head_frac=0.85, seed=11)
    theta_demo = (0.01 * np.random.default_rng(SEED).normal(
        size=(DEMO["d"], 2 * DEMO["m"]))).astype(np.float32)
    held, _ = to_device(s.day(DEMO["days"]), dev)
    nll = {}
    for tag, window, inner, n in (("train-once", 1, 5 * DEMO["days"], 1),
                                  ("streamed", 2, 5, DEMO["days"])):
        tr = StreamTrainer(s, lam=DEMO["lam"], beta=DEMO["lam"],
                           window=window, inner_iters=inner, device=dev)
        state, _ = tr.run(tr.init(theta_demo), days=n)
        nll[tag] = float(nll_sparse(state.opt.theta, held)) / held.y.shape[0]
    check(nll["streamed"] < nll["train-once"] - 0.02,
          f"the streamed model does not beat train-once: {nll}")
    print(f"  demo stream (d={DEMO['d']}, {DEMO['days']} days): next-day NLL "
          f"streamed {nll['streamed']:.4f} vs train-once "
          f"{nll['train-once']:.4f}")

    # (e) the drift reference arms the monitored serving driver
    ref = obs.load_drift_reference(dref)
    theta_ckpt = checkpoint.save(str(tmp / "theta.npz"),
                                 {"theta": straight["theta"]})
    common = ["--ckpt", theta_ckpt, "--requests", "256", "--seed", str(SEED),
              "--device", str(dev)]
    mon_args = ["--monitor", "--drift-ref", dref]
    reps, monitored = {}, {}
    # in turns: unmonitored and monitored fp32, then monitored and
    # unmonitored int8; the monitored runs' launches are counted
    for tag in ("fp32", "fp32 monitored", "int8 monitored", "int8"):
        extra = (["--int8"] if tag.startswith("int8") else []) + (
            mon_args if "monitored" in tag else [])
        if "monitored" in tag:
            _reset((B1,))
        reps[tag] = serve.run(common + extra)
        if "monitored" in tag:
            for name, count in B1.items():
                monitored[name] = monitored.get(name, 0) + count
    for tag in ("fp32 monitored", "int8 monitored"):
        sig = reps[tag]["monitor"]["signals"]
        missing = [k for k in ("drift.score_psi", "drift.score_kl",
                               "drift.id_psi") if k not in sig]
        check(not missing, f"{tag}: the monitor has no {missing}")
    for name, count in monitored.items():
        check(count > 0, f"the monitored serving path never launched {name}")
    # calib.*: the armed monitor fed the stream's last held-out day, scored
    # on the card
    nxt, _ = to_device(DayStream(4, **kw).day(3), dev)
    p = sparse_predict(straight["theta"], nxt).cpu().numpy()
    mon = obs.HealthMonitor(registry=MetricsRegistry())
    mon.arm_drift(ref)
    mon.observe_predictions(p, nxt.y.cpu().numpy())
    calib = {k: v for k, v in mon.signals().items() if k.startswith("calib.")}
    check(calib["calib.ratio"] is not None and np.isfinite(
        calib["calib.ratio"]), f"calib.ratio not populated: {calib}")
    print(f"  drift reference from the stream's last held-out day "
          f"({int(ref.score_counts.sum()):,} scores, top-"
          f"{ref.top_ids.shape[0]} ids, ratio {ref.ratio:.3f}); "
          f"launch.serve --monitor --drift-ref on the stream's final Theta: "
          + "; ".join(f"{tag} " + ", ".join(
              f"{k}={v:.4f}" for k, v in sorted(
                  reps[tag]["monitor"]["signals"].items())
              if k.startswith("drift.")) + f" ("
              f"{reps[tag]['monitor']['alerts']} alert changes)"
              for tag in ("fp32 monitored", "int8 monitored"))
          + "; the armed monitor on the held-out day: " + ", ".join(
              f"{k}={v}" if v is None else f"{k}={v:.4f}"
              for k, v in sorted(calib.items()))
          + f"; monitored launches {monitored}")
    for kind in ("fp32", "int8"):
        plain = reps[kind]["engine"]["latency_us"]
        mon_us = reps[f"{kind} monitored"]["engine"]["latency_us"]
        print(f"  {kind} engine wall per request (the mean over its "
              f"single and batched replays), unmonitored vs monitored: "
              f"{plain:.1f} vs {mon_us:.1f} us ({mon_us / plain:.3f}x)")
    print(f"phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return monitored


# ------------------------------------------------------------ phase 27
# two pytest processes at once, the card's sharded paths' files (each
# test spawns its ranks) beside the rest
CARD_TESTS = (("tests/test_torch_stream_card.py",
               "tests/test_torch_flash_attention_card.py",
               "tests/test_torch_lm_train_card.py",
               "tests/test_torch_sparse_card.py",
               "tests/test_torch_moe_card.py",
               "tests/test_torch_mamba_scan_card.py",
               "tests/test_torch_mamba_scan_backward_card.py",
               "tests/test_torch_lsplm_fused_card.py",
               "tests/test_torch_direction_card.py",
               "tests/test_torch_hybrid_card.py",
               "tests/test_torch_dense_card.py",
               "tests/test_torch_serve_card.py",
               "tests/test_torch_train_card.py",
               "tests/test_torch_lm_zoo_card.py"),
              ("tests/test_torch_shard_card.py",
               "tests/test_torch_lm_shard_card.py",
               "tests/test_torch_lm_train_shard_card.py"))


def phase_card_tests():
    """The jax-free ``cuda``-marked tests (the streaming slice's, B6's
    against its plain version, the training path's, B1/B4/B2's against
    their plain versions and at every autotune config, the sharded
    training path's, the MoE family's, B7's against its plain versions,
    the sharded LM serving and training paths', and B5's, B3's, the
    hybrid's B6, the dense and sparse training paths' and planned scoring's
    against their plain versions or the CPU), in two pytest processes
    of their own, run at once (CARD_TESTS; they build nothing: the
    kernels phase 1 built load from ``build/``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp, f"pytest{i}.log") for i in range(len(CARD_TESTS))]
        procs = []
        try:
            for files, log in zip(CARD_TESTS, logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                         "-p", "no:cacheprovider", *files], cwd=ROOT,
                        env=env, stdout=f, stderr=subprocess.STDOUT))
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [log.read_text() for log in logs]
    tails = []
    for files, code, out in zip(CARD_TESTS, codes, outs):
        lines = out.strip().splitlines()
        tail = lines[-1] if lines else ""
        passed = re.search(r"(\d+) passed", tail)
        check(code == 0 and passed and int(passed.group(1)) > 0
              and "skipped" not in tail,
              f"pytest -m cuda {' '.join(files)} exited {code}: "
              f"{out[-4000:]}")
        tails.append(f"{' '.join(files)}: {tail}")
    print("phase 27: pytest -m cuda in two processes at once: "
          + "; ".join(tails) + f" ({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------------ phase 28
# LM training: llama3.2-1b at full width and depth, trainable (fp32
# leaves), the train_4k shape with its batch cut from 256 to 4, lr 3e-4
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 4, 3, 3e-4
TRAIN_CE_CHUNK = 1024  # the chunked-CE step beside the config's full CE
PROBE_LR, PROBE_STEPS = 3e-5, 4  # the fall gated at a tenth of the lr
CE_RTOL = 1e-4  # tests/test_chunked_ce.py:31
class _Spans:
    """Device time spans of wrapped functions, by CUDA events on the
    current stream: each call adds one (start, end) pair to its label."""

    def __init__(self, torch):
        self.torch, self.pairs = torch, {}

    def wrap(self, label, fn):
        torch = self.torch

        def wrapped(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pairs.setdefault(label, []).append((start, end))
            return out

        return wrapped

    def ms(self, label) -> tuple[float, int]:
        """(summed ms, calls) of ``label`` since the last :meth:`clear`;
        the caller has synchronised."""
        pairs = self.pairs.get(label, [])
        return sum(s.elapsed_time(e) for s, e in pairs), len(pairs)

    def clear(self):
        self.pairs.clear()


def _loss_and_grads(torch, model, batch):
    """(loss, ce, {name: gradient}) of one loss_fn and backward."""
    from repro_torch.models import loss_fn

    named = list(model.named_parameters())
    loss, (ce, _) = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return loss.detach(), ce.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(named, grads)}


def phase_lm_train(torch, dev):
    """LM training at full width: llama3.2-1b trainable from a seeded
    torch.Generator, a 4 x 4,096 batch from the token stream. (a) one
    loss_fn and backward: every gradient leaf finite and not all zero
    (the graph is not cut at B6), B6 32 times; (b) the same with
    ce_chunk = 1024 on the same weights: the loss within CE_RTOL, both
    peaks; (c) make_train_step: one warm-up step, three timed steps
    (ms, tokens/s, MFU, peak memory, B6 launches each, the device spans
    of the plain attention backward and AdamW); every loss finite and the
    first update lowering the loss; (d) a profiled step, its device time
    split by op; (e) three updates from the same initial weights at lr
    3e-5: the loss falls at each.

    At lr 3e-4 only the first update is gated to lower the loss: on one
    repeated batch from random weights, AdamW's first steps move every
    leaf by about lr (the update is near lr sign(g)), and at 3e-4 the
    full-width loss overshoots past the first update (on an H100: 12.34,
    9.73, 16.85, 13.09). Its fall over three updates is gated at a tenth
    of that lr, in (e)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )
    from repro_torch.models import init_model, make_train_step
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == LM_PARAMS and all(
        p.requires_grad and p.dtype == torch.float32
        for p in model.parameters()),
        f"{LM_ARCH}: {n_params:,} parameters, not {LM_PARAMS:,} fp32 "
        "leaves with a gradient")
    raw = TokenStream(cfg.vocab_size, seed=SEED).batch(TRAIN_BATCH,
                                                        LM_SEQ + 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    tokens = TRAIN_BATCH * LM_SEQ
    layers = cfg.num_layers

    # (a) the gradient gate, the config as it stands (full CE)
    _reset((B6,))
    torch.cuda.reset_peak_memory_stats()
    loss_full, _, grads = _loss_and_grads(torch, model, batch)
    torch.cuda.synchronize()
    peak_full = torch.cuda.max_memory_allocated() / 1e9
    check(B6["flash_attention"] == 2 * layers,
          f"B6 launched {B6['flash_attention']} times in a forward and "
          f"backward, not {2 * layers} (each layer's forward and its "
          "checkpointed recompute)")
    bad = [n for n, g in grads.items()
           if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    check(not bad, f"gradient leaves not finite or all zero: {bad[:8]}")
    attn_leaves = [n for n in grads if re.search(r"\.attn\.w[qkv]$", n)]
    check(len(attn_leaves) == 3 * layers,
          f"{len(attn_leaves)} wq/wk/wv leaves, not {3 * layers}")
    g_norms = {n: float(grads[n].norm()) for n in attn_leaves}
    del grads

    # (b) the same weights and batch with the CE in chunks of 1,024
    model.cfg = dataclasses.replace(cfg, ce_chunk=TRAIN_CE_CHUNK)
    try:
        torch.cuda.reset_peak_memory_stats()
        loss_chunk, _, grads = _loss_and_grads(torch, model, batch)
        torch.cuda.synchronize()
        peak_chunk = torch.cuda.max_memory_allocated() / 1e9
        del grads
    finally:
        model.cfg = cfg
    rel = abs(float(loss_chunk) - float(loss_full)) / abs(float(loss_full))
    check(rel <= CE_RTOL, f"chunked CE loss {float(loss_chunk)} vs the full "
          f"CE's {float(loss_full)}: relative {rel:.2e} > {CE_RTOL}")
    print(f"phase 28: {LM_ARCH} trainable at full width ({n_params:,} fp32 "
          f"parameters), batch {TRAIN_BATCH} x {LM_SEQ}: loss_fn + backward "
          f"launched B6 {2 * layers} times ({layers} forward, {layers} in "
          f"the checkpointed recompute); all {len(g_norms)} "
          f"wq/wk/wv leaves and every other leaf finite and nonzero (wq/wk/wv"
          f" gradient norms {min(g_norms.values()):.3e}.."
          f"{max(g_norms.values()):.3e}); full CE loss "
          f"{float(loss_full):.6f} (peak {peak_full:.2f} GB) vs ce_chunk "
          f"{TRAIN_CE_CHUNK} {float(loss_chunk):.6f} (peak {peak_chunk:.2f} "
          f"GB): relative {rel:.2e} (bar {CE_RTOL})")

    # (c) the train step: a warm-up, then timed steps with spans
    opt, step = make_train_step(model, lr=TRAIN_LR)
    state = opt.init(dict(model.named_parameters()))
    state, warm = step(state, batch)
    warm_loss = float(warm["loss"])
    spans = _Spans(torch)
    backward_plain = attn_ops.attention_backward_plain
    apply = adamw.AdamW.apply
    attn_ops.attention_backward_plain = spans.wrap("attention_backward",
                                                   backward_plain)
    adamw.AdamW.apply = spans.wrap("adamw", apply)
    losses, secs, counts, span_ms = [], [], [], []
    try:
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TRAIN_STEPS):
            _reset((B6,))
            spans.clear()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            counts.append(B6["flash_attention"])
            span_ms.append({k: spans.ms(k) for k in ("attention_backward",
                                                      "adamw")})
        peak_train = torch.cuda.max_memory_allocated() / 1e9
    finally:
        attn_ops.attention_backward_plain = backward_plain
        adamw.AdamW.apply = apply
    check(all(np.isfinite(losses)) and losses[0] < warm_loss,
          f"the training loss is not finite, or the first update did not "
          f"lower it: {warm_loss} then {losses}")
    check(all(c == 2 * layers for c in counts),
          f"B6 launches per step {counts}, not {2 * layers}")
    step_s = float(np.mean(secs))
    flops = 6 * n_params * tokens
    mfu = flops / step_s / BF16_OPS_PER_S
    roof = _train_roofline(cfg, TRAIN_BATCH, LM_SEQ, n_params, 0.0)
    bwd_ms = float(np.mean([s["attention_backward"][0] for s in span_ms]))
    opt_ms = float(np.mean([s["adamw"][0] for s in span_ms]))
    print(f"  train step (make_train_step, lr {TRAIN_LR}): loss "
          f"{warm_loss:.6f} (warm-up step) -> "
          + " -> ".join(f"{x:.6f}" for x in losses)
          + f"; {step_s * 1e3:.1f} ms a step ("
          + ", ".join(f"{s * 1e3:.1f}" for s in secs)
          + f"), {tokens / step_s:,.0f} tokens/s, MFU {mfu:.2%} (6 N T = "
          f"{flops:.4e} FLOP a step over {BF16_OPS_PER_S:.3g} FLOP/s dense "
          f"bf16; no attention term, no recompute), peak memory "
          f"{peak_train:.2f} GB, B6 {counts[0]} launches a step; device "
          f"spans (CUDA events): the plain attention backward "
          f"{bwd_ms:.1f} ms in {span_ms[0]['attention_backward'][1]} calls "
          f"({bwd_ms / (step_s * 1e3):.1%} of the step), AdamW "
          f"{opt_ms:.1f} ms ({opt_ms / (step_s * 1e3):.1%})")
    print(f"  roofline (repro_torch.utils.roofline, the port's H100 "
          f"constants): {json.dumps(roof)}; the measured step "
          f"{step_s / roof['t_bound_s']:.2f} x its bound, MFU "
          f"{mfu:.2%} beside the bound's {roof['mfu_bound']:.2%}")

    # (d) where a step's device time goes, by op
    attn_ops.attention_backward_plain = spans.wrap("attention_backward",
                                                   backward_plain)
    try:
        spans.clear()
        (state, _), wall_us, kernels = _device_profile(
            torch, lambda: step(state, batch))
        bwd_prof_ms = spans.ms("attention_backward")[0]
    finally:
        attn_ops.attention_backward_plain = backward_plain
    busy_us = sum(v[0] for v in kernels.values())
    split = {"B6": 0.0, "GEMMs": 0.0, "the rest": 0.0}
    for name, (us, _) in kernels.items():
        key = ("B6" if any(k in name for k in LM_KERNELS) else
               "GEMMs" if _is_gemm(name) else "the rest")
        split[key] += us
    _print_profile("a train step", wall_us, kernels)
    if busy_us:
        print("  a train step's device time: " + "; ".join(
            f"{k} {us / 1e3:.1f} ms ({us / busy_us:.1%})"
            for k, us in split.items())
              + f"; of it the plain attention backward's span "
              f"{bwd_prof_ms:.1f} ms ({bwd_prof_ms * 1e3 / busy_us:.1%}, "
              "its GEMMs and elementwise ops included)")
        _print_elementwise(kernels, LM_KERNELS)

    # (e) the same start at a tenth of the lr
    del model, state, opt, step
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, trainable=True)
    opt, step = make_train_step(model, lr=PROBE_LR)
    state = opt.init(dict(model.named_parameters()))
    probe = []
    for _ in range(PROBE_STEPS):
        state, metrics = step(state, batch)
        probe.append(float(metrics["loss"]))
    check(all(np.isfinite(probe)) and all(
        b < a for a, b in zip(probe, probe[1:])),
        f"at lr {PROBE_LR} the loss did not fall at each update: {probe}")
    print(f"  the same start at lr {PROBE_LR}: loss "
          + " -> ".join(f"{x:.6f}" for x in probe) + " (falls at each "
          "update)")
    del model, state, opt, step
    print(f"phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return counts[0], {
        "ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": mfu, "flop_per_step": flops, "peak_gb": peak_train,
        "roofline": roof,
        "peak_gb_full_ce": peak_full, "peak_gb_ce_chunk": peak_chunk,
        "losses": [warm_loss] + losses, "probe_losses": probe,
        "attention_backward_ms": bwd_ms,
        "adamw_ms": opt_ms, "device_split_ms": {
            k: v / 1e3 for k, v in split.items()}}


def _train_roofline(cfg, batch, seq, params, coll_bytes, data=1,
                    model=1) -> dict:
    """``Roofline(...).to_dict()`` of one training step with remat on the
    global ``batch`` x ``seq`` tokens, for a rank of a (data, model) mesh
    holding ``params`` parameters and moving ``coll_bytes`` of
    collectives a step, as if each rank had a card of its own: the
    step's FLOPs counted from the shapes over the ranks, the memory lower
    bound on the rank's batch / data rows, the model FLOPs per rank (the
    reference's, 6 N_active T); with ``t_bound_s`` added, and beside the
    Roofline's terms: the model FLOPs of the weights a token meets
    (``model_flops_matmul_per_chip``, 6 T (matmul_params + d V): the
    reference's N_active for every family but the hybrid, whose N_active
    counts an MLP in each Mamba2 layer) and their ``mfu_bound_matmul``,
    and the bound with the compute term at the fp32 peak
    (``t_bound_fp32_s``, FP32_OPS_PER_S: where an fp32 step's products
    run; the Roofline's compute term is at the bf16 tensor-core peak)."""
    from repro_torch.utils.roofline import (
        Roofline,
        lm_step_flops,
        lm_train_hbm_bytes,
        matmul_params,
        model_flops_per_chip,
    )

    ranks = data * model
    units = cfg.num_layers // (cfg.shared_attn_every or 1)
    roof = Roofline(lm_step_flops(cfg, batch, seq) / ranks,
                    lm_train_hbm_bytes(cfg, params, batch // data, seq,
                                       units), coll_bytes,
                    model_flops_per_chip(cfg, "train", batch * seq, ranks))
    matmul = 6 * (matmul_params(cfg) + cfg.d_model * cfg.vocab_size) \
        * batch * seq / ranks
    return {**roof.to_dict(), "t_bound_s": roof.t_bound,
            "model_flops_matmul_per_chip": matmul,
            "mfu_bound_matmul": matmul / BF16_OPS_PER_S / roof.t_bound,
            "t_bound_fp32_s": max(roof.flops / FP32_OPS_PER_S,
                                  roof.t_memory, roof.t_collective)}


# ------------------------------------------------------------ phase 29
TRAIN_CPU_ARCHS = {LM_ARCH: "B6", SSM_ARCH: "B7",
                   HYBRID_ARCH: "B6, Mamba2", MOE_ARCH: "B6, MoE"}
TRAIN_CPU_LR, TRAIN_CPU_STEPS = 1e-3, 3
GRAD_REL, GRAD_ABS = 1e-4, 1e-7  # max |err| <= GRAD_REL max |g_cpu| + ..
LOSS_RTOL = 1e-5
PARAM_BAR, PARAM_SHARE = 1e-6, 0.999  # trouble spot (f): see below
B6_GRAD_SHAPES = ((4, LM_SEQ, 32, 8, 64, "bfloat16"),
                  (2, 1100, 8, 2, 64, "float32"))
B7_GRAD_SHAPE = (2, 256, 512, 16)


def _leaf_errors(card: dict, cpu: dict):
    """{name: (max |card - cpu|, max |cpu|)} over the gradient leaves."""
    return {n: (float((card[n].cpu() - g).abs().max()),
                float(g.abs().max())) for n, g in cpu.items()}


def _train_batch(cfg, seq=32):
    from repro_torch.data.tokens import TokenStream

    return TokenStream(cfg.vocab_size, seed=SEED).batch(2, seq + 1)


def _card_vs_cpu_training(torch, dev, arch, kernels):
    """One reduced ``arch`` in fp32, trainable, on the card and on the CPU
    from the same weights and batch: loss_fn and every gradient leaf at
    the CPU tests' bars, then three AdamW steps (lr 1e-3): losses within
    1e-4, every parameter within 2 lr n and within 1e-6 on 99.9% of the
    elements; the MoE's kept assignments equal in every dispatch
    (forward and recompute). Returns the card's launches of B6 and B7."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )
    from repro_torch.kernels.mamba_scan.mamba_scan import LAUNCHES as B7
    from repro_torch.models import Transformer, init_model, make_train_step
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cpu = init_model(cfg, torch.Generator().manual_seed(SEED), device="cpu",
                     trainable=True)
    card = Transformer(cfg, device=dev, trainable=True)
    card.load_state_dict(cpu.state_dict())
    raw = _train_batch(cfg)
    batches = {"cpu": {k: torch.from_numpy(v) for k, v in raw.items()},
               "cuda": {k: torch.from_numpy(v).to(dev)
                        for k, v in raw.items()}}
    kept = {"cuda": [], "cpu": []}
    plan = _recording(moe, "dispatch_plan", lambda out: kept[
        out.keep.device.type].append(out.keep.cpu()))
    try:
        _reset((B6, B7))
        out = {name: _loss_and_grads(torch, m, batches[name])
               for name, m in (("cpu", cpu), ("cuda", card))}
        torch.cuda.synchronize()
        launches = {"B6": B6["flash_attention"],
                    "B7": B7["mamba1_scan_gated"],
                    "B7_bwd": B7["mamba1_scan_gated_backward"]}
    finally:
        moe.dispatch_plan = plan
    (l_cpu, _, g_cpu), (l_card, _, g_card) = out["cpu"], out["cuda"]
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    check(rel <= LOSS_RTOL, f"{arch}: loss card {float(l_card)} vs CPU "
          f"{float(l_cpu)}, relative {rel:.2e} > {LOSS_RTOL}")
    errs = _leaf_errors(g_card, g_cpu)
    bad = {n: e for n, e in errs.items()
           if not e[0] <= GRAD_REL * e[1] + GRAD_ABS or e[1] == 0.0}
    check(not bad, f"{arch}: gradient leaves card vs CPU beyond "
          f"{GRAD_REL} max|g| + {GRAD_ABS} (or all zero): "
          f"{dict(list(bad.items())[:6])}")
    worst = max(errs.items(), key=lambda kv: kv[1][0] / kv[1][1])
    if cfg.num_experts:
        check(len(kept["cuda"]) == len(kept["cpu"]) == 2 * cfg.num_layers
              and all(torch.equal(a, b) for a, b in zip(kept["cuda"],
                                                        kept["cpu"])),
              f"{arch}: the card and the CPU keep different MoE "
              "assignments, or not one dispatch per layer in the forward "
              "and one in the recompute")
    # each attention layer (the hybrid: each group's shared block) and
    # each Mamba1 layer launches its kernel twice: forward and recompute;
    # each Mamba1 layer's backward launches B7's backward kernel once
    ssm = cfg.family == "ssm"
    attention = (0 if ssm else cfg.num_layers // cfg.shared_attn_every
                 if cfg.family == "hybrid" else cfg.num_layers)
    want = {"B6": 2 * attention, "B7": 2 * cfg.num_layers * ssm,
            "B7_bwd": cfg.num_layers * ssm}
    check(launches == want, f"{arch}: launches {launches} in a forward "
          f"and backward, not {want}")

    losses = {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        opt, step = make_train_step(m, lr=TRAIN_CPU_LR)
        state = opt.init(dict(m.named_parameters()))
        losses[name] = []
        for _ in range(TRAIN_CPU_STEPS):
            state, metrics = step(state, batches[name])
            losses[name].append(float(metrics["loss"]))
    rel_l = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                     losses["cpu"]))
    check(rel_l <= CE_RTOL, f"{arch}: training losses card {losses['cuda']} "
          f"vs CPU {losses['cpu']}")
    check(losses["cpu"][-1] < losses["cpu"][0], f"{arch}: the loss did not "
          f"fall: {losses['cpu']}")
    card_p = dict(card.named_parameters())
    diffs = torch.cat([(card_p[n].detach().cpu() - p.detach()).abs().ravel()
                       for n, p in cpu.named_parameters()])
    limit = 2 * TRAIN_CPU_LR * TRAIN_CPU_STEPS
    share = float((diffs <= PARAM_BAR).float().mean())
    check(float(diffs.max()) <= limit and share >= PARAM_SHARE,
          f"{arch}: parameters after {TRAIN_CPU_STEPS} steps, card vs CPU: "
          f"max |err| {float(diffs.max()):.3e} (bar {limit}), "
          f"{share:.5f} within {PARAM_BAR} (bar {PARAM_SHARE})")
    moe_note = (f"; the same kept assignments in all {len(kept['cpu'])} "
                "dispatches (forward + recompute)" if cfg.num_experts else "")
    print(f"  {arch} (reduced, {cfg.num_layers} layers, fp32; {kernels}): "
          f"loss rel {rel:.2e}, worst gradient leaf {worst[0]} "
          f"{worst[1][0]:.3e} of max {worst[1][1]:.3e}; launches "
          f"{launches}; {TRAIN_CPU_STEPS} steps losses card "
          + " -> ".join(f"{x:.6f}" for x in losses["cuda"])
          + f" (rel {rel_l:.2e}); parameters max |err| "
          f"{float(diffs.max()):.3e}, {share:.6f} within {PARAM_BAR}"
          + moe_note)
    return launches


def _ulp_bar(torch, g, dtype) -> float:
    """One ulp of max |g| in ``dtype`` (bf16), or 1e-6 max |g| (fp32)."""
    top = float(g.abs().max())
    if dtype == torch.float32:
        return 1e-6 * top
    return torch.finfo(dtype).eps * 2.0 ** np.floor(np.log2(top))


# B7's backward kernel against its plain version: the per-(b, t, c)
# gradients and dh0 bitwise, a sum within B7_SUM_REL of its terms'
# magnitudes + B7_SUM_ABS (the kernel sums in another order)
B7_SUM_REL, B7_SUM_ABS = 1e-6, 1e-7
B7_PER_ELEMENT = ("dt_raw", "x", "z", "h0")


def _check_b7_backward(torch, args, dy, dhT, tag, repeats=3):
    """B7's backward kernel (``mamba1_scan_gated_backward``) against
    ``plain_gated_scan_backward`` on the card, on the gated scan's inputs
    ``args`` and the output gradients dy and dhT: ddt_raw, dx, dz and dh0
    bitwise; ddt_bias, dB_in and dC_in (fp32 from both), dA_log and dD
    within B7_SUM_REL sum|terms| + B7_SUM_ABS; ``repeats`` launches
    bitwise. Returns (max |err| over the sums, the worst sum's share of
    its bar, ms of the plain version's one run by CUDA events)."""
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.kernels.mamba_scan import ops

    runs = [ms.mamba1_scan_gated_backward(*args, dy, dhT)
            for _ in range(repeats)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ops.plain_gated_scan_backward(*args, dy, dhT)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    mags = ops.gated_scan_backward_magnitudes(*args, dy, dhT)
    torch.cuda.synchronize()
    err = share = 0.0
    for i, name in enumerate(ms.GATED_INPUTS):
        got, w = runs[0][i], want[i]
        if w is None:
            check(all(r[i] is None for r in runs), f"B7 backward returned "
                  f"a gradient of {name} at {tag}, the plain version none")
            continue
        check(got.dtype == w.dtype and got.shape == w.shape,
              f"B7 backward d{name} dtype/shape at {tag}")
        check(all(torch.equal(r[i], got) for r in runs[1:]),
              f"B7 backward d{name} not bitwise repeatable over {repeats} "
              f"launches at {tag}")
        if name in B7_PER_ELEMENT:
            if not torch.equal(got, w):
                e = (got.float() - w.float()).abs()
                raise SmokeFailure(
                    f"B7 backward d{name} not bitwise plain_gated_scan_"
                    f"backward's at {tag}: {int((got != w).sum())} elements "
                    f"differ, max |err| {float(e.max()):.3e}")
            continue
        e = (got - w).abs()
        bar = B7_SUM_REL * mags[name] + B7_SUM_ABS
        check(bool((e <= bar).all()), f"B7 backward d{name} vs plain at "
              f"{tag}: max |err| {float(e.max()):.3e}, "
              f"{float((e / bar).max()):.3f} of B7_SUM_REL sum|terms| + "
              f"B7_SUM_ABS")
        err, share = max(err, float(e.max())), max(share,
                                                   float((e / bar).max()))
    return err, share, plain_ms


def _b7_function_vs_autograd(torch, args, dy, dhT, tag, count=True):
    """The gradient through ``ops.gated_selective_scan`` 's Function on
    the card against autograd of ``plain_gated_scan`` on the same leaves:
    each leaf within 1e-6 max|g| (fp32) or one bf16 ulp of max|g| (bf16),
    B6's bars; with ``count``, one launch each of B7's gated mode and its
    backward kernel. Returns the worst leaf's share of its bar."""
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.mamba_scan import GATED_INPUTS
    from repro_torch.kernels.mamba_scan.mamba_scan import LAUNCHES as B7

    grads = []
    for fn in (ops.gated_selective_scan, ops.plain_gated_scan):
        leaves = [None if a is None else a.clone().requires_grad_()
                  for a in args]
        if count:
            _reset((B7,))
        y, hT = fn(*leaves)
        outs = [(y, dy)] + ([(hT, dhT)] if dhT is not None else [])
        grads.append(torch.autograd.grad(
            [o for o, _ in outs], [t for t in leaves if t is not None],
            [g for _, g in outs]))
        if count and fn is ops.gated_selective_scan:
            check(B7["mamba1_scan_gated"] == 1
                  and B7["mamba1_scan_gated_backward"] == 1,
                  f"B7's Function at {tag}: launches {dict(B7)}, not one "
                  "forward and one backward")
    names = [n for n, a in zip(GATED_INPUTS, args) if a is not None]
    worst = 0.0
    for name, g, w in zip(names, *grads):
        bar = _ulp_bar(torch, w.float(), w.dtype)
        err = float((g.float() - w.float()).abs().max())
        check(g.dtype == w.dtype and err <= bar, f"B7 Function d{name} vs "
              f"autograd of plain_gated_scan at {tag}: max |err| {err:.3e} "
              f"> {bar:.3e}")
        worst = max(worst, err / bar if bar else 0.0)
    return worst


def phase_lm_train_card_vs_cpu(torch, dev):
    """The training path's gates at reduced size and on the Functions:
    (a) llama (B6), falcon-mamba (B7), zamba2 (B6 + Mamba2) and
    granite-moe (B6 + MoE) card vs CPU (``_card_vs_cpu_training``); (b)
    B6's Function against autograd of plain_attention on one ``do`` at
    llama's full-width layer shape in bf16 and a reduced one in fp32; (c)
    B7's Function (its forward and its backward kernel) against autograd
    of plain_gated_scan at B6's bars (:func:`_b7_function_vs_autograd`),
    and the backward kernel against plain_gated_scan_backward
    (:func:`_check_b7_backward`), in fp32 and bf16."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )

    t_phase = time.perf_counter()
    print("phase 29: LM training, reduced, card vs CPU on the same weights")
    launches = {arch: _card_vs_cpu_training(torch, dev, arch, kernels)
                for arch, kernels in TRAIN_CPU_ARCHS.items()}

    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    for B, S, H, kvh, hd, dt in B6_GRAD_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn((B, S, h, hd), generator=gen, device=dev)
                       .to(dtype) for h in (H, kvh, kvh, H))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        _reset((B6,))
        o = attn_ops.causal_attention(*leaves)
        got = torch.autograd.grad(o, leaves, do)
        check(B6["flash_attention"] == 1, "the Function did not launch B6")
        del o
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = attn_ops.plain_attention(*leaves)
        want = torch.autograd.grad(o, leaves, do)
        del o
        errs = []
        for name, g, w in zip("qkv", got, want):
            err, bar = float((g.float() - w.float()).abs().max()), _ulp_bar(
                torch, w.float(), dtype)
            check(g.dtype == w.dtype and err <= bar, f"B6 Function d{name} "
                  f"vs autograd of plain_attention at {(B, S, H, kvh, hd)} "
                  f"{dt}: max |err| {err:.3e} > {bar:.3e}")
            errs.append(f"d{name} {err:.3e} (bar {bar:.3e})")
        print(f"  B6 Function vs autograd of plain_attention at (B, S, H, "
              f"KVH, hd) = {(B, S, H, kvh, hd)} {dt}: " + ", ".join(errs))
        del q, k, v, do, got, want, leaves

    Bq, S, di, N = B7_GRAD_SHAPE
    f = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    for dtype, h0 in ((torch.float32, False), (torch.bfloat16, True)):
        args = [3 * f(Bq, S, di), f(di) - 3, f(Bq, S, di), f(Bq, S, N),
                f(Bq, S, N), 0.5 * f(di, N), f(di), f(Bq, S, di),
                f(Bq, di, N) if h0 else None]
        for i in (0, 2, 3, 4, 7):
            args[i] = args[i].to(dtype)
        dy, dh = f(Bq, S, di).to(dtype), f(Bq, di, N)
        tag = f"(B, S, di, N) = {B7_GRAD_SHAPE} {str(dtype)[6:]} h0={h0}"
        share = _b7_function_vs_autograd(torch, args, dy, dh, tag)
        err, sum_share, _ = _check_b7_backward(torch, args, dy, dh, tag)
        print(f"  B7 Function (gated B7 + the backward kernel, one launch "
              f"each) vs autograd of plain_gated_scan at {tag}: all "
              f"{sum(a is not None for a in args)} input gradients within "
              f"their bars (worst {share:.3f} of 1e-6 max|g| fp32 / one "
              f"bf16 ulp); the kernel vs plain_gated_scan_backward: "
              f"ddt_raw, dx, dz{', dh0' if h0 else ''} bitwise, the sums "
              f"within {B7_SUM_REL} sum|terms| + {B7_SUM_ABS} (max |err| "
              f"{err:.3e}, worst {sum_share:.3f} of the bar), 3 launches "
              f"bitwise")
    print(f"phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase 30
TUNE_TOL = 2.0  # check_table's freshness bar (the reference's --check-tol)
TUNE_TABLE = ROOT / "src" / "repro_torch" / "tune" / "tables" / "cuda-sm90.json"


def phase_tune_sweep(torch, dev):
    """The autotune sweep on the card (``repro_torch.tune.sweep``): B1, B4
    and B2 at the reference's PROD_SHAPES + SMOKE_SHAPES, every config
    parity-gated (bitwise the default's output, within 2e-4 of the
    plain oracle; B2 bitwise ``scatter_runs_ref``) before it is timed,
    per envelope the default and the winner with their µs, a departure
    from the default re-timed on Zipf ids and kept only if it holds there;
    the swept table as one JSON line; B1's two copy schemes at the
    sparse training
    path's own Zipf batches; then ``check_table`` on the committed
    ``cuda-sm90.json`` at tol 2.0."""
    from repro_torch import tune
    from repro_torch.data.sparse import generate_sparse
    from repro_torch.kernels.lsplm_sparse_fused import ops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        launch_config,
        lsplm_sparse_fused_forward,
    )
    from repro_torch.launch.train import _theta0, _user_range
    from repro_torch.tune import sweep

    t_phase = time.perf_counter()
    shapes = sweep.PROD_SHAPES + sweep.SMOKE_SHAPES
    records = []
    table = sweep.sweep_shapes(
        shapes, device=dev, records=records, log=lambda msg: None,
        generator="python3 chip_smoke.py --only 30 (phase 30)")
    backend = tune.backend_key(dev)
    for r in records:
        check(r["best_us"] < float("inf"),
              f"{r['kernel']}/{r['envelope']}: no config passed parity")
        ratio = (f"{r['default_us'] / r['best_us']:.3f}x"
                 if r["default_us"] else "n/a")
        z = r["zipf"]
        print(f"phase 30: {r['kernel']} {r['envelope']} (N, K, d, m = "
              f"{tuple(r['shape'])}): default {r['default']} "
              + (f"{r['default_us']:.2f} us" if r["default_us"] else "-")
              + f", winner {r['best']} {r['best_us']:.2f} us, default/winner "
              f"{ratio}; {r['configs']} configs, {r['rejected']} rejected"
              + (f" ({'; '.join(sorted(set(r['rejected_why'])))})"
                 if r["rejected"] else "")
              + ("" if z is None else
                 f"; on Zipf ids default {z['default_us']:.2f} us, winner "
                 f"{z['best_us']:.2f} us, default/winner "
                 f"{z['default_us'] / z['best_us']:.3f}x: "
                 + ("held" if z["held"] else "not held"))
              + f"; table gets {r['committed']}")
    moved = [r for r in records if r["committed"] != r["default"]]
    print(f"phase 30: {len(moved)} of {len(records)} swept entries depart "
          f"from the builtin default"
          + "".join(f"; {r['kernel']} {r['envelope']} {r['committed']}"
                    for r in moved)
          + f" ({sum(r['zipf'] is not None for r in records)} departures "
          f"on uniform ids re-timed on Zipf ids, "
          f"{sum(bool(r['zipf'] and not r['zipf']['held']) for r in records)}"
          f" not held)")
    print("phase 30: swept table " + json.dumps(
        json.loads(table.to_json(backend)), sort_keys=True))

    # B1's copy schemes at the training path's Zipf batches (phase 6's
    # data: batch seed --seed + 1, Theta0 from --seed), in turns
    train = generate_sparse(num_features=D_FEATURES,
                            num_user_features_range=_user_range(D_FEATURES),
                            sessions=SESSIONS, seed=SEED + 1,
                            with_plans=False, device=dev)
    tp = ops.pad_theta(_theta0(D_FEATURES, REGIONS, SEED, dev))
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    for side, ids, vals in (("ad", train.ad_ids, train.ad_vals),
                            ("user", train.user_ids, train.user_vals)):
        n, k = ids.shape
        warps, rule = launch_config(n, k, 2 * REGIONS, int8=False,
                                    dedup=True)
        ms = {tune.COPY_LANE: [], tune.COPY_PIECE: []}
        outs = {}
        for copy in (tune.COPY_PIECE, tune.COPY_LANE, tune.COPY_LANE,
                     tune.COPY_PIECE):
            def fn(copy=copy):
                return lsplm_sparse_fused_forward(ids, vals, tp, dedup=True,
                                                  copy=copy)
            outs[copy] = fn()
            ms[copy].append(_time_ms(torch, fn, flush))
        check(all(torch.equal(a, b) for a, b in zip(
            outs[tune.COPY_LANE], outs[tune.COPY_PIECE])),
            f"B1's copy schemes differ at the training {side} side")
        lane, piece = (min(ms[tune.COPY_LANE]), min(ms[tune.COPY_PIECE]))
        print(f"phase 30: B1 copy schemes at the training {side} side "
              f"(Zipf, N={n:,} K={k}, dedup, {warps} rows a block; the rule "
              f"takes {'by piece' if rule == tune.COPY_PIECE else 'lane'}): "
              f"by piece {piece:.4f} ms, lane per row {lane:.4f} ms "
              f"(lane/piece {lane / piece:.3f}); runs by piece "
              f"{ms[tune.COPY_PIECE]}, lane {ms[tune.COPY_LANE]}; outputs "
              "bitwise equal")
    del train, tp, flush

    check(TUNE_TABLE.is_file(), f"no committed table at {TUNE_TABLE}")
    committed = tune.AutotuneTable.load(TUNE_TABLE)
    meta = committed.meta.get(backend, {})
    check(bool(meta.get("nvidia_smi")), "the committed table's meta does not "
          "name the card and its power limit")
    checks = []
    failures = sweep.check_table(shapes, committed, device=dev, tol=TUNE_TOL,
                                 records=checks, log=lambda msg: None)
    for r in checks:
        print(f"phase 30: check {r['kernel']} {r['envelope']}: committed "
              f"{r['committed']} {r['us']:.2f} us vs fresh best {r['best']} "
              f"{r['best_us']:.2f} us ({r['ratio']:.2f}x, bar {TUNE_TOL})")
    check(not failures, "check_table on the committed cuda-sm90.json: "
          + "; ".join(failures))
    print(f"phase 30: the committed {TUNE_TABLE.name} (swept on "
          f"{meta['nvidia_smi']}, torch {meta.get('torch')}, CUDA "
          f"{meta.get('cuda')}) passes check_table at tol {TUNE_TOL} on "
          f"{len(checks)} (kernel, envelope) pairs")
    print(f"phase 30 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ phase 31
def _off_rule_table(tune, backend):
    """A table holding, at every envelope of ``backend`` at 2m = 24, a
    config B1's, B4's and B2's rules do not take at the drivers' shapes:
    two rows a block (the rule takes 1 at N <= 132 and 8 past 528), fp32
    rows by piece (the rule copies lane per row below N = 2,048), B2's 128
    entries a block (the default 256). Returns (table, {wrapper: knobs})."""
    installed = {"lsplm_sparse_fused_forward": (2, tune.COPY_PIECE),
                 "lsplm_sparse_fused_int8_forward": (2,),
                 "lsplm_sparse_scatter": (128,)}
    table = tune.AutotuneTable()
    for n in tune.N_BUCKETS:
        for k in tune.K_BUCKETS:
            env = tune.fused_envelope(n, k, 2 * REGIONS)
            table.put(backend, "fused_fwd", env,
                      {"block_n": 2, "copy": tune.COPY_PIECE})
            table.put(backend, "fused_fwd_int8", env, {"block_n": 2})
    for e in tune.E_BUCKETS:
        table.put(backend, "scatter", tune.scatter_envelope(e, 2 * REGIONS),
                  {"block_e": 128})
    return table, installed


def _counting_knobs(module, name, keys, counts):
    """Wrap ``module.name`` (a kernel wrapper as its call site sees it) to
    count its calls by the knobs they pass; returns the original, which
    the caller puts back."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        key = (name, tuple(kw.get(x) for x in keys))
        counts[key] = counts.get(key, 0) + 1
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    return fn


def phase_tune_drivers(torch, dev, tmp: Path):
    """The tuning flags through the drivers on the card: ``launch.train
    --sparse`` untuned, ``--tune`` and ``--block-n 2`` give bitwise equal
    trajectories and Theta at d = 50,000; ``launch.serve --tune`` gives
    bitwise equal scores in fp32 and int8; both drivers again under an
    installed table whose entries the rules never take there, every
    kernel launched with those knobs; phase 3's G=1 dispatch wall
    with the committed table against an empty one, in turns; ``--block-k``
    exits with the stated departure."""
    from repro_torch import tune
    from repro_torch.kernels.lsplm_sparse_fused import ops as fops
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES as B1,
    )
    from repro_torch.kernels.lsplm_sparse_scatter import ops as sops
    from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
        LAUNCHES as B2,
    )
    from repro_torch.launch import serve, train as train_driver
    from repro_torch.serve.compress import compress
    from repro_torch.serve.engine import ScoringEngine, synthetic_requests

    t_phase = time.perf_counter()
    d = STREAM_GATE_D
    base = ["--sparse", "--sparse-features", str(d), "--sessions",
            str(STREAM_GATE_SESSIONS), "--regions", str(REGIONS), "--lam",
            str(LAM), "--beta", str(BETA), "--iters", "10", "--seed",
            str(SEED)]
    runs = {}
    for tag, extra in (("untuned", []), ("--tune", ["--tune"]),
                       ("--block-n 2", ["--block-n", "2"])):
        ckpt = str(tmp / f"theta{len(runs)}.npz")
        _reset((B1, B2))
        t0 = time.perf_counter()
        rep = train_driver.run(base + extra + ["--ckpt", ckpt])
        wall = time.perf_counter() - t0
        check(B1["lsplm_sparse_fused_forward"] > 0
              and B2["lsplm_sparse_scatter"] > 0,
              f"launch.train --sparse {tag} launched no B1 or B2")
        recs = [{k: v for k, v in r.items() if k != "wall_s"}
                for r in rep["iters"]]
        runs[tag] = (recs, np.load(ckpt)["theta"], ckpt)
        print(f"phase 31: launch.train --sparse {tag} (d={d:,}, "
              f"{STREAM_GATE_SESSIONS} sessions, 10 iterations): f "
              f"{recs[0]['f_new']:.4f} -> {recs[-1]['f_new']:.4f}, nnz "
              f"{recs[-1]['nnz']:,}, test AUC {rep['test_auc']:.4f}, "
              f"{wall:.1f} s with set-up")
    want, theta, ckpt = runs["untuned"]
    for tag in ("--tune", "--block-n 2"):
        check(runs[tag][0] == want and np.array_equal(
            runs[tag][1].view(np.int32), theta.view(np.int32)),
            f"launch.train --sparse {tag} left the untuned trajectory")
    check(not tune.get_overrides(), "the driver left overrides behind")
    print("phase 31: --tune and --block-n 2 trajectories and Theta bitwise "
          "equal to the untuned run's")

    untuned = {}
    for tag, extra in (("fp32", []), ("int8", ["--int8"])):
        argv = ["--ckpt", ckpt, "--requests", "256", "--seed", str(SEED)]
        plain = untuned[tag] = serve.run(argv + extra)["scores"]
        tuned = serve.run(argv + extra + ["--tune"])["scores"]
        check(np.array_equal(plain.view(np.int32), tuned.view(np.int32)),
              f"launch.serve --tune ({tag}) changed the scores")
        print(f"phase 31: launch.serve --tune ({tag}, d={d:,}): "
              f"{plain.size:,} scores bitwise equal to the untuned run's")

    # the table path itself: an installed table whose every envelope holds
    # a config the rule does not take at the drivers' shapes
    odd, installed = _off_rule_table(tune, tune.backend_key(dev))
    tune.set_active_table(odd)
    knobs = {}
    kept = [_counting_knobs(fops, name, keys, knobs) for name, keys in (
        ("lsplm_sparse_fused_forward", ("block_n", "copy")),
        ("lsplm_sparse_fused_int8_forward", ("block_n",)))]
    kept.append(_counting_knobs(sops, "lsplm_sparse_scatter", ("block_e",),
                                knobs))
    try:
        rep = train_driver.run(base + ["--ckpt", str(tmp / "theta_odd.npz")])
        odd_theta = np.load(tmp / "theta_odd.npz")["theta"]
        served = {tag: serve.run(["--ckpt", ckpt, "--requests", "256",
                                  "--seed", str(SEED)] + extra)["scores"]
                  for tag, extra in (("fp32", []), ("int8", ["--int8"]))}
    finally:
        for (module, name), fn in zip(
                ((fops, "lsplm_sparse_fused_forward"),
                 (fops, "lsplm_sparse_fused_int8_forward"),
                 (sops, "lsplm_sparse_scatter")), kept):
            setattr(module, name, fn)
        tune.set_active_table(None)
    check([{k: v for k, v in r.items() if k != "wall_s"}
           for r in rep["iters"]] == want
          and np.array_equal(odd_theta.view(np.int32), theta.view(np.int32)),
          "launch.train --sparse under the off-rule table left the untuned "
          "trajectory")
    for tag, scores in served.items():
        check(np.array_equal(untuned[tag].view(np.int32),
                             scores.view(np.int32)),
              f"launch.serve ({tag}) under the off-rule table changed the "
              "scores")
    for name, want in installed.items():
        check(knobs.get((name, want), 0) > 0,
              f"no {name} launch took the installed {want}")
    entries = sum(len(e) for e in odd.entries(
        tune.backend_key(dev)).values())
    print(f"phase 31: under an installed table holding {installed} at "
          f"every envelope ({entries} entries), launch.train --sparse gives "
          f"the untuned trajectory and Theta and launch.serve the untuned "
          f"scores (fp32, int8), bitwise; launches by knobs: "
          f"{dict(sorted(knobs.items(), key=str))}")

    # phase 3's model and G=1 dispatches, committed table vs empty, in turns
    rng = np.random.default_rng(SEED)
    theta = np.zeros((D_FEATURES, 2 * REGIONS), np.float32)
    alive = rng.random(D_FEATURES) < ALIVE_FRACTION
    theta[alive] = (rng.normal(size=(int(alive.sum()), 2 * REGIONS))
                    * 0.3).astype(np.float32)
    art = compress(theta)
    reqs = synthetic_requests(128, num_features=D_FEATURES, seed=SEED + 6)
    engine = ScoringEngine(art, device="cuda")
    engine.warm({engine.envelope(r) for r in reqs},
                batch_sizes=engine.g_buckets)
    walls = {"committed": [], "empty": []}
    scores = {}
    for tag in ("committed", "empty", "empty", "committed"):
        tune.set_active_table(None if tag == "committed"
                              else tune.AutotuneTable())
        engine.score_many(reqs[:16])  # the shapes' knobs resolved once
        t0 = time.perf_counter()
        scores[tag] = engine.score_many(reqs)
        walls[tag].append((time.perf_counter() - t0) * 1e6 / len(reqs))
    tune.set_active_table(None)
    check(all(np.array_equal(a, b) for a, b in zip(scores["committed"],
                                                   scores["empty"])),
          "the committed table changed the G=1 scores")
    hits = sorted({tune.fused_envelope(*shape, 2 * REGIONS)
                   for r in reqs for shape in (
                       (1, engine.envelope(r)[0]),
                       (engine.envelope(r)[2], engine.envelope(r)[1]))}
                  & set(tune.active_table().entries(
                      tune.backend_key(dev)).get("fused_fwd", {})))
    print(f"phase 31: G=1 dispatch wall (phase 3's model, {len(reqs)} "
          f"requests a run): committed table "
          f"{', '.join(f'{w:.1f}' for w in walls['committed'])} us, empty "
          f"table {', '.join(f'{w:.1f}' for w in walls['empty'])} us "
          f"(runs in turns: committed, empty, empty, committed); scores "
          f"bitwise equal; dispatch envelopes with a committed fused_fwd "
          f"entry: {hits or 'none'}")
    on = torch.device("cuda", torch.cuda.current_device())  # as ops.py asks
    key = ("fused_fwd", 1, 24, 2 * REGIONS, on)
    tune.resolve_fused(*key)
    t0 = time.perf_counter()
    for _ in range(100_000):
        tune.resolve_fused(*key)
    per_us = (time.perf_counter() - t0) * 10
    print(f"phase 31: resolving a seen shape's knobs (resolve_fused on "
          f"{on}): {per_us:.3f} us of host time a launch, 2 launches "
          f"a G=1 dispatch")

    try:
        train_driver.run(base + ["--block-k", "4"])
        check(False, "launch.train --block-k 4 did not exit")
    except SystemExit as e:
        check("no counterpart on the card" in str(e),
              f"--block-k 4 exited with {e}")
        print(f"phase 31: --block-k 4 exits: {e}")
    print(f"phase 31 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ phases 32-33
# the meshes on the one card, grouped by world: each world is spawned
# once and runs its meshes in turn (a spawn costs ~15 s on the card)
SHARD_WORLDS = {4: ((2, 2),), 2: ((1, 2), (2, 1))}
SHARD_LOSS_RTOL, SHARD_GRAD_ATOL = 2e-5, 3e-5  # tests/test_shard_step.py
SHARD_D, SHARD_SESSIONS, SHARD_ITERS = 50_000, 512, 6  # phase 33
SHARD_DENSE = (25_000, 20_000, 5_000, 256)  # user, ad, noise, sessions
SHARD_STREAM_DAYS = 3


def _sparse_counters():
    """The launch counters of B1, B2 and B3 in this process."""
    from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
        LAUNCHES as B1,
    )
    from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
        LAUNCHES as B2,
    )
    from repro_torch.kernels.owlqn_direction.owlqn_direction import (
        LAUNCHES as B3,
    )
    return (B1, B2, B3)


def _shard_entries(routed) -> list[int]:
    """Routed (user + ad) entries each id-range shard holds."""
    R = routed.rows_per_shard
    return [int((routed.user_ids[s] != R).sum() + (routed.ad_ids[s] != R).sum())
            for s in range(routed.num_shards)]


def _untouched_max(torch, routed, shard: int, grad) -> float:
    """The largest |dTheta| on the rows of ``shard``'s block that no routed
    id touches (its pad rows included): must be exactly 0."""
    R = routed.rows_per_shard
    touched = torch.zeros(R + 1, dtype=torch.bool)
    for ids in (routed.user_ids[shard], routed.ad_ids[shard]):
        touched[ids.reshape(-1).long()] = True
    rows = (~touched[:R]).to(grad.device)
    return float(grad[rows].abs().max()) if bool(rows.any()) else 0.0


def _cell_kernels(torch, cell, theta, grad, tag):
    """B1, B2 and B3 against their plain versions at the shapes the
    sharded path gives them on this rank, with phase 5's bars: B1 on the
    cell's local ids into the (R + 1)-row padded block at ``theta`` (the
    rank's rows, in-kernel dedup, bitwise the pre-pass + B1), B2 on the
    cell's sliced plans (and the card-sorted layout bitwise), B3 bitwise
    on the rank's all-reduced dTheta block ``grad``. Returns (max abs
    errors, what was checked)."""
    from repro_torch.kernels.lsplm_sparse_scatter import ops as sops

    b = cell.batch
    e, shapes = _b1_at_training_shapes(torch, ((tag, b),), theta)
    err = {"lsplm_sparse_fused_forward": e, "lsplm_sparse_scatter": 0.0}
    rng = np.random.default_rng(SEED + 32 + cell.data_rank * cell.num_shards
                                + cell.model_rank)
    for side, ids, vals, plan in (
            ("user", b.user_ids, b.user_vals, b.user_plan),
            ("ad", b.ad_ids, b.ad_vals, b.ad_plan)):
        dz = torch.from_numpy(rng.normal(size=(vals.shape[0], 2 * REGIONS))
                              .astype(np.float32)).to(vals.device)
        e = _check_scatter(torch, sops, plan, vals, dz, f"{tag} {side} side")
        unplanned = sops.scatter_add_unplanned(ids, vals, dz, plan.num_rows,
                                               plan.num_rows - 1)
        check(torch.equal(unplanned, sops.scatter_add_planned(plan, vals, dz)),
              f"B2 on the card-sorted entries differs from the plan's "
              f"({tag} {side} side)")
        err["lsplm_sparse_scatter"] = max(err["lsplm_sparse_scatter"], e)
        shapes.append(f"{side} plan E'={plan.num_kept:,} "
                      f"U={plan.num_unique:,} rows={plan.num_rows:,}")
    err["owlqn_direction"] = _check_b3(
        torch, theta, grad, LAM, BETA,
        f"{tag} dTheta block {tuple(theta.shape)}", exact=True)
    return err, shapes


def _shard_rank(rank, dev, data, model):
    """One rank of phase 32 (module level: the spawned ranks import it).
    The training driver's problem at paper width on a (data, model) mesh
    (``launch.train.sharded_sparse_problem``): the loss and gradient at
    Theta0 over equal and over balanced id ranges, TRAIN_ITERS sharded
    OWLQN+ steps with their walls, all-reduces and launches (counted from
    0 just before them), the gathered Theta, then one more step under
    torch.profiler. B1, B2 and B3 are held against their plain versions
    on this rank's cell of each partition (:func:`_cell_kernels`) before
    the counted steps. Rank 0 returns the gathered arrays."""
    import torch

    from repro_torch.data.sparse import generate_sparse
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import sharded_sparse_problem
    from repro_torch.shard.partition import balanced_partition

    mesh = Mesh(data, model)
    root = mesh.rank == 0
    kw = dict(lam=LAM, beta=BETA, seed=SEED, batch_seed=SEED + 1, mesh=mesh,
              device=dev)
    t0 = time.perf_counter()
    routed, part, cell, theta0, opt = sharded_sparse_problem(
        D_FEATURES, REGIONS, SESSIONS, **kw)
    torch.cuda.synchronize()
    out = {"rank": rank, "backend": mesh.backend,
           "setup_s": time.perf_counter() - t0, "bounds": {}, "entries": {},
           "untouched_max": {}, "loss0": {}, "grad0": {}, "kernels": {}}

    def progress(what):  # rank 0's stages, as they end
        if root:
            print(f"    [{data} x {model}] rank 0: {what} at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

    progress("set-up")
    host = generate_sparse(num_features=D_FEATURES,
                           num_user_features_range=(int(0.6 * D_FEATURES),
                                                    D_FEATURES),
                           sessions=SESSIONS, seed=SEED + 1, with_plans=False,
                           device="cpu")
    balanced = balanced_partition(D_FEATURES, model, host.user_ids,
                                  host.ad_ids, pad_id=D_FEATURES)
    # one id range has nothing to balance
    for name in ("equal", "balanced") if model > 1 else ("equal",):
        if name == "equal":
            r, p, c, o, th = routed, part, cell, opt, theta0
        else:
            r, p, c, th, o = sharded_sparse_problem(
                D_FEATURES, REGIONS, SESSIONS, **kw, partition=balanced)
        loss, grad = o.loss_and_grad(th)
        out["kernels"][name] = _cell_kernels(
            torch, c, th, grad, f"{data} x {model} rank {rank} cell of the "
            f"{name} ranges")
        out["bounds"][name] = p.bounds.tolist()
        out["entries"][name] = _shard_entries(r)
        out["untouched_max"][name] = _untouched_max(torch, r,
                                                    mesh.model_rank, grad)
        out["loss0"][name] = float(loss)
        g = p.unpad_rows(mesh.gather_rows(grad))
        out["grad0"][name] = g.cpu().numpy() if root else None
        del r, c, o, th, grad, g
        progress(f"loss and gradient over {name} ranges")
    counters = _sparse_counters()
    _reset(counters)
    mesh.reset_counts()
    state = opt.init(theta0)
    its, walls = [], []
    for _ in range(TRAIN_ITERS):
        t1 = time.perf_counter()
        state, s = opt.step(state)  # ends in host syncs
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        its.append((s.f, s.f_new, s.alpha, s.nnz, s.ls_iters))
    out["launches"] = {"lsplm_sparse_fused_forward":
                       counters[0]["lsplm_sparse_fused_forward"],
                       **counters[1], **counters[2]}
    out.update(iters=its, walls=walls, collectives=mesh.collective_counts())
    theta = part.unpad_rows(mesh.gather_rows(state.theta))
    out["theta"] = theta.cpu().numpy() if root else None
    del theta
    progress(f"{TRAIN_ITERS} steps and the gathered Theta")
    (_, s), wall_us, kernels = _device_profile(torch,
                                               lambda: opt.step(state))
    out["profile"] = {
        "wall_us": wall_us, "ls_iters": s.ls_iters,
        "device_us": sum(v[0] for v in kernels.values()),
        "copy_us": sum(v[0] for name, v in kernels.items()
                       if "memcpy" in name.lower()),
        "launches": sum(v[1] for v in kernels.values()),
        "ours": {label: sum(n for name, (_, n) in kernels.items()
                            if label in name)
                 for label in SPARSE_STEP_KERNELS}}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _shard_world(rank, dev, shapes):
    """One rank of a spawned world: :func:`_shard_rank` on each (data,
    model) mesh of ``shapes`` in turn."""
    return {shape: _shard_rank(rank, dev, *shape) for shape in shapes}


def _flips(theta, ref) -> int:
    """Elements whose sign (or zero) differs between two Thetas."""
    return int((np.sign(theta) != np.sign(ref)).sum())


def _gate_theta(theta, ref, tag, share) -> str:
    allowed = int(share * ref.size)
    beyond = int(_beyond_bar(theta, ref).sum())
    flips = _flips(theta, ref)
    check(beyond <= allowed and flips <= allowed,
          f"{tag}: Theta beyond rtol {TRAJ_RTOL}/atol {TRAJ_ATOL} in {beyond}"
          f" elements, {flips} flipped in sign or zero (allowed {allowed})")
    return (f"Theta beyond the bar in {beyond}, flipped {flips} of "
            f"{ref.size:,} (allowed {allowed}), max |diff| "
            f"{float(np.abs(theta - ref).max()):.2e}")


def _gate_fs(fs, ref, tag) -> float:
    err = float(np.max(np.abs(np.subtract(fs, ref)) / np.abs(ref)))
    check(err <= TRAJ_F_RTOL, f"{tag}: f rtol {err:.2e}")
    return err


def phase_shard(torch, dev):
    """Sharded LS-PLM training at paper width: the training driver's
    problem (d = 10^6, m = 12, 4,000 sessions x 4 ads, lam = beta = 0.05,
    TRAIN_ITERS iterations) unsharded on the card, on a 1 x 1 mesh (bitwise
    the unsharded run) and on the meshes of SHARD_WORLDS as spawned ranks
    sharing the one card (gloo). Each mesh against the unsharded run: the loss and
    gradient at Theta0 over equal and balanced ranges, untouched and pad
    rows' gradient exactly 0, f and Theta at phase 7's bars, every rank's
    f, step size and nnz bitwise equal. Returns the 2 x 2 run's launches
    summed over its ranks (the ``train_sharded`` path) and the max abs
    errors of B1, B2 and B3 against their plain versions on every rank's
    cell."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.train import sparse_problem

    t0 = time.perf_counter()
    batch, theta0, opt = sparse_problem(D_FEATURES, REGIONS, SESSIONS,
                                        lam=LAM, beta=BETA, seed=SEED,
                                        batch_seed=SEED + 1, device=dev)
    loss0, grad0 = opt.loss_and_grad(theta0)
    grad0 = grad0.cpu().numpy()
    g_scale = max(1.0, float(np.abs(grad0).max()))
    state = opt.init(theta0)
    fs, walls = [], []
    for _ in range(TRAIN_ITERS):
        t1 = time.perf_counter()
        state, s = opt.step(state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        fs.append(s.f_new)
    ref_theta = state.theta.cpu().numpy()
    del batch, opt, state
    print(f"phase 32: unsharded at d={D_FEATURES:,}, m={REGIONS}, "
          f"{SESSIONS:,} sessions: {np.median(walls) * 1e3:.2f} ms/iter "
          f"(median of {TRAIN_ITERS}), f {fs[0]:.2f} -> {fs[-1]:.2f} "
          f"({time.perf_counter() - t0:.1f} s with set-up)")

    one = _shard_rank(0, dev, 1, 1)
    check(one["iters"] and [it[1] for it in one["iters"]] == fs,
          "the 1 x 1 mesh's f trajectory is not bitwise the unsharded one")
    check(np.array_equal(one["theta"], ref_theta)
          and np.array_equal(one["grad0"]["equal"], grad0)
          and one["loss0"]["equal"] == float(loss0),
          "the 1 x 1 mesh's Theta, loss or gradient is not bitwise the "
          "unsharded one")
    print(f"  1 x 1 mesh: loss, gradient, {TRAIN_ITERS} steps' f and Theta "
          f"bitwise the unsharded run; {np.median(one['walls']) * 1e3:.2f} "
          f"ms/iter; B1, B2, B3 vs plain on its cell (phase 5's bars) max "
          f"|err| " + ", ".join(f"{e:.2e}"
                                for e in one["kernels"]["equal"][0].values()))
    train_sharded, runs = {}, {}
    kernel_err = dict(one["kernels"]["equal"][0])
    for size, shapes in SHARD_WORLDS.items():
        t1 = time.perf_counter()
        world = run_ranks(_shard_world, size, shapes, device=dev)
        wall = time.perf_counter() - t1
        print(f"  a world of {size} ranks on one card ran the meshes "
              f"{list(shapes)} in {wall:.1f} s, spawn and set-up included")
        runs.update({shape: [r[shape] for r in world] for shape in shapes})
    for (data, model), ranks in runs.items():
        r0, tag = ranks[0], f"mesh {data} x {model}"
        for name in r0["loss0"]:
            err = abs(r0["loss0"][name] - float(loss0)) / float(loss0)
            check(err <= SHARD_LOSS_RTOL, f"{tag} {name}: loss rtol {err:.2e}")
            gerr = float(np.abs(r0["grad0"][name] - grad0).max()) / g_scale
            check(gerr <= SHARD_GRAD_ATOL,
                  f"{tag} {name}: gradient {gerr:.2e} of g_scale")
            worst = max(r["untouched_max"][name] for r in ranks)
            check(worst == 0.0, f"{tag} {name}: untouched or pad rows' "
                  f"gradient {worst:.2e}, not 0")
            lines = []
            for r in ranks:
                errs, shapes = r["kernels"][name]
                for k, e in errs.items():
                    kernel_err[k] = max(kernel_err[k], e)
                lines.append(
                    f"rank {r['rank']} ({', '.join(shapes[2:])}; B1 "
                    f"{', '.join(x.split(' ranges ')[-1] for x in shapes[:2])}"
                    f"): max |err| B1 {errs['lsplm_sparse_fused_forward']:.2e}"
                    f", B2 {errs['lsplm_sparse_scatter']:.2e}, B3 "
                    f"{errs['owlqn_direction']:.2e}")
            print(f"  {tag} {name} ranges, kernels vs plain on each rank's "
                  f"cell at Theta0 (phase 5's bars: B1 z rtol {Z_RTOL}/atol "
                  f"{Z_ATOL}, p atol {P_ATOL}, bitwise the pre-pass + B1; B2 "
                  f"bitwise scatter_runs_ref and the card-sorted layout, "
                  f"|err| <= {B2_REL} x sum|terms| + {B2_ABS}, pad and "
                  f"untouched rows 0; B3 bitwise on the dTheta block): "
                  + "; ".join(lines))
        check(all(r["iters"] == r0["iters"] for r in ranks),
              f"{tag}: the ranks' f, step sizes or nnz differ")
        f_err = _gate_fs([it[1] for it in r0["iters"]], fs, tag)
        theta_line = _gate_theta(r0["theta"], ref_theta, tag, PATTERN_SHARE)
        launches = {n: sum(r["launches"][n] for r in ranks)
                    for n in r0["launches"]}
        for n, c in launches.items():
            check(c > 0, f"{tag}: the sharded path never launched {n}")
        if (data, model) == (2, 2):
            train_sharded = launches
        per_iter = {a: {k: v / TRAIN_ITERS for k, v in c.items()}
                    for a, c in r0["collectives"].items()}
        ls = sum(it[4] for it in r0["iters"])
        print(f"  {tag} ({data * model} ranks on one card, backend "
              f"{r0['backend']}): "
              f"{np.median(r0['walls']) * 1e3:.2f} ms/iter (median; rank 0; "
              f"{ls} line-search trials), f rel {f_err:.2e}, "
              f"{theta_line}; loss/grad at Theta0 within "
              f"{SHARD_LOSS_RTOL}/{SHARD_GRAD_ATOL} over "
              f"{' and '.join(r0['loss0'])} ranges, untouched and pad rows' "
              f"dTheta 0; every rank's f, "
              f"alpha, nnz bitwise equal; all-reduces per iteration "
              + ", ".join(f"{a} {c['all_reduce']:.1f} ({c['bytes'] / 1e6:.3f}"
                          f" MB, {c['seconds'] * 1e3:.2f} ms on rank 0's "
                          f"host)" for a, c in per_iter.items())
              + f"; launches over ranks {launches}")
        print("    entries per shard: " + ", ".join(
            f"{name} {r0['entries'][name]} (bounds {r0['bounds'][name]})"
            for name in r0["entries"]))
        for r in ranks:
            p = r["profile"]
            idle = (1 - p["device_us"] / p["wall_us"] if p["device_us"]
                    else float("nan"))
            dev_ms = (f"{p['device_us'] / 1e3:.2f} ms of device in "
                      f"{p['launches']} launches, {p['copy_us'] / 1e3:.2f} "
                      f"ms of it copies (idle {idle:.1%})"
                      if p["launches"] else "device time not measured")
            in_ar = ", ".join(
                f"{a} {c['seconds'] * 1e3 / TRAIN_ITERS:.2f}"
                for a, c in r["collectives"].items())
            print(f"    rank {r['rank']}: set-up {r['setup_s']:.1f} s, "
                  f"{np.median(r['walls']) * 1e3:.2f} ms/iter, of it in "
                  f"all-reduces (host wall, mean per iteration) {in_ar} ms;"
                  f" profiled "
                  f"step ({p['ls_iters']} trials) {p['wall_us'] / 1e3:.2f} "
                  f"ms wall, {dev_ms}, hand-written {p['ours']}; peak "
                  f"{r['peak_gb']:.2f} GB")
    return train_sharded, kernel_err


def _shard_stream_rank(rank, dev, tmp):
    """Phase 33's stream gates on one rank of a 2 x 2 mesh: the full
    window under ``history="reset"`` bitwise the sharded full batch on the
    same mesh, and a checkpoint taken mid-stream resuming bitwise."""
    import torch

    from repro_torch.data.sparse import build_batch_plans
    from repro_torch.dist import make_distributed_step, shard_sparse_batch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.owlqn_plus import OWLQNPlus
    from repro_torch.shard.partition import make_partition
    from repro_torch.shard.step import make_sharded_sparse_loss
    from repro_torch.stream import DayStream, StreamTrainer

    mesh = Mesh(2, 2)
    days, d = SHARD_STREAM_DAYS, SHARD_D
    stream = DayStream(days, sessions_per_day=SHARD_SESSIONS,
                       num_features=d, active_user=STREAM_K[0],
                       active_ad=STREAM_K[1], drift=STREAM_DRIFT, seed=SEED)
    theta0 = torch.from_numpy(_seen_theta0(stream, days, REGIONS))
    part = make_partition(d, mesh.model)
    full = build_batch_plans(stream.window(days - 1, days), shards=part,
                             data_shards=mesh.data)
    loss_and_grad, loss = make_sharded_sparse_loss(
        shard_sparse_batch(mesh, full, dev), mesh)
    opt = OWLQNPlus(loss_and_grad, lam=LAM, beta=BETA, loss=loss)
    step = make_distributed_step(opt, mesh)
    st = opt.init(part.shard_rows(part.pad_rows(theta0),
                                  mesh.model_rank).to(dev))
    fs_ref = []
    for _ in range(STREAM_INNER):
        st, s = step(st)
        fs_ref.append(s.f_new)
    tr = StreamTrainer(stream, lam=LAM, beta=BETA, window=days,
                       inner_iters=STREAM_INNER, mesh=mesh, device=dev)
    state, trace = tr.run(tr.init(theta0)._replace(day=days - 1), days=1)
    full_ok = (list(trace[0].fs) == fs_ref
               and torch.equal(st.theta, state.opt.theta))
    tr = StreamTrainer(stream, lam=LAM, beta=BETA, window=STREAM_WINDOW,
                       inner_iters=STREAM_INNER, mesh=mesh, device=dev)
    mid, _ = tr.run(tr.init(theta0), days=days - 1)
    path = tr.save(str(Path(tmp) / "stream.npz"), mid)
    torch.distributed.barrier()
    back = tr.load(path, theta0)
    fin_a, ta = tr.run(mid, days=1)
    fin_b, tb = tr.run(back, days=1)
    theta_a, theta_b = tr.theta(fin_a), tr.theta(fin_b)
    return {"full_window_bitwise": bool(full_ok), "fs": fs_ref,
            "resume_bitwise": ([w.fs for w in ta] == [w.fs for w in tb]
                               and bool(torch.equal(theta_a, theta_b))),
            "resumed_day": back.day}


def phase_shard_drivers(torch, dev, tmp: Path):
    """``launch.train`` with ``--mesh-data 2 --mesh-model 2`` at d = 50,000
    in its three modes (sparse, dense, stream), each against its unsharded
    run at phase 7's bars with every rank's scalars bitwise equal; the
    sparse run's checkpoint (the unpadded Theta) loads unsharded and gives
    its final objective; then the stream's full window under reset against
    the sharded full batch and a mid-stream checkpoint's resume, both
    bitwise, on the same mesh. Its walls are not metrics: in the whole
    script it runs beside phases 27, 35 and 37."""
    from repro_torch.io import checkpoint
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.train import sparse_problem

    mesh_flags = ["--mesh-data", "2", "--mesh-model", "2"]
    du, da, dn, dsess = SHARD_DENSE
    runs = {
        "sparse": ["--sparse", "--sparse-features", str(SHARD_D),
                   "--sessions", str(SHARD_SESSIONS), "--regions",
                   str(REGIONS), "--lam", str(LAM), "--beta", str(BETA),
                   "--iters", str(SHARD_ITERS), "--device", str(dev)],
        "dense": ["--user-features", str(du), "--ad-features", str(da),
                  "--noise-features", str(dn), "--sessions", str(dsess),
                  "--regions", str(REGIONS), "--lam", str(DENSE_LAM),
                  "--beta", str(DENSE_BETA), "--iters", str(SHARD_ITERS),
                  "--device", str(dev)],
        "stream": _stream_argv(dev, SHARD_D, SHARD_SESSIONS,
                               SHARD_STREAM_DAYS)}
    for mode, argv in runs.items():
        ck = [str(tmp / f"{mode}-single.npz"), str(tmp / f"{mode}-mesh.npz")]
        t0 = time.perf_counter()
        single = train_driver.run(argv + ["--ckpt", ck[0]])
        t1 = time.perf_counter()
        mesh = train_driver.run(argv + ["--ckpt", ck[1]] + mesh_flags)
        t2 = time.perf_counter()
        tag = f"{mode} driver 2 x 2 vs unsharded"
        if mode == "stream":
            fs = [f for w in mesh["windows"] for f in w["fs"]]
            ref = [f for w in single["windows"] for f in w["fs"]]
            theta, ref_theta = (mesh["theta"].numpy(),
                                single["theta"].cpu().numpy())
            consistent = all(r["windows"] == mesh["ranks"][0]["windows"]
                             for r in mesh["ranks"])
        else:
            fs = [r["f_new"] for r in mesh["iters"]]
            ref = [r["f_new"] for r in single["iters"]]
            theta = np.load(ck[1])["theta"]
            ref_theta = np.load(ck[0])["theta"]
            consistent = all(r["iters"] == mesh["ranks"][0]["iters"]
                             for r in mesh["ranks"])
        check(consistent, f"{tag}: the ranks' scalars differ")
        f_err = _gate_fs(fs, ref, tag)
        line = _gate_theta(theta, ref_theta, tag, PATTERN_SHARE)
        launches = {}
        for r in mesh["ranks"]:
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
        wanted = (("owlqn_direction",) if mode == "dense" else
                  ("lsplm_sparse_fused_forward", "lsplm_sparse_scatter",
                   "owlqn_direction"))
        check(all(r["launches"].get(n, 0) > 0 for r in mesh["ranks"]
                  for n in wanted),
              f"{tag}: a rank never launched one of {wanted}: "
              f"{[r['launches'] for r in mesh['ranks']]}")
        print(f"phase 33: {tag}: f rel {f_err:.2e}, {line}; every rank's "
              f"scalars bitwise equal; backend {mesh['ranks'][0]['backend']}"
              f"; walls unsharded {t1 - t0:.1f} s, 2 x 2 {t2 - t1:.1f} s "
              f"(spawn included); launches over ranks "
              f"{ {n: c for n, c in launches.items() if c} }")
        if mode == "sparse":
            batch, _, opt = sparse_problem(SHARD_D, REGIONS, SHARD_SESSIONS,
                                           lam=LAM, beta=BETA, seed=SEED,
                                           batch_seed=SEED + 1, device=dev)
            loaded = checkpoint.load(ck[1], {"theta": torch.zeros(
                SHARD_D, 2 * REGIONS, device=dev)})["theta"]
            f = float(opt.objective(loaded))
            err = abs(f - fs[-1]) / abs(fs[-1])
            check(err <= SHARD_LOSS_RTOL,
                  f"the sharded checkpoint's objective {f:.4f} unsharded vs "
                  f"{fs[-1]:.4f} (rtol {err:.2e})")
            print(f"  the 2 x 2 checkpoint (unpadded Theta) loads unsharded:"
                  f" f {f:.4f} against the run's {fs[-1]:.4f} (rtol "
                  f"{err:.2e}, bar {SHARD_LOSS_RTOL})")
            del batch, opt, loaded
    t0 = time.perf_counter()
    ranks = run_ranks(_shard_stream_rank, 4, str(tmp), device=dev)
    check(all(r["full_window_bitwise"] for r in ranks),
          "the sharded stream's full window under reset is not bitwise the "
          "sharded full batch")
    check(all(r["resume_bitwise"] and r["resumed_day"] == SHARD_STREAM_DAYS - 1
              for r in ranks), "the sharded stream's resume is not bitwise")
    print(f"  stream on the 2 x 2 mesh: full window ({SHARD_STREAM_DAYS} "
          f"days, reset) bitwise the sharded full batch (f "
          f"{[round(f, 4) for f in ranks[0]['fs']]}), a day-"
          f"{SHARD_STREAM_DAYS - 1} checkpoint resumes bitwise "
          f"({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------------ phases 34-35
# sharded LM serving at full width: the meshes on the one card, grouped by
# world (a spawned world runs its meshes in turn), with the families each
# runs and the MoE plan of each run
SERVE_SHARD_CASES = {
    (2, 2): ((LM_ARCH, "weight_gather"), (MOE_ARCH, "token_gather"),
             (MOE_ARCH, "weight_gather"), (HYBRID_ARCH, "weight_gather")),
    (1, 2): ((LM_ARCH, "weight_gather"), (MOE_ARCH, "weight_gather"),
             (SSM_ARCH, "weight_gather"), (HYBRID_ARCH, "weight_gather"))}
# the sharding knobs by name, as config overrides: full-width llama runs
# one fp32 prefill under each on 1 x 2 (phase 34), reduced models train
# under them (phase 37)
KNOBS = {"seq_parallel": {"seq_parallel": True},
         "head_dim": {"attn_shard": "head_dim"}}
SERVE_SHARD_WORLDS = {4: ((2, 2),), 2: ((1, 2),)}
# 3 greedy tokens (2 decode steps, the fp32 gate's count; cut from 16:
# a weight_gather decode step gathers the experts' 1.2 GB over gloo)
SERVE_SHARD_BATCH, SERVE_SHARD_SEQ, SERVE_SHARD_NEW = 4, 512, 3
# the first-use prefill's length: the kernels, cuBLAS and gloo are set up
# by any length, and a full one cost up to 4.5 s of gloo a case (one SSD
# chunk, so the hybrid takes it)
SERVE_SHARD_WARM = 64
# the fp32 gates against one rank: prefill logits and this many decode
# steps fed one rank's tokens, at an fp32 bar (sound runs on the H100 read
# at most ~8e-5 (1 + |logit|))
SERVE_SHARD_TOL32, SERVE_SHARD_STEPS32 = 1e-3, 2  # steps cut from 4
SERVE_SHARD_REDUCED = (LM_ARCH, SSM_ARCH, MOE_ARCH,
                       HYBRID_ARCH)  # phase 35, fp32


def _lm_counters():
    """The launch counters of B6 and B7 in this process."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )
    from repro_torch.kernels.mamba_scan.mamba_scan import LAUNCHES as B7

    return B6, B7


def _plain_capture(fn):
    """``fn()`` with B6's and B7's plain versions in place of the model's
    attention and gated-scan hooks for this one call, and the arguments
    of the first call of each ({"B6": (q, k, v), "B7": the scan's}, a
    key absent where the model made no such call)."""
    from repro_torch.kernels.flash_attention.ops import plain_attention
    from repro_torch.kernels.mamba_scan.ops import plain_gated_scan
    from repro_torch.models import ssm, transformer

    seen = {}

    def keeping(name, plain):
        def call(*args, **kw):
            seen.setdefault(name, args)
            return plain(*args, **kw)
        return call

    hooks = ((transformer.attention_ops, "causal_attention", "B6",
              plain_attention),
             (ssm.ops, "gated_selective_scan", "B7", plain_gated_scan))
    kernels = [getattr(mod, attr) for mod, attr, _, _ in hooks]
    for mod, attr, name, plain in hooks:
        setattr(mod, attr, keeping(name, plain))
    try:
        return fn(), seen
    finally:
        for (mod, attr, _, _), kernel in zip(hooks, kernels):
            setattr(mod, attr, kernel)


def _split_products(fn, parts: int, ff_parts: int = 1):
    """``fn()`` with the model's row-parallel products (wo, w2, x_proj,
    out_proj) and its MoE expert sum computed as a mesh of ``parts``
    model ranks computes them: each rank's slice of the contracted axis
    (of the MoE: its E / parts experts and, with ``ff_parts`` data ranks,
    its slice of d_ff, token_gather's layout) a product of its own in the
    activation dtype, the partials summed in fp32 in the mesh's order
    (over model, then over data) and rounded once; and Mamba2's gated
    norm's mean of squares as each rank's sum over its d_inner / parts
    channels, summed in fp32 and divided by d_inner. On one process: the
    witness that this rounding order is what parts a mesh's bf16 logits
    from one rank's."""
    import torch

    from repro_torch.models import layers, moe, ssm

    row, dispatch = layers.row_parallel, moe.dispatch_compute
    mean_sq = ssm._mean_sq

    def split_mean_sq(y, cfg, mesh=None):
        acc = None
        for part in y.chunk(parts, -1):
            part = part.contiguous()
            ss = torch.sum(part * part, dim=-1, keepdim=True)
            acc = ss if acc is None else acc + ss
        return acc / cfg.d_inner

    def split_row(x, w, mesh=None):
        k, acc = x.shape[-1] // parts, None
        for i in range(parts):
            y = (x[..., i * k:(i + 1) * k].contiguous()
                 @ w[i * k:(i + 1) * k].to(x.dtype)).float()
            acc = y if acc is None else acc + y
        return acc.to(x.dtype)

    def split_dispatch(x_flat, gate, idx, w1, w3, w2, capacity,
                       expert_lo=0):
        e, f, acc = w1.shape[0] // parts, w1.shape[2] // ff_parts, None
        for j in range(ff_parts):
            part = None
            for i in range(parts):
                ex, ff = slice(i * e, (i + 1) * e), slice(j * f, (j + 1) * f)
                y = dispatch(x_flat, gate, idx,
                             w1[ex, :, ff].contiguous(),
                             w3[ex, :, ff].contiguous(),
                             w2[ex, ff].contiguous(), capacity,
                             expert_lo=expert_lo + i * e).float()
                part = y if part is None else part + y
            acc = part if acc is None else acc + part
        return acc.to(x_flat.dtype)

    layers.row_parallel = ssm.row_parallel = split_row
    moe.dispatch_compute = split_dispatch
    ssm._mean_sq = split_mean_sq
    try:
        return fn()
    finally:
        layers.row_parallel = ssm.row_parallel = row
        moe.dispatch_compute = dispatch
        ssm._mean_sq = mean_sq


def _shard_kernel_checks(torch, model, rows, logits, caches, at, tag):
    """B6 and B7 against their plain versions at the shapes this rank's
    serving path gives them: the prefill of ``rows`` again with both
    plain versions in the model (its logits held by the caller against
    the kernels' ``logits``), B6 on
    the first attention call's q, k, v (this rank's heads) at its bf16
    bar and B7's gated mode on layer 0's scan inputs (this rank's
    channels) bitwise; for the SSM family also one decode step from
    ``caches`` (cloned) with the kernel and with the plain scan, and B7
    bitwise on that step's layer-0 inputs. Returns ({"B6": max |err|,
    "B7": 0.0 where held}, {"prefill": (max |err|, share of the bar),
    "decode": likewise})."""
    from repro_torch.models import decode_step, prefill

    plain, seen = _plain_capture(lambda: prefill(model, tokens=rows,
                                                 **at)[0])
    errs, bars = {}, {"prefill": _within(torch, logits, plain, LM_TOL)}
    if "B6" in seen:
        errs["B6"] = _check_b6(torch, *seen["B6"], True, f"{tag}: the "
                               "first attention call's q, k, v")
    if "B7" in seen:
        _check_b7_gated(torch, seen["B7"], f"{tag}: layer 0's scan")
        errs["B7"] = 0.0
        step = dict(token=logits.argmax(-1).to(torch.int32),
                    pos=SERVE_SHARD_SEQ, **at)
        got, _ = decode_step(model, {k: v.clone() for k, v in caches.items()},
                             **step)
        (want, _), seen = _plain_capture(lambda: decode_step(
            model, {k: v.clone() for k, v in caches.items()}, **step))
        bars["decode"] = _within(torch, got, want, LM_TOL)
        _check_b7_gated(torch, seen["B7"], f"{tag}: layer 0's decode scan",
                        chained=False)
    return errs, bars


def _fp32_run(torch, model32, rows, fed, at):
    """The fp32 gates' run of ``model32``: the prefill of ``rows``, then
    SERVE_SHARD_STEPS32 decode steps on fp32 caches fed ``fed``'s tokens
    (one rank's greedy tokens: the same on both sides of a comparison).
    Returns (prefill logits (B, V), decode logits (B, steps, V)) as
    numpy."""
    from repro_torch.models import decode_step, init_caches, prefill
    from repro_torch.models.generate import fill_caches

    logits, c0 = prefill(model32, tokens=rows, **at)
    caches = fill_caches(init_caches(
        model32.cfg, rows.shape[0] * at["mesh"].data,
        SERVE_SHARD_SEQ + SERVE_SHARD_STEPS32, dtype=torch.float32,
        device=rows.device, mesh=at["mesh"]), c0)
    del c0
    steps = []
    for t in range(SERVE_SHARD_STEPS32):
        lg, caches = decode_step(model32, caches, token=fed[:, t],
                                 pos=SERVE_SHARD_SEQ + t, **at)
        steps.append(lg)
    return logits.cpu().numpy(), torch.stack(steps, 1).cpu().numpy()


def _serve_shard_case(torch, dev, mesh, arch, mode, feed=None,
                      checks=True, knobs=False):
    """One family at full width on ``mesh`` (the 1 x 1 mesh: one rank):
    bf16 weights from init_model(mesh=) on a seeded generator, the
    prompts' rows of this rank, a first-use prefill of their first
    SERVE_SHARD_WARM tokens, then the counted run
    (B6, B7 and the mesh's all-reduces from 0): a timed prefill, then
    (uncounted) the same prefill under the profiler (its wall and device
    time; the logits the checks read), then
    (uncounted) B6 and B7 against their plain versions at this rank's
    shapes (:func:`_shard_kernel_checks`; with ``checks``, which a
    second MoE plan on the same mesh, with the same heads, leaves out),
    then (counted) SERVE_SHARD_NEW
    - 1 timed greedy decode steps; the tokens gathered over data and
    each step's top two logits; the model split as a
    mesh of two model ranks splits it (one rank only,
    :func:`_split_products`); then the same weights widened to fp32
    (:func:`_fp32_run`, fed ``feed``: one rank's greedy tokens, this
    run's own when None) and, with ``checks`` and attention in the
    model, its prefill with the plain versions; with ``knobs``, one fp32
    prefill under each of KNOBS (and B6 against its plain
    version in fp32 at the q, k, v that knob gives it). For
    the MoE family on one rank also each half of the batch alone
    (weight_gather's oracle on two data shards)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import Transformer, decode_step, init_caches
    from repro_torch.models import init_model, prefill
    from repro_torch.models.generate import fill_caches
    from repro_torch.models.sharding import batch_rows

    cfg = get_config(arch)
    B6, B7 = _lm_counters()
    tag = f"{arch} ({mode}) on {mesh.data} x {mesh.model} rank {mesh.rank}"
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, mesh=mesh)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    prompts = torch.from_numpy(TokenStream(cfg.vocab_size, seed=SEED).batch(
        SERVE_SHARD_BATCH, SERVE_SHARD_SEQ + 1)["tokens"]).to(dev)
    rows = batch_rows(prompts, mesh)
    at = dict(mesh=mesh, moe_serving_mode=mode)
    prefill(model, tokens=rows[:, :SERVE_SHARD_WARM], **at)  # first use
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _reset((B6, B7))
    mesh.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prefill(model, tokens=rows, **at)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = (B6["flash_attention"], B7["mamba1_scan_gated"])
    counts = mesh.collective_counts()
    (logits, c0), wall_us, kernels = _device_profile(
        torch, lambda: prefill(model, tokens=rows, **at))
    out = {"setup_s": setup_s, "param_bytes": param_bytes,
           "prefill_s": prefill_s,
           "profile": {"wall_us": wall_us,
                       "device_us": sum(v[0] for v in kernels.values()),
                       "launches": sum(v[1] for v in kernels.values())},
           "launches": {"prefill": launches}, "counts": {"prefill": counts},
           "logits": logits.float().cpu().numpy()}
    caches = fill_caches(init_caches(cfg, SERVE_SHARD_BATCH,
                                     SERVE_SHARD_SEQ + SERVE_SHARD_NEW,
                                     device=dev, mesh=mesh), c0)
    del c0
    out["kernel_err"], out["plain"] = (_shard_kernel_checks(
        torch, model, rows, logits, caches, at, tag) if checks else ({}, {}))
    tok = logits.argmax(-1).to(torch.int32)
    toks, lgs, steps = [tok], [logits], SERVE_SHARD_NEW - 1
    _reset((B6, B7))
    mesh.reset_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        lg, caches = decode_step(model, caches, token=tok,
                                 pos=SERVE_SHARD_SEQ + i, **at)
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(tok)
        lgs.append(lg)
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    out["launches"]["decode"] = (B6["flash_attention"],
                                 B7["mamba1_scan_gated"])
    out["counts"]["decode"] = {
        a: {k: v / steps for k, v in c.items()}
        for a, c in mesh.collective_counts().items()}
    out["tokens"] = mesh.gather(torch.stack(toks, 1), "data", 0).cpu().numpy()
    out["top2"] = torch.stack(lgs, 1).float().topk(2, -1).values.cpu().numpy()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del caches, lgs
    halves = prompts.chunk(2)
    if mesh.size == 1:
        def split(toks, ff_parts=1):
            return _split_products(lambda: prefill(model, tokens=toks, **at)[
                0], 2, ff_parts).float().cpu().numpy()

        out["logits_split"] = split(rows)
        if cfg.num_experts:
            out["logits_split_by_shard"] = np.concatenate(
                [split(half) for half in halves])
            out["logits_split_tokens"] = split(rows, ff_parts=2)
    if cfg.num_experts and mesh.size == 1:
        out["logits_by_shard"] = np.concatenate([
            prefill(model, tokens=half, **at)[0].float().cpu().numpy()
            for half in halves])
    model32 = Transformer(dataclasses.replace(cfg, dtype="float32"),
                          device=dev, mesh=mesh)
    model32.load_state_dict(model.state_dict())
    del model
    fed = torch.as_tensor(out["tokens"] if feed is None else feed,
                          device=dev)
    out["logits32"], out["decode32"] = _fp32_run(
        torch, model32, rows, batch_rows(fed, mesh), at)
    if checks and cfg.family != "ssm":  # B7 is held bitwise in bf16
        out["plain32"] = _plain_capture(lambda: prefill(
            model32, tokens=rows, **at)[0])[0].cpu().numpy()
    if knobs:
        out["knobs"] = _knob_prefills(torch, dev, model32, rows, at, tag)
    if cfg.num_experts and mesh.size == 1:
        runs = [_fp32_run(torch, model32, half, f, at)
                for half, f in zip(halves, fed.chunk(2))]
        out["logits32_by_shard"], out["decode32_by_shard"] = (
            np.concatenate(parts) for parts in zip(*runs))
    del model32
    torch.cuda.empty_cache()
    return out


def _knob_prefills(torch, dev, model32, rows, at, tag) -> dict:
    """{knob: (fp32 prefill logits, B6's max |err| against its plain
    version in fp32 at the first attention call's q, k, v, q's shape)}
    of ``model32``'s weights under each of KNOBS."""
    import dataclasses

    from repro_torch.models import Transformer, prefill, transformer

    out, kernel = {}, transformer.attention_ops.causal_attention
    for knob, over in KNOBS.items():
        model = Transformer(dataclasses.replace(model32.cfg, **over),
                            device=dev, mesh=at["mesh"])
        model.load_state_dict(model32.state_dict())
        seen = {}

        def keeping(q, k, v, **kw):
            seen.setdefault("qkv", (q, k, v))
            return kernel(q, k, v, **kw)

        transformer.attention_ops.causal_attention = keeping
        try:
            logits = prefill(model, tokens=rows, **at)[0].cpu().numpy()
        finally:
            transformer.attention_ops.causal_attention = kernel
        q = seen["qkv"][0]
        out[knob] = (logits, _check_b6(torch, *seen["qkv"], True,
                                       f"{tag} under {knob}: "
                                       "the first attention call's q, k, "
                                       "v in fp32"), tuple(q.shape))
        del model, seen
    return out


def _serve_shard_world(rank, dev, shapes, feeds):
    """One rank of phase 34 (module level: the spawned ranks import it):
    each mesh of ``shapes`` in turn, its families in turn, each fed one
    rank's greedy tokens ``feeds[arch]`` in its fp32 decode steps."""
    import torch

    from repro_torch.launch.mesh import Mesh

    out = {}
    for shape in shapes:
        mesh = Mesh(*shape)
        out[shape] = {"rank": rank, "data_rank": mesh.data_rank,
                      "backend": mesh.backend}
        checked = set()
        for arch, mode in SERVE_SHARD_CASES[shape]:
            t0 = time.perf_counter()
            out[shape][arch, mode] = _serve_shard_case(
                torch, dev, mesh, arch, mode, feeds[arch],
                checks=arch not in checked,
                knobs=shape == (1, 2) and arch == LM_ARCH)
            checked.add(arch)
            if rank == 0:
                print(f"    [{shape[0]} x {shape[1]}] rank 0: {arch} "
                      f"({mode}) in {time.perf_counter() - t0:.1f} s",
                      flush=True)
    return out


def _logit_bar(got, want, tol=LM_TOL) -> float:
    """The largest |got - want| as a share of rtol = atol = ``tol``."""
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


def _argmax_ties(got, want, tag, tol) -> int:
    """Gate each row's argmax of ``got`` against ``want``'s: equal, or,
    where ``want``'s top logits lie within the bar ``tol`` of each other
    (a tie at that resolution), one of those. Returns the rows that were
    such a tie and took another of its tokens."""
    g, w = got.argmax(-1), want.argmax(-1)
    top = want.max(-1)
    near = want[np.arange(len(g)), g] >= top - (tol + tol * np.abs(top))
    check(bool(((g == w) | near).all()),
          f"{tag}: prefill argmax differs (rows {np.flatnonzero(g != w)}) "
          f"outside a tie within the bar")
    return int((g != w).sum())


def _first_flips(got, want, top2):
    """Each row whose greedy tokens ``got`` part from one rank's
    ``want``: (the first step where they do, one rank's top-2 logit gap
    there as a share of the LM_TOL bar). Up to that step both runs were
    fed the same tokens."""
    flips = []
    for i in range(len(got)):
        diff = np.flatnonzero(got[i] != want[i])
        if diff.size:
            top, second = top2[i, diff[0]]
            flips.append((int(diff[0]), float(
                (top - second) / (LM_TOL + LM_TOL * abs(top)))))
    return flips


def _gate_plain(r, family, who) -> tuple:
    """Gate one run of :func:`_serve_shard_case` against the same run
    with B6's and B7's plain versions, as phases 17, 21 and 23 do: with
    attention in the model, the fp32 prefill logits within rtol = atol =
    LM_TOL, argmax equal (or a tie within SERVE_SHARD_TOL32); in bf16
    the SSM family's prefill and decode logits within LM_TOL (B7 is
    bitwise its plain version), an attention family's printed (an order
    of bf16 roundings as valid as another's carries full-width logits
    past the bar, §6 of PERF.md). Returns (the fp32 share of the bar or
    None, the bf16 shares by step, the argmax ties)."""
    bar32, ties = None, 0
    if "plain32" in r:
        bar32 = _logit_bar(r["logits32"], r["plain32"])
        check(bar32 <= 1.0, f"{who}: fp32 prefill logits with B6 vs plain "
              f"attention {bar32:.2f} of the bar (rtol = atol = {LM_TOL})")
        ties = _argmax_ties(r["logits32"], r["plain32"], f"{who} (kernels "
                            "vs plain)", SERVE_SHARD_TOL32)
    bars16 = {}
    for step, (err, bar) in r["plain"].items():
        check(family != "ssm" or bar <= 1.0, f"{who}: bf16 {step} logits "
              f"with B7 vs the plain scan {bar:.2f} of the bar (rtol = atol"
              f" = {LM_TOL}), max |err| {err:.3e}")
        bars16[step] = bar
    return bar32, bars16, ties


def _plain_line(bar32, bars16) -> str:
    """The kernels-vs-plain shares of :func:`_gate_plain` for a print."""
    return ((f"fp32 prefill logits {bar32:.2e} of the bar, " if bar32
             is not None else "") + "bf16 " + ", ".join(
        f"{k} {b:.3f}" for k, b in bars16.items()))


def _per_group(counts) -> str:
    return ", ".join(f"{a} {c['all_reduce']:g} ({c['bytes'] / 1e6:.3f} MB, "
                     f"{c['seconds'] * 1e3:.2f} ms host)"
                     for a, c in counts.items())


def phase_serve_shard(torch, dev):
    """Sharded LM serving at full width and depth (bf16 weights from a
    seeded generator): each family of SERVE_SHARD_CASES on one rank (the
    1 x 1 mesh) in this process, then on its meshes as spawned ranks
    sharing the one card over gloo (this process holds no model then;
    the 4-rank and the 2-rank world run at once). Prompts 4 x 512,
    SERVE_SHARD_NEW greedy tokens. Gates, on every rank
    of every
    mesh (in its first run of each family) and on one rank: B6 within
    its bf16 bar on the rank's q, k, v,
    B7 bitwise on the rank's scan inputs in prefill and in a decode
    step, and the logits with both against the same run with their
    plain versions (:func:`_gate_plain`). Against one rank, on the same weights widened
    to fp32: every rank's prefill logits and SERVE_SHARD_STEPS32 decode
    steps fed one rank's greedy tokens within rtol = atol =
    SERVE_SHARD_TOL32 of one rank's rows (granite's weight_gather on two
    data shards: of one rank's run of each half of the batch alone, the
    plan's own semantics), the prefill argmax equal (or a tie within the
    bar). In bf16, on a mesh with model > 1: every rank's prefill logits
    within rtol = atol = LM_TOL of one rank's run with its row-parallel
    products split as the mesh splits them (:func:`_split_products`).
    Printed, not gated, in bf16: the bar's share against plain one rank,
    and where the greedy tokens first part from one rank's and how near
    a tie one rank's top two logits were there. Every rank of a data shard bitwise equal,
    every rank's tokens equal; B6 once per layer (the hybrid: per group)
    and prefill, B7's gated mode once per layer per prefill and per
    decode step, on every rank. Returns the B6 and B7 launches of the
    counted runs by path, and B6's and B7's max |err| against their
    plain versions at the ranks' shapes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh, run_ranks

    t_phase = time.perf_counter()
    one = {}
    for arch in dict.fromkeys(a for cases in SERVE_SHARD_CASES.values()
                              for a, _ in cases):
        one[arch] = _serve_shard_case(torch, dev, Mesh(1, 1), arch,
                                      "weight_gather")
        r = one[arch]
        bar32, bars16, _ = _gate_plain(r, get_config(arch).family,
                                       f"{arch} on one rank")
        split = (f"; split as two model ranks split it, vs one rank "
                 f"{_logit_bar(r['logits_split'], r['logits']):.3f} of the "
                 f"bar" if "logits_split" in r else "")
        print(f"phase 34: {arch} on one rank: prefill "
              f"{SERVE_SHARD_BATCH} x {SERVE_SHARD_SEQ} "
              f"{SERVE_SHARD_BATCH * SERVE_SHARD_SEQ / r['prefill_s']:,.0f} "
              f"tokens/s, decode {r['decode_ms']:.2f} ms/token, peak "
              f"{r['peak_gb']:.2f} GB; kernels vs plain: "
              + _plain_line(bar32, bars16) + split)
    feeds = {arch: r["tokens"] for arch, r in one.items()}
    runs = {}

    def run_world(size, shapes):
        t0 = time.perf_counter()
        world = run_ranks(_serve_shard_world, size, shapes, feeds,
                          device=dev)
        return world, time.perf_counter() - t0

    # the worlds run at once (the script's budget, A19): every time a
    # mesh's ranks take is taken beside the other world's load, and is
    # printed as contended
    with ThreadPoolExecutor(len(SERVE_SHARD_WORLDS)) as pool:
        jobs = {size: pool.submit(run_world, size, shapes)
                for size, shapes in SERVE_SHARD_WORLDS.items()}
        worlds = {size: job.result() for size, job in jobs.items()}
    for size, shapes in SERVE_SHARD_WORLDS.items():
        world, secs = worlds[size]
        print(f"  a world of {size} ranks on one card ran the meshes "
              f"{list(shapes)} in {secs:.1f} s, spawn and set-up included, "
              "beside the other world")
        runs.update({shape: [r[shape] for r in world] for shape in shapes})
    by_path = {"flash_attention": {}, "mamba1_scan": {}}
    errs = {"flash_attention": 0.0, "mamba1_scan": 0.0}
    for arch in one:
        for name, k in (("flash_attention", "B6"), ("mamba1_scan", "B7")):
            errs[name] = max(errs[name], one[arch]["kernel_err"].get(k, 0.0))
    for shape, ranks in runs.items():
        data, model = shape
        for arch, mode in SERVE_SHARD_CASES[shape]:
            cfg, tag = get_config(arch), f"{arch} ({mode}) on {data} x {model}"
            ref = one[arch]
            sfx = ("_by_shard" if cfg.num_experts and data > 1
                   and mode == "weight_gather" else "")
            wit = ("logits_split_tokens" if mode == "token_gather"
                   else "logits_split" + sfx)
            units = (0 if cfg.family == "ssm" else cfg.num_layers
                     // (cfg.shared_attn_every or 1))
            scans = cfg.num_layers if cfg.family == "ssm" else 0
            first, bars, dbars, bars16, wits, arg16 = {}, [], [], [], [], []
            knob_bars = {}
            plain, plain32, ties, pties = {}, None, 0, 0
            for r in ranks:
                got, who = r[arch, mode], f"{tag} rank {r['rank']}"
                want = {k: np.split(ref[k + sfx], data)[r["data_rank"]]
                        for k in ("logits32", "decode32", "logits")}
                bar32, b16, n = _gate_plain(got, cfg.family, who)
                if bar32 is not None:
                    plain32 = max(plain32 or 0.0, bar32)
                pties += n
                for step, bar in b16.items():
                    plain[step] = max(plain.get(step, 0.0), bar)
                for name, k in (("flash_attention", "B6"),
                                ("mamba1_scan", "B7")):
                    errs[name] = max(errs[name],
                                     got["kernel_err"].get(k, 0.0))
                bar = _logit_bar(got["logits32"], want["logits32"],
                                 SERVE_SHARD_TOL32)
                check(bar <= 1.0, f"{who}: fp32 prefill logits {bar:.2f} of "
                      f"the bar (rtol = atol = {SERVE_SHARD_TOL32})")
                ties += _argmax_ties(got["logits32"], want["logits32"], who,
                                     SERVE_SHARD_TOL32)
                dbar = _logit_bar(got["decode32"], want["decode32"],
                                  SERVE_SHARD_TOL32)
                check(dbar <= 1.0, f"{who}: fp32 logits of "
                      f"{SERVE_SHARD_STEPS32} decode steps fed one rank's "
                      f"tokens {dbar:.2f} of the bar (rtol = atol = "
                      f"{SERVE_SHARD_TOL32})")
                bars16.append(_logit_bar(got["logits"], want["logits"]))
                if model > 1:
                    wits.append(_logit_bar(got["logits"], np.split(
                        ref[wit], data)[r["data_rank"]]))
                    check(wits[-1] <= 1.0, f"{who}: bf16 prefill logits "
                          f"{wits[-1]:.2f} of the bar (rtol = atol = "
                          f"{LM_TOL}) from one rank's with its products "
                          "split as the mesh splits them")
                arg16.append(float((got["logits"].argmax(-1)
                                    == want["logits"].argmax(-1)).mean()))
                seen = first.setdefault(r["data_rank"], got)
                check(all(np.array_equal(got[k], seen[k]) for k in
                          ("logits", "logits32", "decode32", "top2")),
                      f"{tag}: the ranks of data shard {r['data_rank']} "
                      "hold different logits")
                check(np.array_equal(got["tokens"], ranks[0][arch, mode][
                    "tokens"]), f"{tag}: the ranks' tokens differ")
                lp, ld = got["launches"]["prefill"], got["launches"]["decode"]
                check(lp == (units, scans) and ld == (
                    0, scans * (SERVE_SHARD_NEW - 1)),
                      f"{tag} rank {r['rank']}: (B6, B7) launches "
                      f"{lp} per prefill and {ld} in "
                      f"{SERVE_SHARD_NEW - 1} decode steps, not "
                      f"({units}, {scans}) and (0, {scans} a step)")
                bars.append(bar)
                dbars.append(dbar)
                for knob, (lg, b6, qshape) in got.get("knobs", {}).items():
                    kbar = _logit_bar(lg, want["logits32"],
                                      SERVE_SHARD_TOL32)
                    check(kbar <= 1.0, f"{who}: fp32 prefill logits under "
                          f"{knob} {kbar:.2f} of"
                          f" the bar (rtol = atol = {SERVE_SHARD_TOL32}) "
                          "from one rank's")
                    _argmax_ties(lg, want["logits32"], f"{who} under {knob}",
                                 SERVE_SHARD_TOL32)
                    knob_bars[knob] = (max(knob_bars.get(knob, (0.0,))[0],
                                           kbar), b6, qshape)
                    errs["flash_attention"] = max(errs["flash_attention"],
                                                  b6)
            key = f"serve_sharded/{data}x{model}/{arch}/{mode}"
            for name, i in (("flash_attention", 0), ("mamba1_scan", 1)):
                n = sum(r[arch, mode]["launches"][s][i] for r in ranks
                        for s in ("prefill", "decode"))
                if n:
                    by_path[name][key] = n
            r0 = ranks[0][arch, mode]
            flips = _first_flips(r0["tokens"], ref["tokens"], ref["top2"])
            p = r0["profile"]
            idle = (1 - p["device_us"] / p["wall_us"] if p["device_us"]
                    else float("nan"))
            tok_s = SERVE_SHARD_BATCH * SERVE_SHARD_SEQ / r0["prefill_s"]
            one_s = SERVE_SHARD_BATCH * SERVE_SHARD_SEQ / ref["prefill_s"]
            print(f"  {tag} ({data * model} ranks, backend "
                  f"{ranks[0]['backend']}): contended (the other world of "
                  f"ranks ran on the card at the same time): prefill "
                  f"{tok_s:,.0f} tokens/s ({tok_s / one_s:.2f}x one rank's "
                  f"{one_s:,.0f}, uncontended), decode "
                  f"{r0['decode_ms']:.2f} ms/token "
                  f"({r0['decode_ms'] / ref['decode_ms']:.2f}x one rank's "
                  f"{ref['decode_ms']:.2f}); ranks of a data shard bitwise "
                  f"equal; (B6, B7) per prefill {r0['launches']['prefill']}"
                  f", in {SERVE_SHARD_NEW - 1} decode steps "
                  f"{r0['launches']['decode']}")
            held = (f"kernels vs plain on every rank (rtol = atol = "
                    f"{LM_TOL}, max): " + _plain_line(plain32, plain)
                    + (f", argmax equal ({pties} rows a tie)"
                       if plain32 is not None else "") if plain else
                    "kernels vs plain: held in this mesh's first run of "
                    "the family (the same heads and channels)")
            print(f"    {held}; fp32 vs one rank (rtol = atol = {SERVE_SHARD_TOL32}"
                  f"): prefill max {max(bars):.2e} of the bar, argmax equal "
                  f"({ties} rows a tie within the bar), "
                  f"{SERVE_SHARD_STEPS32} decode steps fed one rank's "
                  f"tokens max {max(dbars):.2e}")
            print(f"    bf16: prefill vs one rank {max(bars16):.3f} of the "
                  f"bar (rtol = atol = {LM_TOL}; not gated), argmax "
                  f"agreement {min(arg16):.0%}"
                  + (f"; vs one rank with its products split as the mesh "
                     f"splits them {max(wits):.3f} (gated)" if wits else "")
                  + f"; greedy-token agreement with one rank "
                  f"{float((r0['tokens'] == ref['tokens']).mean()):.0%}, "
                  f"{len(flips)} of {SERVE_SHARD_BATCH} rows part"
                  + (f", first at steps {[t for t, _ in flips]}, where one "
                     f"rank's top two logits lie "
                     f"{[round(g, 3) for _, g in flips]} bars apart"
                     if flips else ""))
            print(f"    all-reduces (host times contended) per prefill: "
                  f"{_per_group(r0['counts']['prefill'])}; per decode step:"
                  f" {_per_group(r0['counts']['decode'])}")
            if knob_bars:
                print("    one fp32 prefill under each knob vs one rank "
                      f"(rtol = atol = {SERVE_SHARD_TOL32}): " + "; ".join(
                          f"{k} {b:.2e} of the bar,"
                          f" argmax equal, B6 (fp32) at q {q} vs plain max "
                          f"|err| {e:.3e}" for k, (b, e, q) in
                          knob_bars.items()))
            print(f"    rank 0 (times contended): set-up "
                  f"{r0['setup_s']:.1f} s, parameters "
                  f"{r0['param_bytes'] / 1e9:.3f} GB (one rank "
                  f"{ref['param_bytes'] / 1e9:.3f}), peak "
                  f"{r0['peak_gb']:.2f} GB; the timed prefill "
                  f"{r0['prefill_s'] * 1e3:.2f} ms, one more under the "
                  f"profiler {p['wall_us'] / 1e3:.2f} ms wall, "
                  + (f"{p['device_us'] / 1e3:.2f} ms of device in "
                     f"{p['launches']} launches (idle {idle:.1%})"
                     if p["launches"] else "device time not measured"))
    print(f"  B6 vs plain at the ranks' shapes max |err| "
          f"{errs['flash_attention']:.3e} (bar {B6_TOL['bfloat16']}), B7's "
          f"gated mode bitwise equal to its plain version on every rank")
    print(f"phase 34 took {time.perf_counter() - t_phase:.1f} s")
    return by_path, errs


def _serve_shard_reduced(rank, dev, shape):
    """Phase 35 on one rank (the card's or the CPU's): each reduced
    family of SERVE_SHARD_REDUCED in fp32, drawn on the CPU from one seed
    and moved to ``dev``, on the mesh ``shape``: prefill logits of 4 x 96
    (the hybrid's 4 x 128, a multiple of its SSD chunk) and 8 greedy
    tokens (granite's plan: token_gather)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_model, prefill
    from repro_torch.models.generate import generate
    from repro_torch.models.sharding import batch_rows

    mesh = Mesh(*shape)
    out = {"data_rank": mesh.data_rank}
    for arch in SERVE_SHARD_REDUCED:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        model = init_model(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu", mesh=mesh).to(dev)
        seq = HYBRID_CPU["prompt_len"] if cfg.family == "hybrid" else 96
        prompts = torch.from_numpy(TokenStream(cfg.vocab_size, seed=SEED)
                                   .batch(4, seq + 1)["tokens"]).to(dev)
        logits, _ = prefill(model, tokens=batch_rows(prompts, mesh),
                            mesh=mesh, moe_serving_mode="token_gather")
        out[arch] = (logits.cpu().numpy(), generate(
            model, prompts, 8, temperature=0.0, mesh=mesh,
            moe_serving_mode="token_gather").cpu().numpy())
    return out


def phase_serve_shard_reduced(torch, dev):
    """Reduced llama, falcon-mamba, granite and zamba2 in fp32 on a 2 x 2
    mesh, the card's ranks (B6, B7) against the CPU's (plain versions):
    prefill logits within LM_CPU_TOL, greedy tokens equal. (The 1 x 1 mesh
    bitwise the unsharded path in bf16 on the card is phase 27's
    ``tests/test_torch_lm_shard_card.py``.)"""
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the card's and the CPU's at once
        card, cpu = (pool.submit(run_ranks, _serve_shard_reduced, 4, (2, 2),
                                 device=d) for d in (dev, "cpu"))
        card, cpu = card.result(), cpu.result()
    errs = {}
    for arch in SERVE_SHARD_REDUCED:
        for c, h in zip(card, cpu):
            err = np.abs(c[arch][0] - h[arch][0])
            check(bool((err <= LM_CPU_TOL + LM_CPU_TOL
                        * np.abs(h[arch][0])).all()),
                  f"reduced {arch} on 2 x 2: prefill logits card vs CPU "
                  f"max |err| {float(err.max()):.3e} beyond {LM_CPU_TOL}")
            check(np.array_equal(c[arch][1], h[arch][1]),
                  f"reduced {arch} on 2 x 2: greedy tokens card vs CPU "
                  "differ")
            errs[arch] = max(errs.get(arch, 0.0), float(err.max()))
    print(f"phase 35: reduced {', '.join(SERVE_SHARD_REDUCED)} in fp32 on a "
          f"2 x 2 mesh, card ranks (B6/B7) vs CPU ranks (plain): prefill "
          f"logits of 4 x 96 (zamba2 4 x {HYBRID_CPU['prompt_len']}) max "
          f"|err| "
          + ", ".join(f"{a} {e:.3e}" for a, e in errs.items())
          + f" (bar {LM_CPU_TOL}), 8 greedy tokens equal on every rank; "
          f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phases 36-37
# sharded LM training: (arch, mesh, batch, sequence): llama3.2-1b at full
# width on 2 x 2, batch 4 x 512 (cut from phase 28's 4 x 4,096 for phase
# 34's reason: gloo stages every all-reduce through the host), and
# zamba2-2.7b on 1 x 2 at 4 x 256 (cut from 4 x 512 for the script's
# time: ~530 model all-reduces a step); ranks sharing the card over gloo,
# two fp32 updates gated against one rank
TRAIN_SHARD_CASES = ((LM_ARCH, (2, 2), 4, 512), (HYBRID_ARCH, (1, 2), 4, 256))
TRAIN_SHARD_LR = TRAIN_LR
# the second update's bars beside PARAM_BAR on PARAM_SHARE: every element
# within SENS_C x (PARAM_BAR + lr x AdamW's sensitivity to the gradient
# bar; the worst element read 0.467 for llama, 1.134-1.217 for zamba2 on
# an NVIDIA H100 80GB HBM3 at 700 W), and, where one rank's own parameters drift past PARAM_SHARE
# under rounding (weights one ulp away: zamba2's 0.76%, the mesh's 0.48%,
# in the same in_proj leaves and columns), the mesh's share past
# PARAM_BAR within WITNESS_C x theirs
SENS_C, WITNESS_C = 2.0, 1.0
# phase 37, fp32: (mesh, arch, the sharding knob it runs under, if any) by
# world size, a world's cases in turn; zamba2 on 2 x 1 is the script's one
# LM mesh with data > 1 and model = 1 (Mamba2 on a mesh but whole, the
# head without a model gather)
TRAIN_SHARD_REDUCED = {
    4: (((2, 2), LM_ARCH, None), ((2, 2), MOE_ARCH, None),
        ((2, 2), SSM_ARCH, None), ((2, 2), HYBRID_ARCH, None)),
    2: (((1, 2), LM_ARCH, "seq_parallel"), ((1, 2), SSM_ARCH, "seq_parallel"),
        ((1, 2), LM_ARCH, "head_dim"), ((2, 1), HYBRID_ARCH, None))}


def _grad_share(got, want) -> float:
    """max |got - want| over the leaf bar GRAD_REL max |want| + GRAD_ABS
    (``want``'s maximum the whole leaf's, passed as a tensor pair)."""
    ref, top = want
    return float((got - ref).abs().max()) / (GRAD_REL * top + GRAD_ABS)


MAMBA2_SEGMENTS = ("z", "x", "B", "C", "dt")  # in_proj's columns, in order


def _drift(torch, pairs, cfg, m, sens=None) -> dict:
    """Two sets of parameters, leaf by leaf: ``pairs`` yields (name, got,
    want), blocks cut over ``m`` model ranks (1: whole leaves). Returns
    max |err|, ``share`` within PARAM_BAR of ``n`` elements, ``leaves``
    (the three with the most elements past it: name, count, size),
    ``layers`` (the layers holding such elements) and, for the hybrid,
    ``segments`` (its Mamba2 in_proj elements past PARAM_BAR by column
    segment, MAMBA2_SEGMENTS). With ``sens`` (AdamW's sensitivity to the
    gradient bar by leaf, :func:`_train_shard_reference`) also
    ``sens_worst``, the worst |err| over PARAM_BAR + lr sens, and
    ``keen`` / ``keen_within``: the elements whose sens stays under 1e-3
    and how many of them are within PARAM_BAR."""
    out = {"max": 0.0, "n": 0, "past": 0, "sens_worst": 0.0, "keen": 0,
           "keen_within": 0}
    leaves, layers = [], set()
    segments = dict.fromkeys(MAMBA2_SEGMENTS, 0)
    if cfg.family == "hybrid":
        di, N = cfg.d_inner // m, cfg.ssm_state
        widths = (di, di, N, N, cfg.d_inner // cfg.ssm_headdim // m)
    for name, got, want in pairs:
        diff = (got - want).abs()
        past = diff > PARAM_BAR
        count = int(past.sum())
        out["max"] = max(out["max"], float(diff.max()))
        out["n"] += diff.numel()
        out["past"] += count
        if sens is not None:
            out["sens_worst"] = max(out["sens_worst"], float((diff / (
                PARAM_BAR + TRAIN_SHARD_LR * sens[name])).max()))
            keen = sens[name] <= 1e-3
            out["keen"] += int(keen.sum())
            out["keen_within"] += int((keen & ~past).sum())
        if not count:
            continue
        leaves.append((name, count, diff.numel()))
        if name.startswith("layers."):
            layers.add(int(name.split(".")[1]))
        if cfg.family == "hybrid" and name.endswith("mamba.in_proj"):
            for seg, n in zip(MAMBA2_SEGMENTS,
                              past.sum(0).split(widths)):
                segments[seg] += int(n.sum())
    out["share"] = 1 - out["past"] / out["n"]
    out["leaves"] = sorted(leaves, key=lambda t: -t[1])[:3]
    out["layers"] = sorted(layers)
    if cfg.family == "hybrid":
        out["segments"] = segments
    return out


def _rounding_witness(torch, dev, cfg, batch, after) -> dict:
    """The one-rank reference's own drift under rounding: the same model
    from weights one ulp away (each element stepped up or down at random,
    from a seed), two AdamW updates on the same batch, against ``after``
    (the reference's parameters after its two updates, whole leaves):
    :func:`_drift`'s reading."""
    from repro_torch.models import init_model, loss_and_grads
    from repro_torch.optim import AdamW

    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, trainable=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    with torch.no_grad():
        for p in model.parameters():
            up = torch.rand(p.shape, generator=gen, device=dev) < 0.5
            p.copy_(torch.nextafter(p, torch.full_like(p, float(
                "inf")).where(up, float("-inf"))))
    opt = AdamW(lr=TRAIN_SHARD_LR, weight_decay=0.01)
    params = dict(model.named_parameters())
    state = opt.init(params)
    for _ in range(2):
        _, _, grads = loss_and_grads(model, batch)
        params, state = opt.apply(grads, state, params)
        del grads
    del state
    return _drift(torch, ((n, p.detach(), after[n])
                          for n, p in params.items()), cfg, 1)


def _train_shard_reference(torch, dev, cfg, batch, mesh, cuts, sharded,
                           witness: bool):
    """One rank's unsharded model from the same seed on the full batch,
    held against this rank's ``sharded`` results (its blocks, cut by
    ``cuts``, in host memory): the rank's second parameters replayed from
    its first by AdamW on its own two gradients (max |err|: 0 when the
    mesh applied AdamW to the gradients it took); the fp32 loss and
    gradients of both steps against one rank's; the parameters after one
    and after two updates (:func:`_drift`, against AdamW's own
    sensitivity to the gradient bar, ``tests/test_torch_lm_train_
    shard.py``'s: lr sum_t min(2, e_t / |g_t|) over the steps' one-rank
    gradients g_t, e_t = GRAD_REL max |g_t| + GRAD_ABS of the leaf); with
    ``witness`` the one-rank reference's own drift under rounding
    (:func:`_rounding_witness`). Returns the readings."""
    from repro_torch.models import init_model, loss_and_grads
    from repro_torch.models.sharding import local_block
    from repro_torch.optim import AdamW

    def block(n, t):
        return local_block(t, cuts[n][0], mesh, cuts[n][1], n)

    def blocks(tensors):
        return {n: (block(n, t), float(t.abs().max()))
                for n, t in tensors.items()}

    def grad_worst(got, grads):
        shares = {n: _grad_share(got[n].to(dev), w)
                  for n, w in blocks(grads).items()}
        return max(shares.items(), key=lambda kv: kv[1])

    def drift(params):
        return _drift(torch, ((n, after[n].to(dev), block(n, p.detach()))
                              for n, p in params.items()), cfg, mesh.model,
                      sens)

    out, sens = {}, {}

    def sensitivity(grads):  # AdamW's, summed over the steps, on the block
        for n, (g, top) in blocks(grads).items():
            step = torch.clamp((GRAD_REL * top + GRAD_ABS) / g.abs(),
                               max=2.0)
            sens[n] = step if n not in sens else sens[n] + step

    full = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                      device=dev, trainable=True)
    opt = AdamW(lr=TRAIN_SHARD_LR, weight_decay=0.01)
    out["replay"] = 0.0
    for n, p in full.named_parameters():  # leaf by leaf, from one rank's
        mine = {n: block(n, p.detach()).clone()}
        state = opt.init(mine)
        for got in (sharded["grads"], sharded["grads2"]):
            mine, state = opt.apply({n: got[n].to(dev)}, state, mine)
        out["replay"] = max(out["replay"], float(
            (mine[n] - sharded["after"][n].to(dev)).abs().max()))
    del mine, state
    loss, _, grads = loss_and_grads(full, batch)
    out["loss_rel"] = abs(float(loss) - sharded["losses"][0]) / abs(
        float(loss))
    out["grad_worst"] = grad_worst(sharded["grads"], grads)
    sensitivity(grads)
    params = dict(full.named_parameters())
    params, state = opt.apply(grads, opt.init(params), params)
    del grads
    after = sharded["after1"]
    out["update1"] = drift(params)
    loss2, _, grads = loss_and_grads(full, batch)  # make_train_step's step
    out["grad2_worst"] = grad_worst(sharded["grads2"], grads)
    sensitivity(grads)
    params, state = opt.apply(grads, state, params)
    del grads, state
    out["loss2_rel"] = abs(float(loss2) - sharded["losses"][1]) / abs(
        float(loss2))
    after = sharded["after"]
    out["update2"] = drift(params)
    del sens
    if witness and out["update2"]["share"] < PARAM_SHARE:
        torch.cuda.empty_cache()
        out["witness"] = _rounding_witness(torch, dev, cfg, batch, params)
    del full, opt, params, loss2
    torch.cuda.empty_cache()
    return out


def _b6_function_vs_plain(torch, q, k, v, tag):
    """B6's Function against autograd of plain_attention at this q, k, v
    on one seeded ``do``: every input gradient within one bf16 ulp of its
    max |g| in bf16, 1e-6 max |g| in fp32 (phase 29's bars,
    :func:`_ulp_bar`). Returns the worst share of the bar."""
    from repro_torch.kernels.flash_attention import ops as attn_ops

    gen = torch.Generator(device=q.device).manual_seed(SEED + 36)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    grads = []
    for fn in (attn_ops.causal_attention, attn_ops.plain_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, do))
    worst = 0.0
    for name, g, w in zip("qkv", *grads):
        err = float((g.float() - w.float()).abs().max())
        bar = _ulp_bar(torch, w.float(), q.dtype)
        check(g.dtype == w.dtype and err <= bar, f"{tag}: B6 Function d{name}"
              f" vs autograd of plain_attention max |err| {err:.3e} > the "
              f"{q.dtype} bar of max |g|, {bar:.3e}")
        worst = max(worst, err / bar)
    return worst


def _train_shard_rank(rank, dev, arch, shape, batch_size, seq):
    """Phase 36 on one rank (module level: the spawned ranks import it):
    ``arch`` at full width, trainable, on the mesh ``shape`` in fp32: a
    first train step (its gradient and the parameters after it kept, B6
    launches counted, the first attention call's q, k, v of this rank's
    heads kept), a timed train step (B6 and the mesh's all-reduces
    counted, the gradient it applied kept), a third step under the
    profiler (B6 counted); B6 and its Function
    against plain at this rank's shapes, in fp32 (the body the run took)
    and in bf16 (the tensor-core body); then, one rank
    at a time, that rank's unsharded reference
    (:func:`_train_shard_reference`)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_model
    from repro_torch.models import make_train_step, transformer
    from repro_torch.models.sharding import batch_rows
    from repro_torch.optim import AdamW

    mesh = Mesh(*shape)
    B6, _ = _lm_counters()
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    raw = TokenStream(cfg.vocab_size, seed=SEED).batch(batch_size, seq + 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    rows = {k: batch_rows(v, mesh) for k, v in batch.items()}
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, trainable=True, mesh=mesh)
    torch.cuda.synchronize()
    out = {"rank": rank, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank, "backend": mesh.backend,
           "setup_s": time.perf_counter() - t0,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "param_count": sum(p.numel() for p in model.parameters())}
    cuts = model.leaf_specs()
    kernel, seen = transformer.attention_ops.causal_attention, {}

    def keeping(q, k, v, **kw):
        seen.setdefault("qkv", tuple(t.detach().clone() for t in (q, k, v)))
        return kernel(q, k, v, **kw)

    opt, step = make_train_step(model, lr=TRAIN_SHARD_LR)
    params = dict(model.named_parameters())
    state = opt.init(params)
    kept, apply = [], AdamW.apply

    def keeping_grads(self, grads, state, params):  # a step's own gradient
        kept.append(grads)
        return apply(self, grads, state, params)

    # the first step's gradient is the first gradient the gates read (a
    # step is loss_and_grads, then AdamW.apply on that gradient); what the
    # one-rank references read waits in host memory, so the card holds
    # one model at a time
    transformer.attention_ops.causal_attention = keeping
    AdamW.apply = keeping_grads
    try:
        _reset((B6,))
        mesh.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, m1 = step(state, rows)
        torch.cuda.synchronize()
        out["grad_s"] = time.perf_counter() - t0
        launches = [B6["flash_attention"]]
        grads = {n: g.detach().cpu() for n, g in kept.pop().items()}
        after1 = {n: p.detach().cpu() for n, p in params.items()}
        transformer.attention_ops.causal_attention = kernel
        _reset((B6,))
        mesh.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, rows)
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
    finally:
        transformer.attention_ops.causal_attention = kernel
        AdamW.apply = apply
    grads2 = {n: g.detach().cpu() for n, g in kept.pop().items()}
    out["counts"] = mesh.collective_counts()
    out["split"] = mesh.split_counts()
    launches.append(B6["flash_attention"])
    out["losses"] = [float(m1["loss"]), float(m["loss"])]
    after = {n: p.detach().cpu() for n, p in params.items()}
    _reset((B6,))
    (state, m), wall_us, kernels = _device_profile(
        torch, lambda: step(state, rows))
    launches.append(B6["flash_attention"])
    out["launches"] = launches
    out["profile"] = {"wall_us": wall_us,
                      "device_us": sum(v[0] for v in kernels.values()),
                      "launches": sum(v[1] for v in kernels.values())}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del model, opt, step, state, params, m
    torch.cuda.empty_cache()
    sharded = {"losses": out["losses"], "grads": grads, "grads2": grads2,
               "after1": after1, "after": after}
    tag = f"{arch} on {shape[0]} x {shape[1]} rank {rank}"
    q, k, v = seen["qkv"]  # fp32: the body this run's B6 launches took
    out["qkv_shape"] = (tuple(q.shape), tuple(k.shape))
    out["b6_err32"] = _check_b6(torch, q, k, v, True, f"{tag}: layer 0's "
                                "q, k, v in fp32")
    out["b6_grad32"] = _b6_function_vs_plain(torch, q, k, v, f"{tag} fp32")
    q, k, v = (t.to(torch.bfloat16) for t in seen["qkv"])
    out["b6_err"] = _check_b6(torch, q, k, v, True, f"{tag}: layer 0's "
                              "q, k, v in bf16")
    out["b6_grad_ulps"] = _b6_function_vs_plain(torch, q, k, v, tag)
    del q, k, v, seen
    for turn in range(mesh.size):  # one unsharded model on the card at a time
        if turn == rank:
            t0 = time.perf_counter()
            out["ref"] = _train_shard_reference(torch, dev, cfg, batch, mesh,
                                                cuts, sharded, rank == 0)
            torch.cuda.empty_cache()
            out["ref_s"] = time.perf_counter() - t0
        dist.barrier()
    return out


def phase_train_shard(torch, dev):
    """Sharded LM training at full width: each (arch, mesh) of
    TRAIN_SHARD_CASES in turn, trainable (llama3.2-1b on 2 x 2: FSDP over
    data, heads, d_ff and vocab over model; zamba2-2.7b on 1 x 2: the
    Mamba2 heads and the shared block's heads and d_ff over model), ranks
    sharing the one card over gloo, the batch of TRAIN_SHARD_CASES from
    the token stream. Gates, on every rank: the fp32 loss within
    LOSS_RTOL of one rank's on the full batch (the second step's within
    CE_RTOL), every gradient block within GRAD_REL max |g| + GRAD_ABS of
    one rank's (the whole leaf's maximum), the parameters after one
    update within 2 lr and within PARAM_BAR on PARAM_SHARE of the
    elements (phase 29's bars); the parameters after two updates
    bitwise AdamW replayed on the rank's own two gradients, within 4 lr,
    every element within SENS_C x (PARAM_BAR + lr x AdamW's sensitivity
    to the gradient bar), and within PARAM_BAR on PARAM_SHARE of the
    elements, or, where one rank from weights one ulp away drifts past
    that share itself (rank 0's witness), on all but WITNESS_C x its
    share (:func:`_train_shard_reference`); B6 on the first attention call's q, k, v of the rank's heads within
    its fp32 bar (the body the fp32 steps launch) and, cast, its bf16 bar
    (the tensor-core body), and its Function against autograd of
    plain_attention there in both dtypes (:func:`_b6_function_vs_plain`);
    B6 launched twice per attention unit a step (forward and recompute);
    the ranks' losses bitwise equal. Printed: ms a step (unprofiled),
    tokens/s, the
    all-reduces a step per group with the FSDP gathers and
    reduce-scatters among them, each rank's peak and their sum, a third
    step's profile, and the roofline of a rank's step
    (:func:`_train_roofline`, as if each rank had a card of its own)
    beside its measured MFU. Returns B6's launches (every rank's gradient
    and two steps), its max |err| at the ranks' shapes over both dtypes,
    and per (arch, mesh) rank 0's timed step: its all-reduces per group,
    its FSDP gathers and reduce-scatters and its B6 launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks

    t_phase, launches, worst, steps = time.perf_counter(), 0, 0.0, {}
    for arch, shape, batch_size, seq in TRAIN_SHARD_CASES:
        t_case = time.perf_counter()
        ranks = run_ranks(_train_shard_rank, shape[0] * shape[1], arch,
                          shape, batch_size, seq, device=dev)
        cfg = get_config(arch)
        units = cfg.num_layers // (cfg.shared_attn_every or 1)
        mesh = f"{shape[0]} x {shape[1]}"
        witness = ranks[0]["ref"].get("witness")
        for r in ranks:
            who, ref = f"{arch} on {mesh} rank {r['rank']}", r["ref"]
            check(ref["loss_rel"] <= LOSS_RTOL and ref["loss2_rel"]
                  <= CE_RTOL, f"{who}: fp32 losses {r['losses']} against "
                  f"one rank's, relative {ref['loss_rel']:.2e} (bar "
                  f"{LOSS_RTOL}) and {ref['loss2_rel']:.2e} (bar {CE_RTOL})")
            name, share = ref["grad_worst"]
            check(share <= 1.0, f"{who}: gradient leaf {name} {share:.3f} of"
                  f" the bar ({GRAD_REL} max |g| + {GRAD_ABS}) from one "
                  "rank's")
            limit = 2 * TRAIN_SHARD_LR
            u1, u2, w = ref["update1"], ref["update2"], witness
            check(u1["max"] <= limit and u1["share"] >= PARAM_SHARE,
                  f"{who}: parameters after one update max |err| "
                  f"{u1['max']:.3e} (bar {limit}), {u1['share']:.5f} within "
                  f"{PARAM_BAR} (bar {PARAM_SHARE}); the leaves with the "
                  f"most elements past it (name, count, size): "
                  f"{u1['leaves']}")
            check(ref["replay"] == 0.0, f"{who}: the parameters after two "
                  "updates differ from AdamW replayed on the rank's own two "
                  f"gradients by {ref['replay']:.3e}")
            check(u2["max"] <= 2 * limit and u2["sens_worst"] <= SENS_C,
                  f"{who}: parameters after two updates max |err| "
                  f"{u2['max']:.3e} (bar {2 * limit}), the worst element "
                  f"{u2['sens_worst']:.3f} of PARAM_BAR + lr x AdamW's "
                  f"sensitivity to the gradient bar (bar {SENS_C})")
            check(u2["share"] >= PARAM_SHARE or (
                w is not None and 1 - u2["share"]
                <= WITNESS_C * (1 - w["share"])),
                f"{who}: parameters after two updates {u2['share']:.5f} "
                f"within {PARAM_BAR} (bar {PARAM_SHARE}, or {WITNESS_C} x "
                "the share past it of one rank from weights one ulp away: "
                + (f"{1 - w['share']:.5f}" if w else "not run") + "); the "
                f"leaves with the most elements past {PARAM_BAR} (name, "
                f"count, size): {u2['leaves']}")
            check(r["launches"] == [2 * units] * 3, f"{who}: B6 launches "
                  f"{r['launches']} in the three steps, not "
                  f"{2 * units} each ({units} forward, {units} recompute)")
            check(r["losses"] == ranks[0]["losses"], f"{who}: losses "
                  f"{r['losses']} differ from rank 0's {ranks[0]['losses']}")
        r0 = ranks[0]
        tokens = batch_size * seq
        p = r0["profile"]
        idle = (1 - p["device_us"] / p["wall_us"] if p["device_us"]
                else float("nan"))
        split = r0["split"]
        refs = [r["ref"] for r in ranks]
        grad1 = max((r["grad_worst"] for r in refs), key=lambda t: t[1])
        grad2 = max((r["grad2_worst"] for r in refs), key=lambda t: t[1])
        u2 = r0["ref"]["update2"]
        print(f"phase 36: {arch} trainable at full width on {mesh} "
              f"({len(ranks)} ranks, backend {r0['backend']}, one card), "
              f"batch {batch_size} x {seq}, fp32, lr "
              f"{TRAIN_SHARD_LR}: losses " + " -> ".join(
                  f"{x:.6f}" for x in r0["losses"])
              + "; every rank vs one rank: loss rel max "
              f"{max(r['loss_rel'] for r in refs):.2e} (bar {LOSS_RTOL}), "
              f"step 2 {max(r['loss2_rel'] for r in refs):.2e} (bar "
              f"{CE_RTOL}), worst gradient leaf {grad1[1]:.3f} of its bar "
              f"({grad1[0]}), in the second step {grad2[1]:.3f} ({grad2[0]};"
              " not gated: taken at parameters that already differ); the "
              "second update AdamW's on the rank's own "
              f"gradients, max |err| {max(r['replay'] for r in refs):.1e}; "
              f"parameters after one update max |err| "
              f"{max(r['update1']['max'] for r in refs):.3e}, "
              f"{min(r['update1']['share'] for r in refs):.6f} within "
              f"{PARAM_BAR}; after two max |err| "
              f"{max(r['update2']['max'] for r in refs):.3e}, "
              f"{min(r['update2']['share'] for r in refs):.6f} within "
              f"{PARAM_BAR}, the worst element "
              f"{max(r['update2']['sens_worst'] for r in refs):.3f} of "
              f"PARAM_BAR + lr x AdamW's sensitivity (bar {SENS_C}); rank "
              f"0: {u2['past']} of {u2['n']} elements past {PARAM_BAR}, in "
              f"layers {u2['layers']}, leaves {u2['leaves']}"
              + (f", its in_proj's by segment {u2['segments']}"
                 if "segments" in u2 else "")
              + f", {u2['keen_within']} of the {u2['keen']} whose "
              "sensitivity stays under 1e-3 within it; ranks' losses "
              "bitwise equal")
        if witness is not None:
            print(f"  one rank from weights one ulp away, two updates "
                  f"against one rank's: {witness['share']:.6f} within "
                  f"{PARAM_BAR} ({witness['past']} of {witness['n']} "
                  f"past it), max |err| {witness['max']:.3e}, in layers "
                  f"{witness['layers']}, leaves {witness['leaves']}"
                  + (f", in_proj's by segment {witness['segments']}"
                     if "segments" in witness else ""))
        print(f"  B6 at the ranks' shapes (q {r0['qkv_shape'][0]}, k/v "
              f"{r0['qkv_shape'][1]}): fp32 (the body the steps ran) vs "
              f"plain max |err| {max(r['b6_err32'] for r in ranks):.3e} "
              f"(bar {B6_TOL['float32']}), its Function vs autograd of "
              f"plain_attention {max(r['b6_grad32'] for r in ranks):.3f} of "
              f"1e-6 max |g|; bf16 (the tensor-core body) vs plain "
              f"{max(r['b6_err'] for r in ranks):.3e} (bar "
              f"{B6_TOL['bfloat16']}), its Function "
              f"{max(r['b6_grad_ulps'] for r in ranks):.3f} of one bf16 ulp"
              f" of max |g|; B6 {r0['launches'][1]} launches a step on every"
              " rank")
        coll = sum(c["bytes"] for c in r0["counts"].values())
        roof = _train_roofline(get_config(arch), batch_size, seq,
                               r0["param_count"], coll,
                               *shape)
        mfu = {k: roof[k] / r0["step_s"] / BF16_OPS_PER_S for k in (
            "model_flops_per_chip", "model_flops_matmul_per_chip")}
        print(f"  a step {r0['step_s'] * 1e3:.1f} ms "
              f"({tokens / r0['step_s']:,.0f} tokens/s; the first step, "
              f"first use included, {r0['grad_s'] * 1e3:.1f} ms); "
              f"all-reduces a step: {_per_group(r0['counts'])}; of them FSDP"
              f" gathers {split['gather']['calls']} "
              f"({split['gather']['bytes'] / 1e9:.3f} GB) and reduce-"
              f"scatters {split['reduce_scatter']['calls']} "
              f"({split['reduce_scatter']['bytes'] / 1e9:.3f} GB)")
        inflated = (roof["model_flops_per_chip"]
                    / roof["model_flops_matmul_per_chip"])
        mfu32 = (roof["model_flops_matmul_per_chip"] / r0["step_s"]
                 / FP32_OPS_PER_S)
        print(f"  roofline of a rank's step (as if each rank had a card of "
              f"its own): {json.dumps(roof)}; measured MFU a rank (the "
              f"{len(ranks)} ranks share one card), over the bf16 peak "
              f"(the Roofline's): {mfu['model_flops_per_chip']:.2%} by the "
              f"reference's N_active ({inflated:.3f} x the weights a token "
              f"meets), {mfu['model_flops_matmul_per_chip']:.2%} by those "
              f"weights, beside the bounds' {roof['mfu_bound']:.2%} and "
              f"{roof['mfu_bound_matmul']:.2%}; over the fp32 peak "
              f"({FP32_OPS_PER_S:.3g} FLOP/s, where an fp32 step's products "
              f"run) {mfu32:.2%} by those weights; the step "
              f"{r0['step_s'] / roof['t_bound_fp32_s']:.1f} x the bound at "
              f"that peak ({roof['t_bound_fp32_s'] * 1e3:.1f} ms)")
        print("  per rank: " + ", ".join(
            f"rank {r['rank']} {r['param_bytes'] / 1e9:.3f} GB of "
            f"parameters, peak {r['peak_gb']:.2f} GB" for r in ranks)
              + f"; peaks summed {sum(r['peak_gb'] for r in ranks):.2f} GB;"
              f" rank 0 set-up {r0['setup_s']:.1f} s, its one-rank "
              f"reference {r0['ref_s']:.1f} s; a third step under the "
              f"profiler {p['wall_us'] / 1e3:.1f} ms wall, "
              + (f"{p['device_us'] / 1e3:.1f} ms of device in "
                 f"{p['launches']} launches (idle {idle:.1%})"
                 if p["launches"] else "device time not measured")
              + f"; {arch} on {mesh} took "
              f"{time.perf_counter() - t_case:.1f} s")
        launches += sum(sum(r["launches"]) for r in ranks)
        worst = max(worst, *(max(r["b6_err"], r["b6_err32"])
                             for r in ranks))
        steps[arch, shape] = {"counts": r0["counts"], "split": r0["split"],
                              "launches": r0["launches"][1]}
    print(f"phase 36 took {time.perf_counter() - t_phase:.1f} s")
    return launches, worst, steps


def _train_shard_reduced(rank, dev, world):
    """Phase 37 on one rank of a ``world``-rank group (the card's or the
    CPU's): each case of TRAIN_SHARD_REDUCED[world], a reduced family
    under its sharding knob, in fp32, drawn on the CPU from one seed and
    moved to ``dev``, trainable on its mesh: the loss and every gradient
    block gathered (rank 0 keeps them), B6 and B7 counted, then
    TRAIN_CPU_STEPS updates (losses, the parameters gathered). On the
    card, falcon-mamba's gated scans are captured: layer 0's forward call
    and its recompute. Results by :func:`_reduced_case`."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Transformer, init_model, loss_and_grads
    from repro_torch.models import make_train_step, ssm
    from repro_torch.models.sharding import batch_rows, gather_block

    B6, B7 = _lm_counters()
    out, meshes = {}, {}
    for shape, arch, knob in TRAIN_SHARD_REDUCED[world]:
        if shape not in meshes:
            meshes[shape] = Mesh(*shape)
        mesh = meshes[shape]
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  **KNOBS.get(knob, {}))
        model = Transformer(cfg, device=dev, trainable=True, mesh=mesh)
        model.load_state_dict(init_model(
            cfg, torch.Generator().manual_seed(SEED), device="cpu",
            trainable=True, mesh=mesh).state_dict())
        raw = TokenStream(cfg.vocab_size, seed=SEED).batch(4, 33)
        rows = {k: batch_rows(torch.from_numpy(v), mesh).to(dev)
                for k, v in raw.items()}
        scans, kernel = [], ssm.ops.gated_selective_scan

        def keeping(*args):
            scans.append(tuple(None if a is None else a.detach().clone()
                               for a in args))
            return kernel(*args)

        if dev.type == "cuda" and cfg.family == "ssm":
            ssm.ops.gated_selective_scan = keeping
        try:
            _reset((B6, B7))
            loss, _, grads = loss_and_grads(model, rows)
            launches = {"B6": B6["flash_attention"],
                        "B7": B7["mamba1_scan_gated"],
                        "B7_bwd": B7["mamba1_scan_gated_backward"]}
        finally:
            ssm.ops.gated_selective_scan = kernel
        cuts = model.leaf_specs()
        gathered = {n: gather_block(g.detach(), cuts[n][0], mesh,
                                    cuts[n][1]).cpu() for n, g in grads.items()}
        opt, step = make_train_step(model, lr=TRAIN_CPU_LR)
        state, losses = opt.init(dict(model.named_parameters())), []
        for _ in range(TRAIN_CPU_STEPS):
            state, m = step(state, rows)
            losses.append(float(m["loss"]))
        params = {n: gather_block(p.detach(), cuts[n][0], mesh,
                                  cuts[n][1]).cpu()
                  for n, p in model.named_parameters()}
        case = _reduced_case(shape, arch, knob)
        out[case] = {"loss": float(loss), "launches": launches,
                     "losses": losses,
                     "grads": gathered if mesh.rank == 0 else None,
                     "params": params if mesh.rank == 0 else None}
        if scans:  # layer 0's forward call and its recompute (the last)
            out[case]["scans"] = {"forward": _scan_to_cpu(scans[0]),
                                  "recompute": _scan_to_cpu(scans[-1])}
            out[case]["scan_calls"] = len(scans)
        del model, opt, step, state
    return out


def _train_shard_one_by_one(rank, dev):
    """Phase 37's 1 x 1 mesh on the card (module level: a spawned rank of
    its own, so torch's deterministic mode holds in this process alone):
    reduced llama and falcon-mamba in fp32, the unsharded step and the
    1 x 1 mesh's, both under torch's deterministic implementations (the
    embedding's backward adds repeated ids' rows in no fixed order
    otherwise): loss, every gradient, the parameters after two updates.
    Returns the archs whose two runs are not bitwise equal."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_model, loss_and_grads
    from repro_torch.models import make_train_step

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    differ = []
    try:
        for arch in (LM_ARCH, SSM_ARCH):
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype="float32")
            raw = _train_batch(cfg, seq=64)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
            runs = []
            for mesh in (None, Mesh(1, 1)):
                model = init_model(cfg, torch.Generator(
                    device=dev).manual_seed(SEED), device=dev,
                    trainable=True, mesh=mesh)
                loss, _, grads = loss_and_grads(model, batch)
                opt, step = make_train_step(model, lr=TRAIN_CPU_LR, mesh=mesh)
                state, losses = opt.init(dict(model.named_parameters())), []
                for _ in range(2):
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                runs.append((loss, grads, losses,
                             dict(model.named_parameters())))
            (l0, g0, s0, p0), (l1, g1, s1, p1) = runs
            if not (torch.equal(l0, l1) and s0 == s1 and all(
                    torch.equal(g0[n], g1[n]) and torch.equal(p0[n], p1[n])
                    for n in g0)):
                differ.append(arch)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    return differ


def _scan_to_cpu(args):
    return tuple(None if a is None else a.cpu() for a in args)


def _reduced_case(shape, arch, knob) -> str:
    """A phase-37 case's name: the arch, with ``+knob`` under one, and the
    mesh."""
    return (arch + (f"+{knob}" if knob else "")
            + f" on {shape[0]} x {shape[1]}")


def phase_train_shard_reduced(torch, dev):
    """Reduced llama, granite, falcon-mamba and zamba2 on 2 x 2, llama
    and falcon-mamba under seq_parallel and llama under
    attn_shard="head_dim" on 1 x 2, and zamba2 on 2 x 1, in fp32,
    trainable: the card's ranks (B6, B7) against the CPU's (plain
    versions; the four worlds run at once) on the same weights and batch,
    at phase 29's bars (loss LOSS_RTOL, every gathered gradient leaf GRAD_REL max |g| +
    GRAD_ABS, TRAIN_CPU_STEPS updates' losses CE_RTOL and parameters 2 lr
    n and PARAM_BAR on PARAM_SHARE of the elements); B6 launched twice per
    attention unit and B7 twice per Mamba1 layer (forward, recompute) on
    every card rank, B7's backward kernel once per Mamba1 layer; B7's
    gated mode on a rank's channels bitwise its plain version in layer
    0's forward call and in its recompute, the gradient through its
    Function within phase 29's Function bars of autograd of
    plain_gated_scan there and the backward kernel at
    :func:`_check_b7_backward` 's; then on the card the 1 x 1 mesh
    bitwise the unsharded step (loss, every gradient, the parameters
    after two updates). Returns the card ranks' launches of B6, B7 and
    B7's backward."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    launches = {"B6": 0, "B7": 0, "B7_bwd": 0}
    lines = []
    with ThreadPoolExecutor(2 * len(TRAIN_SHARD_REDUCED) + 1) as pool:
        worlds = {(world, d): pool.submit(
            run_ranks, _train_shard_reduced, world, world, device=d)
            for world in TRAIN_SHARD_REDUCED for d in (dev, "cpu")}
        one = pool.submit(run_ranks, _train_shard_one_by_one, 1, device=dev)
        worlds = {k: f.result() for k, f in worlds.items()}  # every world at once
        one_by_one = one.result()[0]
    for world in TRAIN_SHARD_REDUCED:
        card, cpu = worlds[world, dev], worlds[world, "cpu"]
        for shape, arch, knob in TRAIN_SHARD_REDUCED[world]:
            cfg = get_config(arch).reduced()
            case = _reduced_case(shape, arch, knob)
            tag = f"reduced {case}"
            c0, h0 = card[0][case], cpu[0][case]
            for c, h in zip(card, cpu):
                rel = abs(c[case]["loss"] - h[case]["loss"]) / abs(
                    h[case]["loss"])
                check(rel <= LOSS_RTOL, f"{tag}: loss card vs CPU relative "
                      f"{rel:.2e} > {LOSS_RTOL}")
                rel_l = max(abs(a - b) / abs(b) for a, b in zip(
                    c[case]["losses"], h[case]["losses"]))
                check(rel_l <= CE_RTOL, f"{tag}: training losses card "
                      f"{c[case]['losses']} vs CPU {h[case]['losses']}")
                attention = (0 if cfg.family == "ssm" else cfg.num_layers
                             // (cfg.shared_attn_every or 1))
                want = {"B6": 2 * attention,
                        "B7": 2 * cfg.num_layers * (cfg.family == "ssm"),
                        "B7_bwd": cfg.num_layers * (cfg.family == "ssm")}
                check(c[case]["launches"] == want, f"{tag}: launches "
                      f"{c[case]['launches']} in a gradient, not {want}")
                for k in launches:
                    launches[k] += c[case]["launches"][k]
            errs = _leaf_errors(c0["grads"], h0["grads"])
            bad = {m: e for m, e in errs.items()
                   if not e[0] <= GRAD_REL * e[1] + GRAD_ABS or e[1] == 0.0}
            check(not bad, f"{tag}: gathered gradient leaves card vs CPU "
                  f"beyond {GRAD_REL} max|g| + {GRAD_ABS}: "
                  f"{dict(list(bad.items())[:6])}")
            diffs = torch.cat([(c0["params"][m] - p).abs().ravel()
                               for m, p in h0["params"].items()])
            limit = 2 * TRAIN_CPU_LR * TRAIN_CPU_STEPS
            share = float((diffs <= PARAM_BAR).float().mean())
            check(float(diffs.max()) <= limit and share >= PARAM_SHARE,
                  f"{tag}: parameters card vs CPU max |err| "
                  f"{float(diffs.max()):.3e} (bar {limit}), {share:.5f} "
                  f"within {PARAM_BAR}")
            worst = max(e[0] / (GRAD_REL * e[1] + GRAD_ABS)
                        for e in errs.values())
            line = (f"{case}: worst gradient leaf {worst:.3f} of its bar, "
                    f"parameters max |err| "
                    f"{float(diffs.max()):.2e}")
            if "scans" in c0:
                worst_fn = 0.0
                for when, args in c0["scans"].items():
                    args = tuple(None if a is None else a.to(dev)
                                 for a in args)
                    _check_b7_gated(torch, args, f"{tag} rank 0: layer 0's "
                                    f"gated scan ({when})", chained=False)
                    at = f"{tag} rank 0: layer 0's gated scan ({when})"
                    dy = torch.ones_like(args[2])
                    dh = torch.ones(args[2].shape[0], args[2].shape[2],
                                    args[3].shape[2], device=dev)
                    # other phases launch B7 beside this one: no counts
                    worst_fn = max(worst_fn, _b7_function_vs_autograd(
                        torch, args, dy, dh, at, count=False))
                    _check_b7_backward(torch, args, dy, dh, at)
                check(c0["scan_calls"] == 2 * cfg.num_layers,
                      f"{tag}: {c0['scan_calls']} gated scans, not "
                      f"{2 * cfg.num_layers}")
                line += ("; B7 gated on rank 0's channels bitwise plain in "
                         "layer 0's forward and recompute, its Function's "
                         "gradient within B6's bars of autograd of plain "
                         f"(worst {worst_fn:.3f} of a bar), the backward "
                         "kernel bitwise plain_gated_scan_backward on "
                         "ddt_raw, dx, dz and within its bar on the sums")
            lines.append(line)
    check(not one_by_one, "the 1 x 1 mesh's step is not bitwise the unsharded"
          f" step on the card: {one_by_one}")
    print(f"phase 37: reduced fp32 training, card ranks (B6/B7) vs CPU ranks"
          f" (plain) at phase 29's bars: " + "; ".join(lines)
          + f"; the 1 x 1 mesh bitwise the unsharded step on the card "
          f"({LM_ARCH}, {SSM_ARCH}: loss, gradients, two updates); "
          f"card launches B6 {launches['B6']}, B7 {launches['B7']}, B7's "
          f"backward {launches['B7_bwd']}; "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------ phase 38
# the dry run (repro_torch.launch.dryrun: the step traced on tensors
# without storage) held against this run's own measurements. It runs in a
# process of its own, so that its fake process group touches no other
# phase, beside the untimed gates after phase 36, and it uses the host
# alone: ``torch.tensor`` of a Python number on the card allocates it
# for real before FakeTensorMode takes it (a scalar a call), and nothing
# else may reach the card (gated: at most DRYRUN_CARD_BYTES at a time).
DRYRUN_CASES = {
    # phase 28's step: llama3.2-1b trainable, 4 x 4,096, one card
    "train": (LM_ARCH, "train", TRAIN_BATCH, LM_SEQ, (1, 1), {}),
    # phase 18's (a): falcon-mamba-7b's 4 x 4,096 prefill, one card
    "prefill": (SSM_ARCH, "prefill", LM_BATCH, LM_SEQ, (1, 1), {}),
    # phase 36's llama step: fp32, 4 x 512, on a (fake) 2 x 2 mesh
    "shard": (LM_ARCH, "train", 4, 512, (2, 2), {"dtype": "float32"}),
    # phase 42's step: falcon-mamba-7b trainable at SSM_TRAIN_LAYERS
    # layers, 4 x 4,096, one card
    "ssm_train": (SSM_ARCH, "train", TRAIN_BATCH, LM_SEQ, (1, 1),
                  {"num_layers": SSM_TRAIN_LAYERS}),
}
DRYRUN_BAND = 0.25  # a predicted peak within +-25% of the measured one
DRYRUN_FLOP_TOL = 0.01  # the traced FLOPs against the shapes' count
DRYRUN_TIMEOUT = 900  # s, from the process's start
DRYRUN_CARD_BYTES = 2**20  # the most the trace may hold on the card
OP_CALLS = 2000  # calls a path of the rebinding's overhead is timed over
_DRYRUN = r"""
import dataclasses, json, sys, time
import repro_torch.configs as C
from repro_torch.launch import dryrun
out = {}
for name, (arch, kind, B, S, mesh, over) in json.loads(sys.argv[1]).items():
    shape = "chip_smoke_" + name
    C.INPUT_SHAPES[shape] = dict(kind=kind, seq_len=S, global_batch=B)
    cfg = dataclasses.replace(C.get_config(arch), **over)
    with dryrun.fake_world(*mesh) as m:
        trace = dryrun.trace_combo(cfg, shape, m, device="cuda")
        out[name] = dryrun.analyse(arch, shape, "x".join(map(str, mesh)),
                                   trace, cfg, m)
import torch
out["card_bytes"] = (torch.cuda.max_memory_allocated()
                     if torch.cuda.is_initialized() else 0)
print(json.dumps(out))
"""


_CHILDREN: list = []  # processes still to stop when the script ends


def start_dryrun():
    """Phase 38's trace, started in a process of its own (read by
    :func:`phase_dryrun`; stopped at the script's end if still running)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    # its output goes to files, so a trace that ends long before phase 38
    # reads it never waits on a full pipe
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    proc = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN, json.dumps(DRYRUN_CASES)], cwd=ROOT,
        env=env, stdout=logs[0], stderr=logs[1], text=True)
    proc.started, proc.logs = time.perf_counter(), logs
    _CHILDREN.append(proc)
    return proc


def _stop_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _attention_excess(cfg, B, S) -> int:
    """What a card step's attention computes beyond ``lm_step_flops``'
    four causal forwards of 2 B H hd S (S + 1) a unit (the forward counted
    three times, its recompute once): B6 twice (the forward and the
    recompute), 2 B H hd S^2 each by its formula, and
    ``attention_backward_plain``, whose query chunks of c rows each run
    the recomputed forward's two products and the backward's four over
    the keys up to the chunk's end, c1: 2 B H hd c c1 each."""
    H, hd, ch = cfg.num_heads, cfg.resolved_head_dim, min(cfg.attn_chunk, S)
    units = cfg.num_layers // (cfg.shared_attn_every or 1)
    tri = sum((min(c0 + ch, S) - c0) * min(c0 + ch, S)
              for c0 in range(0, S, ch))
    return units * 2 * B * H * hd * (2 * S * S + 6 * tri - 4 * S * (S + 1))


def _op_overhead(torch, dev) -> dict:
    """The operator binding's host cost a call: B7's gated mode at the
    decode step's shape, B6 at 4 x 16 tokens and B3 at D 1,000, each
    called OP_CALLS times through its wrapper (the checks and the
    ``torch.ops.repro_torch`` operator) and as the bare launch (the
    operator's CUDA kernel, called directly), host wall to a
    synchronisation, in turns (op, bare, op, bare; the lower of each
    path's two). Returns {kernel: (op us, bare us)}."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.kernels.owlqn_direction import owlqn_direction as od

    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def r(*shape, dt=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    B, di, N = LM_BATCH, 8192, 16
    scan = (r(B, 1, di), r(di, dt=f32), r(B, 1, di), r(B, 1, N), r(B, 1, N),
            -r(di, N, dt=f32).abs(), r(di, dt=f32), r(B, 1, di),
            r(B, di, N, dt=f32))
    q, k = r(LM_BATCH, 16, 32, 64), r(LM_BATCH, 16, 8, 64)
    th, gr = r(1000, 24, dt=f32), r(1000, 24, dt=f32)
    cases = {
        "B7 gated (4, 1, 8192, 16)": (
            lambda: ms.mamba1_scan_gated(*scan),
            lambda: ms._launch_gated(*scan, 0)),
        "B6 (4, 16, 32 / 8, 64) bf16": (
            lambda: fa.flash_attention(q, k, k),
            lambda: fa._launch(q, k, k, True)),
        "B3 (1000, 24)": (lambda: od.owlqn_direction(th, gr, 0.1, 0.1),
                          lambda: od._launch(th, gr, 0.1, 0.1)),
    }
    out = {}
    with torch.no_grad():
        for name, (op, bare) in cases.items():
            best = [float("inf"), float("inf")]
            for turn in (0, 1, 0, 1):
                fn = (op, bare)[turn]
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(OP_CALLS):
                    fn()
                torch.cuda.synchronize()
                best[turn] = min(best[turn], (time.perf_counter() - t0)
                                 / OP_CALLS * 1e6)
            out[name] = tuple(best)
    return out


def phase_dryrun(torch, dev, proc, train_metrics, train_b6, ssm_metrics,
                 ssm_launches, shard_steps, ssm_train_metrics):
    """The dry run against this run's measurements (DRYRUN_CASES, traced
    by :func:`start_dryrun` 's process on fake CUDA tensors, the card's
    paths: B6 and B7 as the operators whose fakes give their shapes).
    Gates: phase 28's step: the predicted peak within DRYRUN_BAND of its
    measured ``max_memory_allocated``, B6 traced as often as it launched
    (2 x layers), the traced FLOPs within DRYRUN_FLOP_TOL of
    ``lm_step_flops`` (phase 28's roofline) plus the attention the card
    runs beyond that count (:func:`_attention_excess`); phase 18's 4 x
    4,096 prefill: B7 traced as often as it launched (64), the peak
    within the band; phase 42's Mamba1 step: the peak within the band,
    B7 and its backward kernel traced as often as they launched (2 x
    layers, layers); phase 36's llama step on the fake 2 x 2 mesh: the
    all-reduces and their bytes per group, and the FSDP gathers and
    reduce-scatters among them, equal to the ranks' measured counts
    exactly; the trace's process held at most DRYRUN_CARD_BYTES on the
    card. Printed first: each case's record (memory by category, FLOPs,
    HBM bytes, the roofline), and the operator binding's host cost a
    call (:func:`_op_overhead`) beside phase 18's decode ms/token."""
    from repro_torch.configs import get_config
    from repro_torch.utils.roofline import lm_step_flops

    t0 = time.perf_counter()

    def read(log):
        log.seek(0)
        return log.read()

    try:
        proc.wait(timeout=max(0.0, DRYRUN_TIMEOUT - (t0 - proc.started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"phase 38: the dry run did not end within "
                           f"{DRYRUN_TIMEOUT} s: "
                           f"{read(proc.logs[1])[-3000:]}") from None
    out, err = (read(log) for log in proc.logs)
    check(proc.returncode == 0, f"phase 38: the dry run exited "
          f"{proc.returncode}: {err[-4000:]}")
    recs = json.loads(out.strip().splitlines()[-1])
    card_bytes = recs.pop("card_bytes")
    lines = []
    for name, rec in recs.items():
        mem, r = rec["memory"], rec["roofline"]
        lines.append(
            f"  {name}: {rec['arch']} {rec['kind']} on {rec['mesh']} "
            f"({rec['trace_seconds']} s to trace): peak "
            f"{mem['total_bytes_per_chip'] / 1e9:.2f} GB ("
            + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in
                        mem["peak_by_category"].items())
            + f"), FLOPs {r['flops_per_chip']:.4e}, HBM bytes "
            f"{r['hbm_bytes_per_chip']:.4e}, collective bytes "
            f"{r['collective_bytes_per_chip']:.4e}; t_compute "
            f"{r['t_compute_s'] * 1e3:.2f} ms, t_memory "
            f"{r['t_memory_s'] * 1e3:.2f} ms, t_collective "
            f"{r['t_collective_s'] * 1e3:.2f} ms, {r['bottleneck']}-bound; "
            f"kernel calls {rec['kernel_calls']}")

    print("phase 38: the dry run's records (fake tensors, the card's "
          "paths; predictions with the NVIDIA H100 80GB HBM3 constants):")
    for line in lines:
        print(line)
    check(card_bytes <= DRYRUN_CARD_BYTES, f"phase 38: the trace held "
          f"{card_bytes} bytes on the card at once (bar {DRYRUN_CARD_BYTES})")
    cfg = get_config(LM_ARCH)
    train, prefill, shard = recs["train"], recs["prefill"], recs["shard"]
    ssm_train = recs["ssm_train"]
    peaks = {"train": (train, train_metrics["peak_gb"], "phase 28's step"),
             "prefill": (prefill, ssm_metrics["prefill_peak_gb"],
                         "phase 18's 4 x 4,096 prefill"),
             "ssm_train": (ssm_train, ssm_train_metrics["peak_gb"],
                           "phase 42's Mamba1 step")}
    ratios = {}
    for name, (rec, measured, what) in peaks.items():
        got = rec["memory"]["total_bytes_per_chip"] / 1e9
        ratios[name] = got / measured
        check(abs(got / measured - 1) <= DRYRUN_BAND,
              f"phase 38: the predicted peak of {what}, {got:.2f} GB, is "
              f"{got / measured:.3f} x the measured {measured:.2f} GB "
              f"(band +-{DRYRUN_BAND:.0%})")
    b6 = train["kernel_calls"].get("flash_attention", 0)
    check(b6 == train_b6 == 2 * cfg.num_layers,
          f"phase 38: B6 traced {b6} times in the step, launched "
          f"{train_b6} (expected {2 * cfg.num_layers})")
    b7 = prefill["kernel_calls"].get("mamba1_scan_gated", 0)
    layers = get_config(SSM_ARCH).num_layers
    check(b7 == ssm_launches["prefill"] == layers,
          f"phase 38: B7 traced {b7} times in the prefill, launched "
          f"{ssm_launches['prefill']} (expected {layers})")
    ssm_calls = {k: ssm_train["kernel_calls"].get(k, 0)
                 for k in ("mamba1_scan_gated", "mamba1_scan_gated_backward")}
    want = {"mamba1_scan_gated": 2 * SSM_TRAIN_LAYERS,
            "mamba1_scan_gated_backward": SSM_TRAIN_LAYERS}
    check(ssm_calls == ssm_train_metrics["launches_per_step"] == want,
          f"phase 38: B7 and its backward traced {ssm_calls} in the Mamba1 "
          f"step, launched {ssm_train_metrics['launches_per_step']} "
          f"(expected {want})")
    roof = lm_step_flops(cfg, TRAIN_BATCH, LM_SEQ)
    excess = _attention_excess(cfg, TRAIN_BATCH, LM_SEQ)
    flops = train["roofline"]["flops_per_chip"]
    off = abs(flops - (roof + excess)) / roof
    check(off <= DRYRUN_FLOP_TOL,
          f"phase 38: the traced step's FLOPs {flops:.4e} are {off:.2%} "
          f"of phase 28's roofline ({roof:.4e}) away from it plus the "
          f"attention's excess ({excess:.4e}); bar {DRYRUN_FLOP_TOL:.0%}")
    arch, shape, batch_size, seq = TRAIN_SHARD_CASES[0]
    step = shard_steps[arch, shape]
    want = {a: {"count": int(c["all_reduce"]), "bytes": int(c["bytes"])}
            for a, c in step["counts"].items()}
    want.update({k: {"count": c["calls"], "bytes": c["bytes"]}
                 for k, c in step["split"].items()})
    got = shard["collectives_by_axis"]
    check(got == want, f"phase 38: the fake {shape[0]} x {shape[1]} step's "
          f"collectives {got} differ from phase 36's rank 0 {want}")
    check(shard["kernel_calls"].get("flash_attention") == step["launches"],
          f"phase 38: B6 traced {shard['kernel_calls']} times on the fake "
          f"mesh, launched {step['launches']} on rank 0")
    overhead = _op_overhead(torch, dev)
    decode_ms = ssm_metrics["decode_ms_per_token"]
    b7_op, b7_bare = overhead["B7 gated (4, 1, 8192, 16)"]
    print(f"phase 38: the dry run against this run: {LM_ARCH}'s train "
          f"step peak "
          f"{train['memory']['total_bytes_per_chip'] / 1e9:.2f} GB = "
          f"{ratios['train']:.3f} x phase 28's {train_metrics['peak_gb']:.2f}"
          f" GB, {SSM_ARCH}'s prefill {ratios['prefill']:.3f} x phase 18's "
          f"{ssm_metrics['prefill_peak_gb']:.2f} GB, its {SSM_TRAIN_LAYERS}-"
          f"layer step {ratios['ssm_train']:.3f} x phase 42's "
          f"{ssm_train_metrics['peak_gb']:.2f} GB (band "
          f"+-{DRYRUN_BAND:.0%}); B6 traced {b6} (launched {train_b6}), B7 "
          f"{b7} (launched {ssm_launches['prefill']}), in the Mamba1 step B7 "
          f"{ssm_calls['mamba1_scan_gated']} and its backward "
          f"{ssm_calls['mamba1_scan_gated_backward']} (as launched); the "
          f"step's FLOPs "
          f"{flops:.4e} = {flops / roof:.4f} x phase 28's roofline "
          f"{roof:.4e}, {(flops - excess) / roof:.4f} x it without the "
          f"attention the card runs beyond that count ({excess:.4e}: B6's "
          f"recompute and the plain backward's chunks; bar "
          f"{DRYRUN_FLOP_TOL:.0%}); the fake {shape[0]} x {shape[1]} step's "
          f"collectives equal phase 36's rank 0 exactly: "
          + json.dumps(got) + f"; the {len(recs)} traces took "
          f"{sum(r['trace_seconds'] for r in recs.values()):.1f} s in "
          f"their process, {time.perf_counter() - t0:.1f} s waited for "
          f"here, and held at most {card_bytes} bytes on the card")
    print("  the operator binding's host cost a call (op: the wrapper and "
          "torch.ops.repro_torch; bare: the launch alone; us, the lower of"
          " two runs of " + f"{OP_CALLS}): " + "; ".join(
              f"{k} {a:.2f} vs {b:.2f} (+{a - b:.2f})"
              for k, (a, b) in overhead.items())
          + f"; B7 {layers} a decode step: +{(b7_op - b7_bare) * layers / 1e3:.3f}"
          f" ms/token against phase 18's {decode_ms:.2f} ms/token")
    return recs, overhead


# ------------------------------------------------------------ phase 39
# the zoo's configs no phase above runs (ROADMAP A15i), each at full width
# and depth in bf16: {arch: the parameters init_model draws}
ZOO_PARAMS = {"olmo-1b": 1_176_764_416, "internvl2-2b": 1_889_146_880,
              "musicgen-medium": 1_365_394_944,
              "mistral-nemo-12b": 12_247_782_400}
ZOO_LONG = ("olmo-1b", "mistral-nemo-12b")  # these also prefill 1 x 32,768
# B6 at hd 128: mistral-nemo's two prefill shapes (32 heads over 8 KV
# heads) and olmo's (16 MHA heads)
ZOO_B6_SHAPES = ((LM_BATCH, LM_SEQ, 32, 8, 128, TIMED_RUNS, WARM_RUNS),
                 (1, LM_LONG, 32, 8, 128, LONG_RUNS, 1),
                 (LM_BATCH, LM_SEQ, 16, 16, 128, TIMED_RUNS, WARM_RUNS))


def _zoo_feed(torch, dev, cfg):
    """A 4 x 4,096-position prompt of ``cfg`` and the input after it:
    (prefill's kwargs, decode_step's kwarg for position 4,096 -- a (B,)
    token or a (B, d) frame embedding --, the forward's kwargs over all
    4,097 positions). Tokens come from the token stream; musicgen's frame
    embeddings and internvl2's 256 patch embeddings (in front of 3,840
    tokens) from a numpy seed, in bf16 on the card."""
    from repro_torch.data.tokens import TokenStream

    def emb(n):
        return _embeddings(torch, cfg, LM_BATCH, n, SEED + 39).to(
            dev, torch.bfloat16)

    if cfg.embeds_in:
        e = emb(LM_SEQ + 1)
        return ({"embeds": e[:, :LM_SEQ]}, {"embed": e[:, LM_SEQ]},
                {"embeds": e})
    P = cfg.num_prefix_embeds
    toks = torch.from_numpy(TokenStream(cfg.vocab_size, seed=SEED).batch(
        LM_BATCH, LM_SEQ - P + 2)["tokens"]).to(dev)
    pre = {"prefix_embeds": emb(P)} if P else {}
    return ({"tokens": toks[:, :-1], **pre}, {"token": toks[:, -1]},
            {"tokens": toks, **pre})


def _logit_gate(torch, got, want):
    """(max |err|, share of the rtol = atol = LM_TOL bar, argmax equal)."""
    err, bar = _within(torch, got, want, LM_TOL)
    return err, bar, torch.equal(got.argmax(-1), want.argmax(-1))


def _decode_bound_ms(model, dec, valid) -> float:
    """A decode step's least time: every matmul weight read once (the
    embedding table only where tied, as the head) and the ``valid``
    cache positions of k and v, over the card's memory rate."""
    weights = sum(p.numel() * p.element_size() for name, p in
                  model.named_parameters()
                  if name != "embed" or model.cfg.tie_embeddings)
    kv = sum(c[:, :, :valid].numel() * c.element_size()
             for n, c in dec.items() if n in ("k", "v"))
    return (weights + kv) / HBM_BYTES_PER_S * 1e3


def _zoo_model(torch, dev, arch):
    """(a) (b) (c) and the gates of phase 39 on one config; the model is
    freed on return. Returns (B6 launches by run, B6's max |err| on layer
    0's q, k, v, the metrics)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )
    from repro_torch.models import (
        decode_step,
        forward,
        init_caches,
        init_model,
        prefill,
    )
    from repro_torch.models import transformer
    from repro_torch.models.generate import fill_caches, generate

    cfg = get_config(arch)
    nl = cfg.num_layers
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == ZOO_PARAMS[arch], f"{arch} has {n_params:,} "
          f"parameters, not {ZOO_PARAMS[arch]:,}")
    feed, nxt, full = _zoo_feed(torch, dev, cfg)
    long_prompt = (torch.from_numpy(TokenStream(cfg.vocab_size, seed=SEED)
                                    .batch(1, LM_LONG + 1)["tokens"]).to(dev)
                   if arch in ZOO_LONG else None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prefill(model, **{k: v[:, :SSM_SHORT] for k, v in feed.items()})

    launches, secs = {}, {}

    def run(name, fn):
        """``fn()`` with B6's count set to 0 just before and read just
        after, timed on the host (synchronised)."""
        _reset((B6,))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        launches[name] = B6["flash_attention"]
        return out

    torch.cuda.reset_peak_memory_stats()
    logits, caches = run("prefill", lambda: prefill(model, **feed))
    if cfg.embeds_in or cfg.num_prefix_embeds:
        # no generate: musicgen decodes seeded frame embeddings, internvl2
        # its greedy tokens after the patch prefix, step by step
        emb = (_embeddings(torch, cfg, LM_BATCH, LM_NEW, SEED + 40).to(
            dev, torch.bfloat16) if cfg.embeds_in else None)
        out, _ = run("decode", lambda: _greedy_decode(
            torch, model, logits, caches, LM_SEQ, LM_NEW, emb))
        how = ("32 decode steps on seeded frame embeddings (decode_step("
               "embed=))" if cfg.embeds_in else
               "32 greedy decode steps after the patch prefix")
    else:
        out = run("generate", lambda: generate(model, feed["tokens"], LM_NEW,
                                               temperature=0.0))
        how = f"greedy generate of {LM_NEW} tokens (its prefill included)"
    if long_prompt is not None:
        long_logits, long_caches = run("prefill_32k", lambda: prefill(
            model, tokens=long_prompt))
        check(long_logits.shape == (1, cfg.vocab_size)
              and bool(torch.isfinite(long_logits.float()).all()),
              f"{arch}: 32k prefill logits have the wrong shape or are not "
              "finite")
        del long_logits, long_caches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, count in launches.items():
        want = 0 if name == "decode" else nl
        check(count == want, f"{arch}: B6 launched {count} times in {name}, "
              f"not {want}")
    check(logits.shape == (LM_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"{arch}: prefill logits have the wrong shape or are not finite")
    check(caches["k"].shape == (nl, LM_BATCH, LM_SEQ, cfg.num_kv_heads,
                                cfg.resolved_head_dim),
          f"{arch}: prefill caches have shape {tuple(caches['k'].shape)}")
    check(out.shape == (LM_BATCH, LM_NEW) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size,
          f"{arch}: decoded tokens have the wrong shape or are out of range")
    check(torch.equal(out[:, 0], logits.argmax(-1).to(out.dtype)),
          f"{arch}: the first greedy token is not the prefill logits' argmax")
    del out

    # B6 against plain on layer 0's q, k, v of (a)
    q, k, v = _first_attention_inputs(torch, model, **feed)
    b6_err = _check_b6(torch, q, k, v, True, f"{arch}'s layer 0 q, k, v "
                       f"({LM_BATCH} x {LM_SEQ:,}, hd {q.shape[-1]})")
    del q, k, v
    # the model on plain attention; decode of position 4,096 after (a)
    # against the forward of all 4,097 positions there
    plain_logits, _ = _with_plain_attention(lambda: prefill(model, **feed))
    dec = fill_caches(init_caches(cfg, LM_BATCH, LM_SEQ + LM_NEW,
                                  device=dev), caches)
    del caches
    step_logits, dec = decode_step(model, dec, pos=LM_SEQ, **nxt)
    hidden, _ = forward(model, return_hidden=True, **full)
    fwd_logits = transformer.lm_logits(model, hidden[:, LM_SEQ])
    del hidden
    gates = {"plain": (logits, plain_logits),
             "decode": (step_logits, fwd_logits)}
    bf16 = {g: _logit_gate(torch, *pair) for g, pair in gates.items()}
    fp32 = {}
    if not all(bar <= 1.0 and same for _, bar, same in bf16.values()):
        # bf16 misses: the same weights in fp32 on row 0 are gated instead
        one = {k: v[:1] for k, v in feed.items()}
        model32 = _twin(model, dtype="float32")
        l32, c32 = prefill(model32, **one)
        p32, _ = _with_plain_attention(lambda: prefill(model32, **one))
        d32 = fill_caches(init_caches(cfg, 1, LM_SEQ + 1,
                                      dtype=torch.float32, device=dev), c32)
        del c32
        s32, _ = decode_step(model32, d32, pos=LM_SEQ,
                             **{k: v[:1] for k, v in nxt.items()})
        h32, _ = forward(model32, return_hidden=True,
                         **{k: v[:1] for k, v in full.items()})
        f32 = transformer.lm_logits(model32, h32[:, LM_SEQ])
        del model32, d32, h32
        torch.cuda.empty_cache()
        fp32 = {"plain": _logit_gate(torch, l32, p32),
                "decode": _logit_gate(torch, s32, f32)}
    for g, (err, bar, same) in (fp32 or bf16).items():
        what = ("prefill logits with B6 vs plain attention" if g == "plain"
                else f"decode of position {LM_SEQ:,} after (a) vs the "
                f"forward of {LM_SEQ + 1:,} positions")
        check(bar <= 1.0 and same, f"{arch}: {'fp32' if fp32 else 'bf16'} "
              f"{what} beyond rtol = atol = {LM_TOL} or argmax unequal: max "
              f"|err| {err:.3e}, {bar:.2f} of the bar, argmax equal {same}")

    if "decode" in secs:
        decode_ms = secs["decode"] * 1e3 / LM_NEW
        pos, tok = LM_SEQ + 1, nxt
    else:
        decode_ms, last, dec = _timed_decode(
            torch, model, dec, step_logits.argmax(-1).to(torch.int32), LM_SEQ)
        pos, tok = LM_SEQ + LM_NEW // 2 + 1, {"token": last}
    _, wall_us, kernels = _device_profile(
        torch, lambda: decode_step(model, dec, pos=pos, **tok))
    busy_ms = sum(v[0] for v in kernels.values()) / 1e3
    bound_ms = _decode_bound_ms(model, dec, pos + 1)
    _print_profile(f"one {arch} decode step", wall_us, kernels)
    _print_elementwise(kernels, LM_KERNELS)
    metrics = {"parameters": n_params, "setup_s": setup_s,
               "prefill_tokens_per_s": LM_BATCH * LM_SEQ / secs["prefill"],
               "decode_ms_per_token": decode_ms, "peak_gb": peak_gb,
               "decode_step_device_ms": busy_ms,
               "decode_step_wall_ms": wall_us / 1e3,
               "decode_step_bound_ms": bound_ms}
    if "prefill_32k" in secs:
        metrics["prefill_32k_tokens_per_s"] = LM_LONG / secs["prefill_32k"]
    line = "; ".join(
        f"{g}: bf16 max |err| {e:.3e} ({b:.2f} of the bar), argmax "
        f"{'equal' if same else 'unequal'}"
        + (f"; fp32 on row 0 (gated) max |err| {fp32[g][0]:.3e} "
           f"({fp32[g][1]:.2f}), argmax equal" if fp32 else "")
        for g, (e, b, same) in bf16.items())
    print(f"phase 39: {arch} ({cfg.family}, {nl} layers, d {cfg.d_model}, "
          f"H {cfg.num_heads} / KVH {cfg.num_kv_heads} x hd "
          f"{cfg.resolved_head_dim}, {n_params:,} parameters, bf16 from a "
          f"seeded torch.Generator, set-up {setup_s:.2f} s): (a) prefill "
          f"{LM_BATCH} x {LM_SEQ:,} in {secs['prefill'] * 1e3:.1f} ms = "
          f"{metrics['prefill_tokens_per_s']:,.0f} tokens/s; (b) {how} in "
          f"{secs.get('decode', secs.get('generate')):.2f} s, tokens in "
          "range"
          + (f"; (c) prefill 1 x {LM_LONG:,} in {secs['prefill_32k']:.2f} s "
             f"= {metrics['prefill_32k_tokens_per_s']:,.0f} tokens/s"
             if "prefill_32k" in secs else "")
          + f"; peak memory {peak_gb:.2f} GB; B6 launches {launches}")
    print(f"  B6 vs plain on layer 0's q, k, v: max |err| {b6_err:.3e} (bar "
          f"{B6_TOL['bfloat16']}), repeatable; rtol = atol = {LM_TOL}: "
          f"{line}; decode {decode_ms:.2f} ms/token at batch {LM_BATCH} "
          f"(host wall, {'(b)' if 'decode' in secs else 'mean of 16 greedy steps'}); "
          f"one decode step profiled: {wall_us / 1e3:.2f} ms wall, "
          f"{busy_ms:.2f} ms of device kernels (idle "
          f"{1 - busy_ms * 1e3 / wall_us:.1%}), bound {bound_ms:.2f} ms (its "
          f"weights and {pos + 1:,} cache positions read once at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    del model, dec, logits, plain_logits, step_logits, fwd_logits
    torch.cuda.empty_cache()
    return launches, b6_err, metrics


def phase_zoo_lm(torch, dev):
    """The zoo's serving paths at full width and depth in bf16 (ROADMAP
    A15i): olmo-1b, internvl2-2b, musicgen-medium and mistral-nemo-12b,
    one at a time (each model and the allocator's cache freed before the
    next): (a) prefill of 4 x 4,096 positions, (b) 32 greedy decode steps
    after it (``generate`` for the token models; internvl2's after its
    patch prefix and musicgen's on seeded frame embeddings, through
    ``decode_step``), (c) a 1 x 32,768 prefill for olmo and
    mistral-nemo. Gates: the parameter count, B6 once per layer per
    prefill, B6 vs plain on layer 0's q, k, v, last-token logits with B6
    vs the same model on plain attention and decode of position 4,096
    after (a) vs the forward of the 4,097 positions, both at rtol = atol
    = 5e-2 with argmax equal (in fp32 on row 0 where bf16 misses),
    tokens in range. Then B6 timed at hd 128 at mistral-nemo's and olmo's
    prefill shapes. Returns ({arch: {run: B6 launches}}, B6's max |err|,
    {arch: metrics}, the timing rows)."""
    t_phase, launches, errs, metrics = time.perf_counter(), {}, [], {}
    for arch in ZOO_PARAMS:
        launches[arch], err, metrics[arch] = _zoo_model(torch, dev, arch)
        errs.append(err)
    rng = np.random.default_rng(SEED + 39)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    rows = [_b6_time_row(torch, dev, rng, flush, *shape, 39)
            for shape in ZOO_B6_SHAPES]
    print(f"phase 39 took {time.perf_counter() - t_phase:.1f} s")
    return launches, max(errs), metrics, rows


# ------------------------------------------------------------ phase 40
def _quantiles(x) -> str:
    """min / median / max of a tensor's elements, or "-" when empty."""
    if not x.numel():
        return "-"
    x = x.float().flatten().sort().values
    return (f"{float(x[0]):.3f} / {float(x[x.numel() // 2]):.3f} / "
            f"{float(x[-1]):.3f}")


INT8_STEPS = 64  # decode steps from empty caches, int8 against bf16
INT8_TOL = 0.2  # tests/test_int8_kv.py:34 (rtol = atol)
WINDOW_PROMPT, WINDOW_NEW = 8000, 256  # the 8,192-slot ring wraps at step 192
LONG_500K_POS = 524_280  # long_500k's last 8 decode positions start here


def phase_decode_variants(torch, dev):
    """The two decode variants at llama3.2-1b's full width (bf16): (a)
    the int8 KV cache, batch 4, 64 steps from empty caches through
    ``decode_step`` against the bf16-cache decode of the same tokens; (b)
    the sliding-window ring of ``cfg.sliding_window`` = 8,192 slots:
    ``generate(window=True)`` of 256 tokens after a 4 x 8,000 prompt,
    whose ring wraps at step 192, against ``window=False`` bit for bit
    before the wrap and, after it, each step's logits against a witness
    that attends over the same 8,192 positions in position order; (c)
    the reference's long_500k shape: a ring filled by a prefill of 8,192
    tokens, then 8 window decode steps at positions 524,280-524,287.
    Returns ({path: B6 launches}, metrics)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash_attention.flash_attention import (
        LAUNCHES as B6,
    )
    from repro_torch.models import (
        decode_step,
        init_caches,
        init_model,
        prefill,
    )
    from repro_torch.models import generate as G
    from repro_torch.models import layers as L

    t_phase, cfg = time.perf_counter(), get_config(LM_ARCH)
    W = cfg.sliding_window
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    stream = TokenStream(cfg.vocab_size, seed=SEED + 40)

    # (a) the int8 cache: the same weights (shared, not copied) under
    # kv_cache_dtype="int8"
    model8 = _twin(model, kv_cache_dtype="int8")
    toks = torch.from_numpy(stream.batch(LM_BATCH, INT8_STEPS + 1)[
        "tokens"]).to(dev)

    def decode_run(m):
        decode_step(m, init_caches(m.cfg, LM_BATCH, 1, device=dev),
                    token=toks[:, 0], pos=0)  # first use
        caches = init_caches(m.cfg, LM_BATCH, INT8_STEPS, device=dev)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(INT8_STEPS):
            lg, caches = decode_step(m, caches, token=toks[:, t], pos=t)
            out.append(lg)
        torch.cuda.synchronize()
        return (torch.stack(out), caches,
                (time.perf_counter() - t0) * 1e3 / INT8_STEPS)

    _reset((B6,))
    l16, c16, ms16 = decode_run(model)
    l8, c8, ms8 = decode_run(model8)
    int8_b6 = B6["flash_attention"]
    check(c8["k"].dtype == torch.int8 and c8["k_scale"].dtype
          == torch.bfloat16, "the int8 caches are not int8 codes with bf16 "
          "scales")
    check(bool(torch.isfinite(l8.float()).all()), "int8-cache logits are "
          "not finite")
    err8, bar8 = _within(torch, l8, l16, INT8_TOL)
    check(bar8 <= 1.0, f"int8-cache logits beyond rtol = atol = {INT8_TOL} "
          f"of the bf16 cache's: max |err| {err8:.3e}")
    # top-1 is printed, not gated: a random model's bf16 logits over
    # 128,256 tokens lie within a few bf16 ulps at the top of some rows
    # (the top-2 gaps printed), where the int8 cache's logit error picks
    # either (ROADMAP C)
    flip = l8.argmax(-1) != l16.argmax(-1)  # (steps, B)
    agree = int((~flip).all(-1).sum())
    top2 = l16.float().topk(2, -1).values
    gap = top2[..., 0] - top2[..., 1]
    row_err = (l8.float() - l16.float()).abs().amax(-1)
    for name in ("k", "v"):
        check(bool((c8[name].abs().amax(-1) == 127).all()),
              f"an int8 {name} slot's max |code| is not 127")
    print(f"phase 40: (a) int8 KV cache ({LM_ARCH}, full width, batch "
          f"{LM_BATCH}, {INT8_STEPS} decode steps from empty caches, the "
          f"same tokens): logits within rtol = atol = {INT8_TOL} of the bf16"
          f" cache's (max |err| {err8:.3e}, {bar8:.2f} of the bar), every "
          f"written (token, head) slot's max |code| 127 in k and v; top-1 "
          f"(printed) equal on all {LM_BATCH} rows in {agree} of "
          f"{INT8_STEPS} steps, {int(flip.sum())} of {flip.numel()} "
          f"(step, row) argmaxes flipped, where the bf16 cache's top-2 gap "
          f"was {_quantiles(gap[flip])} against a row's max |err| "
          f"{_quantiles(row_err[flip])} (all rows: gap "
          f"{_quantiles(gap)}, max |err| {_quantiles(row_err)}); "
          f"{ms8:.2f} ms/token with "
          f"the int8 cache (it dequantises the whole valid cache each step) "
          f"against {ms16:.2f} with bf16 (host wall); B6 {int8_b6} (decode "
          "attention is plain PyTorch, as in the reference)")
    del model8, l8, l16, c8, c16

    # (b) the ring: generate(window=True) with every decode step's logits
    # kept; window=False up to the wrap, keeping its caches
    prompt = torch.from_numpy(stream.batch(LM_BATCH, WINDOW_PROMPT + 1)[
        "tokens"]).to(dev)
    wrap = W - WINDOW_PROMPT  # decode step i runs at WINDOW_PROMPT + i
    kept = []
    launches = {}
    step = _recording(G, "decode_step", lambda out: kept.append(out[0]))
    try:
        _reset((B6,))
        t0 = time.perf_counter()
        tok_w = G.generate(model, prompt, WINDOW_NEW, temperature=0.0,
                           window=True)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        launches["generate_window"] = B6["flash_attention"]
    finally:
        G.decode_step = step
    seen = {}
    step = _recording(G, "decode_step",
                      lambda out: seen.__setitem__("caches", out[1]))
    try:
        _reset((B6,))
        tok_f = G.generate(model, prompt, wrap + 1, temperature=0.0)
        launches["generate_full"] = B6["flash_attention"]
    finally:
        G.decode_step = step
    check(tok_w.shape == (LM_BATCH, WINDOW_NEW) and int(tok_w.min()) >= 0
          and int(tok_w.max()) < cfg.vocab_size and len(kept)
          == WINDOW_NEW - 1, "window tokens have the wrong shape or are out "
          "of range")
    check(torch.equal(tok_w[:, :wrap + 1], tok_f), f"window decode's first "
          f"{wrap + 1} tokens (before the ring wraps) differ from "
          "window=False's")
    # the witness: window=False's caches, grown, decoding the window run's
    # tokens from the wrap on, attending over the last W positions of its
    # position-ordered cache (last_window; the identity on a ring's W)
    full = G.fill_caches(init_caches(cfg, LM_BATCH, WINDOW_PROMPT
                                     + WINDOW_NEW, device=dev),
                         seen.pop("caches"))
    plain = L.decode_attention

    def last_window(q, k, v, valid, **kw):
        lo = max(0, valid - W)
        return plain(q, k[:, lo:valid], v[:, lo:valid], valid - lo, **kw)

    def after_wrap(m, full, ring=None, rows=LM_BATCH):
        """(worst (share of the bar, max |err|), argmax flips) of the ring's
        logits (``kept``, or ``ring`` decoded here) against the witness on
        ``full`` at every step after the wrap."""
        worst, flips = (0.0, 0.0), 0
        L.decode_attention = last_window
        try:
            for i in range(wrap, WINDOW_NEW - 1):
                fed = {"token": tok_w[:rows, i], "pos": WINDOW_PROMPT + i}
                got = (kept[i] if ring is None else
                       decode_step(m, ring, window=True, **fed)[0])
                lg, full = decode_step(m, full, **fed)
                err, bar = _within(torch, got, lg, LM_TOL)
                worst = max(worst, (bar, err))
                flips += int((got.argmax(-1) != lg.argmax(-1)).sum())
        finally:
            L.decode_attention = plain
        return worst, flips

    worst16, flips16 = after_wrap(model, full)
    del full, kept
    gated = "bf16"
    worst, flips = worst16, flips16
    if worst16[0] > 1.0 or flips16:
        # bf16 misses (the ring sums its W positions in another order, and
        # 16 bf16 layers carry that past the bar): the same weights in fp32
        # on row 0, with fp32 caches, are gated instead, the ring and the
        # witness both from one prefill of the W positions before the wrap
        # (the prompt and the window run's first tokens)
        gated = "fp32 on row 0"
        model32 = _twin(model, dtype="float32")
        _, c32 = prefill(model32, tokens=torch.cat([prompt[:1],
                                                    tok_w[:1, :wrap]], 1))
        ring = G.fill_caches(init_caches(cfg, 1, W, dtype=torch.float32,
                                         device=dev), c32)
        full = G.fill_caches(init_caches(cfg, 1, WINDOW_PROMPT + WINDOW_NEW,
                                         dtype=torch.float32, device=dev),
                             c32)
        del c32
        worst, flips = after_wrap(model32, full, ring, rows=1)
        del model32, ring, full
        torch.cuda.empty_cache()
    check(worst[0] <= 1.0 and flips == 0, f"{gated}: window decode after "
          f"the wrap vs the position-ordered witness beyond rtol = atol = "
          f"{LM_TOL} or argmax unequal: {worst[0]:.2f} of the bar (max "
          f"|err| {worst[1]:.3e}), {flips} argmax flips")
    print(f"phase 40: (b) the ring ({W:,} slots): generate(window=True) of "
          f"{WINDOW_NEW} tokens after a {LM_BATCH} x {WINDOW_PROMPT:,} prompt "
          f"in {window_s:.2f} s ({(WINDOW_NEW - 1) / window_s:.1f} steps/s "
          f"with its prefill), the ring wrapping at step {wrap}; the first "
          f"{wrap + 1} tokens bitwise window=False's; after the wrap "
          f"{WINDOW_NEW - 1 - wrap} steps' logits vs a witness attending "
          f"over the same {W:,} positions in position order: bf16 max |err| "
          f"{worst16[1]:.3e} ({worst16[0]:.2f} of the rtol = atol = "
          f"{LM_TOL} bar), {flips16} argmax flips"
          + (f"; fp32 on row 0 (gated) max |err| {worst[1]:.3e} "
             f"({worst[0]:.2f}), argmax equal" if gated != "bf16" else
             " (gated)") + f"; B6 {launches}")

    # (c) long_500k: a ring filled by one prefill of W tokens, then 8
    # window decode steps ending at position 524,287
    long_prompt = torch.from_numpy(stream.batch(1, W + 1)["tokens"]).to(dev)
    _reset((B6,))
    logits, caches = prefill(model, tokens=long_prompt)
    launches["long_500k_prefill"] = B6["flash_attention"]
    ring = G.fill_caches(init_caches(cfg, 1, W, device=dev), caches)
    del caches
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for pos in range(LONG_500K_POS, LONG_500K_POS + 8):
        lg, ring = decode_step(model, ring, token=tok, pos=pos, window=True)
        outs.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t0) * 1e3 / 8
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs),
          "long_500k decode logits are not finite")
    for run, want in (("generate_window", cfg.num_layers),
                      ("generate_full", cfg.num_layers),
                      ("long_500k_prefill", cfg.num_layers)):
        check(launches[run] == want, f"B6 launched {launches[run]} times in "
              f"{run}, not {want}")
    print(f"phase 40: (c) long_500k: batch 1, a ring of {W:,} slots filled "
          f"by a prefill of {W:,} tokens, then 8 window decode steps at "
          f"positions {LONG_500K_POS:,}-{LONG_500K_POS + 7:,}: logits "
          f"finite, {long_ms:.2f} ms/token (host wall)")
    del model, ring
    torch.cuda.empty_cache()
    print(f"phase 40 took {time.perf_counter() - t_phase:.1f} s")
    return ({"lm_serve_int8": int8_b6,
             "lm_serve_window": sum(launches.values()),
             **{f"lm_serve_window/{r}": n for r, n in launches.items()}},
            {"int8_ms_per_token": ms8, "bf16_cache_ms_per_token": ms16,
             "window_steps_per_s": (WINDOW_NEW - 1) / window_s,
             "long_500k_ms_per_token": long_ms})


# ------------------------------------------------------------ phase 41
ZOO_CPU = {"mistral-nemo-12b": {"head_dim": 128}, "olmo-1b": {},
           "internvl2-2b": {}, "musicgen-medium": {}}
ZOO_CPU_RING = 64  # the reduced sliding_window


def _rope_ulps(torch, pos, hd, theta, dev):
    """How far the card's rope tables at ``pos`` lie from the CPU's beyond
    1e-6 (cos and sin's own rounding on the two devices), in ulps of the
    fp32 angle (the largest over cos and sin), and how far the inverse
    frequencies each side's fp32 ``pow`` gives lie apart, in their own
    ulps. Two frequencies k ulps apart put the angles at most 2k + 1 of
    the angle's ulps apart (a position times a frequency's ulp is within
    two of the product's, and each product rounds once)."""
    from repro_torch.models import layers as L

    inv = [(1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=w) / hd))).cpu()
           for w in ("cpu", dev)]
    inv_ulps = float(((inv[1] - inv[0]).abs() / torch.from_numpy(
        np.spacing(inv[0].numpy()))).max())
    ulp = torch.from_numpy(np.spacing((pos[:, None].float() * inv[0])
                                      .numpy()))
    tables = [L.rope_cos_sin(pos.to(w), hd, theta) for w in ("cpu", dev)]
    return max(float((((a - b.cpu()).abs() - 1e-6).clamp(min=0) / ulp)
                     .max()) for a, b in zip(*tables)), inv_ulps


def phase_zoo_card_vs_cpu(torch, dev):
    """Phase 15's check on the four configs reduced, fp32, B6 on the card
    and plain attention on the CPU, the same weights (mistral-nemo with
    head_dim 128: d 256, H 4 x 128 = 512 != d; internvl2 with its patch
    prefix; musicgen on frame embeddings, decoding with ``embed=``); then
    on reduced mistral-nemo an int8-cache decode of 16 steps from empty
    caches, and window decode: ``generate(window=True)`` past the
    64-slot ring's wrap, and a ring filled by a prefill of 64 tokens
    decoding at positions 524,280-524,287. Logits within LM_CPU_TOL,
    greedy tokens equal."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import (
        decode_step,
        init_caches,
        prefill,
    )
    from repro_torch.models import layers as L
    from repro_torch.models.generate import fill_caches, generate

    t_phase = time.perf_counter()
    for arch, over in ZOO_CPU.items():
        cpu, card, _ = phase_lm_card_vs_cpu(torch, dev, arch, 41, over=over)
        if arch == "mistral-nemo-12b":
            models = {"cpu": cpu, "card": card}
    cfg = models["cpu"].cfg
    W = cfg.sliding_window
    check(W == ZOO_CPU_RING, f"the reduced window is {W}")
    toks = TokenStream(cfg.vocab_size, seed=SEED + 41).batch(
        2, W + 17)["tokens"]

    def on(where):
        return torch.from_numpy(toks).to("cpu" if where == "cpu" else dev)

    def held(a, b, what, tol=LM_CPU_TOL):
        err = (a.cpu() - b).abs()
        check(bool((err <= tol + tol * b.abs()).all()),
              f"reduced mistral-nemo {what}, card vs CPU, beyond {tol}: max "
              f"|err| {float(err.max()):.3e}")
        check(torch.equal(a.cpu().argmax(-1), b.argmax(-1)), f"reduced "
              f"mistral-nemo {what}: argmax differs between card and CPU")
        return float(err.max())

    # int8: the same weights under kv_cache_dtype="int8", 16 steps from
    # empty caches. The two sides quantise fp32 k and v that differ in the
    # last bits, so a value whose k / scale lies that near a half step
    # takes codes one apart: up to the first such slot the logits are held
    # at LM_CPU_TOL, from it on at the int8 cache's own bar (INT8_TOL)
    out = {}
    for where, m in models.items():
        m8 = _twin(m, kv_cache_dtype="int8")
        caches = init_caches(m8.cfg, 2, 16, device=m8.device)
        out[where] = [decode_step(m8, caches, token=on(where)[:, t],
                                  pos=t)[0] for t in range(16)]
        out[where + "_codes"] = torch.stack([caches["k"], caches["v"]]).to(
            "cpu", torch.int32)
    apart = (out["card_codes"] - out["cpu_codes"]).abs()
    check(int(apart.max()) <= 1, f"reduced mistral-nemo int8 codes, card vs "
          f"CPU, {int(apart.max())} apart")
    slots = apart.amax(dim=(0, 1, 2, 4, 5)).nonzero()
    first = int(slots[0]) if slots.numel() else 16
    err8 = max(held(a, b, f"int8-cache decode step {t}",
                    LM_CPU_TOL if t < first else INT8_TOL)
               for t, (a, b) in enumerate(zip(out["card"], out["cpu"])))
    codes = int(apart.sum())
    # the ring: generate past the wrap, then positions near 2^19
    gen = {w: generate(m, on(w)[:, :W - 4], 16, temperature=0.0,
                       window=True).cpu() for w, m in models.items()}
    check(torch.equal(gen["card"], gen["cpu"]), "reduced mistral-nemo window "
          "generate: tokens differ between card and CPU")
    # the rope tables there, card vs CPU in ulps of the fp32 angle (an
    # fp32 pow on each side: ROADMAP C), then the ring on the CPU's tables
    # on both devices
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    pos = torch.arange(LONG_500K_POS, LONG_500K_POS + 8)
    rope, inv_ulps = _rope_ulps(torch, pos, hd, theta, dev)
    check(rope <= 2 * inv_ulps + 1, f"rope tables at positions "
          f"{LONG_500K_POS:,}-{LONG_500K_POS + 7:,}, card vs CPU, {rope:.2f} "
          f"ulps of the fp32 angle apart, beyond the {2 * inv_ulps + 1:.0f} "
          f"that inverse frequencies {inv_ulps:.0f} ulps apart explain")
    cpu_tables = L.rope_cos_sin
    L.rope_cos_sin = lambda p, hd, th: tuple(
        t.to(p.device) for t in cpu_tables(p.cpu(), hd, th))
    far = {}
    try:
        for where, m in models.items():
            logits, caches = prefill(m, tokens=on(where)[:, :W])
            ring = fill_caches(init_caches(cfg, 2, W, dtype=torch.float32,
                                           device=m.device), caches)
            far[where] = [decode_step(m, ring, token=on(where)[:, W + i],
                                      pos=LONG_500K_POS + i, window=True)[0]
                          for i in range(8)]
    finally:
        L.rope_cos_sin = cpu_tables
    errw = max(held(a, b, f"window decode at position {LONG_500K_POS + i}")
               for i, (a, b) in enumerate(zip(far["card"], far["cpu"])))
    print(f"phase 41: reduced mistral-nemo (hd 128) with an int8 KV cache, "
          f"16 decode steps from empty caches: logits max |err| {err8:.3e} "
          f"(bar {LM_CPU_TOL} up to the first slot whose codes differ, "
          f"{first}, then {INT8_TOL}), argmax equal, {codes} of "
          f"{apart.numel()} k and v codes one apart; generate(window=True)"
          f" of 16 tokens after {W - 4} (the {W}-slot ring wraps) tokens "
          f"equal; a ring filled by a prefill of {W} tokens decoding at "
          f"positions {LONG_500K_POS:,}-{LONG_500K_POS + 7:,} on the CPU's "
          f"rope tables: logits max |err| {errw:.3e}, argmax equal; the "
          f"card's own tables there {rope:.2f} ulps of the fp32 angle from "
          f"the CPU's beyond 1e-6, its inverse frequencies (an fp32 pow on each side) "
          f"{inv_ulps:.0f} ulps from theirs (bar: 2 x that + 1)")
    print(f"phase 41 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ phase 42
# Mamba1 training at full width (phase 42): the widths above at
# SSM_TRAIN_LAYERS of the 64 layers, trainable in fp32, the train_4k shape
# with its batch cut from 256 to 4 (TRAIN_BATCH x LM_SEQ), lr 3e-5
SSM_TRAIN_SHORT = 512  # layer 0's scan inputs for the kernel-vs-plain gate
B7_BWD_BEFORE = (512, 1024)  # where the autograd plain backward is timed
B7_BWD_BEFORE_RUNS = 3  # its timed runs at each, after one warm-up run
B7_BWD_KERNELS = ("mamba1_scan_gated_bwd_kernel",)


def _scan_backward_bound(torch, args, dy):
    """Least time of the gated scan's backward: each input and dy read
    once and each input's gradient written once at the memory rate,
    against its SFU operations at the SFU rate: N + 5 a (b, s, channel)
    (da's N exponentials, softplus's exp and log, sigma(v)'s
    reciprocal, sigma(z)'s exp and reciprocal)."""
    x = args[2]
    B, S, di = x.shape
    N = args[3].shape[2]
    inputs = sum(t.numel() * t.element_size() for t in args
                 if t is not None)
    nbytes = 2 * inputs + dy.numel() * dy.element_size()
    ops = B * S * di * (N + 5)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SFU_EXP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def _ssm_train_times(torch, dev):
    """(c): the backward kernel at (TRAIN_BATCH, LM_SEQ, 8,192, 16) in
    bf16 and fp32 (the model's inputs: B and C slices of one projection,
    z half of another, no h0, no dhT) beside its bound; in bf16 also
    held against its plain version on those inputs at
    :func:`_check_b7_backward` 's bars, whose one run gives the plain
    version's ms. Then the autograd plain backward that it replaces,
    ``gated_scan_backward_plain``, at B7_BWD_BEFORE: one warm-up run,
    then the median ms of B7_BWD_BEFORE_RUNS and their peak memory above
    what was allocated before them, the kernel beside it. Returns (the
    rows, the bf16 4 x 4,096 one first; the sums' max |err| at 4 x
    4,096)."""
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.kernels.mamba_scan import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device=dev)
    di, N = 8192, 16
    rows, err = [], None
    for dtype in (torch.bfloat16, torch.float32):
        args = _b7_gated_inputs(torch, dev, gen, TRAIN_BATCH, LM_SEQ, di, N,
                                dtype, False, R=256)
        dy = torch.randn(args[2].shape, generator=gen, device=dev).to(dtype)
        bound_ms, bound_by, nbytes, nops = _scan_backward_bound(torch, args,
                                                                dy)
        row = {"mode": "backward", "b": TRAIN_BATCH, "s": LM_SEQ, "di": di,
               "n": N, "dtype": str(dtype)[6:],
               "ms": _time_ms(torch, lambda: ms.mamba1_scan_gated_backward(
                   *args, dy, None), flush, runs=10),
               "plain_ms": None, "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by}
        checked = "plain not run in fp32"
        if dtype == torch.bfloat16:  # the main path's shape, held
            err, share, row["plain_ms"] = _check_b7_backward(
                torch, args, dy, None, "the main path's shape "
                f"{(TRAIN_BATCH, LM_SEQ, di, N)} bf16")
            checked = (f"plain_gated_scan_backward {row['plain_ms']:.1f} ms "
                       "(one run); the kernel vs it: ddt_raw, dx, dz "
                       f"bitwise, the sums within {B7_SUM_REL} sum|terms| "
                       f"+ {B7_SUM_ABS} (max |err| {err:.3e}, worst "
                       f"{share:.3f} of the bar), 3 launches bitwise")
        rows.append(row)
        print(f"phase 42: B7 backward kernel (B, S, di, N) = "
              f"{(TRAIN_BATCH, LM_SEQ, di, N)} {row['dtype']}: "
              f"{row['ms']:.3f} ms (median of 10), bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e9:.3f} GB, {nops:.3e} SFU "
              f"operations; {bound_ms / row['ms']:.1%} of it reached); "
              f"{checked}; library n/a (no single PyTorch call)")
        del args, dy
    torch.cuda.empty_cache()
    for S in B7_BWD_BEFORE:
        args = _b7_gated_inputs(torch, dev, gen, TRAIN_BATCH, S, di, N,
                                torch.bfloat16, False, R=256)
        dy = torch.randn(args[2].shape, generator=gen,
                         device=dev).to(torch.bfloat16)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if S == B7_BWD_BEFORE[0]:  # the warm-up run
            ops.gated_scan_backward_plain(*args, dy, None)
        runs = [_time_ms(torch, lambda: ops.gated_scan_backward_plain(
            *args, dy, None), flush, 1, 0)
            for _ in range(B7_BWD_BEFORE_RUNS)]
        before_ms = float(np.median(runs))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        kernel_ms = _time_ms(torch, lambda: ms.mamba1_scan_gated_backward(
            *args, dy, None), flush, runs=10)
        rows.append({"mode": "backward", "b": TRAIN_BATCH, "s": S, "di": di,
                     "n": N, "dtype": "bfloat16", "ms": kernel_ms,
                     "plain_autograd_ms": before_ms,
                     "plain_autograd_runs_ms": runs,
                     "plain_autograd_peak_gb": peak})
        print(f"  before: gated_scan_backward_plain (autograd of the plain "
              f"scan's loop, recomputed) at (B, S) = ({TRAIN_BATCH}, {S}) "
              f"bf16: {before_ms:.1f} ms (median of "
              + ", ".join(f"{t:.1f}" for t in runs) + " after a warm-up "
              f"run at S = {B7_BWD_BEFORE[0]}), "
              f"{peak:.2f} GB of peak memory above the inputs; the kernel "
              f"{kernel_ms:.3f} ms ({before_ms / kernel_ms:,.0f}x)")
        del args, dy
    del flush
    return rows, err


def phase_ssm_train(torch, dev):
    """Mamba1 training at full width: falcon-mamba-7b's widths at
    SSM_TRAIN_LAYERS layers, trainable from a seeded torch.Generator, a 4
    x 4,096 batch from the token stream. (c) first, on the card alone:
    the backward kernel timed and held against its plain version at the
    main path's shape (:func:`_ssm_train_times`). (a) one loss_fn
    and backward: every gradient leaf finite and not all zero, B7's
    gated mode 2 x layers (forward and checkpointed recompute), its
    backward kernel once a layer, the contract mode and both plain
    backwards never; (b) layer 0's real scan inputs at 4 x
    SSM_SHORT, captured by a forward of the model, in bf16 (the model's
    own call: no h0, no dhT) and widened to fp32 with h0 and dhT:
    the kernel against plain_gated_scan_backward (:func:`_check_b7_backward`);
    (d) make_train_step at lr 3e-5: a warm-up step and 3 timed steps (ms,
    tokens/s, MFU, peak memory, both kernels' launches a step), the loss
    finite and falling at each of the three updates, then a profiled
    step: the backward kernel's share of its device time. Returns
    (launches {path: n} of the backward kernel and of B7's forward, the
    sums' max |err| at the main path's shape, the timing rows,
    metrics)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.mamba_scan import mamba_scan as ms
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.models import init_model, loss_fn, make_train_step
    from repro_torch.models import ssm

    t_phase = time.perf_counter()
    B7 = ms.LAUNCHES
    rows, err = _ssm_train_times(torch, dev)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              num_layers=SSM_TRAIN_LAYERS)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, trainable=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == SSM_PARAMS - (64 - layers) * SSM_LAYER_PARAMS and all(
        p.requires_grad and p.dtype == torch.float32
        for p in model.parameters()),
        f"{SSM_ARCH} at {layers} layers: {n_params:,} parameters, not "
        f"{SSM_PARAMS:,} less {64 - layers} whole layers, fp32 with a "
        "gradient")
    raw = TokenStream(cfg.vocab_size, seed=SEED).batch(TRAIN_BATCH,
                                                        LM_SEQ + 1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    tokens = TRAIN_BATCH * LM_SEQ

    # (a) the gradient gate
    plain_calls: list = []  # the plain versions' names, once a call
    wrapped = {name: _recording(ops, name,
                                lambda _, n=name: plain_calls.append(n))
               for name in ("gated_scan_backward_plain",
                            "plain_gated_scan_backward", "plain_gated_scan",
                            "plain_scan")}
    try:
        _reset((B7,))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _, grads = _loss_and_grads(torch, model, batch)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        peak_grad = torch.cuda.max_memory_allocated() / 1e9
        launches = dict(B7)
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
    want = {"mamba1_scan": 0, "mamba1_scan_gated": 2 * layers,
            "mamba1_scan_gated_backward": layers}
    check(launches == want and not plain_calls,
          f"phase 42: launches {launches} in a loss_fn and backward, not "
          f"{want}, or a plain version ran on the card: "
          f"{sorted(set(plain_calls))}")
    bad = [n for n, g in grads.items()
           if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    check(not bad, f"phase 42: gradient leaves not finite or all zero: "
          f"{bad[:8]}")
    scan_leaves = [n for n in grads if re.search(
        r"\.(A_log|D|dt_bias|dt_proj|x_proj)$", n)]
    check(len(scan_leaves) == 5 * layers,
          f"{len(scan_leaves)} A_log/D/dt_bias/dt_proj/x_proj leaves, not "
          f"{5 * layers}")
    norms = {n: float(grads[n].norm()) for n in scan_leaves}
    print(f"phase 42: {SSM_ARCH} trainable at full width, {layers} of 64 "
          f"layers ({n_params:,} fp32 parameters, built in {setup_s:.2f} "
          f"s), batch {TRAIN_BATCH} x {LM_SEQ}: loss_fn + backward "
          f"{grad_s:.2f} s, loss {float(loss):.6f}, peak {peak_grad:.2f} GB;"
          f" B7 gated {launches['mamba1_scan_gated']} ({layers} forward, "
          f"{layers} in the checkpointed recompute), B7's backward kernel "
          f"{launches['mamba1_scan_gated_backward']}, contract mode 0, no "
          f"plain version; all {len(grads)} gradient leaves finite and "
          f"nonzero (the scan's own leaves' norms "
          f"{min(norms.values()):.3e}..{max(norms.values()):.3e})")
    del grads, loss

    # (b) layer 0's real scan inputs, the kernel against plain
    short = {k: v[:, :SSM_TRAIN_SHORT] for k, v in batch.items()}
    seen, scan = [], ssm.ops.gated_selective_scan

    def keep_first(*args):
        if not seen:
            seen.append(tuple(None if a is None else a.detach().clone()
                              for a in args))
        return scan(*args)

    ssm.ops.gated_selective_scan = keep_first
    try:
        with torch.no_grad():
            loss_fn(model, short)
    finally:
        ssm.ops.gated_selective_scan = scan
    args = list(seen[0])
    gen = torch.Generator(device=dev).manual_seed(SEED + 142)
    check(args[2].dtype == torch.bfloat16 and args[8] is None
          and args[2].shape == (TRAIN_BATCH, SSM_TRAIN_SHORT, cfg.d_inner),
          f"phase 42: layer 0's scan inputs {args[2].dtype} "
          f"{tuple(args[2].shape)}, h0 {args[8] is not None}")
    x, N = args[2], args[3].shape[2]
    dy = torch.randn(x.shape, generator=gen, device=dev)
    h0 = torch.randn((x.shape[0], x.shape[2], N), generator=gen, device=dev)
    dh = torch.randn(h0.shape, generator=gen, device=dev)
    wide = [None if a is None else a.float() for a in args]
    wide[8] = h0
    lines = []
    for tag, case, g_y, g_h in (
            ("bf16, no h0 or dhT (the model's call)", args,
             dy.to(torch.bfloat16), None),
            ("bf16 with h0 and dhT", args[:8] + [h0], dy.to(torch.bfloat16),
             dh),
            ("fp32 with h0 and dhT", wide, dy, dh),
            ("fp32, no h0 or dhT", wide[:8] + [None], dy, None)):
        e, share, _ = _check_b7_backward(torch, case, g_y, g_h,
                                         f"layer 0's scan inputs, {tag}")
        lines.append(f"{tag}: max |err| {e:.3e} ({share:.3f} of the bar)")
    print(f"  B7's backward kernel vs plain_gated_scan_backward on layer "
          f"0's scan inputs at (B, S, di, N) = {tuple(x.shape) + (N,)}: "
          f"ddt_raw, dx, dz (and dh0) bitwise, the sums within "
          f"{B7_SUM_REL} sum|terms| + {B7_SUM_ABS}, 3 launches bitwise; "
          + "; ".join(lines))
    del seen, args, wide, case, dy, h0, dh

    # (d) the train step
    opt, step = make_train_step(model, lr=PROBE_LR)
    state = opt.init(dict(model.named_parameters()))
    state, warm = step(state, batch)
    losses, secs, counts = [float(warm["loss"])], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        _reset((B7,))
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        counts.append((B7["mamba1_scan_gated"],
                       B7["mamba1_scan_gated_backward"]))
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and all(
        b < a for a, b in zip(losses, losses[1:])),
        f"phase 42: at lr {PROBE_LR} the loss is not finite or did not "
        f"fall at each update: {losses}")
    check(all(c == (2 * layers, layers) for c in counts),
          f"phase 42: B7 (forward, backward) launches a step {counts}, not "
          f"{(2 * layers, layers)}")
    step_s = float(np.mean(secs))
    flops = 6 * n_params * tokens
    mfu = flops / step_s / BF16_OPS_PER_S
    (state, _), wall_us, kernels = _device_profile(
        torch, lambda: step(state, batch))
    busy_us = sum(v[0] for v in kernels.values())
    split = {"B7 backward": 0.0, "B7 forward": 0.0, "GEMMs": 0.0,
             "the rest": 0.0}
    for name, (us, _) in kernels.items():
        key = ("B7 backward" if any(k in name for k in B7_BWD_KERNELS) else
               "B7 forward" if any(k in name for k in SSM_KERNELS) else
               "GEMMs" if _is_gemm(name) else "the rest")
        split[key] += us
    print(f"  train step (make_train_step, lr {PROBE_LR}): loss "
          + " -> ".join(f"{x:.6f}" for x in losses) + " (warm-up step, then "
          f"{TRAIN_STEPS} timed: falls at each update); "
          f"{step_s * 1e3:.1f} ms a step (" + ", ".join(
              f"{t * 1e3:.1f}" for t in secs) + f"), {tokens / step_s:,.0f} "
          f"tokens/s, MFU {mfu:.2%} (6 N T = {flops:.4e} FLOP a step over "
          f"{BF16_OPS_PER_S:.3g} FLOP/s dense bf16), peak memory "
          f"{peak_train:.2f} GB; a step launches B7 gated {counts[0][0]} "
          f"and its backward kernel {counts[0][1]}")
    _print_profile("a Mamba1 train step", wall_us, kernels,
                   B7_BWD_KERNELS + SSM_KERNELS, "B7 + its backward")
    if busy_us:
        print("  a Mamba1 train step's device time: " + "; ".join(
            f"{k} {us / 1e3:.1f} ms ({us / busy_us:.1%})"
            for k, us in split.items()))
        _print_elementwise(kernels, B7_BWD_KERNELS + SSM_KERNELS)
    del model, state, opt, step
    torch.cuda.empty_cache()
    print(f"phase 42 took {time.perf_counter() - t_phase:.1f} s")
    paths = {"backward": {"lm_train_ssm": launches[
        "mamba1_scan_gated_backward"], "lm_train_ssm/step": counts[0][1]},
        "forward": {"lm_train_ssm": launches["mamba1_scan_gated"],
                    "lm_train_ssm/step": counts[0][0]}}
    return paths, err, rows, {
        "layers": layers, "params": n_params, "ms_per_step": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "mfu": mfu, "flop_per_step": flops,
        "peak_gb": peak_train, "peak_gb_gradient": peak_grad,
        "losses": losses, "launches_per_step": {
            "mamba1_scan_gated": counts[0][0],
            "mamba1_scan_gated_backward": counts[0][1]},
        "device_split_ms": {k: v / 1e3 for k, v in split.items()},
        "backward_share": split["B7 backward"] / busy_us if busy_us else
        None}


SERVE_PHASES = (2, 3, 4)  # the serving path's phases, runnable alone
TRAIN_PHASES = (5, 6, 7, 8)  # the sparse training path's, runnable alone
SCAN_PHASES = (17, 18, 19, 20)  # the SSM path's phases, runnable alone
FAMILY_PHASES = (21, 22, 23, 24)  # the hybrid and MoE paths', likewise
STREAM_PHASES = (25, 26, 27)  # the streaming path's, likewise
LM_TRAIN_PHASES = (28, 29)  # the LM training path's, likewise
TUNE_PHASES = (30, 31)  # the autotune sweep and the tuning flags, likewise
SHARD_PHASES = (32, 33)  # sharded training at paper width, the drivers
SHARD_SERVE_PHASES = (34, 35)  # sharded LM serving, full width and reduced
SHARD_TRAIN_PHASES = (36, 37)  # sharded LM training, full width and reduced
DRYRUN_PHASES = (38,)  # the dry run, alone with the phases it is held to
ZOO_PHASES = (39, 40, 41)  # the zoo's configs and decode variants, likewise
SSM_TRAIN_PHASES = (42,)  # Mamba1 training at full width, likewise
DRYRUN_NEEDS = {18, 28, 36, 42}


def _serving_model(torch, dev):
    """Phases 2 and 4's model: a random d = 1,000,000 Theta with every row
    alive, padded (d+1, 2m) on the card, and its int8 codes and scales."""
    from repro_torch.serve.compress import compress, quantize

    rng = np.random.default_rng(SEED + 3)
    theta_np = (rng.normal(size=(D_FEATURES, 2 * REGIONS)) * 0.3).astype(
        np.float32)
    art = compress(theta_np)  # every row alive: (d+1, 2m) with the pad row
    q = quantize(art)
    return art.theta.to(dev), q.codes.to(dev), q.scales.to(dev)


def _sparse_problem(torch, dev):
    """The training driver's batch, Theta0 and optimizer at its launch
    defaults (batch seed --seed + 1, test batch --seed + 2), the test
    batch, and the seconds they took."""
    from repro_torch.launch.train import sparse_problem, sparse_test_batch

    t0 = time.perf_counter()
    problem = sparse_problem(D_FEATURES, REGIONS, SESSIONS, lam=LAM,
                             beta=BETA, seed=SEED, batch_seed=SEED + 1,
                             device=dev)
    test = sparse_test_batch(D_FEATURES, SESSIONS, seed=SEED + 2, device=dev)
    torch.cuda.synchronize()
    return problem, test, time.perf_counter() - t0


def _in_tmp(phase, torch, dev):
    """``phase(torch, dev, tmp)`` with a temporary directory of its own."""
    with tempfile.TemporaryDirectory() as tmp:
        return phase(torch, dev, Path(tmp))


def _run_only(torch, dev, only, t_start) -> int:
    """Phase 1 and the given serving (2-4), sparse training (5-8), SSM
    (17-20), hybrid or MoE (21-24), streaming (25-27), LM training
    (28-29), autotuning (30-31), sharded training (32-33), sharded LM
    serving (34-35), sharded LM training (36-37), zoo (39-41) or Mamba1
    training (42) phases alone, or the dry run (38, run last) with the
    phases it is held to (18, 28, 36, 42) (``--only``): a partial run,
    so it prints no kernels line and no result line."""
    got = {}  # what phase 38 holds the dry run to
    if 38 in only and not DRYRUN_NEEDS <= only:
        raise SmokeFailure(f"--only 38 needs phases {sorted(DRYRUN_NEEDS)} "
                           "beside it")
    if only & {2, 4}:
        model = _serving_model(torch, dev)
    if only & set(TRAIN_PHASES):
        problem, test, setup_s = _sparse_problem(torch, dev)
        train, theta0, _ = problem
    for phase in sorted(only, key=lambda p: (p == 38, p)):
        if phase == 2:
            phase_kernels(torch, dev, *model)
        elif phase == 3:
            with tempfile.TemporaryDirectory() as tmp:
                phase_main_path(torch, Path(tmp))
        elif phase == 4:
            phase_times(torch, dev, *model)
        elif phase == 5:
            phase_training_kernels(torch, dev, train, test, theta0)
        elif phase == 6:
            with tempfile.TemporaryDirectory() as tmp:
                phase_training(torch, dev, problem, test, setup_s, Path(tmp))
        elif phase == 7:
            phase_trajectory(torch, dev, problem)
        elif phase == 8:
            phase_training_times(torch, dev, train, theta0)
        elif phase == 17:
            phase_scan_kernel(torch, dev)
        elif phase == 18:
            got[18] = phase_ssm_lm(torch, dev)
        elif phase == 19:
            phase_lm_card_vs_cpu(torch, dev, SSM_ARCH, 19, "B7")
        elif phase == 20:
            phase_scan_times(torch, dev)
        elif phase == 21:
            phase_hybrid_lm(torch, dev)
        elif phase == 22:
            phase_lm_card_vs_cpu(torch, dev, HYBRID_ARCH, 22, **HYBRID_CPU)
        elif phase == 23:
            phase_moe_lm(torch, dev)
        elif phase == 24:
            phase_moe_card_vs_cpu(torch, dev)
        elif phase == 25:
            with tempfile.TemporaryDirectory() as tmp:
                phase_stream(torch, dev, Path(tmp))
        elif phase == 26:
            with tempfile.TemporaryDirectory() as tmp:
                phase_stream_gates(torch, dev, Path(tmp))
        elif phase == 27:
            phase_card_tests()
        elif phase == 28:
            got[28] = phase_lm_train(torch, dev)
        elif phase == 29:
            phase_lm_train_card_vs_cpu(torch, dev)
        elif phase == 30:
            phase_tune_sweep(torch, dev)
        elif phase == 31:
            with tempfile.TemporaryDirectory() as tmp:
                phase_tune_drivers(torch, dev, Path(tmp))
        elif phase == 32:
            phase_shard(torch, dev)
        elif phase == 33:
            with tempfile.TemporaryDirectory() as tmp:
                phase_shard_drivers(torch, dev, Path(tmp))
        elif phase == 34:
            phase_serve_shard(torch, dev)
        elif phase == 35:
            phase_serve_shard_reduced(torch, dev)
        elif phase == 36:
            got[36] = phase_train_shard(torch, dev)
        elif phase == 37:
            phase_train_shard_reduced(torch, dev)
        elif phase == 39:
            phase_zoo_lm(torch, dev)
        elif phase == 40:
            phase_decode_variants(torch, dev)
        elif phase == 41:
            phase_zoo_card_vs_cpu(torch, dev)
        elif phase == 42:
            got[42] = phase_ssm_train(torch, dev)
        else:
            (train_b6, train_metrics), ssm, shard = got[28], got[18], got[36]
            phase_dryrun(torch, dev, start_dryrun(), train_metrics,
                         train_b6, ssm[3], ssm[1], shard[2], got[42][3])
        # the next phase gets the card as the whole script leaves it
        torch.cuda.empty_cache()
    print(f"phases 1 and {sorted(only)} passed in "
          f"{time.perf_counter() - t_start:.1f} s (partial run: no result)")
    return 0


def main(argv: list[str]) -> int:
    """``chip_smoke.py`` runs every phase; ``chip_smoke.py --only 2,3,4``
    (or ``5,6,8``, or ``17,20``, or ``21,22,23,24``, or ``25,26,27``, or
    ``28,29``, or ``30,31``, or ``32,33``, or ``34,35``, or ``36,37``, or
    ``18,28,36,42,38``, or ``39,40,41``, or ``42``) runs phase 1 and
    the named phases of the serving path (2-4), the sparse training path
    (5-8), the SSM path (17-20), the hybrid and MoE paths (21-24), the
    streaming path (25-27), the LM training path (28-29), the autotuning
    path (30-31), the sharded training path (32-33), the sharded LM
    serving path (34-35), the sharded LM training path (36-37), the
    zoo's other configs and the decode variants (39-41) or the Mamba1
    training path (42) alone, or the dry run (38) beside the phases it
    is held to."""
    import torch

    only = set()
    alone = (SERVE_PHASES + TRAIN_PHASES + SCAN_PHASES + FAMILY_PHASES
             + STREAM_PHASES + LM_TRAIN_PHASES + TUNE_PHASES + SHARD_PHASES
             + SHARD_SERVE_PHASES + SHARD_TRAIN_PHASES + DRYRUN_PHASES
             + ZOO_PHASES + SSM_TRAIN_PHASES)
    if argv:
        if len(argv) != 2 or argv[0] != "--only":
            raise SmokeFailure(f"usage: chip_smoke.py [--only "
                               f"{','.join(map(str, alone))}]")
        only = {int(p) for p in argv[1].split(",")}
        if not only <= set(alone):
            raise SmokeFailure(f"--only takes phases of {alone}")

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.device import resolve_device
    except ImportError as e:
        raise SmokeFailure(f"the port is not beside this script: {e}") from e
    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    phase_device(torch)
    if only:
        return _run_only(torch, dev, only, t_start)

    theta, codes, scales = _serving_model(torch, dev)
    err, _ = phase_kernels(torch, dev, theta, codes, scales)
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, _, _ = phase_main_path(torch, Path(tmp))
    times = phase_times(torch, dev, theta, codes, scales)
    del theta, codes, scales

    problem, test, setup_s = _sparse_problem(torch, dev)
    train, theta0, _ = problem
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

    hybrid_launches, hybrid_err, hybrid_metrics = phase_hybrid_lm(torch, dev)
    phase_lm_card_vs_cpu(torch, dev, HYBRID_ARCH, 22, **HYBRID_CPU)
    moe_launches, moe_err, moe_metrics = phase_moe_lm(torch, dev)
    phase_moe_card_vs_cpu(torch, dev)
    zoo_launches, zoo_err, zoo_metrics, zoo_times = phase_zoo_lm(torch, dev)
    times["flash_attention"] += zoo_times
    variant_launches, variant_metrics = phase_decode_variants(torch, dev)
    phase_zoo_card_vs_cpu(torch, dev)
    err["flash_attention"] = max(err["flash_attention"], hybrid_err,
                                 moe_err, zoo_err)

    with tempfile.TemporaryDirectory() as tmp:
        stream_launches, stream_err = phase_stream(torch, dev, Path(tmp))
    for name, e in stream_err.items():
        err[name] = max(err[name], e)
    with tempfile.TemporaryDirectory() as tmp:
        monitored_launches = phase_stream_gates(torch, dev, Path(tmp))
    # phase 38's trace runs on the host alone, in a process of its own,
    # beside the device-bound training steps of phases 28, 29 and 42 (the
    # script's budget, A19)
    dry = start_dryrun()
    train_b6, train_metrics = phase_lm_train(torch, dev)
    train_cpu_launches = phase_lm_train_card_vs_cpu(torch, dev)
    ssm_train_paths, err["mamba1_scan_gated_backward"], \
        times["mamba1_scan_gated_backward"], ssm_train_metrics = \
        phase_ssm_train(torch, dev)
    phase_tune_sweep(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_tune_drivers(torch, dev, Path(tmp))
    sharded_launches, shard_err = phase_shard(torch, dev)
    for name, e in shard_err.items():
        err[name] = max(err[name], e)
    serve_sharded, serve_sharded_err = phase_serve_shard(torch, dev)
    for name, e in serve_sharded_err.items():
        err[name] = max(err[name], e)
    train_shard_b6, train_shard_err, shard_steps = phase_train_shard(torch,
                                                                     dev)
    err["flash_attention"] = max(err["flash_attention"], train_shard_err)
    # the phases whose numbers are gates, not times, run at once after
    # every timed one: the card tests (phase 27, a pytest process of their
    # own), the sharded drivers against their unsharded runs (phase 33),
    # the reduced sharded serving and training checks (phases 35, 37) and
    # the end of the dry run's trace (phase 38's process, on the host
    # alone, started before phase 28); phase 38's gates and its timing of
    # the operator binding follow them
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(phase_card_tests),
                pool.submit(_in_tmp, phase_shard_drivers, torch, dev),
                pool.submit(phase_serve_shard_reduced, torch, dev),
                pool.submit(phase_train_shard_reduced, torch, dev)]
        train_shard_reduced = [job.result() for job in jobs][-1]
    dry_recs, op_overhead = phase_dryrun(
        torch, dev, dry, train_metrics, train_b6, ssm_metrics, ssm_launches,
        shard_steps, ssm_train_metrics)

    kernels = []
    for name in ("lsplm_sparse_fused_forward",
                 "lsplm_sparse_fused_int8_forward",
                 "lsplm_sparse_scatter", "owlqn_direction",
                 "lsplm_fused_forward", "flash_attention", "mamba1_scan",
                 "mamba1_scan_gated_backward"):
        main_shape, *others = times[name]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train_launches.get(name, 0),
                   "dense_train": dense_launches["dense_train"].get(name, 0)}
        if name in stream_launches:
            by_path["stream_train"] = stream_launches[name]
        if name in monitored_launches:
            by_path["serve_monitored"] = monitored_launches[name]
        if name in sharded_launches:
            by_path["train_sharded"] = sharded_launches[name]
        if name == "lsplm_fused_forward":
            by_path["dense_serve"] = dense_launches["dense_serve"]
        if name == "flash_attention":
            by_path = {"lm_serve": lm_total, **{
                f"lm_serve/{step}": n for step, n in lm_launches.items()}}
            for path, runs in (("lm_serve_hybrid", hybrid_launches),
                               ("lm_serve_moe", moe_launches)):
                by_path[path] = sum(runs.values())
                by_path.update({f"{path}/{step}": n
                                for step, n in runs.items()})
            for arch, runs in zoo_launches.items():
                by_path[f"lm_serve_zoo/{arch}"] = sum(runs.values())
                by_path.update({f"lm_serve_zoo/{arch}/{step}": n
                                for step, n in runs.items()})
            by_path.update(variant_launches)
            by_path["lm_train/step"] = train_b6
            by_path.update({f"lm_train_reduced/{arch}": n["B6"]
                            for arch, n in train_cpu_launches.items()
                            if n["B6"]})
            by_path["serve_sharded"] = sum(serve_sharded[name].values())
            by_path.update(serve_sharded[name])
            by_path["train_shard"] = train_shard_b6
            by_path["train_shard_reduced"] = train_shard_reduced["B6"]
        if name == "mamba1_scan":
            by_path = {"lm_serve_ssm": ssm_total, **{
                f"lm_serve_ssm/{step}": n
                for step, n in ssm_launches.items()}}
            by_path.update({f"lm_train_reduced/{arch}": n["B7"]
                            for arch, n in train_cpu_launches.items()
                            if n["B7"]})
            by_path["serve_sharded"] = sum(serve_sharded[name].values())
            by_path.update(serve_sharded[name])
            by_path.update(ssm_train_paths["forward"])
            # B7 trains sharded at reduced width only (phase 37):
            # falcon-mamba's full width needs ~116 GB on one card
            by_path["train_shard_reduced"] = train_shard_reduced["B7"]
        if name == "mamba1_scan_gated_backward":
            by_path = dict(ssm_train_paths["backward"])
            by_path.update({f"lm_train_reduced/{arch}": n["B7_bwd"]
                            for arch, n in train_cpu_launches.items()
                            if n["B7_bwd"]})
            by_path["train_shard_reduced"] = train_shard_reduced["B7_bwd"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": next((by_path[path] for path in (
                "lm_serve_ssm", "lm_train_ssm", "lm_serve", "train",
                "serve", "dense_train")
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
    print(f"hybrid serving ({HYBRID_ARCH}): " + json.dumps(hybrid_metrics))
    print(f"MoE serving ({MOE_ARCH}): " + json.dumps(moe_metrics))
    print("zoo serving: " + json.dumps(zoo_metrics))
    print(f"decode variants ({LM_ARCH}): " + json.dumps(variant_metrics))
    print(f"LM training ({LM_ARCH}): " + json.dumps(train_metrics))
    print(f"Mamba1 training ({SSM_ARCH}, {SSM_TRAIN_LAYERS} layers): "
          + json.dumps(ssm_train_metrics))
    print("dry run (predictions from fake tensors): " + json.dumps(
        {k: {"peak_gb": r["memory"]["total_bytes_per_chip"] / 1e9,
             "flops": r["roofline"]["flops_per_chip"],
             "kernel_calls": r["kernel_calls"],
             "collectives": r["collectives_by_axis"]}
         for k, r in dry_recs.items()}) + "; operator binding us a call "
        "(op, bare): " + json.dumps(op_overhead))
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
    finally:
        _stop_children()
