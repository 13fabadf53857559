"""Dry run of the paper's own production job: one Algorithm-1 iteration
of LS-PLM on the single (16 x 16) and multi (32 x 16) meshes.

The port's counterpart of ``repro/launch/dryrun_lsplm.py``, on its
sizes: d = 2^19 features (12.6M parameters at m = 12), d_common = 2^18,
a common-feature batch of 2^14 samples over 2^12 sessions, and its four
variants (``baseline``: fp32 features, L-BFGS memory 10;
``bf16_features``; ``bf16+m5_history``: also memory 5;
``cf8_sessions``: 2^11 sessions, 8 samples each)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun_lsplm [--mesh single|multi|both|DxM] [--variant v] [--out f.json]

As ``launch/dryrun.py`` does for the LM zoo, it runs the step itself on
tensors without storage, on one rank of a ``"fake"`` world: the rank's
block of the batch (``dist.shard_batch``, cut on the host from a batch
whose feature matrices are stride-0 views of one zero, then made fake on
the traced device) and of the optimizer state (``dist.shard_state``),
the sharded common-feature objective (``dist.make_sharded_dense_loss``)
and B3 (``core.direction``) on the card. The rank traced is the last of
data block 0 (model rank ``model - 1``): the port cuts Theta's rows into
id ranges and a batch's columns with them, so the ranks of the upper
ranges hold the per-sample (non-common) columns, the largest blocks.

Algorithm 1's line search loops until a trial is accepted, and a fake
tensor has no value to accept one by; so the iteration is composed
explicitly from ``OWLQNPlus.step``'s parts, with its line search cut to
one trial: the loss and gradient, the Eq. 9 direction (B3), the two-loop
over a full history (every slot valid), the orthant projections, the
norms, one trial's loss and regulariser, and the non-zero count; the
history push (its branch reads y.s on the host) is left out. It is
reported as one iteration with one line-search trial, as the reference
reports its body counted once. ``OWLQNPlus`` itself is unchanged. The
figures are predictions from fake tensors with the NVIDIA H100 80GB HBM3
constants at 700 W (``launch/mesh.py``), not measurements.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.direction import (
    choose_orthant,
    descent_direction,
    project_orthant,
)
from repro_torch.core.objective import CommonFeatureBatch
from repro_torch.dist import make_sharded_dense_loss, shard_batch, shard_state
from repro_torch.launch.dryrun import (
    GB,
    fake_like,
    fake_world,
    memory_record,
    mesh_shape,
)
from repro_torch.optim import lbfgs
from repro_torch.optim.owlqn_plus import OWLQNPlus, reg_value
from repro_torch.utils import collectives
from repro_torch.utils.memtrack import MemTracker
from repro_torch.utils.roofline import Roofline

D_FEATURES = 2**19
D_COMMON = 2**18
M_REGIONS = 12
BATCH = 2**14
SESSIONS = 2**12
VARIANTS = ("baseline", "bf16_features", "bf16+m5_history", "cf8_sessions")
LAM = BETA = 1.0


def _host_batch(variant: str, d: int, d_common: int, batch: int,
                sessions: int) -> CommonFeatureBatch:
    """The variant's batch on the host: real session ids (each session's
    samples side by side), labels and weights; feature matrices that are
    stride-0 views of one zero (no memory until a block is cut)."""
    feat = torch.bfloat16 if "bf16" in variant else torch.float32
    if variant == "cf8_sessions":
        sessions //= 2
    zero = torch.zeros((), dtype=feat)
    return CommonFeatureBatch(
        x_common=zero.expand(sessions, d_common),
        x_noncommon=zero.expand(batch, d - d_common),
        session_id=torch.arange(batch, dtype=torch.int32) // (
            batch // sessions),
        y=torch.zeros(batch), weight=torch.ones(batch))


def trace_iteration(mesh, variant: str = "baseline", device="cuda",
                    d: int = D_FEATURES, d_common: int = D_COMMON,
                    m: int = M_REGIONS, batch: int = BATCH,
                    sessions: int = SESSIONS) -> dict:
    """One iteration on this rank of ``mesh`` (a :func:`fake_world` 's),
    traced under ``FakeTensorMode`` on ``device`` (the module
    docstring): ``{"flops", "hbm_bytes", "calls", "argument_bytes",
    "peak", "collectives", "by_axis", "seconds"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    memory = 5 if "m5" in variant else 10
    device = torch.device(device)
    host = shard_batch(mesh, _host_batch(variant, d, d_common, batch,
                                         sessions), common_feature=True)
    t0 = time.perf_counter()
    with FakeTensorMode():
        opt0 = OWLQNPlus(lambda t: (t.sum(), t), LAM, BETA, memory=memory)
        whole = opt0.init(torch.empty((d, 2 * m), device=device))
        with MemTracker(device.type) as mem:
            state = shard_state(whole, mesh)
            del whole
            h = state.history
            h.valid, h.newest = [True] * memory, memory - 1  # a full history
            mem.tag(state.theta, "parameters")
            mem.tag([h.s, h.y, h.rho, h.gamma, state.prev_theta,
                     state.prev_d], "optimizer_state")
            block = CommonFeatureBatch(*(
                None if t is None else fake_like(t, device) for t in host))
            mem.tag(list(block), "inputs")
            loss_and_grad, loss_fn = make_sharded_dense_loss(
                block, mesh, common_feature=True)
            red = mesh.sum_model
            argument = mem.live_bytes()
            mesh.reset_counts()
            with mem.counting(), torch.no_grad():
                theta = state.theta
                loss, grad = loss_and_grad(theta)
                mem.tag(grad, "gradients")
                f0 = loss + red(reg_value(theta, LAM, BETA))
                d_ = descent_direction(theta, grad, LAM, BETA)  # B3
                p = project_orthant(lbfgs.two_loop(h, d_, red), d_)
                p_norm2, d_norm2 = red(torch.stack([lbfgs.vdot(p, p),
                                                    lbfgs.vdot(d_, d_)]))
                xi = choose_orthant(theta, d_)
                theta_t = project_orthant(torch.add(theta, p, alpha=1.0), xi)
                reg_t, gain = red(torch.stack([
                    reg_value(theta_t, LAM, BETA),
                    -lbfgs.vdot(d_, theta_t - theta)]))
                f_t = loss_fn(theta_t) + reg_t
                nnz = red(torch.count_nonzero(theta_t))
                del f0, p_norm2, d_norm2, gain, f_t, nnz
    return {"flops": float(mem.flops), "hbm_bytes": float(mem.hbm_bytes),
            "calls": dict(mem.calls), "argument_bytes": argument,
            "peak": mem.peak(),
            "collectives": collectives.collective_bytes(mesh),
            "by_axis": collectives.by_axis(mesh),
            "seconds": time.perf_counter() - t0}


def run(mesh_name: str, variant: str = "baseline", device="cuda",
        verbose: bool = True) -> dict:
    """The record of one (mesh, variant): the reference's keys, plus the
    memory's categories, the collectives by axis and B3's calls."""
    data, model = mesh_shape(mesh_name)
    chips = data * model
    with fake_world(data, model, rank=model - 1) as mesh:
        tr = trace_iteration(mesh, variant, device, D_FEATURES, D_COMMON,
                             M_REGIONS, BATCH, SESSIONS)
    params = D_FEATURES * 2 * M_REGIONS
    # the reference's useful FLOPs: LS-PLM's forward and backward, 6 x
    # 2m x the rows' features, common rows once per session
    eff_rows = SESSIONS * D_COMMON + BATCH * (D_FEATURES - D_COMMON)
    rl = Roofline(flops=tr["flops"], hbm_bytes=tr["hbm_bytes"],
                  coll_bytes=float(tr["collectives"]["total_bytes"]),
                  model_flops=6.0 * 2 * M_REGIONS * eff_rows / chips)
    rec = {
        "arch": "lsplm-production", "shape": "ctr_iteration",
        "mesh": mesh_name, "mesh_shape": [data, model], "variant": variant,
        "chips": chips, "params": params, "rank": model - 1,
        "line_search_trials": 1,
        "trace_seconds": round(tr["seconds"], 1),
        "memory": memory_record(tr["argument_bytes"], tr["peak"]),
        "collectives": tr["collectives"],
        "collectives_by_axis": tr["by_axis"],
        "kernel_calls": tr["calls"],
        "roofline": rl.to_dict(),
    }
    if verbose:
        r = rec["roofline"]
        print(f"[OK] lsplm-production {mesh_name} [{variant}]: "
              f"params={params / 1e6:.1f}M "
              f"mem/chip={tr['peak']['peak_bytes'] / GB:.3f}GB "
              f"flops={r['flops_per_chip']:.3e} "
              f"t_comp={r['t_compute_s']:.3e} t_mem={r['t_memory_s']:.3e} "
              f"t_coll={r['t_collective_s']:.3e} bound={r['bottleneck']} "
              f"B3={tr['calls'].get('owlqn_direction', 0)}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default="both",
                    help="single, multi, both or DxM")
    ap.add_argument("--variant", default="all",
                    choices=("all",) + VARIANTS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    recs = [run(m, v, args.device) for m in meshes for v in variants]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
