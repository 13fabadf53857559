"""Multi-rank dry run: prove every (architecture x input shape) builds
and runs on the production meshes without allocating anything, and
extract per-rank memory, FLOPs, HBM bytes and collectives into a
roofline with the H100's constants.

The port's counterpart of ``repro/launch/dryrun.py``::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out results.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 2x2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table results.json

The reference jits each combo with explicit shardings, lowers and
compiles it on ``ShapeDtypeStruct`` s and reads XLA's memory and cost
analyses and the compiled HLO. PyTorch has no compiled program to read,
so the port runs the step itself, eagerly, on tensors without storage
(:func:`trace_combo`):

  * the world is ``torch.distributed``'s ``"fake"`` backend with this
    process as rank 0 of the mesh's world: each collective returns at
    once, and the :class:`~repro_torch.launch.mesh.Mesh` counts what it
    issues (``utils/collectives.py``);
  * under ``FakeTensorMode`` the model is built on the traced device in
    the blocks ``models/sharding.py`` gives rank 0 (``param_specs``
    whole for training, ``serving_spec`` for serving), and one step of
    the kind the shape names runs: ``make_train_step`` with its AdamW
    state, ``prefill``, or ``decode_step`` on ``init_caches`` at
    ``decode_cache_len`` (on the sliding window where
    ``uses_sliding_window`` says so);
  * the build and the step run under ``utils/memtrack.py`` 's
    :class:`~repro_torch.utils.memtrack.MemTracker`: live storages by
    category and their peak, and over the step the FLOPs (the formulas
    ``FlopCounterMode`` adds up), the HBM bytes and the calls of B3, B6,
    B7 and B7's backward kernel (whose operators' fakes, FLOP formulas
    and byte counts are in ``kernels/_ops.py``).

The traced device is ``cuda`` (the card's paths: B6 and B7 as traced
operators) unless ``--device cpu`` is asked for. A torch built without
CUDA can make a fake CUDA tensor but cannot index or differentiate one,
so a machine without a card traces the CPU's paths (the plain versions,
which compute every score of attention's S x S square) at CPU-test
sizes; the figures of record come from the card machine's torch.

The meshes: ``single`` 16 x 16 (256 ranks), ``multi`` 32 x 16 (512: the
reference's (2, 16, 16) with the pod folded into ``data``, as its
``data_axes`` does) and ``DxM`` (``1x1``, ``2x2``, ``1x4``: the card
counts of a benchmark cell). Where the KV heads (or the heads) do not
divide by ``model``, the trace takes ``attn_shard="head_dim"``: the
reference's ``cache_specs`` cuts head_dim there, and the port's
``"heads"`` layout refuses such a mesh (``sharding.check_mesh``). A batch
of one row (``long_500k``) is not split over ``data``, as the reference's
decode does not split it.

Not ported: the reference's depth probes and scan corrections
(``extrapolated_costs``, ``_ssm_scan_corrections``) and so its
``--no-probes``. They exist because XLA's cost analysis counts a loop
body once; the eager trace runs every layer, attention chunk and scan
step and counts each, so there is nothing to extrapolate. Every figure
is a prediction from fake tensors and the constants of the NVIDIA H100
80GB HBM3 at 700 W (``launch/mesh.py``), not a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed

import torch
import torch.distributed as dist

from repro_torch.configs import (
    INPUT_SHAPES,
    decode_cache_len,
    get_config,
    input_specs,
    list_archs,
    uses_sliding_window,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as SH
from repro_torch.models.transformer import (
    Transformer,
    decode_step,
    init_caches,
    make_train_step,
    prefill,
)
from repro_torch.utils import collectives
from repro_torch.utils.memtrack import MemTracker
from repro_torch.utils.roofline import Roofline, model_flops_per_chip

MESHES = {"single": (16, 16), "multi": (32, 16)}
GB = 1e9


def mesh_shape(name: str) -> tuple[int, int]:
    """(data, model) of ``single``, ``multi`` or ``DxM``."""
    if name in MESHES:
        return MESHES[name]
    try:
        data, model = (int(n) for n in name.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {name!r}: single, multi or DxM (e.g. 2x2)"
                         ) from None
    return data, model


@contextlib.contextmanager
def fake_world(data: int, model: int, rank: int = 0):
    """A :class:`Mesh` of ``data`` x ``model`` ranks on which this process
    is ``rank`` of a ``"fake"`` process group (none for one rank), torn
    down on exit. Refuses to run inside a live process group."""
    world = data * model
    if world > 1:
        if dist.is_initialized():
            raise RuntimeError("the dry run's fake world needs a process "
                               "with no process group")
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    try:
        yield Mesh(data, model)
    finally:
        if world > 1:
            dist.destroy_process_group()


def placeable(cfg, mesh):
    """``cfg`` with ``attn_shard="head_dim"`` where its heads or KV heads
    do not divide by the mesh's ``model`` (the reference cuts head_dim
    there), else ``cfg`` itself."""
    m = mesh.model
    if cfg.attn_shard == "heads" and m > 1 and cfg.num_heads and (
            cfg.num_heads % m or cfg.num_kv_heads % m):
        return dataclasses.replace(cfg, attn_shard="head_dim")
    return cfg


@dataclasses.dataclass
class Trace:
    """What one traced step gave (all per rank)."""
    kind: str
    tokens: int  # processed by the whole mesh
    window: bool
    attn_shard: str
    flops: float
    hbm_bytes: float
    calls: dict  # the port's operators by name
    argument_bytes: dict  # by category, live before the step
    peak: dict  # MemTracker.peak()
    collectives: dict
    by_axis: dict
    seconds: float


def fake_like(spec: torch.Tensor, device) -> torch.Tensor:
    """An uninitialised tensor of ``spec`` 's shape and dtype on
    ``device`` (a fake one under ``FakeTensorMode``)."""
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def memory_record(argument: dict, peak: dict) -> dict:
    """The record's ``memory``: the reference's per-chip argument, temp
    and total bytes (the arguments: the storages live before the step;
    the total: the peak), and both split by category."""
    arg = sum(argument.values())
    return {"argument_bytes_per_chip": arg,
            "temp_bytes_per_chip": peak["peak_bytes"] - arg,
            "total_bytes_per_chip": peak["peak_bytes"],
            "argument_by_category": argument,
            "peak_by_category": peak["by_category"]}


def trace_combo(cfg, shape_name: str, mesh, device="cuda",
                serve_dtype: torch.dtype = torch.bfloat16,
                moe_serving_mode: str = "weight_gather") -> Trace:
    """Build rank 0's model for ``mesh`` under ``FakeTensorMode`` on
    ``device`` and run one step of ``shape_name``'s kind under the
    counters (the module docstring). ``mesh`` is a :func:`fake_world`'s
    (or a 1 x 1) mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = INPUT_SHAPES[shape_name]
    kind, B, S = spec["kind"], spec["global_batch"], spec["seq_len"]
    cfg = placeable(cfg, mesh)
    device = torch.device(device)
    window = kind == "decode" and uses_sliding_window(cfg, shape_name)
    sharded = B > 1  # the reference splits a batch dim only when > 1
    # the inputs' meta stand-ins, cut to this rank's rows
    specs = {k: v if v.dim() == 0 else SH.batch_rows(v, mesh, sharded)
             for k, v in input_specs(cfg, shape_name, serve_dtype).items()}
    t0 = time.perf_counter()
    with FakeTensorMode(), MemTracker(device.type) as mem:
        model = Transformer(cfg, device=device, trainable=kind == "train",
                            mesh=mesh)
        mem.tag(list(model.parameters()), "parameters")
        batch = {k: fake_like(v, device) for k, v in specs.items()
                 if k != "pos"}
        mem.tag(batch, "inputs")
        if kind == "train":
            opt, train_step = make_train_step(model, mesh=mesh)
            state = opt.init(dict(model.named_parameters()))
            mem.tag(state, "optimizer_state")
            for p in model.parameters():  # each leaf's gradient, as made
                p.register_hook(lambda g: mem.tag(g, "gradients"))

            def step():
                return train_step(state, batch)
        elif kind == "prefill":
            def step():
                return prefill(model, mesh=mesh, batch_sharded=sharded,
                               moe_serving_mode=moe_serving_mode, **batch)
        else:
            cache_len = decode_cache_len(cfg, shape_name)
            caches = init_caches(cfg, B, cache_len, dtype=serve_dtype,
                                 device=device, mesh=mesh,
                                 batch_sharded=sharded)
            mem.tag(caches, "inputs")
            # the last position: attention reads every slot of the cache
            pos = (S if window else cache_len) - 1

            def step():
                return decode_step(model, caches, pos=pos, window=window,
                                   mesh=mesh, batch_sharded=sharded,
                                   moe_serving_mode=moe_serving_mode,
                                   **batch)
        argument = mem.live_bytes()
        mesh.reset_counts()
        with mem.counting():
            out = step()
        del out
    return Trace(
        kind=kind, tokens=B * S if kind != "decode" else B, window=window,
        attn_shard=cfg.attn_shard, flops=float(mem.flops),
        hbm_bytes=float(mem.hbm_bytes), calls=dict(mem.calls),
        argument_bytes=argument, peak=mem.peak(),
        collectives=collectives.collective_bytes(mesh),
        by_axis=collectives.by_axis(mesh),
        seconds=time.perf_counter() - t0)


def analyse(arch: str, shape_name: str, mesh_name: str, trace: Trace, cfg,
            mesh) -> dict:
    """The reference's record of one combo: per rank memory (the
    arguments the step is handed, the peak and its categories),
    collectives, the roofline with the H100's constants, and the calls
    of B3, B6 and B7 traced."""
    chips = mesh.size
    rl = Roofline(flops=trace.flops, hbm_bytes=trace.hbm_bytes,
                  coll_bytes=float(trace.collectives["total_bytes"]),
                  model_flops=model_flops_per_chip(cfg, trace.kind,
                                                   trace.tokens, chips))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": [mesh.data, mesh.model], "kind": trace.kind,
        "sliding_window": trace.window, "attn_shard": trace.attn_shard,
        "chips": chips,
        "memory": memory_record(trace.argument_bytes, trace.peak),
        "collectives": trace.collectives,
        "collectives_by_axis": trace.by_axis,
        "kernel_calls": trace.calls,
        "roofline": rl.to_dict(),
        "trace_seconds": round(trace.seconds, 1),
    }


def run_one(arch: str, shape_name: str, mesh_name: str, device="cuda",
            verbose: bool = True) -> dict:
    """Trace and analyse one combo in a fake world of its own."""
    cfg = get_config(arch)
    with fake_world(*mesh_shape(mesh_name)) as mesh:
        trace = trace_combo(cfg, shape_name, mesh, device=device)
        rec = analyse(arch, shape_name, mesh_name, trace, cfg, mesh)
    if verbose:
        r = rec["roofline"]
        calls = ",".join(f"{k}={v}" for k, v in sorted(
            rec["kernel_calls"].items())) or "-"
        print(f"[OK] {arch:22s} {shape_name:12s} {mesh_name:6s} "
              f"trace={rec['trace_seconds']:6.1f}s "
              f"mem/chip={rec['memory']['total_bytes_per_chip'] / GB:8.2f}GB "
              f"flops={r['flops_per_chip']:.3e} "
              f"t_comp={r['t_compute_s']:.3e} t_mem={r['t_memory_s']:.3e} "
              f"t_coll={r['t_collective_s']:.3e} bound={r['bottleneck']:10s} "
              f"kernels {calls}", flush=True)
    return rec


H100_BYTES = 80e9  # NVIDIA H100 80GB HBM3: device memory a rank has


def fit_table(records: list[dict]) -> str:
    """The per-H100 fit table of ``records`` (:func:`run_one` 's, or the
    failures ``main`` records): one markdown row per (arch, shape), in
    the registry's order, one column per mesh in the order the records
    name them, each giving the
    memory per rank in GB (``!`` past the card's 80 GB), the FLOPs per
    rank in TFLOP, the roofline's three terms in ms (compute / memory /
    collective) and its bound; then B6's and B7's calls per rank (from
    the first mesh's record; B7's backward kernel's beside its
    forward's). A failure's cell names its error."""
    meshes, rows = [], {}
    for r in records:
        if r["mesh"] not in meshes:
            meshes.append(r["mesh"])
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def cell(r):
        if r is None:
            return "-"
        if "roofline" not in r:
            return "error: " + r["error"][:80].replace("|", "/")
        gb = r["memory"]["total_bytes_per_chip"]
        rl = r["roofline"]
        return (f"{gb / GB:.1f}{'!' if gb > H100_BYTES else ''} GB, "
                f"{rl['flops_per_chip'] / 1e12:.4g} TF, "
                f"{rl['t_compute_s'] * 1e3:.3g}/{rl['t_memory_s'] * 1e3:.3g}/"
                f"{rl['t_collective_s'] * 1e3:.3g} ms, {rl['bottleneck']}")

    out = ["| arch | shape | " + " | ".join(meshes) + " | B6 / B7 |",
           "|---|---|" + "---|" * len(meshes) + "---|"]
    order = {k: i for i, k in enumerate(list_archs() + list(INPUT_SHAPES))}
    for (arch, shape), by in sorted(rows.items(), key=lambda kv: (
            order.get(kv[0][0], len(order)), kv[0][0],
            order.get(kv[0][1], len(order)))):
        first = next((r for r in by.values() if "roofline" in r), None)
        calls = first["kernel_calls"] if first else {}
        bwd = calls.get("mamba1_scan_gated_backward", 0)
        out.append(f"| {arch} | {shape} | " + " | ".join(
            cell(by.get(m)) for m in meshes)
            + f" | {calls.get('flash_attention', 0)} / "
            f"{calls.get('mamba1_scan_gated', 0)}"
            + (f" + {bwd} backward" if bwd else "") + " |")
    return "\n".join(out)


def _failure(arch, shape_name, mesh_name, error: str, tb: str) -> dict:
    print(f"[FAIL] {arch} {shape_name} {mesh_name}: {error}", flush=True)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "error": error, "traceback": tb[-2000:]}


def _in_process(combo, device) -> dict:
    """One combo's record, or its failure's, traced here."""
    try:
        return run_one(*combo, device=device)
    except Exception as e:  # noqa: BLE001 -- record it, go on
        return _failure(*combo, f"{type(e).__name__}: {e}",
                        traceback.format_exc())


def _in_child(combo, device, tmp: str, timeout: float | None) -> dict:
    """One combo's record traced by a process of its own (``--jobs``):
    a trace holds one world and a few GB of host at most, and the
    slowest ones run beside the rest. A trace still running after
    ``timeout`` seconds is stopped and recorded as a failure."""
    arch, shape_name, mesh_name = combo
    out = os.path.join(tmp, f"{mesh_name}_{arch}_{shape_name}.json")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape_name, "--mesh", mesh_name, "--device",
             device, "--out", out], capture_output=True, text=True,
            timeout=timeout)
    except subprocess.TimeoutExpired:
        return _failure(*combo, f"TimeoutExpired: the trace ran past "
                        f"{timeout:g} s", "")
    print(proc.stdout.split("\n\n")[0], flush=True)
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)[0]
    return _failure(*combo, f"the tracing process exited {proc.returncode}",
                    proc.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single (16x16), multi (32x16) or DxM, or several "
                    "of them, comma-separated")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace this many combos at once, each in a "
                    "process of its own")
    ap.add_argument("--timeout", type=float, default=None,
                    help="with --jobs: record a combo still tracing after "
                    "this many seconds as a failure")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device whose paths are traced (cpu: the "
                    "plain versions, for a machine without a card)")
    ap.add_argument("--table", nargs="+", metavar="JSON",
                    help="print the fit table of these --out files and "
                    "trace nothing")
    args = ap.parse_args(argv)
    if args.table:
        records = []
        for path in args.table:
            with open(path) as f:
                records += json.load(f)
        print(fit_table(records))
        return 0
    meshes = args.mesh.split(",")
    for name in meshes:  # refuse a bad name before any work
        mesh_shape(name)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    results = []
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            results = [r for r in json.load(f) if "roofline" in r]
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    combos = [(a, s, m) for m in meshes for a in archs for s in shapes
              if (a, s, m) not in done]

    def keep(rec):
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    if args.jobs > 1:
        # the longest traces first: the Mamba1 family's training steps
        # (on the CPU's paths B7's backward is a loop over time), then
        # the others'
        ssm = {a for a in list_archs() if get_config(a).family == "ssm"}
        combos.sort(key=lambda c: (INPUT_SHAPES[c[1]]["kind"] != "train",
                                   c[0] not in ssm))
        with tempfile.TemporaryDirectory() as tmp, \
                ThreadPoolExecutor(args.jobs) as pool:
            jobs = [pool.submit(_in_child, c, args.device, tmp,
                                args.timeout) for c in combos]
            for job in as_completed(jobs):
                keep(job.result())
    else:
        for combo in combos:
            keep(_in_process(combo, args.device))
    mine = [r for r in results if r["mesh"] in meshes]
    n_ok = sum(1 for r in mine if "roofline" in r)
    print(f"\n{n_ok}/{len(mine)} combos traced successfully")
    return 0 if n_ok == len(mine) else 1


if __name__ == "__main__":
    raise SystemExit(main())
