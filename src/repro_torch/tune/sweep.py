"""Autotune sweep harness of the port: time launch configs, parity-gate,
persist.

The port's counterpart of ``repro/tune/sweep.py``. For each shape envelope
the harness times every config in a small grid and accepts the fastest
config WHOSE OUTPUT PASSES THE PARITY GATE: bitwise equal to the builtin
default's output at the same inputs, and within ``PARITY_RTOL`` /
``PARITY_ATOL`` of the plain oracle (B2: bitwise ``ref.scatter_runs_ref``).
A config that fails the gate, or raises at launch, is recorded as
rejected and never timed into the table. A winner that does not beat
the measured builtin default by :data:`MIN_GAIN` is discarded in favour
of the default -- the table only commits to wins that survive noise.

The sweep times the reference's batches: uniform ids. The system's own
id traffic is Zipf-hot (``data.sparse.zipf_ids``, the training
generator's law), and a launch knob's cost moves with how often rows
repeat. So a winner that departs from the builtin default is timed again
against the default at the same shape on Zipf ids, and enters the table
only if it wins there too by :data:`MIN_GAIN`; otherwise the default
does (the record says so).

What gets swept depends on the backend (``repro_torch.tune.table.
backend_key``):

  * ``cuda-sm*``: ``fused_fwd`` (B1: ``block_n`` x ``copy``),
    ``fused_fwd_int8`` (B4: ``block_n``) and ``scatter`` (B2:
    ``block_e``), each config timed with CUDA events over enough
    back-to-back launches to span at least ~1 ms (a spin kernel keeps the
    card busy while the host enqueues them), best of ``REPS``, after a
    warm-up;
  * ``cpu``: ``chunk_fwd`` / ``chunk_bwd``, the chunks of the plain
    forward and of the unplanned dvals, best-of-``REPS`` wall clock.

The B1/B4 grid holds only the ``block_n`` that fit the shared-memory
budget at the envelope's edge (K and 2m rounded up, dedup on), so an
entry fits every shape of its envelope.

CLI (see README "Autotuning")::

    PYTHONPATH=src python -m repro_torch.tune.sweep --device cpu \\
        --out src/repro_torch/tune/tables/cpu.json
    # on a card (chip_smoke.py phase 30 prints the same table):
    PYTHONPATH=src python -m repro_torch.tune.sweep --device cuda \\
        --out src/repro_torch/tune/tables/cuda-sm90.json

``--check TABLE.json`` re-times the committed config for every envelope
this sweep covers and fails (exit 1) if it is missing, loses parity, or
is slower than the fresh best by more than ``--check-tol``.
"""
from __future__ import annotations

import argparse
import math
import shutil
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.sparse import zipf_ids
from repro_torch.kernels.lsplm_sparse_fused import lsplm_sparse_fused as fk
from repro_torch.kernels.lsplm_sparse_fused.ops import (
    _chunked_zmap,
    pad_theta,
)
from repro_torch.kernels.lsplm_sparse_fused.ref import sparse_matmul_ref
from repro_torch.kernels.lsplm_sparse_scatter import (
    lsplm_sparse_scatter as sk,
)
from repro_torch.kernels.lsplm_sparse_scatter.ops import dvals_unplanned
from repro_torch.kernels.lsplm_sparse_scatter.plan import (
    build_transpose_plan,
)
from repro_torch.kernels.lsplm_sparse_scatter.ref import scatter_runs_ref
from repro_torch.tune import table as tabmod

# the reference's shapes -- (N, K, d, m): bench_sparse_fused's production
# envelope, bench_tune's wide-K shapes, and the CI smoke shape
PROD_SHAPES = [(4096, 16, 16_384, 12), (8192, 16, 100_000, 8),
               (16384, 24, 500_000, 12), (32768, 48, 1_000_000, 4),
               (2048, 64, 100_000, 16), (8192, 64, 200_000, 8)]
SMOKE_SHAPES = [(512, 8, 4_096, 4)]

REPS = 5
# A non-default winner must beat the MEASURED default config by this
# factor to earn a table entry (best-of-reps flatters marginal configs).
MIN_GAIN = 1.10
PARITY_RTOL = 2e-4
PARITY_ATOL = 2e-4

COPY_GRID = (tabmod.COPY_LANE, tabmod.COPY_PIECE)
CHUNK_GRID = (2, 4, 8, 16, 32, 48, 64)
MIN_SPAN_US = 1000.0  # device time one timed run of launches spans
MAX_LAUNCHES = 1000  # launches a timed run takes at most
SPIN_CYCLES_PER_US = 2000  # ~the H100's SM clock, for the spin ahead


ID_LAWS = ("uniform", "zipf")  # the batches' id traffic (see above)


class _Batch(NamedTuple):
    ids: torch.Tensor  # (N, K) int32 over [0, d), drawn by an ID_LAWS law
    vals: torch.Tensor  # (N, K) float32
    theta: torch.Tensor  # (d + 1, 2m) float32, the pad row last
    dz: torch.Tensor  # (N, 2m) float32
    ids_np: np.ndarray


def _make(n: int, k: int, d: int, m: int, seed: int = 0,
          device="cpu", law: str = "uniform") -> _Batch:
    """Deterministic sweep batch (the reference's numpy draws): padded
    Theta, pad-free uniform ids. ``law="zipf"`` swaps in Zipf-hot ids
    drawn from ``seed + 1`` and keeps every other draw."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, d, (n, k)).astype(np.int32)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    theta = rng.normal(size=(d, 2 * m)).astype(np.float32) * 0.1
    dz = rng.normal(size=(n, 2 * m)).astype(np.float32)
    if law == "zipf":
        ids = zipf_ids(np.random.default_rng(seed + 1), 0, d,
                       (n, k)).astype(np.int32)
    elif law != "uniform":
        raise ValueError(f"law must be one of {ID_LAWS}, got {law!r}")
    dev = torch.device(device)
    return _Batch(torch.from_numpy(ids).to(dev),
                  torch.from_numpy(vals).to(dev),
                  pad_theta(torch.from_numpy(theta)).to(dev),
                  torch.from_numpy(dz).to(dev), ids)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _events_us(fn, count: int, host_us: float) -> float:
    """Device µs per call of ``count`` back-to-back calls of ``fn``, timed
    by CUDA events behind a spin long enough to cover their enqueue."""
    spin_us = 1.5 * count * host_us + 200.0
    torch.cuda._sleep(int(spin_us * SPIN_CYCLES_PER_US))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / count


def time_best(fn: Callable[[], object], *, device,
              reps: int = REPS) -> float:
    """Best-of-``reps`` microseconds of one call of ``fn`` after a warm-up:
    on the card each rep times enough back-to-back launches to span
    :data:`MIN_SPAN_US` with CUDA events; on the CPU, the wall clock."""
    dev = torch.device(device)
    fn()
    fn()
    _sync(dev)
    if dev.type != "cuda":
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6
    t0 = time.perf_counter()
    fn()
    host_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize(dev)
    one = _events_us(fn, 1, host_us)
    count = max(1, min(MAX_LAUNCHES, math.ceil(MIN_SPAN_US / max(one, 0.1))))
    return min(_events_us(fn, count, host_us) for _ in range(reps))


def _bitwise(a, b) -> bool:
    """Bitwise equality of two tensors or of two tuples of them."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _close(out, ref) -> bool:
    return bool(torch.allclose(out, ref, rtol=PARITY_RTOL, atol=PARITY_ATOL))


class _Case(NamedTuple):
    """One kernel at one shape: the configs to sweep, how to run one
    (``run(None)`` is the builtin default), the default's concrete config
    at this shape, the oracle gate and the table envelope."""

    grid: list[dict]
    run: Callable[[dict | None], object]
    default: dict
    oracle_ok: Callable[[object], bool]
    envelope: str


def _fused_grid(n, k, m2, *, int8: bool) -> list[dict]:
    """B1/B4 configs that fit at the envelope's edge (K and 2m rounded up,
    dedup on), so an entry fits every shape of its envelope."""
    most = fk.max_block_n(tabmod.round_up(max(k, 1), tabmod.K_BUCKETS),
                          tabmod.round_up(m2, tabmod.M2_BUCKETS), int8=int8,
                          dedup=True)
    blocks = [b for b in fk.BLOCK_N_GRID if b <= n and b <= most]
    if int8:
        return [{"block_n": b} for b in blocks]
    return [{"block_n": b, "copy": c} for b in blocks for c in COPY_GRID]


def _case_fused(batch: _Batch, n, k, d, m) -> _Case:
    ids, vals, theta = batch.ids, batch.vals, batch.theta
    ref = sparse_matmul_ref(ids, vals, theta)
    bn, copy = fk.launch_config(n, k, 2 * m, int8=False, dedup=True)

    def run(cfg):
        return fk.lsplm_sparse_fused_forward(ids, vals, theta, dedup=True,
                                             **(cfg or {}))

    return _Case(_fused_grid(n, k, 2 * m, int8=False), run,
                 {"block_n": bn, "copy": copy},
                 lambda out: _close(out[1], ref),
                 tabmod.fused_envelope(n, k, 2 * m))


def _quantize(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 codes of a padded Theta (the reference
    sweep's rule; the pad row keeps scale 0)."""
    th = theta.cpu().numpy()
    scales = (np.abs(th).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    codes = np.rint(th / safe[:, None]).astype(np.int8)
    return (torch.from_numpy(codes).to(theta.device),
            torch.from_numpy(scales).to(theta.device))


def _case_fused_int8(batch: _Batch, n, k, d, m) -> _Case:
    ids, vals = batch.ids, batch.vals
    codes, scales = _quantize(batch.theta)
    ref = sparse_matmul_ref(ids, vals,
                            codes.to(torch.float32) * scales[:, None])
    bn, _ = fk.launch_config(n, k, 2 * m, int8=True, dedup=True)

    def run(cfg):
        return fk.lsplm_sparse_fused_int8_forward(ids, vals, codes, scales,
                                                  dedup=True, **(cfg or {}))

    return _Case(_fused_grid(n, k, 2 * m, int8=True), run, {"block_n": bn},
                 lambda out: _close(out[1], ref),
                 tabmod.fused_envelope(n, k, 2 * m))


def _case_scatter(batch: _Batch, n, k, d, m) -> _Case:
    num_rows = batch.theta.shape[0]
    plan = build_transpose_plan(batch.ids_np, num_rows).to(batch.dz.device)
    vals = batch.vals.reshape(-1).contiguous()
    ref = scatter_runs_ref(plan, vals, batch.dz, num_rows)
    m2 = 2 * m
    most = sk.max_block_e(tabmod.round_up(m2, tabmod.M2_BUCKETS))
    grid = [{"block_e": e} for e in sk.BLOCK_E_GRID if e <= most]

    def run(cfg):
        return sk.lsplm_sparse_scatter(plan, vals, batch.dz, **(cfg or {}))

    return _Case(grid, run, {"block_e": sk.DEFAULT_BLOCK_E},
                 lambda out: _bitwise(out, ref),
                 tabmod.scatter_envelope(plan.num_kept, m2))


def _chunks(k: int) -> list[int]:
    return sorted(c for c in set(CHUNK_GRID) | {k} if c <= k)


def _case_chunk_fwd(batch: _Batch, n, k, d, m) -> _Case:
    ids, vals, theta = batch.ids, batch.vals, batch.theta
    ref = sparse_matmul_ref(ids, vals, theta)
    default = tabmod.BUILTIN_DEFAULTS["chunk_fwd"]["chunk"]

    def run(cfg):
        return _chunked_zmap(ids, vals, theta,
                             (cfg or {"chunk": default})["chunk"])

    return _Case([{"chunk": c} for c in _chunks(k)], run, {"chunk": default},
                 lambda out: _close(out, ref),
                 tabmod.fused_envelope(n, k, 2 * m))


def _case_chunk_bwd(batch: _Batch, n, k, d, m) -> _Case:
    ids, theta, dz = batch.ids, batch.theta, batch.dz
    ref = torch.einsum("nkm,nm->nk", theta[ids.long()], dz)

    def run(cfg):  # the builtin default gathers all K at once
        return dvals_unplanned(ids, theta, dz, (cfg or {"chunk": k})["chunk"])

    return _Case([{"chunk": c} for c in _chunks(k)], run, {"chunk": k},
                 lambda out: _close(out, ref),
                 tabmod.fused_envelope(n, k, 2 * m))


_CASES = {"fused_fwd": _case_fused, "fused_fwd_int8": _case_fused_int8,
          "scatter": _case_scatter, "chunk_fwd": _case_chunk_fwd,
          "chunk_bwd": _case_chunk_bwd}


def sweep_case(case: _Case, *, device, reps: int = REPS,
               extra: tuple = ()) -> list[dict]:
    """Time each config of ``case.grid`` (plus ``extra``); parity-gate
    before timing. A rejected row carries ``us`` = inf and its reason."""
    want = case.run(None)
    grid = list(case.grid) + [c for c in extra if c not in case.grid]
    rows = []
    for cfg in grid:
        try:
            out = case.run(cfg)
        except (ValueError, RuntimeError) as e:
            rows.append({"config": cfg, "us": math.inf, "parity": False,
                         "why": f"launch refused: {e}"})
            continue
        why = ("differs from the default's output" if not _bitwise(out, want)
               else "outside the oracle's bars" if not case.oracle_ok(out)
               else None)
        if why:
            rows.append({"config": cfg, "us": math.inf, "parity": False,
                         "why": why})
            continue
        rows.append({"config": cfg, "parity": True,
                     "us": time_best(lambda cfg=cfg: case.run(cfg),
                                     device=device, reps=reps)})
    return rows


def _pick(rows: list[dict], default: dict | None = None) -> dict:
    """Fastest PARITY-PASSING config; raises if every config failed.

    With ``default`` (the kernel's builtin config at this shape), a
    non-default winner is only accepted when it beats the default's own
    measured time by :data:`MIN_GAIN`; otherwise the default row is
    returned."""
    ok = [r for r in rows if r["parity"]]
    if not ok:
        raise RuntimeError(f"no config passed parity: {rows}")
    best = min(ok, key=lambda r: r["us"])
    if default is not None and best["config"] != default:
        base = [r for r in ok if r["config"] == default]
        if base and base[0]["us"] < best["us"] * MIN_GAIN:
            return base[0]
    return best


# --------------------------------------------------------------- driver
def kernels_for_backend(backend: str) -> tuple[str, ...]:
    """Which table kernels matter on a backend: the card's launch knobs,
    or the plain loops' chunks on the CPU."""
    if backend.startswith("cuda-sm"):
        return ("fused_fwd", "fused_fwd_int8", "scatter")
    return ("chunk_fwd", "chunk_bwd")


def device_meta(device) -> dict:
    """Provenance of a card's sweep: its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, and the torch and CUDA versions."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "threads": torch.get_num_threads(),
                "torch": torch.__version__}
    smi = "not available"
    if shutil.which("nvidia-smi"):
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        smi = out.stdout.strip() or smi
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def sweep_shapes(shapes, *, device, reps: int = REPS,
                 table: tabmod.AutotuneTable | None = None,
                 records: list | None = None, log=obs.log,
                 generator: str = "python -m repro_torch.tune.sweep"
                 ) -> tabmod.AutotuneTable:
    """Sweep every applicable kernel at every shape into ``table``;
    ``records`` (a list) gets one dict per (kernel, envelope): the
    default config and its µs, the uniform-id winner and its µs, the
    configs timed and rejected, ``zipf`` (a departure's re-timing on
    Zipf ids: both µs and whether it held) and ``committed``, the config
    the table got."""
    dev = torch.device(device)
    backend = tabmod.backend_key(dev)
    table = table if table is not None else tabmod.AutotuneTable()
    for n, k, d, m in shapes:
        batch = _make(n, k, d, m, device=dev)
        zipf = None
        for kernel in kernels_for_backend(backend):
            case = _CASES[kernel](batch, n, k, d, m)
            rows = sweep_case(case, device=dev, reps=reps)
            best = _pick(rows, default=case.default)
            base = [r for r in rows if r["config"] == case.default]
            rejected = [r for r in rows if not r["parity"]]
            rec = {"kernel": kernel, "envelope": case.envelope,
                   "shape": [n, k, d, m], "default": case.default,
                   "default_us": base[0]["us"] if base else None,
                   "best": best["config"], "best_us": best["us"],
                   "configs": len(rows), "rejected": len(rejected),
                   "rejected_why": [r["why"] for r in rejected],
                   "zipf": None, "committed": best["config"]}
            if best["config"] != case.default:
                if zipf is None:
                    zipf = _make(n, k, d, m, device=dev, law="zipf")
                zcase = _CASES[kernel](zipf, n, k, d, m)
                zrows = sweep_case(zcase._replace(grid=[best["config"]]),
                                   device=dev, reps=reps,
                                   extra=(zcase.default,))
                held = _pick(zrows, default=zcase.default)["config"] \
                    == best["config"]
                zus = {r["config"] == best["config"]: r["us"] for r in zrows}
                rec["zipf"] = {"default_us": zus.get(False),
                               "best_us": zus.get(True), "held": held}
                if not held:
                    rec["committed"] = case.default
            table.put(backend, kernel, case.envelope, rec["committed"])
            if records is not None:
                records.append(rec)
            z = rec["zipf"]
            log(f"tune/{backend}/{kernel}/{case.envelope}: best "
                f"{best['config']} {best['us']:.1f}us (default "
                f"{case.default} "
                + (f"{rec['default_us']:.1f}us" if base else "not in grid")
                + f") over {len(rows)} configs ({len(rejected)} "
                f"parity-rejected)"
                + ("" if z is None else
                   f"; on Zipf ids {z['best_us']:.1f}us vs default "
                   f"{z['default_us']:.1f}us: "
                   + ("held" if z["held"] else "not held, the default "
                      "enters the table")))
        del batch, zipf
    table.meta.setdefault(backend, {}).update({
        "reps": reps, "shapes": [list(s) for s in shapes],
        "generator": generator, **device_meta(dev),
    })
    return table


def check_table(shapes, committed: tabmod.AutotuneTable, *, device,
                reps: int = REPS, tol: float = 2.0, records: list | None = None,
                log=obs.log) -> list[str]:
    """Freshness gate: the committed config for every envelope covered by
    ``shapes`` must exist, hold parity, and stay within ``tol`` x of a
    fresh sweep's best time. Returns failure strings (empty == pass)."""
    dev = torch.device(device)
    backend = tabmod.backend_key(dev)
    failures = []
    for n, k, d, m in shapes:
        batch = _make(n, k, d, m, device=dev)
        for kernel in kernels_for_backend(backend):
            case = _CASES[kernel](batch, n, k, d, m)
            env = case.envelope
            cfg = committed.get(backend, kernel, env)
            if cfg is None:
                failures.append(f"{backend}/{kernel}/{env}: no committed entry")
                continue
            rows = sweep_case(case, device=dev, reps=reps, extra=(cfg,))
            best = _pick(rows)
            mine = [r for r in rows if r["config"] == cfg]
            if not mine[0]["parity"]:
                failures.append(f"{backend}/{kernel}/{env}: committed {cfg} "
                                f"lost parity ({mine[0]['why']})")
                continue
            ratio = mine[0]["us"] / best["us"]
            status = "ok" if ratio <= tol else f"STALE (> {tol:.1f}x)"
            if records is not None:
                records.append({"kernel": kernel, "envelope": env,
                                "committed": cfg, "us": mine[0]["us"],
                                "best": best["config"],
                                "best_us": best["us"], "ratio": ratio})
            log(f"check/{backend}/{kernel}/{env}: committed {cfg} "
                f"{mine[0]['us']:.1f}us vs fresh best {best['config']} "
                f"{best['us']:.1f}us -- {ratio:.2f}x {status}")
            if ratio > tol:
                failures.append(
                    f"{backend}/{kernel}/{env}: committed {cfg} is "
                    f"{ratio:.2f}x slower than fresh best {best['config']}")
        del batch
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune.sweep",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card's launch knobs) or "
                         "'cpu' (the plain loops' chunks)")
    ap.add_argument("--smoke", action="store_true",
                    help="sweep the CI smoke shape only")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--out", default=None,
                    help="write/merge the swept table into this JSON file")
    ap.add_argument("--check", default=None,
                    help="freshness-gate a committed table instead of writing")
    ap.add_argument("--check-tol", type=float, default=2.0)
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    shapes = SMOKE_SHAPES if args.smoke else PROD_SHAPES + SMOKE_SHAPES
    if args.check:
        committed = tabmod.AutotuneTable.load(args.check)
        failures = check_table(shapes, committed, device=device,
                               reps=args.reps, tol=args.check_tol)
        for f in failures:
            obs.log(f"FAIL {f}",
                    printer=lambda msg: print(msg, file=sys.stderr))
        return 1 if failures else 0

    table = None
    if args.out:
        try:  # merge into the existing file so envelopes accumulate
            table = tabmod.AutotuneTable.load(args.out)
        except OSError:
            table = None
    cmd = "python -m repro_torch.tune.sweep " + " ".join(
        sys.argv[1:] if argv is None else argv)
    table = sweep_shapes(shapes, device=device, reps=args.reps, table=table,
                         generator=cmd.strip())
    backend = tabmod.backend_key(device)
    if args.out:
        table.save(args.out, backend)
        obs.log(f"wrote {args.out} [{backend}]")
    else:
        print(table.to_json(backend))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
