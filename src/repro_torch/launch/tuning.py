"""Launch-layer autotune knobs shared by the port's train and serve drivers.

The port's counterpart of ``repro/launch/tuning.py``. ``--block-n`` and
``--chunk`` pin a kernel knob process-wide (they map onto
:func:`repro_torch.tune.set_overrides`, which beats the committed table
but loses to explicit call-site kwargs); ``--tune`` runs a fresh sweep at
the job's own shapes and installs the result as the active in-memory
table -- nothing is written to disk. ``--block-k`` is accepted for the
reference's command lines and refused: B1 has no K tile
(:data:`repro_torch.tune.BLOCK_K_DEPARTURE`).

Values are validated LOUDLY at launch: a non-positive knob, or one that
mismatches the job geometry (``--chunk`` wider than the batch's K,
``--block-n`` taller than the batch or off B1's grid), is a
``SystemExit`` -- a flag that reported timings for a config it never ran
would be worse than no flag.

:func:`tuning_scope` restores the overrides and the active table a
driver's ``run()`` found, so an in-process caller (tests, ``chip_smoke.py``)
gets back the process it had.
"""
from __future__ import annotations

import argparse
from contextlib import contextmanager

from repro_torch.kernels.lsplm_sparse_fused.lsplm_sparse_fused import (
    BLOCK_N_GRID,
)
from repro_torch.tune import table as tabmod


def add_tuning_flags(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group(
        "autotune", "kernel launch knobs (default: the committed autotune "
        "table -- see repro_torch.tune and README 'Autotuning')")
    g.add_argument("--block-n", type=int, default=None,
                   help="rows a block of the fused forward (B1/B4: 1, 2, "
                        "4 or 8, one warp a row)")
    g.add_argument("--block-k", type=int, default=None,
                   help="refused: B1 has no K tile on the card (a warp "
                        "walks a row's slots 32 at a time)")
    g.add_argument("--chunk", type=int, default=None,
                   help="K-chunk of the plain loops (fwd AND bwd)")
    g.add_argument("--tune", action="store_true",
                   help="sweep this job's shapes up front and use the "
                        "fresh result instead of the committed table")


def tuning_flags_set(args: argparse.Namespace) -> bool:
    return (args.block_n is not None or args.block_k is not None
            or args.chunk is not None or args.tune)


def apply_tuning_flags(args: argparse.Namespace, *,
                       batch_n: int | None = None,
                       batch_k: int | None = None) -> None:
    """Install the flag overrides; loud ``SystemExit`` on bad values.

    ``batch_n``/``batch_k`` are the job's batch geometry (rows, widest
    id-list K) once known -- a knob exceeding them is rejected here."""
    try:
        tabmod.set_overrides(block_n=args.block_n, block_k=args.block_k,
                             chunk=args.chunk)
    except ValueError as e:
        raise SystemExit(f"autotune flags: {e}") from None
    if args.block_n is not None and args.block_n not in BLOCK_N_GRID:
        raise SystemExit(f"--block-n {args.block_n}: B1/B4 take "
                         f"{' / '.join(map(str, BLOCK_N_GRID))} rows a block "
                         "(one warp a row)")
    if batch_k is not None and args.chunk is not None \
            and args.chunk > batch_k:
        raise SystemExit(
            f"--chunk {args.chunk} exceeds the job's K={batch_k} id columns "
            f"-- no loop would run that chunk; pass a value <= {batch_k} or "
            "drop the flag")
    if batch_n is not None and args.block_n is not None \
            and args.block_n > batch_n:
        raise SystemExit(
            f"--block-n {args.block_n} exceeds the job's batch of "
            f"{batch_n} rows -- no launch would fill that block; pass a "
            f"value <= {batch_n} or drop the flag")


def tune_job_shapes(shapes, *, device, log=print) -> None:
    """``--tune``: sweep the job's (n, k, d, m) shapes on ``device`` and
    make the result THIS process's active table (committed files
    untouched). Flag overrides still beat it -- pinning a knob while
    sweeping the rest is legitimate."""
    from repro_torch.tune.sweep import sweep_shapes

    # shapes sharing a table envelope resolve identically -- sweep each
    # envelope once, at its largest member (closest to the bucket edge)
    uniq: dict[str, tuple] = {}
    for n, k, d, m in sorted(set(shapes)):
        uniq[tabmod.fused_envelope(n, k, 2 * m)] = (n, k, d, m)
    shapes = sorted(uniq.values())
    log(f"--tune: sweeping {len(shapes)} job shape(s) "
        f"{shapes} (in-memory table; committed files untouched)")
    records = []
    table = sweep_shapes(shapes, device=device, log=log, records=records)
    moved = [r for r in records if r["committed"] != r["default"]]
    log(f"--tune: {len(moved)} of {len(records)} swept entries depart from "
        f"the builtin default"
        + "".join(f"; {r['kernel']}/{r['envelope']} {r['committed']}"
                  for r in moved))
    tabmod.set_active_table(table)


@contextmanager
def tuning_scope():
    """Restore the process-wide overrides and active table on exit."""
    overrides = tabmod.get_overrides()
    table = tabmod._active_table
    try:
        yield
    finally:
        tabmod.clear_overrides()
        tabmod.set_overrides(**overrides)
        tabmod.set_active_table(table)
