"""The sparse LS-PLM backward: dTheta and dvals, kernel or plain version.

The port's counterpart of ``repro/kernels/lsplm_sparse_scatter/ops.py``:

  * ``scatter_add_planned(plan, vals, dz) -> dTheta (D, 2m)``: with a
    per-batch :class:`~.plan.TransposePlan`. On the card: the run-length
    kernel (B2, ``lsplm_sparse_scatter.py``) on the plan's id-sorted
    entries, which writes the dense dTheta itself. On the CPU: the plain
    class-gather segment sums (:func:`_compact_classes`) and one gather
    through ``plan.inv_compact``.
  * ``scatter_add_unplanned(ids, vals, dz, num_rows, pad_id)``: the same
    without a plan. On the card the entries are sorted on the device
    (stable ``torch.sort``) and B2 runs on them; on the CPU it is the
    ``index_add_`` oracle (``ref.scatter_add_ref``).
  * ``dvals_planned`` / ``dvals_unplanned``: dvals[n,k] =
    theta[ids[n,k]] . dz[n], plain gathers on either device.

Every output row of dTheta has one writer and a fixed summation order on
both devices, so repeated calls give bitwise equal results. Which
implementation runs follows the device of ``dz`` and nothing else; a CUDA
call launches the kernel or raises.

The knobs come from ``repro_torch.tune`` at each call's shape: B2's
``block_e`` (``"scatter"``, by kept entries and 2m) and the slots
``dvals_unplanned`` gathers at a time (``"chunk_bwd"``; all K by
default). Neither changes a bit. The unplanned dTheta on the CPU stays
the exact ``index_add_`` in entry order: it has no chunk, since chunking
it would reorder its adds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.lsplm_sparse_scatter.lsplm_sparse_scatter import (
    lsplm_sparse_scatter,
)
from repro_torch.kernels.lsplm_sparse_scatter.plan import (  # noqa: F401
    TransposePlan,
    build_transpose_plan,
    run_pieces,
)
from repro_torch.kernels.lsplm_sparse_scatter.ref import scatter_add_ref
from repro_torch.tune.table import resolve_fused, resolve_scatter


class RunLayout(NamedTuple):
    """The id-sorted entries of one batch as B2 reads them (the subset of
    a :class:`TransposePlan` the kernel path needs), built on the device
    when no plan was given."""

    order: torch.Tensor  # (E',) int32 sorted pos -> flat entry
    row_ids: torch.Tensor  # (E',) int32 sorted column ids
    sample_sorted: torch.Tensor  # (E',) int32
    piece_start: torch.Tensor  # (P+1,) int32
    piece_run: torch.Tensor  # (P,) int32
    run_piece_start: torch.Tensor  # (U+1,) int32
    task_piece_start: torch.Tensor  # (T+1,) int32
    inv_sorted: torch.Tensor  # (D,) int32, U for untouched ids
    num_entries: int  # N*K


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def sorted_runs(ids: torch.Tensor, num_rows: int, pad_id: int) -> RunLayout:
    """Sort the batch's non-pad entries by id on ``ids``' device (stable:
    equal ids keep flat entry order) and cut the runs into B2's pieces and
    tasks."""
    k = ids.shape[1]
    flat = ids.reshape(-1)
    keep = torch.nonzero(flat != pad_id).squeeze(1)
    srt, perm = torch.sort(flat.index_select(0, keep), stable=True)
    order = keep.index_select(0, perm)
    uniq, counts = torch.unique_consecutive(srt, return_counts=True)
    run_start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    piece_start, piece_run, run_piece_start, task_piece_start = run_pieces(
        run_start)
    u = uniq.numel()
    inv_sorted = torch.full((num_rows,), u, dtype=torch.int32,
                            device=ids.device)
    inv_sorted[uniq.long()] = torch.arange(u, dtype=torch.int32,
                                           device=ids.device)
    return RunLayout(order=order.to(torch.int32),
                     row_ids=srt.to(torch.int32),
                     sample_sorted=(order // k).to(torch.int32),
                     piece_start=piece_start, piece_run=piece_run,
                     run_piece_start=run_piece_start,
                     task_piece_start=task_piece_start,
                     inv_sorted=inv_sorted, num_entries=flat.numel())


def _scatter_card(layout, vals: torch.Tensor, dz: torch.Tensor
                  ) -> torch.Tensor:
    """B2 on a plan or a :class:`RunLayout`: the dense dTheta, with the
    tune table's ``block_e`` at its kept entries and 2m."""
    cfg = resolve_scatter(layout.order.numel(), dz.shape[1], dz.device)
    return lsplm_sparse_scatter(
        layout, vals.reshape(-1).to(torch.float32).contiguous(),
        dz.to(torch.float32).contiguous(), block_e=cfg["block_e"])


def _compact_classes(plan: TransposePlan, vals: torch.Tensor,
                     dz: torch.Tensor) -> torch.Tensor:
    """Plain class-gather segment sums -> compact (U+1, 2m) in class-major
    order with a trailing zero row, in ``dz``'s dtype. The plain version
    of B2 (its rows in another order: densify through ``inv_compact``)."""
    m2 = dz.shape[-1]
    vflat = vals.reshape(-1).to(dz.dtype)
    outs = []
    for src, samp, mask, width in zip(plan.class_src, plan.class_samp,
                                      plan.class_mask, plan.class_width):
        v = vflat.index_select(0, src) * mask.to(dz.dtype)
        rows = (v[:, None] * dz.index_select(0, samp)).reshape(-1, width, m2)
        outs.append(rows.sum(dim=1))
    outs.append(dz.new_zeros((1, m2)))
    return torch.cat(outs, dim=0)


def scatter_add_planned(plan: TransposePlan, vals: torch.Tensor,
                        dz: torch.Tensor) -> torch.Tensor:
    """dTheta (D, 2m) from the precomputed plan: B2 on the card, the class
    gathers on the CPU. The pad row and every untouched row come out
    exactly 0."""
    if _on_card(dz):
        return _scatter_card(plan, vals, dz)
    return _compact_classes(plan, vals, dz).index_select(0, plan.inv_compact)


def scatter_add_unplanned(ids: torch.Tensor, vals: torch.Tensor,
                          dz: torch.Tensor, num_rows: int,
                          pad_id: int) -> torch.Tensor:
    """dTheta (D, 2m) without a plan: the entries sorted on the card and
    B2, or the ``index_add_`` oracle on the CPU (where it is exact in
    entry order)."""
    if _on_card(dz):
        return _scatter_card(sorted_runs(ids, num_rows, pad_id), vals, dz)
    return scatter_add_ref(ids, vals, dz, num_rows)


def dvals_planned(plan: TransposePlan, theta: torch.Tensor, dz: torch.Tensor,
                  shape: tuple[int, int]) -> torch.Tensor:
    """dvals[n,k] = theta[ids[n,k]] . dz[n] through the sorted layout
    (duplicate ids read adjacently); dropped pad entries get 0."""
    rows = theta.index_select(0, plan.row_ids).to(dz.dtype)
    dv = (rows * dz.index_select(0, plan.sample_sorted)).sum(dim=-1)
    dv = torch.cat([dv, dv.new_zeros(1)])
    return dv.index_select(0, plan.rank).reshape(shape)


def _dvals_chunk(ids: torch.Tensor, theta: torch.Tensor,
                 chunk: int | None) -> int:
    """The unplanned dvals' chunk: the caller's, else the tune table's
    ``chunk_bwd`` at this shape (builtin: all K at once)."""
    if chunk is None:
        chunk = resolve_fused("chunk_bwd", *ids.shape, theta.shape[1],
                              theta.device)["chunk"] or ids.shape[1]
    if chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    return chunk


def dvals_unplanned(ids: torch.Tensor, theta: torch.Tensor,
                    dz: torch.Tensor, chunk: int | None = None
                    ) -> torch.Tensor:
    """dvals (N, K) by a direct gather of the rows, ``chunk`` slots at a
    time (None: the tune table's ``chunk_bwd``, all K by default). Each
    element is one dot over 2m whatever the chunk, so the chunk changes
    no bit."""
    n, k = ids.shape
    chunk = _dvals_chunk(ids, theta, chunk)
    parts = []
    for k0 in range(0, k, chunk):
        part = ids[:, k0:k0 + chunk]
        rows = theta.index_select(0, part.reshape(-1).long()).to(dz.dtype)
        parts.append((rows.view(n, part.shape[1], -1)
                      * dz[:, None, :]).sum(dim=-1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
