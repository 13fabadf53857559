"""Slice a full-batch :class:`TransposePlan` for a (data x model) mesh.

The port's counterpart of ``repro/shard/plan_slicing.py``. The plan's
layout is sorted by column id, so an id-range partition cuts it into
CONTIGUOUS slices: two ``searchsorted`` calls find shard s's entries, and
the argsort is never repeated.

  * ``slice_plan``: model axis. Per-id-range shard-local plans with rebased
    ids (global minus range start) and re-bucketed popularity classes;
    every field equals ``build_transpose_plan`` on the routed shard-local
    ids, B2's schedule (``piece_start``, ``piece_run``,
    ``run_piece_start``, ``task_piece_start``) included, because both feed
    the same ``assemble_plan_from_sorted`` and the slice keeps the full
    plan's stable id order.
  * ``restrict_plan``: data axis. A sample-range sub-plan; a stable subset
    of the sorted entries stays sorted.
  * ``shard_plan_grid``: the (data_shards x num_shards) grid of cell
    plans, restricted then sliced.

The reference's ``stack_plans`` / ``cell_plan`` pad the cells to one
shape so they can ride ``shard_map``; a rank of the port holds its own
cell, so the grid stays unpadded.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.lsplm_sparse_scatter.plan import (
    TransposePlan,
    assemble_plan_from_sorted,
)
from repro_torch.shard.partition import Partition


def _host(plan: TransposePlan):
    """The plan's sorted-layout leaves as int64 host arrays."""
    return tuple(np.asarray(t.detach().cpu().numpy(), np.int64)
                 for t in (plan.row_ids, plan.sample_sorted,
                           plan.slot_sorted))


def _group_offsets(keys: np.ndarray) -> np.ndarray:
    """Per-element offset within runs of equal consecutive keys."""
    if keys.size == 0:
        return keys.copy()
    starts = np.nonzero(np.diff(np.concatenate([[-1], keys])))[0]
    lens = np.diff(np.concatenate([starts, [keys.size]]))
    return np.arange(keys.size) - np.repeat(starts, lens)


def default_shard_k(plan: TransposePlan, part: Partition, num_samples: int,
                    *, k_multiple: int = 1) -> int:
    """Uniform per-shard K from the plan itself: the rule of
    ``partition.shard_slot_width`` on the raw ids, so independently
    computed plan and tensor widths agree."""
    row_ids, sample_sorted, _ = _host(plan)
    owned = row_ids < part.num_rows  # a kept global pad id owns no shard
    k = 0
    if np.any(owned):
        sh = part.shard_of(row_ids[owned])
        per_cell = np.bincount(
            sh * np.int64(num_samples) + sample_sorted[owned])
        k = int(per_cell.max())
    return max(1, -(-k // k_multiple) * k_multiple)


def slice_plan(plan: TransposePlan, part: Partition, *, num_cols: int,
               shard_k: int | None = None,
               k_multiple: int = 1) -> list[TransposePlan]:
    """Per-model-shard plans as contiguous slices of a full-batch plan.

    Shard s's plan addresses the ROUTED local grid (N, shard_k) with local
    ids in [0, sizes[s]) and ``num_rows = rows_per_shard + 1`` (the
    shard's padded block and its ``pad_theta`` zero row): what
    ``build_transpose_plan(routed_ids[s], rows_per_shard + 1,
    pad_id=rows_per_shard)`` builds, without re-sorting. ``num_cols`` is K
    of the ORIGINAL (N, K) grid the plan was built on; ``shard_k``
    defaults to ``route_ids``'s rule."""
    row_ids, sample_sorted, slot_sorted = _host(plan)
    if plan.num_entries % num_cols:
        raise ValueError(f"num_cols={num_cols} does not divide "
                         f"num_entries={plan.num_entries}")
    N = plan.num_entries // num_cols
    Ks = default_shard_k(plan, part, N, k_multiple=k_multiple) \
        if shard_k is None else int(shard_k)
    num_rows_local = part.rows_per_shard + 1
    out = []
    for lo, hi in part.ranges():
        a = int(np.searchsorted(row_ids, lo, side="left"))
        b = int(np.searchsorted(row_ids, hi, side="left"))
        srt_l = row_ids[a:b] - lo
        n_l = sample_sorted[a:b]
        # routed slot = rank of the entry's original k among the sample's
        # in-shard entries, by a stable grouping on (n, k); the id sort is
        # inherited
        perm = np.argsort(n_l * np.int64(num_cols) + slot_sorted[a:b],
                          kind="stable")
        k_local = np.empty(b - a, np.int64)
        k_local[perm] = _group_offsets(n_l[perm])
        if k_local.size and k_local.max() >= Ks:
            raise ValueError(
                f"shard_k={Ks} too small for range [{lo}, {hi}): a sample "
                f"holds {int(k_local.max()) + 1} in-range entries")
        out.append(assemble_plan_from_sorted(
            srt_l, n_l * np.int64(Ks) + k_local,
            num_rows=num_rows_local, num_entries=N * Ks, num_cols=Ks))
    return out


def restrict_plan(plan: TransposePlan, n0: int, n1: int, *,
                  num_cols: int) -> TransposePlan:
    """Sample-range restriction: the plan of ``ids[n0:n1]``, sort-free."""
    row_ids, sample_sorted, slot_sorted = _host(plan)
    if plan.num_entries % num_cols:
        raise ValueError(f"num_cols={num_cols} does not divide "
                         f"num_entries={plan.num_entries}")
    if not (0 <= n0 <= n1 <= plan.num_entries // num_cols):
        raise ValueError(f"bad sample range [{n0}, {n1}) for "
                         f"{plan.num_entries // num_cols} samples")
    keep = (sample_sorted >= n0) & (sample_sorted < n1)
    order = (sample_sorted[keep] - n0) * np.int64(num_cols) + slot_sorted[keep]
    return assemble_plan_from_sorted(
        row_ids[keep], order, num_rows=plan.num_rows,
        num_entries=(n1 - n0) * num_cols, num_cols=num_cols)


def shard_plan_grid(plan: TransposePlan, part: Partition, *, num_cols: int,
                    data_shards: int = 1, shard_k: int | None = None,
                    k_multiple: int = 1) -> list[list[TransposePlan]]:
    """(data_shards x num_shards) grid of cell plans: restrict per data
    block, then slice per id range. ``shard_k`` must be the routed K when
    the tensors were routed with an explicit one."""
    N = plan.num_entries // num_cols
    if N % data_shards:
        raise ValueError(f"data_shards={data_shards} does not divide "
                         f"N={N} samples")
    N_l = N // data_shards
    if shard_k is None:
        shard_k = default_shard_k(plan, part, N, k_multiple=k_multiple)
    return [slice_plan(restrict_plan(plan, b * N_l, (b + 1) * N_l,
                                     num_cols=num_cols),
                       part, num_cols=num_cols, shard_k=shard_k)
            for b in range(data_shards)]
