"""Id-range partitioning and host-side batch routing for the sharded sparse
path: the paper's parameter-server split (§4, Fig. 5) on padded-COO
batches.

The port's counterpart of ``repro/shard/partition.py`` (a copy of its
numpy; the port imports nothing of the reference). Each model shard owns
one CONTIGUOUS id range ``[bounds[s], bounds[s+1])`` of the d feature
columns:

  * Theta rows are the L2,1 groups, so a feature row never straddles
    shards and OWLQN+'s orthant/direction algebra stays shard-local;
  * the backward's :class:`~repro_torch.kernels.lsplm_sparse_scatter.plan.
    TransposePlan` is sorted by id, so per-shard plans are contiguous
    slices of the full plan (``plan_slicing``);
  * local ids are global ids minus the range start.

``make_partition`` cuts equal ranges; ``balanced_partition`` cuts at
quantiles of the batch's id histogram so a Zipf-hot head does not load
shard 0 alone. Unequal ranges still give every shard ``rows_per_shard``
rows in the padded layout (``Partition.pad_rows`` / ``unpad_rows``); pad
rows receive no ids, so their gradient is exactly zero and OWLQN+ keeps
them at exact zero.

``route_batch`` buckets each sample's (ids, vals) per shard with ONE
uniform per-shard K (the most in-shard entries of any (sample, shard)
cell), keeping the entries' order within a sample: the routed ids and
values equal the reference's bit for bit. Its plans are the grid of
(data block, id range) cell plans, each unpadded: a rank of the port
holds its own cell, so the reference's ``stack_plans`` (uniform shapes
for ``shard_map``) has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels.lsplm_sparse_scatter.plan import TransposePlan


class Partition:
    """Contiguous id-range partition of ``num_rows`` feature columns.

    ``bounds`` is (S+1,) non-decreasing with ``bounds[0] == 0`` and
    ``bounds[-1] == num_rows``; shard s owns ids in
    ``[bounds[s], bounds[s+1])``.
    """

    def __init__(self, bounds: Sequence[int]):
        b = np.asarray(bounds, np.int64)
        if b.ndim != 1 or b.size < 2:
            raise ValueError(f"bounds must be (S+1,) with S >= 1, got {b.shape}")
        if b[0] != 0:
            raise ValueError(f"bounds[0] must be 0, got {b[0]}")
        if np.any(np.diff(b) < 0):
            raise ValueError(f"bounds must be non-decreasing: {b}")
        self.bounds = b

    @property
    def num_shards(self) -> int:
        return int(self.bounds.size - 1)

    @property
    def num_rows(self) -> int:
        return int(self.bounds[-1])

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.bounds)

    @property
    def rows_per_shard(self) -> int:
        """Uniform per-shard row count of the padded layout."""
        return int(max(1, self.sizes.max()))

    @property
    def is_uniform(self) -> bool:
        """True iff every range already has ``rows_per_shard`` rows (the
        padded layout is then the identity)."""
        return bool(np.all(self.sizes == self.rows_per_shard))

    def ranges(self) -> list[tuple[int, int]]:
        return [(int(self.bounds[s]), int(self.bounds[s + 1]))
                for s in range(self.num_shards)]

    def __repr__(self) -> str:
        return (f"Partition(num_rows={self.num_rows}, "
                f"num_shards={self.num_shards}, sizes={self.sizes.tolist()})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, Partition)
                and np.array_equal(self.bounds, other.bounds))

    def shard_of(self, ids) -> np.ndarray:
        """Owning shard per id (host numpy). Ids >= num_rows (e.g. the
        global pad id) map to ``num_shards``: owned by nobody."""
        return np.searchsorted(self.bounds[1:], np.asarray(ids), side="right")

    def pad_rows(self, theta: torch.Tensor) -> torch.Tensor:
        """(d, 2m) -> (S * rows_per_shard, 2m): shard s's rows at
        ``[s * rows_per_shard, s * rows_per_shard + sizes[s])``, zero
        padding after. The tensor itself for a uniform partition."""
        if theta.shape[0] != self.num_rows:
            raise ValueError(f"theta has {theta.shape[0]} rows, partition "
                             f"covers {self.num_rows}")
        if self.is_uniform:
            return theta
        R = self.rows_per_shard
        parts = []
        for lo, hi in self.ranges():
            parts.append(theta[lo:hi])
            if hi - lo < R:
                parts.append(theta.new_zeros((R - (hi - lo),)
                                             + tuple(theta.shape[1:])))
        return torch.cat(parts, dim=0)

    def unpad_rows(self, theta_padded: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`pad_rows`: drops the per-shard pad rows."""
        R = self.rows_per_shard
        if theta_padded.shape[0] != self.num_shards * R:
            raise ValueError(f"padded theta has {theta_padded.shape[0]} "
                             f"rows, expected {self.num_shards * R}")
        if self.is_uniform:
            return theta_padded
        return torch.cat([theta_padded[s * R: s * R + (hi - lo)]
                          for s, (lo, hi) in enumerate(self.ranges())], dim=0)

    def shard_rows(self, theta_padded: torch.Tensor, shard: int
                   ) -> torch.Tensor:
        """Shard ``shard``'s block (rows_per_shard rows) of the padded
        layout, along the last-but-one axis when ``theta_padded`` has a
        leading history axis."""
        R = self.rows_per_shard
        return theta_padded.narrow(theta_padded.ndim - 2, shard * R, R)


def make_partition(num_rows: int, num_shards: int) -> Partition:
    """Equal contiguous ranges (the first ``num_rows % num_shards`` shards
    get one extra row); the padded layout is the identity when the shards
    divide ``num_rows``. The drivers' partition."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_rows < num_shards:
        raise ValueError(
            f"cannot cut {num_rows} rows into {num_shards} non-empty ranges")
    base, rem = divmod(num_rows, num_shards)
    sizes = np.full(num_shards, base, np.int64)
    sizes[:rem] += 1
    return Partition(np.concatenate([[0], np.cumsum(sizes)]))


def balanced_partition(num_rows: int, num_shards: int, *id_arrays,
                       pad_id: int | None = None) -> Partition:
    """Frequency-balanced contiguous ranges from the batch's id histogram:
    cuts at quantiles of the cumulative entry count, so each shard serves
    ~1/S of the gathers and scatters even when the ids are Zipf-hot. One
    id's mass cannot be split."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    counts = np.zeros(num_rows, np.int64)
    for arr in id_arrays:
        flat = _host(arr).reshape(-1)
        if pad_id is not None:
            flat = flat[flat != pad_id]
        if flat.size:
            counts += np.bincount(flat, minlength=num_rows)[:num_rows]
    cum = np.cumsum(counts)
    total = int(cum[-1]) if num_rows else 0
    if total == 0:  # no signal: equal ranges
        return make_partition(num_rows, num_shards)
    targets = (np.arange(1, num_shards) * total) / num_shards
    cuts = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.concatenate([[0], cuts, [num_rows]])
    return Partition(np.maximum.accumulate(np.clip(bounds, 0, num_rows)))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def shard_slot_width(part: Partition, ids, *, pad_id: int,
                     num_samples: int | None = None,
                     k_multiple: int = 1) -> int:
    """The uniform per-shard K: the most in-shard entries of any (sample,
    shard) cell, rounded up to ``k_multiple``, at least 1. ``route_ids``
    and ``plan_slicing.slice_plan`` both use this rule."""
    ids = _host(ids)
    N = ids.shape[0] if num_samples is None else num_samples
    flat = ids.reshape(-1)
    keep = flat != pad_id
    if not np.any(keep):
        return max(1, k_multiple)
    sh = part.shard_of(flat[keep])
    n = np.nonzero(keep)[0] // ids.shape[1]
    per_cell = np.bincount(sh * N + n, minlength=(part.num_shards + 1) * N)
    k = int(per_cell[: part.num_shards * N].max())
    return max(1, -(-k // k_multiple) * k_multiple)


def route_ids(part: Partition, ids, vals, *, pad_id: int,
              shard_k: int | None = None,
              k_multiple: int = 1) -> tuple[np.ndarray, np.ndarray, int]:
    """Bucket a padded-COO (N, K) pair per model shard.

    Returns ``(ids_r, vals_r, Ks)``, (S, N, Ks) numpy arrays: shard s's
    slice holds, per sample, the entries whose global id falls in shard
    s's range as LOCAL ids (global minus range start), in their k order,
    the tail padded with the local pad id ``part.rows_per_shard`` (the
    zero row ``pad_theta`` appends to a shard's block) and value 0.
    Entries carrying the global ``pad_id`` are dropped."""
    ids = _host(ids)
    vals = _host(vals)
    if ids.shape != vals.shape or ids.ndim != 2:
        raise ValueError(f"ids/vals must share (N, K): {ids.shape} vs "
                         f"{vals.shape}")
    N, K = ids.shape
    S = part.num_shards
    Ks = shard_slot_width(part, ids, pad_id=pad_id, k_multiple=k_multiple) \
        if shard_k is None else int(shard_k)

    flat = ids.reshape(-1)
    keep = np.nonzero(flat != pad_id)[0]
    sh = part.shard_of(flat[keep])
    if keep.size and sh.max() >= S:
        bad = flat[keep][sh >= S].max()
        raise ValueError(f"id {bad} outside partition range "
                         f"[0, {part.num_rows}) and != pad_id {pad_id}")
    n = keep // K

    ids_r = np.full((S, N, Ks), part.rows_per_shard, np.int32)
    vals_r = np.zeros((S, N, Ks), vals.dtype)
    if keep.size:
        # sort by (shard, sample); ties keep flat (= k) order
        perm = np.argsort(sh * np.int64(N) + n, kind="stable")
        sh_s, n_s, e_s = sh[perm], n[perm], keep[perm]
        cell = sh_s * np.int64(N) + n_s
        starts = np.nonzero(np.diff(np.concatenate([[-1], cell])))[0]
        lens = np.diff(np.concatenate([starts, [cell.size]]))
        if lens.max() > Ks:
            raise ValueError(
                f"shard_k={Ks} too small: a (sample, shard) cell holds "
                f"{lens.max()} entries")
        offs = np.arange(cell.size) - np.repeat(starts, lens)
        ids_r[sh_s, n_s, offs] = (flat[e_s] - part.bounds[sh_s]).astype(np.int32)
        vals_r[sh_s, n_s, offs] = vals.reshape(-1)[e_s]
    return ids_r, vals_r, Ks


class ShardCell(NamedTuple):
    """One rank's cell of a routed batch: its data block's sessions and
    samples, restricted to its id range, as a plain single-device
    ``SparseCTRBatch`` over the shard's padded block (local ids, pad id
    and ``num_features`` = ``rows_per_shard``), plus where it sits."""

    batch: object  # repro_torch.data.sparse.SparseCTRBatch
    data_rank: int
    model_rank: int
    data_shards: int
    num_shards: int
    rows_per_shard: int


class ShardedSparseBatch(NamedTuple):
    """A ``SparseCTRBatch`` routed for a (data x model) mesh.

    Id/val tensors carry a leading model axis (S shards, LOCAL ids, local
    pad id = ``rows_per_shard``); ``session_id`` is rebased per data block
    (each block sees sessions [0, G / data_shards)). Plans, when present,
    are the (data_shards x S) grid of cell plans, each unpadded."""

    user_ids: torch.Tensor   # (S, G, Ku') int32 local ids
    user_vals: torch.Tensor  # (S, G, Ku')
    ad_ids: torch.Tensor     # (S, B, Ka') int32 local ids
    ad_vals: torch.Tensor    # (S, B, Ka')
    session_id: torch.Tensor  # (B,) block-local session index
    y: torch.Tensor          # (B,)
    num_features: int = 0          # d (global columns)
    rows_per_shard: int = 0        # padded rows per model shard
    data_shards: int = 1
    bounds: tuple[int, ...] = ()   # partition bounds
    user_plan: tuple[tuple[TransposePlan, ...], ...] | None = None
    ad_plan: tuple[tuple[TransposePlan, ...], ...] | None = None

    @property
    def num_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def partition(self) -> Partition:
        return Partition(np.asarray(self.bounds, np.int64))

    def cell(self, data_rank: int, model_rank: int, device=None) -> ShardCell:
        """Rank (data_rank, model_rank)'s cell, its tensors and plans on
        ``device`` (default: where they are)."""
        from repro_torch.data.sparse import SparseCTRBatch

        Dd, S = self.data_shards, self.num_shards
        if not (0 <= data_rank < Dd and 0 <= model_rank < S):
            raise ValueError(f"cell ({data_rank}, {model_rank}) outside the "
                             f"({Dd}, {S}) grid")
        G_l = self.user_ids.shape[1] // Dd
        B_l = self.ad_ids.shape[1] // Dd
        us = slice(data_rank * G_l, (data_rank + 1) * G_l)
        as_ = slice(data_rank * B_l, (data_rank + 1) * B_l)
        dev = self.ad_ids.device if device is None else torch.device(device)

        def t(x):
            return x.contiguous().to(dev)

        def plan(grid):
            return None if grid is None else grid[data_rank][model_rank].to(dev)

        batch = SparseCTRBatch(
            user_ids=t(self.user_ids[model_rank, us]),
            user_vals=t(self.user_vals[model_rank, us]),
            ad_ids=t(self.ad_ids[model_rank, as_]),
            ad_vals=t(self.ad_vals[model_rank, as_]),
            session_id=t(self.session_id[as_]), y=t(self.y[as_]),
            num_features=self.rows_per_shard,
            user_plan=plan(self.user_plan), ad_plan=plan(self.ad_plan))
        return ShardCell(batch=batch, data_rank=data_rank,
                         model_rank=model_rank, data_shards=Dd, num_shards=S,
                         rows_per_shard=self.rows_per_shard)


def route_batch(batch, part: Partition, *, data_shards: int = 1,
                k_multiple: int = 1) -> ShardedSparseBatch:
    """Route a session-structured sparse batch onto a (data x model) mesh.

    Ids/vals are bucketed per model shard (``route_ids``); the batch's
    transpose plans, when attached, are restricted per data block and
    sliced per id range (``plan_slicing.shard_plan_grid``): the id sort is
    not redone. Sessions must be contiguous and divisible: data block b
    takes sessions [b G / data_shards, (b+1) G / data_shards) and their
    ads. The routed tensors lie on the batch's device."""
    from repro_torch.shard.plan_slicing import shard_plan_grid

    d = batch.num_features
    if part.num_rows != d:
        raise ValueError(f"partition covers {part.num_rows} rows, batch has "
                         f"{d} feature columns")
    uid, aid, sid = (_host(x) for x in (batch.user_ids, batch.ad_ids,
                                        batch.session_id))
    G, B = uid.shape[0], aid.shape[0]
    Dd = int(data_shards)
    if Dd < 1 or G % Dd or B % Dd:
        raise ValueError(
            f"data_shards={Dd} must divide sessions ({G}) and samples ({B})")
    G_l, B_l = G // Dd, B // Dd
    blocks = sid.reshape(Dd, B_l) // G_l
    if not np.all(blocks == np.arange(Dd)[:, None]):
        raise ValueError(
            "sessions must be contiguous: data block b must hold exactly "
            f"sessions [b*{G_l}, (b+1)*{G_l})")

    user_r, user_v, Ku = route_ids(part, uid, _host(batch.user_vals),
                                   pad_id=d, k_multiple=k_multiple)
    ad_r, ad_v, Ka = route_ids(part, aid, _host(batch.ad_vals),
                               pad_id=d, k_multiple=k_multiple)
    user_plan = ad_plan = None
    if batch.user_plan is not None:
        user_plan = shard_plan_grid(batch.user_plan, part,
                                    num_cols=uid.shape[1], data_shards=Dd,
                                    shard_k=Ku)
    if batch.ad_plan is not None:
        ad_plan = shard_plan_grid(batch.ad_plan, part, num_cols=aid.shape[1],
                                  data_shards=Dd, shard_k=Ka)
    dev = batch.ad_ids.device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def on_dev(grid):
        return None if grid is None else tuple(
            tuple(p.to(dev) for p in row) for row in grid)

    return ShardedSparseBatch(
        user_ids=t(user_r), user_vals=t(user_v), ad_ids=t(ad_r),
        ad_vals=t(ad_v), session_id=t((sid % G_l).astype(np.int32)),
        y=batch.y, num_features=d, rows_per_shard=part.rows_per_shard,
        data_shards=Dd, bounds=tuple(int(b) for b in part.bounds),
        user_plan=on_dev(user_plan), ad_plan=on_dev(ad_plan))
