"""Transpose plan: the precomputed CSR-style layout of the sparse backward.

The port's counterpart of ``repro/kernels/lsplm_sparse_scatter/plan.py``.
The backward of z = x @ Theta on padded COO is the transposed scatter

    dTheta[r] = sum_{(n,k): ids[n,k]=r} vals[n,k] * dz[n]

and full-batch OWLQN+ feeds the same batch every step, so the
id -> entries transposition (a sort) is built ONCE per batch on the host
(numpy) and moved to the device once; every step then runs gathers and
segment sums only.

Leaves (all int32 tensors; the sizes that shape outputs are plain ints):

  * ``order``/``row_ids``/``sample_sorted``/``slot_sorted`` — the E' kept
    entries (pad-id entries dropped) sorted by column id;
  * ``class_src``/``class_samp``/``class_mask`` (+ ``class_width``) — the
    popularity classes of the plain segment sums: ids whose entry count is
    in (c/2, c] padded to c slots, one dense (uc, c) gather table each;
  * ``inv_compact`` — (D,) column id -> row of the class-major compact
    result of the plain segment sums (U for untouched ids: the trailing
    zero row that densifies them);
  * ``inv_sorted`` — (D,) column id -> its run among the sorted unique
    ids, U for untouched ids (B2 writes zeros to those rows);
  * ``rank`` — flat entry -> sorted position (E' for dropped pad entries);
  * ``piece_start``/``piece_run``/``run_piece_start``/``task_piece_start``
    — port only: the schedule of the CUDA run-length kernel (B2). Each run
    of one id is cut into pieces of at most :data:`PIECE` sorted entries;
    a piece never crosses a run; a warp of B2 takes the pieces that start
    in one window of :data:`TASK` sorted entries. See :func:`run_pieces`.

Every leaf the reference has equals the reference's exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# most sorted entries B2 sums in one chain; a hot id's run is cut into
# ceil(count / PIECE) pieces whose partials are then added in piece order
PIECE = 256
# sorted entries of one B2 task window: a warp takes the pieces that start
# in one window [TASK * w, TASK * (w + 1)), so at most TASK pieces and
# fewer than TASK + PIECE entries
TASK = 32


def run_pieces(run_start: torch.Tensor, piece: int = PIECE
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """B2's schedule from the run offsets of id-sorted entries.

    ``run_start`` (U+1,) holds where each run of one id starts in the
    sorted entries, and E' last. Returns int32 ``(piece_start (P+1,),
    piece_run (P,), run_piece_start (U+1,), task_piece_start (T+1,))``:
    piece p covers sorted entries ``[piece_start[p], piece_start[p+1])`` of
    run ``piece_run[p]``, run u owns pieces ``[run_piece_start[u],
    run_piece_start[u+1])``, and task t the pieces ``[task_piece_start[t],
    task_piece_start[t+1])``: those that start in the t-th window of
    :data:`TASK` sorted entries holding a piece start (windows inside a
    long piece hold none and get no task). Pieces tile the entries in order.
    Runs on the tensor's device (the plan builds it on the host, the
    unplanned backward on the card)."""
    run_start = run_start.to(torch.int64)
    dev = run_start.device
    counts = run_start[1:] - run_start[:-1]
    per_run = (counts + piece - 1) // piece
    run_piece_start = torch.cat([torch.zeros(1, dtype=torch.int64,
                                             device=dev),
                                 torch.cumsum(per_run, 0)])
    num_pieces = int(run_piece_start[-1])
    piece_run = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), per_run,
        output_size=num_pieces)
    within = torch.arange(num_pieces, device=dev) - run_piece_start[piece_run]
    piece_start = torch.cat([run_start[piece_run] + within * piece,
                             run_start[-1:]])
    window = piece_start[:-1] // TASK
    task_piece_start = torch.cat([
        torch.nonzero(torch.diff(window, prepend=window.new_full((1,), -1))
                      ).squeeze(1), run_piece_start[-1:]])
    return (piece_start.to(torch.int32), piece_run.to(torch.int32),
            run_piece_start.to(torch.int32), task_piece_start.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class TransposePlan:
    """Precomputed id -> entries transposition of a padded-COO batch."""

    class_src: tuple[torch.Tensor, ...]   # per class: (uc*c,) into entries
    class_samp: tuple[torch.Tensor, ...]  # per class: (uc*c,) sample index
    class_mask: tuple[torch.Tensor, ...]  # per class: (uc*c,) 0/1 pad mask
    class_width: tuple[int, ...]
    row_ids: torch.Tensor        # (E',) sorted column ids
    sample_sorted: torch.Tensor  # (E',) entry -> sample n
    slot_sorted: torch.Tensor    # (E',) entry -> slot k
    order: torch.Tensor          # (E',) sorted pos -> flat entry
    rank: torch.Tensor           # (N*K,) flat entry -> sorted pos
    inv_compact: torch.Tensor    # (D,) id -> compact row (U: zero row)
    inv_sorted: torch.Tensor     # (D,) id -> sorted-unique row
    piece_start: torch.Tensor    # (P+1,) B2 piece -> first sorted entry
    piece_run: torch.Tensor      # (P,) B2 piece -> run (sorted-unique row)
    run_piece_start: torch.Tensor  # (U+1,) run -> its first piece
    task_piece_start: torch.Tensor  # (T+1,) B2 warp task -> first piece
    num_rows: int      # D (padded Theta rows)
    num_entries: int   # N*K
    num_kept: int      # E' after the pad-id drop
    num_unique: int    # U distinct kept ids

    def to(self, device) -> "TransposePlan":
        """The same plan with every tensor on ``device``."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                moved[f.name] = v.to(device)
            elif f.name in ("class_src", "class_samp", "class_mask"):
                moved[f.name] = tuple(t.to(device) for t in v)
        return dataclasses.replace(self, **moved)

    @property
    def device(self) -> torch.device:
        return self.row_ids.device

    def validate(self, ids_shape: tuple, theta_rows: int) -> None:
        n, k = ids_shape
        if n * k != self.num_entries:
            raise ValueError(
                f"plan was built for {self.num_entries} entries, batch has "
                f"{n}x{k}={n * k}")
        if theta_rows != self.num_rows:
            raise ValueError(
                f"plan was built for {self.num_rows} Theta rows, got "
                f"{theta_rows}")


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def assemble_plan_from_sorted(srt, order, *, num_rows: int, num_entries: int,
                              num_cols: int) -> TransposePlan:
    """A :class:`TransposePlan` (on the host) from already-sorted entries.

    ``srt`` (E',) holds the kept column ids sorted ascending (stable in
    flat entry order within equal ids), ``order`` (E',) the flat entry of
    each sorted position in the (N, ``num_cols``) grid of
    ``num_entries`` = N * K entries; ``num_rows`` is D."""
    srt = np.asarray(srt, np.int64)
    order = np.asarray(order, np.int64)
    e_kept = int(srt.size)
    k = int(num_cols)
    e = int(num_entries)

    uniq, counts = np.unique(srt, return_counts=True)
    u = int(uniq.size)
    ptr = (np.concatenate([[0], np.cumsum(counts)]) if u
           else np.zeros(1, np.int64))

    # popularity classes: width c = 2^ceil(log2(count)), ids padded to c
    cls = np.ones_like(counts)
    if u:
        cls = np.where(counts <= 1, 1,
                       1 << np.ceil(np.log2(counts)).astype(np.int64))
    class_src, class_samp, class_mask, class_width = [], [], [], []
    dest_parts = []
    for c in np.unique(cls):
        sel = np.nonzero(cls == c)[0]
        js = np.arange(int(c))
        pos = ptr[sel][:, None] + js[None, :]          # sorted positions
        valid = js[None, :] < counts[sel][:, None]
        src = order[np.where(valid, pos, 0)]           # flat entries
        class_src.append(_i32(src.reshape(-1)))
        class_samp.append(_i32(src.reshape(-1) // k))
        class_mask.append(_i32(valid.reshape(-1)))
        class_width.append(int(c))
        dest_parts.append(sel)

    # compact row order == class-major order of the unique ids
    inv_compact = np.full(num_rows, u, np.int64)
    if dest_parts:
        compact_pos = np.empty(u, np.int64)
        compact_pos[np.concatenate(dest_parts)] = np.arange(u)
        inv_compact[uniq] = compact_pos
    inv_sorted = np.full(num_rows, u, np.int64)
    inv_sorted[uniq] = np.arange(u)
    rank = np.full(e, e_kept, np.int64)
    rank[order] = np.arange(e_kept)
    piece_start, piece_run, run_piece_start, task_piece_start = run_pieces(
        torch.from_numpy(ptr.astype(np.int64)))

    return TransposePlan(
        class_src=tuple(class_src), class_samp=tuple(class_samp),
        class_mask=tuple(class_mask), class_width=tuple(class_width),
        row_ids=_i32(srt), sample_sorted=_i32(order // k),
        slot_sorted=_i32(order % k), order=_i32(order), rank=_i32(rank),
        inv_compact=_i32(inv_compact), inv_sorted=_i32(inv_sorted),
        piece_start=piece_start, piece_run=piece_run,
        run_piece_start=run_piece_start, task_piece_start=task_piece_start,
        num_rows=int(num_rows),
        num_entries=e, num_kept=e_kept, num_unique=u)


def build_transpose_plan(ids, num_rows: int, *,
                         pad_id: int | None = None) -> TransposePlan:
    """The per-batch plan, built on the host (numpy; tensors on the CPU).

    ``ids`` (N, K) are the batch's column ids (a numpy array or a tensor,
    copied to the host), ``num_rows`` is D, the rows of the PADDED Theta.
    Entries whose id is ``pad_id`` are dropped: their values are 0 and the
    pad row's cotangent is exactly 0 either way. Move the plan to the
    device once with :meth:`TransposePlan.to`."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    ids = np.asarray(ids)
    if ids.ndim != 2:
        raise ValueError(f"ids must be (N, K), got {ids.shape}")
    n, k = ids.shape
    e = n * k
    flat = ids.reshape(-1).astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= num_rows):
        raise ValueError(
            f"ids out of range [0, {num_rows}): [{flat.min()}, {flat.max()}]")
    keep_flat = np.arange(e, dtype=np.int64)
    if pad_id is not None:
        keep_flat = keep_flat[flat != pad_id]
    kept_ids = flat[keep_flat]
    order_kept = np.argsort(kept_ids, kind="stable")
    return assemble_plan_from_sorted(
        kept_ids[order_kept], keep_flat[order_kept], num_rows=num_rows,
        num_entries=e, num_cols=k)
