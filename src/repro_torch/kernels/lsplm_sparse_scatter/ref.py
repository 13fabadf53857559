"""Direct oracles of the sparse backward (plain PyTorch, any dtype).

The port's counterpart of ``repro/kernels/lsplm_sparse_scatter/ref.py``
and ``ops.py:67 scatter_add_ref``:

    dTheta[r]  = sum_{(n,k): ids[n,k]=r} vals[n,k] * dz[n]
    dvals[n,k] = theta[ids[n,k]] . dz[n]

Conventions match the fused forward package: ids (N, K) with pad id D-1,
vals 0 on pad slots, theta (D, 2m) with the zero pad row last.
``index_add_`` sums in entry order on the CPU; on the card it adds with
atomics in a varying order, so the port's card path never uses it.

:func:`scatter_runs_ref` is the port's own: B2's association repeated in
plain PyTorch, the bitwise yardstick of the kernel (tests, the on-card
smoke). No main path calls it.
"""
from __future__ import annotations

import torch


def scatter_add_ref(ids: torch.Tensor, vals: torch.Tensor, dz: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """dTheta (num_rows, 2m) by one ``index_add_`` of every entry."""
    m2 = dz.shape[-1]
    data = (vals[..., None].to(dz.dtype) * dz[:, None, :]).reshape(-1, m2)
    return torch.zeros((num_rows, m2), dtype=dz.dtype,
                       device=dz.device).index_add_(
        0, ids.reshape(-1).long(), data)


def scatter_bwd_ref(ids: torch.Tensor, vals: torch.Tensor,
                    theta: torch.Tensor, dz: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dvals, dTheta) by direct gather/scatter."""
    dtheta = scatter_add_ref(ids, vals, dz, theta.shape[0]).to(theta.dtype)
    rows = theta[ids.long()].to(dz.dtype)
    dvals = torch.einsum("nkm,nm->nk", rows, dz)
    return dvals.to(vals.dtype), dtheta


def _at_least(lengths: torch.Tensor) -> torch.Tensor:
    """n[t] = how many of ``lengths`` are >= t, for t = 0 .. max: the
    first n[t] of them, longest first, are still adding at step t."""
    return torch.bincount(lengths.cpu(), minlength=1).flip(0).cumsum(0).flip(0)


def scatter_runs_ref(layout, vals: torch.Tensor, dz: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """The dense dTheta (num_rows, 2m) float32 summed in B2's order.

    ``layout`` is a ``TransposePlan`` or an ``ops.RunLayout`` (its
    ``order``, ``sample_sorted``, ``piece_start``, ``run_piece_start`` and
    ``inv_sorted``). Each piece sums from 0 in entry order, one rounded
    product then one rounded add a step (the ordered steps run over all
    pieces at once, longest pieces first); each run adds its pieces'
    partials from 0 in piece order. A partial is never -0.0 (a sum from
    +0.0 in round-to-nearest cannot reach it), so the 0 + partial of a
    one-piece run equals the partial B2 writes directly. Untouched rows
    are 0."""
    if layout.inv_sorted.numel() != num_rows:
        raise ValueError(f"the layout is for {layout.inv_sorted.numel()} "
                         f"rows, not {num_rows}")
    m2 = dz.shape[-1]
    dz = dz.to(torch.float32)
    v = vals.reshape(-1).to(torch.float32).index_select(
        0, layout.order.long())
    samp = layout.sample_sorted.long()
    ps = layout.piece_start.long()
    start, length = ps[:-1], ps[1:] - ps[:-1]
    partial = dz.new_zeros((length.numel(), m2))
    by_len = torch.argsort(length, descending=True, stable=True)
    active = _at_least(length)  # pieces still summing at step t
    for t in range(1, active.numel()):
        sel = by_len[:int(active[t])]
        e = start[sel] + (t - 1)
        partial[sel] = partial[sel] + v[e, None] * dz.index_select(0, samp[e])
    rps = layout.run_piece_start.long()
    first, count = rps[:-1], rps[1:] - rps[:-1]
    compact = dz.new_zeros((count.numel() + 1, m2))  # row U stays 0
    by_count = torch.argsort(count, descending=True, stable=True)
    runs_left = _at_least(count)
    for i in range(1, runs_left.numel()):
        sel = by_count[:int(runs_left[i])]
        compact[sel] = compact[sel] + partial.index_select(0,
                                                           first[sel] + i - 1)
    return compact.index_select(0, layout.inv_sorted.long())
