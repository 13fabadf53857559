"""Direct oracles of the sparse backward (plain PyTorch, any dtype).

The port's counterpart of ``repro/kernels/lsplm_sparse_scatter/ref.py``
and ``ops.py:67 scatter_add_ref``:

    dTheta[r]  = sum_{(n,k): ids[n,k]=r} vals[n,k] * dz[n]
    dvals[n,k] = theta[ids[n,k]] . dz[n]

Conventions match the fused forward package: ids (N, K) with pad id D-1,
vals 0 on pad slots, theta (D, 2m) with the zero pad row last.
``index_add_`` sums in entry order on the CPU; on the card it adds with
atomics in a varying order, so the port's card path never uses it.
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
