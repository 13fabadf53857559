"""Plain gather+einsum oracle for the fused sparse LS-PLM forward.

The port's counterpart of ``repro/kernels/lsplm_sparse_fused/ref.py``:
it materialises the (N, K, 2m) gathered rows and reduces them with one
einsum. Conventions (shared by kernels, ops and oracle):

    ids   (N, K) int32    active column ids; pad slots carry id == D-1
    vals  (N, K) float32  feature values; 0.0 on pad slots
    theta (D, 2m) float32 PADDED parameters -- the last row is all zeros

with D = d + 1 (``ops.pad_theta`` appends the zero row).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sparse_matmul_ref(ids: torch.Tensor, vals: torch.Tensor,
                      theta: torch.Tensor) -> torch.Tensor:
    """z[n] = sum_k vals[n,k] * theta[ids[n,k], :].  (N, K) -> (N, 2m)."""
    rows = theta[ids.long()]  # (N, K, 2m)
    return torch.einsum("nk,nkm->nm", vals.to(rows.dtype), rows)


def lsplm_sparse_forward_ref(ids: torch.Tensor, vals: torch.Tensor,
                             theta: torch.Tensor) -> torch.Tensor:
    """p(y=1|x) per Eq. 2 on padded-COO inputs. Returns (N,)."""
    z = sparse_matmul_ref(ids, vals, theta)
    m = theta.shape[-1] // 2
    gate = torch.softmax(z[..., :m], dim=-1)
    fit = torch.sigmoid(z[..., m:])
    return (gate * fit).sum(dim=-1)


def lsplm_sparse_logps_ref(ids: torch.Tensor, vals: torch.Tensor,
                           theta: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Numerically stable (log_p1, log_p0) for the NLL (Eq. 5), sparse."""
    z = sparse_matmul_ref(ids, vals, theta)
    m = theta.shape[-1] // 2
    log_gate = torch.log_softmax(z[..., :m], dim=-1)
    log_p1 = torch.logsumexp(log_gate + F.logsigmoid(z[..., m:]), dim=-1)
    log_p0 = torch.logsumexp(log_gate + F.logsigmoid(-z[..., m:]), dim=-1)
    return log_p1, log_p0
