"""Objective Eq. 4/5 on sparse batches:
f(Theta) = NLL + lambda*||Theta||_{2,1} + beta*||Theta||_1.

The port's counterpart of the sparse half of ``repro/core/objective.py``
(the dense ``nll`` and ``nll_common_feature`` arrive with the dense path).
Theta is one unpadded (d, 2m) tensor. The smooth part (the NLL) is
differentiable; the regularisers are handled by the optimizer through
directional derivatives (Eq. 9), so :func:`smooth_loss_and_grad` is what
OWLQN+ consumes.

``nll_sparse`` applies the common-feature trick (Eq. 13): the user
region logits are computed once per session and gathered per sample.
Both gather-matmuls run on the fused sparse forward (B1 on the card) and
differentiate through its scatter backward (B2 on the card), driven by the
batch's transpose plans. The per-sample gather ``z_user[session_id]``
differentiates by ``index_put_`` with accumulation, which sums a
session's samples in a fixed order on the card as on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import regularizers
from repro_torch.kernels.lsplm_sparse_fused.ops import (
    logps_from_z,
    pad_theta,
    sparse_gather_matmul,
)


def _nll_from_logps(log_p1, log_p0, y, weight=None) -> torch.Tensor:
    per = -(y * log_p1 + (1.0 - y) * log_p0)
    if weight is not None:
        per = per * weight
    return per.sum()


def nll_sparse(theta: torch.Tensor, batch) -> torch.Tensor:
    """Eq. 5 (summed) on a padded-COO batch (``SparseCTRBatch``), user
    logits once per session (Eq. 13)."""
    tp = pad_theta(theta)
    z_user = sparse_gather_matmul(batch.user_ids, batch.user_vals, tp,
                                  plan=batch.user_plan)
    z_ad = sparse_gather_matmul(batch.ad_ids, batch.ad_vals, tp,
                                plan=batch.ad_plan)
    z = z_user[batch.session_id.long()] + z_ad
    log_p1, log_p0 = logps_from_z(z)
    return _nll_from_logps(log_p1, log_p0, batch.y.to(log_p1.dtype))


def objective(theta: torch.Tensor, batch, lam: float,
              beta: float) -> torch.Tensor:
    """f(Theta), Eq. 4, on a sparse batch."""
    return (nll_sparse(theta, batch) + lam * regularizers.l21_norm(theta)
            + beta * regularizers.l1_norm(theta))


def smooth_loss_and_grad(theta: torch.Tensor, batch
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, dloss/dTheta) of the smooth NLL, both detached; Theta itself
    is not modified and keeps no graph."""
    leaf = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = nll_sparse(leaf, batch)
    (grad,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), grad
