"""Objective Eq. 4/5:
f(Theta) = NLL + lambda*||Theta||_{2,1} + beta*||Theta||_1.

The port's counterpart of ``repro/core/objective.py``. Theta is one
unpadded (d, 2m) tensor (feature rows are the L2,1 groups). The smooth
part (the NLL) is differentiable; the regularisers are handled by the
optimizer through directional derivatives (Eq. 9), so
:func:`smooth_loss_and_grad` is what OWLQN+ consumes. Three batch forms
dispatch here:

  * ``CTRBatch`` -- dense rows x (B, d): :func:`nll`;
  * ``CommonFeatureBatch`` (``common_feature=True``) -- the §3.2 storage,
    user columns once per session: :func:`nll_common_feature`, Eq. 13,
    z = x_c Theta_c (once per session, gathered) + x_nc Theta_nc. Both
    dense products are plain ``torch.matmul`` in fp32, as the reference
    leaves them to XLA; autograd gives their transposed products;
  * padded-COO sparse batches (detected by their id fields):
    :func:`nll_sparse`, which applies Eq. 13 the same way. Both
    gather-matmuls run on the fused sparse forward (B1 on the card) and
    differentiate through its scatter backward (B2 on the card), driven
    by the batch's transpose plans.

The per-sample gather ``z_user[session_id]`` differentiates by
``index_put_`` with accumulation, which sums a session's samples in a
fixed order on the card as on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import regularizers
from repro_torch.core.lsplm import params_from_theta, predict_logits_stable
from repro_torch.kernels.lsplm_sparse_fused.ops import (
    logps_from_z,
    pad_theta,
    sparse_gather_matmul,
)


class CTRBatch(NamedTuple):
    """A plain (uncompressed) dense batch on one device."""

    x: torch.Tensor  # (B, d) float32
    y: torch.Tensor  # (B,) float32 in {0, 1}
    weight: torch.Tensor | None = None  # (B,) optional sample weights


class CommonFeatureBatch(NamedTuple):
    """Compressed batch per §3.2 (Eq. 13). The first d_c feature columns
    are "common" (user features shared by one page view's samples), the
    remaining d_nc per sample (ad features): x = [x_common ; x_noncommon].
    """

    x_common: torch.Tensor  # (G, d_c) one row per session
    x_noncommon: torch.Tensor  # (B, d_nc)
    session_id: torch.Tensor  # (B,) int32 in [0, G)
    y: torch.Tensor  # (B,) float32
    weight: torch.Tensor | None = None  # (B,) optional sample weights


def _nll_from_logps(log_p1, log_p0, y, weight=None) -> torch.Tensor:
    per = -(y * log_p1 + (1.0 - y) * log_p0)
    if weight is not None:
        per = per * weight
    return per.sum()


def nll(theta: torch.Tensor, batch: CTRBatch) -> torch.Tensor:
    """Eq. 5 -- the total (summed) negative log-likelihood of dense rows."""
    log_p1, log_p0 = predict_logits_stable(params_from_theta(theta), batch.x)
    return _nll_from_logps(log_p1, log_p0, batch.y.to(log_p1.dtype),
                           batch.weight)


def nll_common_feature(theta: torch.Tensor,
                       batch: CommonFeatureBatch) -> torch.Tensor:
    """Eq. 5 with the common-feature decomposition (Eq. 13):
    z = x_c @ Theta_c (once per session, gathered) + x_nc @ Theta_nc."""
    d_c = batch.x_common.shape[-1]
    z_c = batch.x_common @ theta[:d_c]  # (G, 2m), once per session
    z = z_c[batch.session_id.long()] + batch.x_noncommon @ theta[d_c:]
    log_p1, log_p0 = logps_from_z(z)
    return _nll_from_logps(log_p1, log_p0, batch.y.to(log_p1.dtype),
                           batch.weight)


def is_sparse_batch(batch) -> bool:
    """Structural check for a padded-COO sparse batch (SparseCTRBatch)."""
    return hasattr(batch, "ad_ids") and hasattr(batch, "user_ids")


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


def _nll_fn(batch, common_feature: bool = False):
    """The NLL a batch takes: sparse batches their own, dense ones
    :func:`nll_common_feature` or :func:`nll`."""
    if is_sparse_batch(batch):
        return nll_sparse
    return nll_common_feature if common_feature else nll


def objective(theta: torch.Tensor, batch, lam: float, beta: float, *,
              common_feature: bool = False) -> torch.Tensor:
    """f(Theta), Eq. 4, on a dense, common-feature or sparse batch."""
    loss = _nll_fn(batch, common_feature)(theta, batch)
    return (loss + lam * regularizers.l21_norm(theta)
            + beta * regularizers.l1_norm(theta))


def smooth_loss_and_grad(theta: torch.Tensor, batch, *,
                         common_feature: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, dloss/dTheta) of the smooth NLL, both detached; Theta itself
    is not modified and keeps no graph."""
    leaf = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = _nll_fn(batch, common_feature)(leaf, batch)
    (grad,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), grad
