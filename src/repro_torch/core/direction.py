"""Eq. 8-10: the descent direction of the non-convex non-smooth objective.

The port's counterpart of ``repro/core/direction.py``.
:func:`descent_direction` is Proposition 2 (Eq. 9) -- the bounded
direction minimising the directional derivative f'(Theta; d) of

    f = loss + lam*||Theta||_{2,1} + beta*||Theta||_1 ;

with lam = 0 it is OWLQN's negative pseudo-gradient. On a CUDA Theta it
runs the hand-written Eq. 9 kernel (``kernels/owlqn_direction``, B3), on
a CPU Theta its plain version. Theta and grad are (d, 2m); feature rows
are the L2,1 groups.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.owlqn_direction.ops import direction


def row_norm_keepdims(theta: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((theta * theta).sum(dim=-1, keepdim=True))


def descent_direction(theta: torch.Tensor, grad: torch.Tensor, lam: float,
                      beta: float) -> torch.Tensor:
    """The direction d of Eq. 9; grad is the smooth loss's gradient."""
    return direction(theta, grad, lam, beta)


def project_orthant(theta: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Eq. 8: pi(Theta; Omega) -- zero the entries whose sign disagrees."""
    return torch.where(torch.sign(theta) == torch.sign(omega), theta,
                       torch.zeros_like(theta))


def choose_orthant(theta: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Eq. 10: xi = sign(Theta) where Theta != 0, else sign(d)."""
    return torch.where(theta != 0.0, torch.sign(theta), torch.sign(d))


def directional_derivative(theta: torch.Tensor, grad: torch.Tensor,
                           d: torch.Tensor, lam: float, beta: float,
                           reduce=None) -> torch.Tensor:
    """f'(Theta; d) in closed form (Lemma 1 / Appendix A, Eq. 15+18+19).
    On a row-sharded Theta ``reduce`` (the mesh's sum over ``model``)
    turns this rank's partial into the global value."""
    smooth = torch.dot(grad.reshape(-1), d.reshape(-1))
    rn = row_norm_keepdims(theta)[..., 0]
    row_nonzero = rn > 0.0
    safe_rn = torch.where(row_nonzero, rn, torch.ones_like(rn))
    inner = (theta * d).sum(dim=-1)
    dnorm = torch.sqrt((d * d).sum(dim=-1))
    l21_term = torch.where(row_nonzero, inner / safe_rn, dnorm).sum()
    l1_term = torch.where(theta != 0.0, torch.sign(theta) * d,
                          d.abs()).sum()
    local = smooth + lam * l21_term + beta * l1_term
    return local if reduce is None else reduce(local)
