"""Plain PyTorch version of the Eq. 9 descent direction.

The same arithmetic as ``repro/core/direction.py:descent_direction``
(which the reference's ``owlqn_direction/ref.py`` re-exports): the
bounded direction minimising the directional derivative of
f = loss + lam*||Theta||_{2,1} + beta*||Theta||_1 (Proposition 2). With
lam = 0 it is OWLQN's negative pseudo-gradient. Theta and grad are
(d, 2m); feature rows are the L2,1 groups. Exact zeros matter: the
element test is ``theta != 0`` (-0.0 counts as zero) and sign(+-0) = 0.
"""
from __future__ import annotations

import torch


def _row_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def owlqn_direction_ref(theta: torch.Tensor, grad: torch.Tensor, lam: float,
                        beta: float) -> torch.Tensor:
    """The direction d of Eq. 9; grad is the smooth loss's gradient."""
    g = -grad
    rn = _row_norm(theta)
    row_nonzero = rn > 0.0
    safe_rn = torch.where(row_nonzero, rn, torch.ones_like(rn))
    # s = -grad - lam * Theta_ij / ||Theta_i.||   (used where the row != 0)
    s = g - lam * theta / safe_rn
    # case a: Theta_ij != 0
    d_a = s - beta * torch.sign(theta)
    # case b: Theta_ij == 0 in a live row -> soft-threshold s by beta
    d_b = torch.clamp(s.abs() - beta, min=0.0) * torch.sign(s)
    # case c: the whole row is zero -> v = softthresh(g, beta), shrink by lam
    v = torch.clamp(g.abs() - beta, min=0.0) * torch.sign(g)
    vn = _row_norm(v)
    safe_vn = torch.where(vn > 0.0, vn, torch.ones_like(vn))
    d_c = torch.clamp(vn - lam, min=0.0) / safe_vn * v
    return torch.where(row_nonzero, torch.where(theta != 0.0, d_a, d_b), d_c)
