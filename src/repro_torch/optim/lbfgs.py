"""Limited-memory BFGS two-loop recursion on one tensor.

The port's counterpart of ``repro/optim/lbfgs.py``, on a single parameter
tensor (the sparse path's (d, 2m) Theta is its only leaf). The history is
a RING BUFFER of ``memory`` (s, y) slots, filled in place, in place of the
reference's concatenate-roll; :func:`two_loop` visits the pairs newest to
oldest and back, as the reference does. A pair with y.s <= eps is stored
but masked out (the paper's §2.2.2 positive-definiteness safeguard); with
no valid pair the two-loop returns d scaled by gamma = 1, i.e. d.

``rho`` and ``gamma`` stay float32 tensors on the parameters' device; the
validity flags live on the host, which costs one sync per push.

On a row-sharded Theta (``repro_torch.dist``) each rank holds its rows of
the parameters and of the history; ``reduce`` (the mesh's sum over its
``model`` group) turns each rank's partial dot product into the global
one, so every rank takes the same branch. Without it the dots are local.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over all elements, as a 0-dim tensor of their dtype."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclass
class LBFGSHistory:
    s: torch.Tensor  # (M, *shape) slot storage
    y: torch.Tensor  # (M, *shape)
    rho: torch.Tensor  # (M,) 1/(y.s), 0 where invalid
    gamma: torch.Tensor  # () (s.y)/(y.y) of the newest valid pair, else 1
    valid: list[bool] = field(default_factory=list)  # per slot
    newest: int = -1  # slot of the newest pair, -1 before the first push

    @property
    def memory(self) -> int:
        return self.s.shape[0]

    def newest_first(self) -> list[int]:
        """Slots from the newest pair to the oldest (filled slots only)."""
        m = self.memory
        if self.newest < 0:
            return []
        return [(self.newest - i) % m for i in range(m)
                if (self.newest - i) % m < len(self.valid)]


def init_history(like: torch.Tensor, memory: int) -> LBFGSHistory:
    return LBFGSHistory(
        s=like.new_zeros((memory, *like.shape)),
        y=like.new_zeros((memory, *like.shape)),
        rho=like.new_zeros((memory,)),
        gamma=like.new_ones(()))


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def push(history: LBFGSHistory, s_new: torch.Tensor, y_new: torch.Tensor,
         eps: float = 1e-10, reduce=None) -> LBFGSHistory:
    """Store (s, y) in the oldest slot, in place; the pair is masked when
    y.s <= eps. Returns ``history``."""
    if reduce is None:
        ys, yy = vdot(y_new, s_new), vdot(y_new, y_new)
    else:  # one reduction for both dots
        ys, yy = reduce(torch.stack([vdot(y_new, s_new),
                                     vdot(y_new, y_new)]))
    ok = bool(ys > eps)
    slot = (history.newest + 1) % history.memory
    history.s[slot].copy_(s_new)
    history.y[slot].copy_(y_new)
    history.rho[slot] = (1.0 / ys) if ok else 0.0
    if ok:
        history.gamma = ys / torch.where(yy > 0, yy, torch.ones_like(yy))
    if slot < len(history.valid):
        history.valid[slot] = ok
    else:
        history.valid.append(ok)
    history.newest = slot
    return history


def two_loop(history: LBFGSHistory, d: torch.Tensor,
             reduce=None) -> torch.Tensor:
    """H @ d (H the implicit inverse Hessian); d plays the part the
    negative gradient plays in smooth L-BFGS. Returns a new tensor."""
    reduce = _identity if reduce is None else reduce
    q = d.clone()
    slots = [i for i in history.newest_first() if history.valid[i]]
    alphas = {}
    for i in slots:  # newest -> oldest
        a = history.rho[i] * reduce(vdot(history.s[i], q))
        q.addcmul_(history.y[i], -a)
        alphas[i] = a
    q.mul_(history.gamma)
    for i in reversed(slots):  # oldest -> newest
        b = history.rho[i] * reduce(vdot(history.y[i], q))
        q.addcmul_(history.s[i], alphas[i] - b)
    return q


def any_valid(history: LBFGSHistory) -> bool:
    return any(history.valid)
