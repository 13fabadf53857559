"""AdamW over a dict or a list of tensors (the LM training substrate).

The port's counterpart of ``repro/optim/adamw.py``, with its arithmetic
and its order of operations: bias-corrected moments, and the decoupled
weight decay inside the lr term,

    p <- p + (-lr * (m * s1 / (sqrt(v * s2) + eps) + wd * p)),
    s1 = 1 / (1 - b1^t), s2 = 1 / (1 - b2^t),

where ``torch.optim.AdamW`` multiplies p by (1 - lr * wd) first and
divides by the bias corrections in another order. ``lr`` is a float or a
callable of the step count t (an int, 1 at the first update). The
moments are fp32 and live on the parameters' device; :meth:`AdamW.apply`
writes the new parameters into the tensors it is given (the reference
returns new arrays), so a model's parameters are updated in place.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, NamedTuple

import torch

Tensors = dict | list


def _zip(*trees) -> list[tuple]:
    """The leaves of dicts with one key set (in the first one's order),
    or of lists of one length, side by side."""
    first = trees[0]
    if isinstance(first, Mapping):
        if any(set(t) != set(first) for t in trees[1:]):
            raise ValueError("the dicts do not have the same keys")
        return [tuple(t[k] for t in trees) for k in first]
    if any(len(t) != len(first) for t in trees[1:]):
        raise ValueError("the lists do not have the same length")
    return list(zip(*trees))


def _map(fn, *trees):
    """``fn`` over the leaves of :func:`_zip`; the result has the first
    tree's structure."""
    out = [fn(*leaves) for leaves in _zip(*trees)]
    return dict(zip(trees[0], out)) if isinstance(trees[0], Mapping) else out


class AdamWState(NamedTuple):
    mu: Tensors
    nu: Tensors
    count: int


class AdamW(NamedTuple):
    lr: float | Callable[[int], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> AdamWState:
        """Zero fp32 moments shaped like ``params`` (a dict, or any
        iterable of tensors, taken as a list), on their devices."""
        if not isinstance(params, Mapping):
            params = list(params)

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(mu=_map(zeros, params), nu=_map(zeros, params),
                          count=0)

    def _scales(self, count: int):
        lr = self.lr(count) if callable(self.lr) else self.lr
        return (lr,) + _bias_scales(self.b1, self.b2, count)

    def _leaf(self, g, m, v, p, lr, mu_hat_scale, nu_hat_scale):
        """One leaf's step: ``m`` and ``v`` become the new moments, in
        place; returns the update, -lr * (m^ / (sqrt(v^) + eps) + wd p)."""
        g = g.float()
        m.mul_(self.b1).add_((1 - self.b1) * g)
        v.mul_(self.b2).add_((1 - self.b2) * g * g)
        den = torch.sqrt(v * nu_hat_scale).add_(self.eps)
        return (m * mu_hat_scale).div_(den).add_(
            self.weight_decay * p).mul_(-lr)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(updates, new state): the moments are new tensors, the inputs
        are left as they were."""
        count = state.count + 1
        scales = self._scales(count)
        mu = _map(torch.clone, state.mu)
        nu = _map(torch.clone, state.nu)
        updates = _map(lambda g, m, v, p: self._leaf(g, m, v, p, *scales),
                       grads, mu, nu, params)
        return updates, AdamWState(mu=mu, nu=nu, count=count)

    @torch.no_grad()
    def apply(self, grads, state: AdamWState, params):
        """One step: ``params`` (the same tensors) updated in place, and
        the new state, whose moments are ``state``'s tensors updated in
        place. Returns (params, state). The arithmetic is
        :meth:`update`'s, leaf by leaf, so at most one leaf's update is
        held at a time."""
        count = state.count + 1
        scales = self._scales(count)
        for g, m, v, p in _zip(grads, state.mu, state.nu, params):
            p.add_(self._leaf(g, m, v, p, *scales))
        return params, AdamWState(mu=state.mu, nu=state.nu, count=count)


def _bias_scales(b1: float, b2: float, count: int) -> tuple[float, float]:
    """1 / (1 - b1^t) and 1 / (1 - b2^t), computed in fp32 as the
    reference computes them, returned as Python floats (exact)."""
    t = torch.tensor(count, dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    s1 = one / (one - torch.tensor(b1, dtype=torch.float32) ** t)
    s2 = one / (one - torch.tensor(b2, dtype=torch.float32) ** t)
    return float(s1), float(s2)
