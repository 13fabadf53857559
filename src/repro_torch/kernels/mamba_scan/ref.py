"""Plain PyTorch oracle of the Mamba1 selective scan: a loop over time.

The port's counterpart of ``repro/kernels/mamba_scan/ref.py``, with its
contract and op order: inputs widened to fp32; per step
da = exp(dt A), h = da h + (dt x) B, y = h . C; then y + D x, returned
in x's dtype, with the final state hT in fp32.

The sum y = h . C over the N states is taken by folding halves
(n + N/2 onto n, then N/4, ...) where N is a power of two: B7 folds in
that order too (each thread its own states first, then shuffles across
the lanes of a channel), so on the card the kernel and this version do
the same fp32 operations in the same order. (The reference's einsum
leaves the order to XLA; any order is within its 2e-5 bar, but one-ulp
differences in y, rounded to bf16 and carried through 64 layers, move
the logits by more than the model's 5e-2 bar.)
"""
from __future__ import annotations

import torch


def _fold_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by folding halves (B7's order) when its size
    is a power of two, else torch's sum."""
    n = p.shape[-1]
    if n & (n - 1):
        return p.sum(-1)
    while n > 1:
        n //= 2
        p = p[..., :n] + p[..., n:]
    return p[..., 0]


def mamba1_scan_ref(dt, x, B_in, C_in, A, D, h0=None):
    """dt, x (B, S, di), B_in, C_in (B, S, N), A (di, N), D (di,), h0
    (B, di, N) or None (zeros) -> (y (B, S, di) in x's dtype, hT (B, di,
    N) fp32)."""
    Bb, S, di = x.shape
    N = B_in.shape[-1]
    f32 = torch.float32
    dt, xf = dt.to(f32), x.to(f32)
    Bf, Cf, Af = B_in.to(f32), C_in.to(f32), A.to(f32)
    h = (torch.zeros((Bb, di, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = torch.empty((Bb, S, di), dtype=f32, device=x.device)
    for t in range(S):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * Af[None])
        h = da * h + (dt_t * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys[:, t] = _fold_sum(h * Cf[:, t, None, :])
    y = ys + D.to(f32)[None, None] * xf
    return y.to(x.dtype), h
