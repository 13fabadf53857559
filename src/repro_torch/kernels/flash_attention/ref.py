"""Plain PyTorch oracle of flash attention: materialised scores.

The port's counterpart of ``repro/kernels/flash_attention/ref.py``: fp32
scores scaled by hd^-0.5, -inf above the diagonal when causal, fp32
softmax and value sum, the result cast to q's dtype.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q/k/v (B,S,H,hd) -> (B,S,H,hd), fp32 softmax."""
    B, S, H, hd = q.shape
    s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bshd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)
