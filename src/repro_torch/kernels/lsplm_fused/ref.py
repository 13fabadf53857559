"""Plain PyTorch version of the dense fused LS-PLM forward (Eq. 2).

The same arithmetic as ``repro/kernels/lsplm_fused/ref.py``: both
contractions in fp32 (bf16 inputs are widened first, so their products
are exact and only the sum rounds, as ``preferred_element_type=float32``
does), softmax over the gate columns, sigmoid of the fit columns, their
dot product, cast to x's dtype.
"""
from __future__ import annotations

import torch


def lsplm_forward_ref(x: torch.Tensor, u: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Eq. 2: sum_i softmax_i(xU) sigmoid(xW_i). x (B, d) -> (B,)."""
    zu = x.to(torch.float32) @ u.to(torch.float32)
    zw = x.to(torch.float32) @ w.to(torch.float32)
    gate = torch.softmax(zu, dim=-1)
    fit = torch.sigmoid(zw)
    return (gate * fit).sum(dim=-1).to(x.dtype)
