"""Attention over a whole sequence: kernel on the card, plain version on
the CPU.

The port's counterpart of ``repro/kernels/flash_attention/ops.py``. A
CUDA q launches the hand-written kernel (``flash_attention.py``, B6) on
the KV-head-sized k and v; a CPU q takes :func:`plain_attention`; there
is no fallback. The model's full-sequence attention calls
:func:`causal_attention` (the reference's model calls
``layers.chunked_causal_attention`` there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_inputs,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import chunked_causal_attention, repeat_kv


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 512) -> torch.Tensor:
    """B6's plain version, on any device: k and v GQA-repeated, then
    ``chunked_causal_attention`` (causal) or ``attention_ref`` (not)."""
    check_inputs("plain_attention", q, k, v)
    rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    if causal:
        return chunked_causal_attention(q, k, v, chunk=chunk)
    return attention_ref(q, k, v, causal=False)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, chunk: int = 512) -> torch.Tensor:
    """(B, S, H, hd) in q's dtype, on q's device. k and v are (B, S, KVH,
    hd); ``chunk`` is the plain version's query chunk."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal=causal, chunk=chunk)
    raise ValueError(f"unsupported device {q.device}")
