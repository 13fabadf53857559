"""Attention over a whole sequence: kernel on the card, plain version on
the CPU.

The port's counterpart of ``repro/kernels/flash_attention/ops.py``. A
CUDA q launches the hand-written kernel (``flash_attention.py``, B6) on
the KV-head-sized k and v; a CPU q takes :func:`plain_attention`; there
is no fallback. The model's full-sequence attention calls
:func:`causal_attention` (the reference's model calls
``layers.chunked_causal_attention`` there).

On the card, :func:`causal_attention` goes through a
``torch.autograd.Function``: B6 computes the forward, and the backward
is :func:`attention_backward_plain`, the plain version's gradient
recomputed from the saved q, k and v. The reference has no backward
kernel (its Pallas call defines no VJP, and its model trains through
the jnp chunked attention), so this is the gradient the reference takes.
The recompute goes one query chunk at a time: a chunk's fp32 scores at
llama3.2-1b's 4 x 4,096 are (4, 32, 512, 4,096), 1.07 GB, and the whole
graph at once would hold eight of them with their softmax.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_inputs,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import (
    NEG_INF,
    chunked_causal_attention,
    repeat_kv,
)


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


def _chunk_attention(qf, kf, vf, c0, causal, dtype):
    """One query chunk of :func:`plain_attention`'s arithmetic: qf (B, c,
    H, hd) at positions c0.., kf and vf (B, S', H, hd) fp32 (causal: the
    keys up to the chunk's last position, since the later ones add exact
    zeros), rounded to ``dtype``."""
    hd = qf.shape[-1]
    s = torch.einsum("bqhd,bshd->bhqs", qf, kf) * hd ** -0.5
    if causal:
        qpos = torch.arange(c0, c0 + qf.shape[1], device=qf.device)
        kpos = torch.arange(kf.shape[1], device=qf.device)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                        NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, vf).to(dtype)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             chunk: int = 512, *, causal: bool = True):
    """(dq, dk, dv) of :func:`plain_attention` for the output gradient
    ``do`` (B, S, H, hd), recomputed one query chunk at a time under
    autograd, on any device. dk and dv are summed over the chunks in fp32
    at H heads, rounded to k's dtype once and then summed over each KV
    head's ``rep`` query heads, as autograd of :func:`plain_attention`
    does; the fp32 sum over chunks goes in another order than autograd's,
    so the result is that gradient up to rounding, not bit for bit."""
    check_inputs("attention_backward_plain", q, k, v)
    B, S, H, hd = q.shape
    kvh, dtype = k.shape[2], q.dtype
    rep = H // kvh
    chunk = min(chunk, S) if causal else S
    f32 = torch.float32
    kf = repeat_kv(k, rep).to(f32)
    vf = repeat_kv(v, rep).to(f32)
    dq = torch.empty_like(q)
    dkf = torch.zeros(kf.shape, dtype=f32, device=q.device)
    dvf = torch.zeros(vf.shape, dtype=f32, device=q.device)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        keys = c1 if causal else S
        with torch.enable_grad():
            qc = q[:, c0:c1].to(f32).requires_grad_()
            kc = kf[:, :keys].detach().requires_grad_()
            vc = vf[:, :keys].detach().requires_grad_()
            o = _chunk_attention(qc, kc, vc, c0, causal, dtype)
            gq, gk, gv = torch.autograd.grad(o, (qc, kc, vc), do[:, c0:c1])
        dq[:, c0:c1] = gq.to(dtype)
        dkf[:, :keys] += gk
        dvf[:, :keys] += gv
        del o, gq, gk, gv

    def per_kv_head(g):
        g = g.to(dtype)
        return g if rep == 1 else g.reshape(B, S, kvh, rep, hd).sum(3)

    return dq, per_kv_head(dkf), per_kv_head(dvf)


class _FlashAttention(torch.autograd.Function):
    """B6 forward, :func:`attention_backward_plain` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward_plain(q, k, v, do.contiguous(),
                                              ctx.chunk, causal=ctx.causal)
        return dq, dk, dv, None, None


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, chunk: int = 512) -> torch.Tensor:
    """(B, S, H, hd) in q's dtype, on q's device. k and v are (B, S, KVH,
    hd); ``chunk`` is the plain version's query chunk (and, on the card,
    the backward's). Differentiable on both devices."""
    if q.device.type == "cuda":
        return _FlashAttention.apply(q, k, v, causal, chunk)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal=causal, chunk=chunk)
    raise ValueError(f"unsupported device {q.device}")
