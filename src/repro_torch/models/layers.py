"""Transformer building blocks: plain functions plus the layer modules.

The port's counterpart of ``repro/models/layers.py``, with its
conventions:
  * activations in ``cfg.dtype`` (bf16 by default); norms, rope and the
    softmax in fp32, cast back to the activation dtype;
  * attention is GQA with ``rep = H // KVH``: query head h reads KV head
    ``h // rep`` (:func:`repeat_kv`'s broadcast order);
  * tensors keep the reference's layout: activations (B, S, d), q/k/v
    (B, S, heads, hd), weights (in, out) applied as ``x @ w``.

The reference keeps fp32 parameters and casts each weight to the
activation dtype at every use. The modules here hold the matmul weights
in the activation dtype once, at load: the same bits, without the cast
per call. The rmsnorm scales stay in ``cfg.param_dtype``, since the
reference multiplies by them in fp32.

Full-sequence attention runs on ``kernels/flash_attention/ops`` (B6 on
the card); :func:`chunked_causal_attention` here is its plain causal
version. Decode attention is plain PyTorch, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

NEG_INF = -1e30


# --------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * scale.to(torch.float32)
    return x.to(dt)


def nonparametric_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's LN: no learnable scale/bias (arXiv:2402.00838)."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def apply_norm(x: torch.Tensor, scale: torch.Tensor | None,
               cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm_type == "nonparametric":
        return nonparametric_layernorm(x)
    return rmsnorm(x, scale)


# ---------------------------------------------------------------------- rope
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim/2), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, *, hd); cos/sin broadcastable (..., S, 1, hd/2)."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# ----------------------------------------------------------------- attention
def repeat_kv(kv: torch.Tensor, rep: int) -> torch.Tensor:
    """(B,S,KVH,hd) -> (B,S,KVH*rep,hd): head h of the result is KV head
    h // rep (each KV head repeated ``rep`` times in place)."""
    if rep == 1:
        return kv
    B, S, KVH, hd = kv.shape
    return kv[:, :, :, None].expand(B, S, KVH, rep, hd).reshape(
        B, S, KVH * rep, hd)


def chunked_causal_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, H, hd)  (already GQA-repeated)
    v: torch.Tensor,
    *,
    chunk: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal self-attention over query chunks: peak score memory is
    (B, H, chunk, S) instead of (B, H, S, S). Scores, softmax and the
    value sum in fp32; returns (B, S, H, hd) in q.dtype.

    The reference asserts ``S % chunk == 0``; here the last chunk may be
    shorter, so any S works (the same numbers where S divides)."""
    B, S, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    chunk = min(chunk, S)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kpos = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, S, chunk):
        qc = q[:, c0:c0 + chunk].to(torch.float32)
        s = torch.einsum("bqhd,bshd->bhqs", qc, kf) * scale
        qpos = torch.arange(c0, c0 + qc.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqs,bshd->bqhd", p, vf)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S_cache, KVH, hd), H % KVH == 0
    v_cache: torch.Tensor,
    valid_len: int,  # number of valid cache slots
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """One query token against the first ``valid_len`` cache slots, in
    fp32. The reference takes a GQA-repeated cache and masks the slots
    past ``valid_len`` (they add exact zeros); here query head h reads KV
    head h // rep of the KVH-sized cache directly (the same pairs as
    :func:`repeat_kv`), so no repeated copy of the cache is made, and the
    slots past ``valid_len`` are not read."""
    B, _, H, hd = q.shape
    KVH = k_cache.shape[2]
    rep = H // KVH
    scale = scale if scale is not None else hd ** -0.5
    k_cache, v_cache = k_cache[:, :valid_len], v_cache[:, :valid_len]
    qf = q.to(torch.float32).reshape(B, KVH, rep, hd)
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)  # (B, KVH, hd, S)
    s = torch.matmul(qf, kf) * scale  # (B, KVH, rep, S)
    p = torch.softmax(s, dim=-1)
    vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)  # (B, KVH, S, hd)
    o = torch.matmul(p, vf)  # (B, KVH, rep, hd)
    return o.reshape(B, 1, H, hd).to(q.dtype)


# --------------------------------------------------------------------- mlps
def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w1.to(x.dtype)) * (x @ w3.to(x.dtype))
    return h @ w2.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w1.to(x.dtype), approximate="tanh") @ w2.to(x.dtype)


# ------------------------------------------------------------------ modules
def module_device(device=None) -> torch.device:
    """Where a module allocates its parameters: ``cuda`` unless ``"cpu"``
    is asked for (:func:`~repro_torch.device.resolve_device`), or
    ``"meta"``, which allocates nothing (for counting)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def new_weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter (serving: no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """The attention projections: wq (d, H*hd), wk/wv (d, KVH*hd), wo
    (H*hd, d), and with ``qkv_bias`` (qwen1.5) bq, bk, bv; on ``device``
    (:func:`module_device`)."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        device = module_device(device)
        d, H, KVH = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        self.cfg = cfg
        self.wq = new_weight((d, H * hd), dtype, device)
        self.wk = new_weight((d, KVH * hd), dtype, device)
        self.wv = new_weight((d, KVH * hd), dtype, device)
        self.wo = new_weight((H * hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = new_weight((H * hd,), dtype, device)
            self.bk = new_weight((KVH * hd,), dtype, device)
            self.bv = new_weight((KVH * hd,), dtype, device)
        else:
            self.bq = self.bk = self.bv = None

    def qkv(self, x: torch.Tensor):
        """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KVH,hd)."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        q = x @ self.wq.to(x.dtype)
        k = x @ self.wk.to(x.dtype)
        v = x @ self.wv.to(x.dtype)
        if self.bq is not None:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        return (q.reshape(B, S, cfg.num_heads, hd),
                k.reshape(B, S, cfg.num_kv_heads, hd),
                v.reshape(B, S, cfg.num_kv_heads, hd))

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """o (B,S,H,hd) -> (B,S,d)."""
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(o.dtype)


class MLP(nn.Module):
    """SwiGLU (w1, w3: (d, f); w2: (f, d)) or GELU (w1, w2); on
    ``device`` (:func:`module_device`)."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        device = module_device(device)
        d, f = cfg.d_model, cfg.d_ff
        self.swiglu = cfg.mlp_type == "swiglu"
        self.w1 = new_weight((d, f), dtype, device)
        self.w3 = new_weight((d, f), dtype, device) if self.swiglu else None
        self.w2 = new_weight((f, d), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            return swiglu(x, self.w1, self.w3, self.w2)
        return gelu_mlp(x, self.w1, self.w2)
