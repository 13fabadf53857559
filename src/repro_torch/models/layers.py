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
activation dtype at every use. For serving, the modules here hold the
matmul weights in the activation dtype once, at load: the same bits,
without the cast per call. The rmsnorm scales stay in
``cfg.param_dtype``, since the reference multiplies by them in fp32. A
module built with ``trainable=True`` holds every leaf in
``cfg.param_dtype`` with ``requires_grad``, as the reference trains
them; the forward rounds each weight to the activation dtype at each
use either way (``.to(x.dtype)`` is free on a weight already there).

Full-sequence attention runs on ``kernels/flash_attention/ops`` (B6 on
the card); :func:`chunked_causal_attention` here is its plain causal
version. Decode attention is plain PyTorch, as in the reference.

On a mesh (``models/sharding.py``) a rank's :class:`Attention` holds q
heads [r H/m, (r+1) H/m) and KV heads [r KVH/m, (r+1) KVH/m) of model
rank r (wq/wk/wv cut by columns, wo by rows), so GQA's head h -> KV head
h // rep stays on the rank; an :class:`MLP` holds d_ff / m of w1/w3's
columns and w2's rows. The head counts are read off the weights. wo's
and w2's products are partial sums, added over ``model`` in fp32
(:func:`row_parallel`). For training the collectives are differentiable
(``launch/mesh.py``): the column-parallel input x enters through
``copy_to`` (its gradient summed over ``model``), the row-parallel sum
passes its cotangent through, and a trainable model's FSDP leaves are
gathered over ``data`` at each use (``sharding.at_use``).

Under ``attn_shard="head_dim"`` the cut of wq/wk/wv (columns) and wo
(rows) is the same contiguous one, but need not fall between heads: a
rank's products are its H hd / m and KVH hd / m columns, gathered
exactly over ``model`` into every head (:func:`~repro_torch.launch.mesh.
gather_replicated`), so every rank runs RoPE and attention (B6) over all
H heads, and takes its contiguous H hd / m columns of the output into
wo's rows (:func:`~repro_torch.launch.mesh.split_to`, whose backward
gathers the ranks' cotangents). Only H hd and KVH hd need divide by
``model``; the attention is computed m times (``ROADMAP.md`` C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    copy_to,
    gather_replicated,
    split_to,
    sum_fp32,
)
from repro_torch.models.sharding import at_use

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


def row_parallel(x: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """x @ w in x's dtype. On a mesh, x's last axis and w's rows are a
    rank's slice of the contracted axis, and the partial product is
    summed over ``model`` in fp32 and rounded once (the product itself
    without a mesh or with model = 1); the sum's backward passes the
    cotangent through. ``w`` is whole over ``data``."""
    return sum_fp32(x @ w.to(x.dtype), mesh, "model")


# --------------------------------------------------------------------- mlps
def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor, mesh=None) -> torch.Tensor:
    x = copy_to(x, mesh, "model")
    h = F.silu(x @ w1.to(x.dtype)) * (x @ w3.to(x.dtype))
    return row_parallel(h, w2, mesh)


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
             mesh=None) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    x = copy_to(x, mesh, "model")
    return row_parallel(F.gelu(x @ w1.to(x.dtype), approximate="tanh"), w2,
                        mesh)


# ------------------------------------------------------------------ modules
def module_device(device=None) -> torch.device:
    """Where a module allocates its parameters: ``cuda`` unless ``"cpu"``
    is asked for (:func:`~repro_torch.device.resolve_device`), or
    ``"meta"``, which allocates nothing (for counting)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def weight_dtype(cfg: ArchConfig, trainable: bool) -> torch.dtype:
    """The matmul weights' dtype: ``cfg.dtype`` for serving,
    ``cfg.param_dtype`` for training."""
    return getattr(torch, cfg.param_dtype if trainable else cfg.dtype)


def new_weight(shape, dtype, device, trainable: bool = False) -> nn.Parameter:
    """An uninitialised parameter: with a gradient when ``trainable``,
    without one for serving."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


class Attention(nn.Module):
    """The attention projections: wq (d, H*hd), wk/wv (d, KVH*hd), wo
    (H*hd, d), and with ``qkv_bias`` (qwen1.5) bq, bk, bv, in ``dtype``;
    on ``device`` (:func:`module_device`), with a gradient when
    ``trainable``."""

    def __init__(self, cfg: ArchConfig, dtype, device=None,
                 trainable: bool = False):
        super().__init__()
        device = module_device(device)
        d, H, KVH = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        self.cfg = cfg

        def weight(*shape):
            return new_weight(shape, dtype, device, trainable)

        self.wq = weight(d, H * hd)
        self.wk = weight(d, KVH * hd)
        self.wv = weight(d, KVH * hd)
        self.wo = weight(H * hd, d)
        if cfg.qkv_bias:
            self.bq = weight(H * hd)
            self.bk = weight(KVH * hd)
            self.bv = weight(KVH * hd)
        else:
            self.bq = self.bk = self.bv = None

    def qkv(self, x: torch.Tensor, mesh=None):
        """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KVH,hd), H and KVH this
        module's (a rank's share on a ``mesh``; every head under
        ``attn_shard="head_dim"``)."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        x = copy_to(x, mesh, "model")
        q = x @ at_use(self.wq, mesh).to(x.dtype)
        k = x @ at_use(self.wk, mesh).to(x.dtype)
        v = x @ at_use(self.wv, mesh).to(x.dtype)
        if self.bq is not None:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        if cfg.attn_shard == "head_dim":
            q, k, v = (gather_replicated(t, mesh, "model", -1)
                       for t in (q, k, v))
        return (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
                v.reshape(B, S, -1, hd))

    def out(self, o: torch.Tensor, mesh=None) -> torch.Tensor:
        """o (B,S,H,hd) -> (B,S,d), summed over ``mesh``'s model axis
        (under ``attn_shard="head_dim"`` o holds every head, of which the
        rank's columns are taken)."""
        B, S = o.shape[:2]
        o = o.reshape(B, S, -1)
        if self.cfg.attn_shard == "head_dim":
            o = split_to(o, mesh, "model", -1)
        return row_parallel(o, at_use(self.wo, mesh), mesh)


class MLP(nn.Module):
    """SwiGLU (w1, w3: (d, f); w2: (f, d)) or GELU (w1, w2) in ``dtype``;
    on ``device`` (:func:`module_device`), with a gradient when
    ``trainable``."""

    def __init__(self, cfg: ArchConfig, dtype, device=None,
                 trainable: bool = False):
        super().__init__()
        device = module_device(device)
        d, f = cfg.d_model, cfg.d_ff
        self.swiglu = cfg.mlp_type == "swiglu"
        self.w1 = new_weight((d, f), dtype, device, trainable)
        self.w3 = (new_weight((d, f), dtype, device, trainable)
                   if self.swiglu else None)
        self.w2 = new_weight((f, d), dtype, device, trainable)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """x (..., d) -> (..., d), summed over ``mesh``'s model axis."""
        w1, w2 = at_use(self.w1, mesh), at_use(self.w2, mesh)
        if self.swiglu:
            return swiglu(x, w1, at_use(self.w3, mesh), w2, mesh)
        return gelu_mlp(x, w1, w2, mesh)
