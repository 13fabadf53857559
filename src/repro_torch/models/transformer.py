"""Decoder-only LM for the attention families without experts and for
the Mamba1 family.

The port's counterpart of ``repro/models/transformer.py`` for the dense,
vlm (``prefix_embeds``) and audio (``embeds``) families:

  [norm -> attn -> residual, norm -> (swiglu | gelu) -> residual] x L

and for the ssm family (falcon-mamba, ``models/ssm.py``):

  [norm -> mamba1 -> residual] x L

Entry points (serving):
  init_model                    parameters drawn from a torch.Generator
  forward                       full-sequence logits (or hidden states)
  prefill                       last-token logits + filled caches (KV,
                                or the ssm family's conv and ssm states)
  init_caches / decode_step     one token against the caches
  make_serve_step               the decode step as a closure

The model is a :class:`Transformer` module that carries its config, so
the functions take it in place of the reference's ``(params, cfg)``
pair. There is no mesh: sharding is ``ROADMAP.md`` A12. The
full-sequence attention goes through ``kernels/flash_attention/ops``
(B6 on the card, its plain version on the CPU), the selective scan of
prefill and of every decode step through ``kernels/mamba_scan/ops``
(B7, likewise). ``decode_step`` updates the caches it is given in place
(the reference returns new arrays) and returns them.

The hybrid and MoE families raise ``NotImplementedError`` naming the
``ROADMAP.md`` item they wait for (A15c, A15d). The training entry
points (``cross_entropy``, ``loss_fn``, ``make_train_step``) wait for
the LM training slice and ``param_specs`` for sharding (A12); none is
defined here yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as SS


def _dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for the families the port does not
    run yet, naming what each waits for."""
    if cfg.family == "ssm" and cfg.ssm_version != 1:
        raise NotImplementedError(f"{cfg.name}: {SS.MAMBA2_TODO}")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family (Mamba2 blocks and the shared "
            "attention block, models/ssm.py) waits for ROADMAP.md A15c")
    if cfg.family == "moe" or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts FFNs (models/moe.py) wait for "
            "ROADMAP.md A15d")


# ================================================================= modules
class Block(nn.Module):
    """One layer: attention projections, MLP, and (rmsnorm) two scales;
    on ``device`` (:func:`~repro_torch.models.layers.module_device`)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        device = L.module_device(device)
        self.attn = L.Attention(cfg, _dt(cfg), device)
        self.ffn = L.MLP(cfg, _dt(cfg), device)
        if cfg.norm_type == "rmsnorm":
            self.norm1 = L.new_weight((cfg.d_model,), _pdt(cfg), device)
            self.norm2 = L.new_weight((cfg.d_model,), _pdt(cfg), device)
        else:
            self.norm1 = self.norm2 = None


class MambaBlock(nn.Module):
    """One ssm layer: the (rmsnorm) scale ``norm`` in ``cfg.param_dtype``
    and the Mamba1 mixer ``mamba``; on ``device`` (``cuda`` unless
    ``"cpu"``; ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        device = L.module_device(device)
        self.mamba = SS.Mamba1(cfg, device)
        self.norm = (L.new_weight((cfg.d_model,), _pdt(cfg), device)
                     if cfg.norm_type == "rmsnorm" else None)


class Transformer(nn.Module):
    """The model: ``embed`` (V, d), ``layers`` (:class:`Block` s, or
    :class:`MambaBlock` s for the ssm family), ``final_norm`` (rmsnorm
    only) and, without tied embeddings, ``lm_head`` (d, V). Matmul
    weights in ``cfg.dtype``, norm scales in ``cfg.param_dtype``. The
    parameters are left unset, on ``device`` (``cuda`` unless ``"cpu"``
    is asked for; ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_supported(cfg)
        device = L.module_device(device)
        self.cfg = cfg
        dt = _dt(cfg)
        block = MambaBlock if cfg.family == "ssm" else Block
        self.embed = L.new_weight((cfg.vocab_size, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = (L.new_weight((cfg.d_model,), _pdt(cfg), device)
                           if cfg.norm_type == "rmsnorm" else None)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.new_weight((cfg.d_model, cfg.vocab_size), dt, device))

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ==================================================================== init
def init_model(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> Transformer:
    """A model on ``device`` (``cuda`` unless ``"cpu"`` is asked for) with
    the reference's initialisation: N(0, 1) weights scaled by
    fan_in^-0.5 (the embedding and the untied head by d^-0.5), zero
    biases, unit norm scales. The normals are drawn in fp32 from
    ``generator`` (which lives on ``device``), in the order embed, then
    per layer wq, wk, wv, wo, w1, (w3,) w2 (the ssm family: per layer
    the Mamba1 leaves in :func:`~repro_torch.models.ssm.init_mamba1`'s
    order, with its distributions), then lm_head, and rounded to the
    weights' dtype. The reference draws from ``jax.random``: the numbers
    differ, the distribution is the same."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"model on {dev}")
    model = Transformer(cfg, device=dev)

    def fill(param, fan_in):
        param.copy_(fan_in ** -0.5 * torch.randn(
            param.shape, generator=generator, device=dev,
            dtype=torch.float32))

    fill(model.embed, cfg.d_model)
    for blk in model.layers:
        if isinstance(blk, MambaBlock):
            SS.init_mamba1(blk.mamba, cfg, generator)
            if blk.norm is not None:
                blk.norm.fill_(1.0)
            continue
        a, f = blk.attn, blk.ffn
        for w in (a.wq, a.wk, a.wv):
            fill(w, cfg.d_model)
        fill(a.wo, a.wo.shape[0])
        fill(f.w1, cfg.d_model)
        if f.w3 is not None:
            fill(f.w3, cfg.d_model)
        fill(f.w2, cfg.d_ff)
        for b in (a.bq, a.bk, a.bv):
            if b is not None:
                b.zero_()
        for n in (blk.norm1, blk.norm2):
            if n is not None:
                n.fill_(1.0)
    if model.final_norm is not None:
        model.final_norm.fill_(1.0)
    if model.lm_head is not None:
        fill(model.lm_head, cfg.d_model)
    return model


# ============================================================ block forward
def _rope(positions: torch.Tensor, cfg: ArchConfig):
    cos, sin = L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)
    return cos[None, :, None, :], sin[None, :, None, :]


def _attn_full(h, blk: Block, cfg: ArchConfig, rope):
    """Full-sequence causal attention sub-block (pre-norm, residual).
    Returns the new h and this layer's (k, v) after rope."""
    x = L.apply_norm(h, blk.norm1, cfg)
    q, k, v = blk.attn.qkv(x)
    q = L.apply_rope(q, *rope)
    k = L.apply_rope(k, *rope)
    o = attention_ops.causal_attention(q, k, v, chunk=cfg.attn_chunk)
    return h + blk.attn.out(o), (k, v)


def _ffn_full(h, blk: Block, cfg: ArchConfig):
    return h + blk.ffn(L.apply_norm(h, blk.norm2, cfg))


def _ssm_full(h, blk: MambaBlock, cfg: ArchConfig):
    """Full-sequence Mamba1 sub-block (pre-norm, residual). Returns the
    new h and this layer's decode state {"conv", "ssm"}."""
    y, state = SS.mamba1_forward(L.apply_norm(h, blk.norm, cfg), blk.mamba,
                                 cfg, return_state=True)
    return h + y, state


def embed_tokens(model: Transformer, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=model.device)
    return model.embed[tokens.long()].to(_dt(model.cfg))


def lm_logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    if model.cfg.tie_embeddings:
        return h @ model.embed.to(h.dtype).T
    return h @ model.lm_head.to(h.dtype)


def final_norm(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    return L.apply_norm(h, model.final_norm, model.cfg)


def _inputs(model: Transformer, tokens, embeds, prefix_embeds):
    dev, dt = model.device, _dt(model.cfg)
    if embeds is not None:
        h = torch.as_tensor(embeds, device=dev).to(dt)
    else:
        h = embed_tokens(model, tokens)
    if prefix_embeds is not None:
        pre = torch.as_tensor(prefix_embeds, device=dev).to(h.dtype)
        h = torch.cat([pre, h], dim=1)
    return h


# ============================================================ full forward
def forward(model: Transformer, tokens=None, embeds=None, prefix_embeds=None,
            return_hidden: bool = False):
    """Full-sequence forward: tokens (B, S_text) or embeds (B, S, d), with
    optional prefix_embeds (B, P, d) in front. Returns (logits (B, S, V),
    aux) -- or (final-norm hidden states (B, S, d), aux) with
    ``return_hidden``; aux is the router loss, 0 without experts."""
    cfg = model.cfg
    h = _inputs(model, tokens, embeds, prefix_embeds)
    if cfg.family == "ssm":
        for blk in model.layers:
            h, _ = _ssm_full(h, blk, cfg)
    else:
        rope = _rope(torch.arange(h.shape[1], device=h.device), cfg)
        for blk in model.layers:
            h, _ = _attn_full(h, blk, cfg, rope)
            h = _ffn_full(h, blk, cfg)
    h = final_norm(model, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_hidden:
        return h, aux
    return lm_logits(model, h), aux


# ================================================================== caches
def attn_cache_shape(cfg: ArchConfig, B: int, S_max: int):
    return (B, S_max, cfg.num_kv_heads, cfg.resolved_head_dim)


def init_caches(cfg: ArchConfig, B: int, S_max: int,
                dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zero decode caches on ``device`` (``cuda`` unless ``"cpu"``).
    S_max = window size for sliding-window decode. ``dtype`` is the KV
    dtype (bf16, as the reference, whatever ``cfg.dtype``); with
    ``kv_cache_dtype="int8"`` the caches are int8 codes with bf16
    per-(token, head) scales. The ssm family's caches are the conv
    states (L, B, K-1, di) in ``dtype`` and the ssm states (L, B, di, N)
    in fp32, whatever S_max."""
    check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        L_ = cfg.num_layers
        return {"conv": torch.zeros((L_, B, K - 1, di), dtype=dtype,
                                    device=dev),
                "ssm": torch.zeros((L_, B, di, N), dtype=torch.float32,
                                   device=dev)}
    shp = (cfg.num_layers,) + attn_cache_shape(cfg, B, S_max)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shp, dtype=torch.int8, device=dev),
                "v": torch.zeros(shp, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shp[:-1] + (1,), dtype=torch.bfloat16,
                                       device=dev),
                "v_scale": torch.zeros(shp[:-1] + (1,), dtype=torch.bfloat16,
                                       device=dev)}
    return {"k": torch.zeros(shp, dtype=dtype, device=dev),
            "v": torch.zeros(shp, dtype=dtype, device=dev)}


# ================================================================== prefill
@torch.no_grad()
def prefill(model: Transformer, tokens=None, embeds=None, prefix_embeds=None):
    """Run the full prompt; return (last-token logits (B, V), caches
    {"k", "v"} of shape (L, B, S, KVH, hd) in the activation dtype,
    filled with the S positions). The ssm family's caches are the states
    after the prompt: {"conv": (L, B, K-1, di) in the activation dtype,
    "ssm": (L, B, di, N) fp32}."""
    cfg = model.cfg
    h = _inputs(model, tokens, embeds, prefix_embeds)
    B, S, _ = h.shape
    if cfg.family == "ssm":
        return _prefill_ssm(model, h)
    rope = _rope(torch.arange(S, device=h.device), cfg)
    shp = (cfg.num_layers,) + attn_cache_shape(cfg, B, S)
    ks = torch.empty(shp, dtype=h.dtype, device=h.device)
    vs = torch.empty(shp, dtype=h.dtype, device=h.device)
    for i, blk in enumerate(model.layers):
        h, (ks[i], vs[i]) = _attn_full(h, blk, cfg, rope)
        h = _ffn_full(h, blk, cfg)
    h = final_norm(model, h[:, -1:])
    return lm_logits(model, h)[:, 0], {"k": ks, "v": vs}


def _prefill_ssm(model: Transformer, h: torch.Tensor):
    cfg = model.cfg
    B = h.shape[0]
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    convs = torch.empty((cfg.num_layers, B, K - 1, di), dtype=h.dtype,
                        device=h.device)
    ssms = torch.empty((cfg.num_layers, B, di, N), dtype=torch.float32,
                       device=h.device)
    for i, blk in enumerate(model.layers):
        h, state = _ssm_full(h, blk, cfg)
        convs[i], ssms[i] = state["conv"], state["ssm"]
    h = final_norm(model, h[:, -1:])
    return lm_logits(model, h)[:, 0], {"conv": convs, "ssm": ssms}


# ================================================================== decode
def _quant(x: torch.Tensor):
    """Per-(token, head) symmetric int8: codes and bf16 scales."""
    s = torch.amax(x.abs(), dim=-1, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def _attn_decode(h, blk: Block, cfg: ArchConfig, caches: dict, i: int,
                 pos: int, window: bool, rope):
    """h (B,1,d) against layer i's cache slots; writes this token's k, v
    (int8 codes and scales with ``kv_cache_dtype="int8"``) into slot
    ``pos`` (``pos % S_c`` with ``window``, a ring buffer)."""
    dt = _dt(cfg)
    x = L.apply_norm(h, blk.norm1, cfg)
    q, k, v = blk.attn.qkv(x)
    q = L.apply_rope(q, *rope)
    k = L.apply_rope(k, *rope)
    k_cache, v_cache = caches["k"][i], caches["v"][i]
    S_c = k_cache.shape[1]
    slot = pos % S_c if window else pos
    if slot >= S_c:
        raise ValueError(f"position {pos} is past the cache's {S_c} slots "
                         "(pass window=True for a ring buffer)")
    valid = min(pos + 1, S_c)
    if cfg.kv_cache_dtype == "int8":
        k_scale, v_scale = caches["k_scale"][i], caches["v_scale"][i]
        kq, kqs = _quant(k.to(torch.float32))
        vq, vqs = _quant(v.to(torch.float32))
        k_cache[:, slot] = kq[:, 0]
        v_cache[:, slot] = vq[:, 0]
        k_scale[:, slot] = kqs[:, 0]
        v_scale[:, slot] = vqs[:, 0]
        k_deq = k_cache[:, :valid].to(dt) * k_scale[:, :valid].to(dt)
        v_deq = v_cache[:, :valid].to(dt) * v_scale[:, :valid].to(dt)
    else:
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        k_deq = k_cache[:, :valid].to(dt)
        v_deq = v_cache[:, :valid].to(dt)
    o = L.decode_attention(q, k_deq, v_deq, valid)
    return h + blk.attn.out(o)


@torch.no_grad()
def decode_step(model: Transformer, caches: dict, token=None, embed=None,
                pos=None, window: bool = False):
    """One serving step: next-token logits (B, V) given the caches at
    position ``pos`` (an int). token (B,) or embed (B, d). The caches are
    updated in place and returned. The ssm family reads no position: its
    caches are the states after the tokens so far."""
    cfg = model.cfg
    if embed is not None:
        h = torch.as_tensor(embed, device=model.device)[:, None, :].to(
            _dt(cfg))
    else:
        h = embed_tokens(model, torch.as_tensor(token)[:, None])
    if cfg.family == "ssm":
        return _decode_ssm(model, caches, h), caches
    pos = int(pos)
    rope = _rope(torch.tensor([pos], device=h.device), cfg)
    for i, blk in enumerate(model.layers):
        h = _attn_decode(h, blk, cfg, caches, i, pos, window, rope)
        h = _ffn_full(h, blk, cfg)
    h = final_norm(model, h)
    return lm_logits(model, h[:, 0]), caches


def _decode_ssm(model: Transformer, caches: dict, h: torch.Tensor):
    """h (B, 1, d) through every Mamba1 layer from its states, which are
    overwritten with the new ones. The reference's decode returns the
    conv states in the activation dtype, so a conv cache in another
    dtype (bf16 caches under an fp32 model) takes the activation dtype
    here, once; in bf16 serving the two agree and nothing is copied."""
    cfg = model.cfg
    if caches["conv"].dtype != h.dtype:
        caches["conv"] = caches["conv"].to(h.dtype)
    for i, blk in enumerate(model.layers):
        x = L.apply_norm(h[:, 0], blk.norm, cfg)
        y, state = SS.mamba1_decode(
            x, {"conv": caches["conv"][i], "ssm": caches["ssm"][i]},
            blk.mamba, cfg)
        caches["conv"][i], caches["ssm"][i] = state["conv"], state["ssm"]
        h = h + y[:, None]
    h = final_norm(model, h)
    return lm_logits(model, h[:, 0])


def make_serve_step(model: Transformer, window: bool = False):
    def serve_step(caches, token_or_embed, pos):
        kw = ({"embed": token_or_embed} if model.cfg.embeds_in
              else {"token": token_or_embed})
        return decode_step(model, caches, pos=pos, window=window, **kw)

    return serve_step
