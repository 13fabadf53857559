"""Decoder-only LM for every family of the zoo, for serving and training.

The port's counterpart of ``repro/models/transformer.py``:

  dense / vlm / audio : [norm -> attn -> res, norm -> (swiglu | gelu) -> res] x L
  moe                 : [norm -> attn -> res, norm -> moe_ffn -> res] x L
  ssm (mamba1)        : [norm -> mamba1 -> res] x L
  hybrid (zamba2)     : J = L / k groups, each k mamba2 layers followed by
                        ONE SHARED transformer block (the same parameters
                        in every group)

(``prefix_embeds`` feeds the vlm family, ``embeds`` the audio one.)

Entry points:
  init_model                    parameters drawn from a torch.Generator
                                (``trainable=True``: fp32 leaves with a
                                gradient, as the reference trains them)
  forward                       full-sequence logits (or hidden states)
                                and the router's aux loss; under
                                autograd each block (the hybrid: each
                                group) is checkpointed, as the
                                reference's ``jax.checkpoint``
  cross_entropy / chunked_cross_entropy / loss_fn
                                the LM loss, the chunked CE never
                                holding the (B, S, V) logits
  loss_and_grads                the loss and every block's gradient
  make_train_step               one backward and one AdamW update
  prefill                       last-token logits + filled caches (KV,
                                the ssm states, or the hybrid's both)
  init_caches / decode_step     one token against the caches
  make_serve_step               the decode step as a closure

The model is a :class:`Transformer` module that carries its config, so
the functions take it in place of the reference's ``(params, cfg)``
pair. The full-sequence attention goes through ``kernels/flash_attention/ops``
(B6 on the card, its plain version on the CPU), the Mamba1 selective
scan of prefill and of every decode step through
``kernels/mamba_scan/ops`` (B7, likewise); Mamba2's SSD and the experts
are plain PyTorch, as they are jnp in the reference. ``decode_step``
updates the caches it is given in place (the reference returns new
arrays) and returns them.

Training differentiates through B6 and B7: their ``ops`` entries are
``torch.autograd.Function`` s on the card. B6's backward is the plain
version's gradient, recomputed; B7's is a backward kernel of its own,
one launch a layer (the reference has no backward kernel of either).
With remat, each B6 and B7 forward runs twice a step: once in the
forward and once in its block's recompute.

Sharded serving (tensor and expert parallelism over a
:class:`~repro_torch.launch.mesh.Mesh`, ``ROADMAP.md`` A12b). A model
built with ``mesh=`` (``init_model``, ``convert.model_from_reference``)
holds on each rank its block of every leaf, cut by :func:`param_specs`
in the serving layout of ``models/sharding.py``; :func:`cache_specs`
places the caches. ``prefill`` / ``decode_step`` / ``make_serve_step``
/ ``forward`` take ``mesh=`` (the model's by default), ``batch_sharded=``
and ``moe_serving_mode=`` with the reference's defaults, and run on this
rank's rows: its data shard's B / data rows when ``batch_sharded``, the
whole batch otherwise (``sharding.batch_rows`` cuts them from a global
batch); ``init_caches`` takes the global B and returns the rank's
caches. Attention runs B6 on the rank's q and KV heads, Mamba1 runs B7
on its d_inner channels, the experts on its experts; the row-parallel
products (wo, w2, x_proj, out_proj, the experts' outputs) are summed
over ``model`` in fp32. The embedding and the head split the vocab over
``model`` when it divides (a vocab-parallel lookup, then a sum; the
logits gathered exactly over ``model`` before anything reads them, so
every rank of a data shard sees the same bits). Everything else is
computed alike on every rank of a data shard. The hybrid's Mamba2
layers run on the rank's heads (``models/ssm.py``). Under
``cfg.attn_shard="head_dim"`` every rank attends over every head, its
columns of q, k and v gathered over ``model`` (``models/layers.py``), and
the KV caches are whole on every rank (:func:`cache_layout`).

Sequence parallelism (``cfg.seq_parallel``, the reference's ``_hspec``:
Megatron-SP). On a mesh with ``model`` > 1, prefill and the training
forward hold the residual stream between blocks as this rank's S / m
positions: the input enters as the rank's slice (``split_to``, whose
backward gathers), each sub-block normalises its slice, gathers it
whole over ``model`` (``gather_replicated``; with the ``copy_to`` that
follows in every sub-block its backward sums over ``model`` and keeps
the slice) and leaves its row-parallel sum as the rank's slice again
(``split_to``); the final norm runs on the slice, which is gathered
before the head. The norm scales then see only the rank's positions, so
they enter through ``copy_to`` (their gradient summed over ``model``).
Every product and sum sees the same numbers as without the knob, so the
logits, the loss and every gradient but the norm scales' are bitwise
those of ``seq_parallel=False`` on the same mesh; a norm scale's
gradient is the same sum in another order. Decode (S = 1) ignores it, as
the reference's does; an S that does not divide by ``model`` raises.

Sharded training (``ROADMAP.md`` A12c). A trainable model built with
``mesh=`` holds its blocks in the training layout: ``param_specs`` whole,
so the ``"data"`` entries are FSDP (a rank holds 1 / data of such a
leaf, gathered over ``data`` at each use, the gradient reduce-scattered
back), on top of the same tensor and expert parallelism over ``model``.
``loss_fn`` / ``make_train_step`` take ``mesh=``; each rank feeds its
data shard's rows. The collectives are differentiable
(``launch/mesh.py``): ``copy_to`` in front of every column-parallel
input, the row-parallel and vocab-parallel sums with an identity
backward, the logits' vocab gather with a slicing backward. The CE is
the global one, sum(s) / sum(n) over every data shard (each rank's term
its s over the global count, the terms summed over ``data``), and the
MoE's aux the mean over ``data``. After the backward, the leaves
replicated over ``data`` have their gradient summed over ``data`` (one
all-reduce); the FSDP leaves already hold theirs. AdamW then updates
each rank's blocks, unchanged: its update is elementwise. Under remat
each block's recompute re-issues its gathers and sums, in the same
order on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.launch.mesh import (
    copy_to,
    gather_replicated,
    split_to,
    sum_fp32,
)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SH
from repro_torch.models import ssm as SS
from repro_torch.optim.adamw import AdamW


def _dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def num_groups(cfg: ArchConfig) -> int:
    """The hybrid's J = L / k groups of k Mamba2 layers, each followed by
    the shared block; ``ValueError`` unless k divides L."""
    k = cfg.shared_attn_every
    if not k or cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: shared_attn_every = {k} must divide "
                         f"num_layers = {cfg.num_layers}")
    return cfg.num_layers // k


# ================================================================= modules
class Block(nn.Module):
    """One attention layer: attention projections, the FFN (an
    :class:`~repro_torch.models.moe.MoE` when ``cfg.num_experts``, else an
    MLP), and (rmsnorm) two scales; on ``device``
    (:func:`~repro_torch.models.layers.module_device`), trainable or
    not (:class:`Transformer`)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        device = L.module_device(device)
        dt = L.weight_dtype(cfg, trainable)
        self.attn = L.Attention(cfg, dt, device, trainable)
        self.ffn = (MOE.MoE(cfg, device, trainable) if cfg.num_experts
                    else L.MLP(cfg, dt, device, trainable))
        if cfg.norm_type == "rmsnorm":
            self.norm1 = L.new_weight((cfg.d_model,), _pdt(cfg), device,
                                      trainable)
            self.norm2 = L.new_weight((cfg.d_model,), _pdt(cfg), device,
                                      trainable)
        else:
            self.norm1 = self.norm2 = None


class MambaBlock(nn.Module):
    """One ssm layer: the (rmsnorm) scale ``norm`` in ``cfg.param_dtype``
    and the mixer ``mamba``, Mamba1 for the ssm family and Mamba2 for the
    hybrid, as the reference picks them; on ``device`` (``cuda`` unless
    ``"cpu"``; ``"meta"`` allocates nothing), trainable or not."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False):
        super().__init__()
        device = L.module_device(device)
        mixer = SS.Mamba1 if cfg.family == "ssm" else SS.Mamba2
        self.mamba = mixer(cfg, device, trainable)
        self.norm = (L.new_weight((cfg.d_model,), _pdt(cfg), device,
                                  trainable)
                     if cfg.norm_type == "rmsnorm" else None)


class Transformer(nn.Module):
    """The model: ``embed`` (V, d), ``layers`` (:class:`Block` s, or
    :class:`MambaBlock` s for the ssm and hybrid families), the hybrid's
    ``shared`` :class:`Block` (one set of parameters, run after every
    group), ``final_norm`` (rmsnorm only) and, without tied embeddings,
    ``lm_head`` (d, V). For serving, matmul weights in ``cfg.dtype``,
    norm scales in ``cfg.param_dtype``, and no gradient; with
    ``trainable=True`` every leaf in ``cfg.param_dtype`` with
    ``requires_grad`` (the forward rounds each weight to the activation
    dtype at each use, as the reference does). The parameters are left
    unset, on ``device`` (``cuda`` unless ``"cpu"`` is asked for;
    ``"meta"`` allocates nothing). With a ``mesh`` of more than one rank
    each leaf is this rank's block (:meth:`leaf_specs`: the training
    layout when ``trainable``, else the serving one), and each FSDP
    block (cut over ``data``, experts aside) carries its ``fsdp_dim`` for
    ``sharding.at_use``; the mesh is checked first
    (``sharding.check_mesh``)."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False,
                 mesh=None):
        super().__init__()
        device = L.module_device(device)
        self.cfg, self.mesh, self.trainable = cfg, mesh, trainable
        sharded = SH.is_sharded(mesh)
        if sharded:
            SH.check_mesh(cfg, mesh.data, mesh.model)
        dt = L.weight_dtype(cfg, trainable)
        build = torch.device("meta") if sharded else device

        def weight(dtype, *shape):
            return L.new_weight(shape, dtype, build, trainable)

        block = MambaBlock if cfg.family in ("ssm", "hybrid") else Block
        self.embed = weight(dt, cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(block(cfg, build, trainable)
                                    for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            num_groups(cfg)
            self.shared = Block(cfg, build, trainable)
        else:
            self.shared = None
        self.final_norm = (weight(_pdt(cfg), cfg.d_model)
                           if cfg.norm_type == "rmsnorm" else None)
        self.lm_head = (None if cfg.tie_embeddings else
                        weight(dt, cfg.d_model, cfg.vocab_size))
        if sharded:  # the full leaves were shapes only: allocate the blocks
            for name, (spec, parts) in self.leaf_specs().items():
                owner, _, leaf = name.rpartition(".")
                p = self.get_parameter(name)
                shape = SH.local_shape(p.shape, spec, mesh.shape, parts, name)
                block = L.new_weight(shape, p.dtype, device, trainable)
                if mesh.data > 1 and "data" in spec \
                        and not SH.is_expert(cfg, name):
                    block.fsdp_dim = spec.index("data")
                setattr(self.get_submodule(owner), leaf, block)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def leaf_specs(self) -> dict:
        """{parameter name: (spec, parts)} of every leaf on this model's
        mesh: the training layout (``sharding.training_spec``) for a
        trainable model, else the serving one
        (``sharding.serving_spec``)."""
        specs = param_specs(self.cfg, self.mesh.model if self.mesh else 1)
        spec_of = SH.training_spec if self.trainable else SH.serving_spec
        return {name: spec_of(specs, name, self.cfg)
                for name, _ in self.named_parameters()}


# ============================================================ param specs
def _block_specs(cfg: ArchConfig, stacked: bool) -> dict:
    """The reference's ``_block_specs``: one tuple of axis names per leaf
    of a layer (a leading None for the stacked L axis)."""
    pre = (None,) if stacked else ()

    def s(*axes):
        return pre + axes

    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm_version == 1 or cfg.family == "ssm":
            mamba = {"in_proj": s("data", "model"), "conv_w": s(None, "model"),
                     "conv_b": s("model"), "x_proj": s("model", None),
                     "dt_proj": s(None, "model"), "dt_bias": s("model"),
                     "A_log": s("model", None), "D": s("model"),
                     "out_proj": s("model", "data")}
        else:
            mamba = {"in_proj": s("data", "model"), "conv_w": s(None, "model"),
                     "conv_b": s("model"), "dt_bias": s(None),
                     "A_log": s(None), "D": s(None),
                     "norm_scale": s("model"), "out_proj": s("model", "data")}
        p = {"mamba": mamba}
        if cfg.norm_type == "rmsnorm":
            p["norm"] = s(None)
        return p
    attn = {"wq": s("data", "model"), "wk": s("data", "model"),
            "wv": s("data", "model"), "wo": s("model", "data")}
    if cfg.qkv_bias:
        attn.update({"bq": s("model"), "bk": s("model"), "bv": s("model")})
    p = {"attn": attn}
    if cfg.num_experts:
        p["ffn"] = {"router": s(None, None), "w1": s("model", None, "data"),
                    "w3": s("model", None, "data"),
                    "w2": s("model", "data", None)}
    elif cfg.mlp_type == "swiglu":
        p["ffn"] = {"w1": s("data", "model"), "w3": s("data", "model"),
                    "w2": s("model", "data")}
    else:
        p["ffn"] = {"w1": s("data", "model"), "w2": s("model", "data")}
    if cfg.norm_type == "rmsnorm":
        p["norm1"] = s(None)
        p["norm2"] = s(None)
    return p


def param_specs(cfg: ArchConfig, model_size: int = 16) -> dict:
    """The reference's production layout of every leaf, as tuples of axis
    names (``None``, ``"data"``, ``"model"``) in the reference's tree:
    ``layers`` (stacked), ``embed``, ``final_norm``, ``lm_head`` and the
    hybrid's ``shared`` (a transformer block, unstacked). A vocab that
    does not divide by ``model_size`` (granite's 49,155) stays unsplit.
    ``models/sharding.py`` reads it whole for training and, with its
    departures, for serving."""
    specs: dict = {"layers": _block_specs(cfg, stacked=True)}
    vocab_ok = cfg.vocab_size % model_size == 0
    specs["embed"] = ("model", "data") if vocab_ok else (None, "data")
    if cfg.norm_type == "rmsnorm":
        specs["final_norm"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("data", "model") if vocab_ok else ("data", None)
    if cfg.shared_attn_every:
        shared = _block_specs(dataclasses.replace(cfg, family="dense",
                                                  num_experts=0),
                              stacked=False)
        specs["shared"] = shared
    return specs


def cache_specs(cfg: ArchConfig, batch_sharded: bool = True,
                model_size: int = 16) -> dict:
    """The reference's cache layout, as tuples of axis names: the batch
    over ``data`` when ``batch_sharded``; KV heads over ``model`` when
    they divide by ``model_size``, else head_dim; the ssm states' d_inner
    over ``model``. The port's caches follow :func:`cache_layout`."""
    b = "data" if batch_sharded else None
    if cfg.family == "ssm":
        return {"conv": (None, b, None, "model"),
                "ssm": (None, b, "model", None)}
    if cfg.num_kv_heads and cfg.num_kv_heads % model_size == 0:
        kv = (None, b, None, "model", None)
    else:
        kv = (None, b, None, None, "model")
    if cfg.family == "hybrid":
        return {"conv": (None, b, None, "model"),
                "ssm": (None, b, None, None, None), "k": kv, "v": kv}
    if cfg.kv_cache_dtype == "int8":
        # scales have a singleton last dim -> never shard it
        sc = kv[:-1] + (None,) if kv[-1] == "model" else kv
        return {"k": kv, "v": kv, "k_scale": sc, "v_scale": sc}
    return {"k": kv, "v": kv}


def cache_layout(cfg: ArchConfig, batch_sharded: bool = True,
                 model_size: int = 16) -> dict:
    """{cache name: (spec, parts)}: where the port's caches lie on a mesh,
    :func:`cache_specs` with the port's departures
    (``sharding.cache_spec``: the hybrid's conv states cut as conv_w, its
    ssm states by heads, and whole KV caches under
    ``attn_shard="head_dim"``). ``sharding.gather_block`` puts a cache
    back together from its ``(spec, parts)``."""
    return {n: SH.cache_spec(cfg, n, spec)
            for n, spec in cache_specs(cfg, batch_sharded, model_size).items()}


# ==================================================================== init
@torch.no_grad()
def init_model(cfg: ArchConfig, generator: torch.Generator,
               device=None, trainable: bool = False,
               mesh=None) -> Transformer:
    """A model on ``device`` (``cuda`` unless ``"cpu"`` is asked for),
    trainable or not (:class:`Transformer`), with the reference's
    initialisation: N(0, 1) weights scaled by
    fan_in^-0.5 (the embedding and the untied head by d^-0.5), zero
    biases, unit norm scales. The normals are drawn in fp32 from
    ``generator`` (which lives on ``device``), in the order embed, then
    per layer wq, wk, wv, wo, then w1, (w3,) w2 or the experts in
    :func:`~repro_torch.models.moe.init_moe`'s order (the ssm and hybrid
    families: per layer the Mamba leaves in
    :func:`~repro_torch.models.ssm.init_mamba1`'s or
    :func:`~repro_torch.models.ssm.init_mamba2`'s order, with their
    distributions), then lm_head, then the hybrid's shared block, and
    rounded to the weights' dtype. The reference draws from
    ``jax.random``: the numbers differ, the distribution is the same.

    With a ``mesh`` of more than one rank, every leaf is still drawn in
    full, in the same order from the same generator, one top-level leaf
    or one layer at a time (so a rank never holds the whole model), and
    the rank keeps its block: the blocks are bitwise the unsharded
    model's slices."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"model on {dev}")
    model = Transformer(cfg, device=dev, trainable=trainable, mesh=mesh)
    cuts = model.leaf_specs() if SH.is_sharded(mesh) else None

    def keep(name, value):
        spec, parts = cuts[name]
        model.get_parameter(name).copy_(
            SH.local_block(value, spec, mesh, parts, name))

    def fill(param, fan_in, name=None, shape=None):
        value = fan_in ** -0.5 * torch.randn(
            param.shape if shape is None else shape, generator=generator,
            device=dev, dtype=torch.float32)
        if cuts is None or name is None:
            param.copy_(value)
        else:  # a top-level leaf of a sharded model: keep the block
            keep(name, value)

    def drawn(prefix, blk, init):
        """``init`` on ``blk``, or on a full-size copy whose blocks
        ``blk`` keeps."""
        if cuts is None:
            return init(blk)
        whole = type(blk)(cfg, dev, trainable)
        init(whole)
        for name, p in whole.named_parameters():
            keep(f"{prefix}.{name}", p)

    def init_block(blk: Block):
        a, f = blk.attn, blk.ffn
        for w in (a.wq, a.wk, a.wv):
            fill(w, cfg.d_model)
        fill(a.wo, a.wo.shape[0])
        if isinstance(f, MOE.MoE):
            MOE.init_moe(f, cfg, generator)
        else:
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

    def init_layer(blk):
        if not isinstance(blk, MambaBlock):
            return init_block(blk)
        if isinstance(blk.mamba, SS.Mamba1):
            SS.init_mamba1(blk.mamba, cfg, generator)
        else:
            SS.init_mamba2(blk.mamba, cfg, generator)
        if blk.norm is not None:
            blk.norm.fill_(1.0)

    V, d = cfg.vocab_size, cfg.d_model
    fill(model.embed, d, "embed", (V, d))
    for i, blk in enumerate(model.layers):
        drawn(f"layers.{i}", blk, init_layer)
    if model.final_norm is not None:
        model.final_norm.fill_(1.0)
    if model.lm_head is not None:
        fill(model.lm_head, d, "lm_head", (d, V))
    if model.shared is not None:
        drawn("shared", model.shared, init_block)
    return model


# ============================================================ block forward
def _rope(positions: torch.Tensor, cfg: ArchConfig):
    cos, sin = L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)
    return cos[None, :, None, :], sin[None, :, None, :]


class Placement(NamedTuple):
    """Where a serving call runs: on ``mesh`` (None: one process), with
    the rows sharded over ``data`` or not, and the MoE's plan."""
    mesh: object = None
    batch_sharded: bool = True
    moe_serving_mode: str = "weight_gather"


LOCAL = Placement()


def placement(model: Transformer, mesh, batch_sharded: bool = True,
               moe_serving_mode: str = "weight_gather") -> Placement:
    """The call's :class:`Placement`, on the model's own mesh. The
    entry points' ``mesh=`` is the reference's argument: it may only
    restate the model's mesh, since a model holds the blocks of the one
    mesh it was cut for (a model without a mesh: the 1 x 1 mesh's), and
    a mesh of another shape raises."""
    held = (model.mesh.data, model.mesh.model) if model.mesh else (1, 1)
    if mesh is None:
        mesh = model.mesh
    elif (mesh.data, mesh.model) != held:
        raise ValueError(
            f"a call on a ({mesh.data}, {mesh.model}) mesh needs a model "
            f"cut for it (init_model or convert.model_from_reference with "
            f"mesh=); this one holds the blocks of a {held} mesh")
    return Placement(mesh, batch_sharded, moe_serving_mode)


def seq_parallel(cfg: ArchConfig, mesh) -> bool:
    """Whether prefill and the training forward hold the residual stream
    as S slices over ``model``: ``cfg.seq_parallel`` on a mesh with
    ``model`` > 1."""
    return bool(cfg.seq_parallel) and mesh is not None \
        and mesh.shape["model"] > 1


def _to_slices(h: torch.Tensor, cfg: ArchConfig, mesh) -> torch.Tensor:
    """h (B, S, d), the same on every model rank -> this rank's (B, S / m,
    d) (``ValueError`` naming S when it does not divide)."""
    if h.shape[1] % mesh.model:
        raise ValueError(f"{cfg.name}: seq_parallel needs the sequence "
                         f"length S = {h.shape[1]} to divide by the mesh's "
                         f"model = {mesh.model}")
    return split_to(h, mesh, "model", 1)


def _norm(h, scale, cfg: ArchConfig, mesh, seq: bool):
    """The norm of h; with ``seq`` (h this rank's S slice) its scale
    enters through ``copy_to``, since it sees only the rank's
    positions."""
    if seq and scale is not None:
        scale = copy_to(scale, mesh, "model")
    return L.apply_norm(h, scale, cfg)


def _pre_norm(h, scale, cfg: ArchConfig, mesh, seq: bool):
    """A sub-block's normed input, whole over S: with ``seq`` the norm of
    this rank's slice, gathered over ``model``."""
    x = _norm(h, scale, cfg, mesh, seq)
    return gather_replicated(x, mesh, "model", 1) if seq else x


def _residual(h, y, mesh, seq: bool):
    """h + the sub-block's (summed) output y: with ``seq``, y's slice."""
    return h + (split_to(y, mesh, "model", 1) if seq else y)


def _attn_full(h, blk: Block, cfg: ArchConfig, rope, mesh=None,
               seq: bool = False):
    """Full-sequence causal attention sub-block (pre-norm, residual).
    Returns the new h and this layer's (k, v) after rope (the rank's
    heads on a mesh; every head under ``attn_shard="head_dim"``); with
    ``seq``, h is this rank's S slice and k, v are whole over S."""
    x = _pre_norm(h, blk.norm1, cfg, mesh, seq)
    q, k, v = blk.attn.qkv(x, mesh)
    q = L.apply_rope(q, *rope)
    k = L.apply_rope(k, *rope)
    o = attention_ops.causal_attention(q, k, v, chunk=cfg.attn_chunk)
    return _residual(h, blk.attn.out(o, mesh), mesh, seq), (k, v)


def _ffn_full(h, blk: Block, cfg: ArchConfig, at: Placement = LOCAL,
              seq: bool = False):
    """The FFN sub-block (pre-norm, residual): the new h and the router's
    aux loss (None without experts); with ``seq``, h is this rank's S
    slice."""
    x = _pre_norm(h, blk.norm2, cfg, at.mesh, seq)
    if isinstance(blk.ffn, MOE.MoE):
        out, aux = MOE.moe_ffn(x, blk.ffn, cfg,
                               serving_mode=at.moe_serving_mode,
                               mesh=at.mesh, batch_sharded=at.batch_sharded)
        return _residual(h, out, at.mesh, seq), aux
    return _residual(h, blk.ffn(x, at.mesh), at.mesh, seq), None


def _ssm_full(h, blk: MambaBlock, cfg: ArchConfig, mesh=None,
              seq: bool = False):
    """Full-sequence Mamba sub-block (pre-norm, residual). Returns the new
    h and this layer's decode state {"conv", "ssm"}; with ``seq``, h is
    this rank's S slice."""
    x = _pre_norm(h, blk.norm, cfg, mesh, seq)
    if cfg.family == "ssm":
        y, state = SS.mamba1_forward(x, blk.mamba, cfg, return_state=True,
                                     mesh=mesh)
    else:
        y, state = SS.mamba2_forward(x, blk.mamba, cfg, return_state=True,
                                     mesh=mesh)
    return _residual(h, y, mesh, seq), state


def embed_tokens(model: Transformer, tokens, mesh=None) -> torch.Tensor:
    """The embedding rows of ``tokens``. With the vocab split over the
    mesh's ``model`` axis (``mesh``, or the model's), each rank looks up
    the tokens in its range, the others' rows are zeros, and the sum over
    ``model`` (one nonzero term) gives the rows exactly; its backward
    passes the cotangent through (what follows is replicated over
    ``model``). An FSDP embedding is gathered over ``data`` first."""
    tokens = torch.as_tensor(tokens, device=model.device).long()
    mesh = mesh or model.mesh
    dt, V_loc = _dt(model.cfg), model.embed.shape[0]
    embed = SH.at_use(model.embed, mesh)
    if V_loc == model.cfg.vocab_size:
        return embed[tokens].to(dt)
    local = tokens - mesh.model_rank * V_loc
    ours = (local >= 0) & (local < V_loc)
    rows = embed[local.clamp(0, V_loc - 1)].to(dt)
    return sum_fp32(torch.where(ours[..., None], rows, 0), mesh, "model")


def lm_logits(model: Transformer, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """h (..., d) -> logits (..., V). With the vocab split over the mesh's
    ``model`` axis, h enters through ``copy_to`` and each rank's (..., V /
    m) are gathered exactly over ``model`` (the gather's backward keeps
    the rank's block), so every rank holds the same bits. An FSDP head
    (or tied embedding) is gathered over ``data`` first."""
    mesh = mesh or model.mesh
    w = model.embed if model.cfg.tie_embeddings else model.lm_head
    split = w.shape[0 if model.cfg.tie_embeddings else 1] \
        != model.cfg.vocab_size
    if split:
        h = copy_to(h, mesh, "model")
    w = SH.at_use(w, mesh).to(h.dtype)
    out = h @ (w.T if model.cfg.tie_embeddings else w)
    if split:
        out = gather_replicated(out, mesh, "model", -1)
    return out


def final_norm(model: Transformer, h: torch.Tensor,
               seq: bool = False) -> torch.Tensor:
    """The final norm of h (with ``seq``, this rank's S slice)."""
    return _norm(h, model.final_norm, model.cfg, model.mesh, seq)


def _inputs(model: Transformer, tokens, embeds, prefix_embeds, mesh=None):
    dev, dt = model.device, _dt(model.cfg)
    if embeds is not None:
        h = torch.as_tensor(embeds, device=dev).to(dt)
    else:
        h = embed_tokens(model, tokens, mesh)
    if prefix_embeds is not None:
        pre = torch.as_tensor(prefix_embeds, device=dev).to(h.dtype)
        h = torch.cat([pre, h], dim=1)
    return h


def _units(model: Transformer, rope, caches=None, at: Placement = LOCAL,
           seq: bool = False) -> list:
    """The layers as the reference checkpoints them: a list of functions
    h -> (h, the router's aux loss or None), one per block, or for the
    hybrid one per group of ``shared_attn_every`` Mamba2 layers followed
    by the shared block, run as ``at`` places them (with ``seq``, on S
    slices). With ``caches`` (prefill's buffers), each layer's (k, v) or
    Mamba state is written into its slot: the shared block's of group j
    into slot j."""
    cfg = model.cfg

    def attention(blk: Block, i: int):
        def unit(h):
            h, (kk, vv) = _attn_full(h, blk, cfg, rope, at.mesh, seq)
            if caches is not None:
                caches["k"][i], caches["v"][i] = kk, vv
            return _ffn_full(h, blk, cfg, at, seq)
        return unit

    def mamba(blk: MambaBlock, i: int):
        def unit(h):
            h, state = _ssm_full(h, blk, cfg, at.mesh, seq)
            if caches is not None:
                caches["conv"][i], caches["ssm"][i] = (state["conv"],
                                                       state["ssm"])
            return h, None
        return unit

    if cfg.family == "ssm":
        return [mamba(blk, i) for i, blk in enumerate(model.layers)]
    if cfg.family != "hybrid":
        return [attention(blk, i) for i, blk in enumerate(model.layers)]
    k = cfg.shared_attn_every

    def group(j: int):
        layers = [mamba(model.layers[i], i) for i in range(j * k, j * k + k)]
        shared = attention(model.shared, j)

        def unit(h):
            for layer in layers:
                h, _ = layer(h)
            return shared(h)
        return unit

    return [group(j) for j in range(num_groups(cfg))]


def _run_layers(model: Transformer, h: torch.Tensor, caches=None,
                remat: bool = False, at: Placement = LOCAL):
    """Every layer's full-sequence pass in order (:func:`_units`), each
    unit through ``torch.utils.checkpoint`` with ``remat``; under
    :func:`seq_parallel` h is this rank's S slice, in and out. Returns
    (h, aux), aux the sum of the MoE layers' router losses (fp32, 0
    without experts)."""
    cfg = model.cfg
    seq = seq_parallel(cfg, at.mesh)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    S = h.shape[1] * (at.mesh.model if seq else 1)
    rope = (None if cfg.family == "ssm" else
            _rope(torch.arange(S, device=h.device), cfg))
    for unit in _units(model, rope, caches, at, seq):
        if remat:
            h, layer_aux = checkpoint(unit, h, use_reentrant=False)
        else:
            h, layer_aux = unit(h)
        if layer_aux is not None:
            aux = aux + layer_aux
    return h, aux


def _differentiated(model: Transformer) -> bool:
    """Whether a forward now builds a graph: grad mode on and a parameter
    that requires a gradient."""
    return torch.is_grad_enabled() and any(
        p.requires_grad for p in model.parameters())


# ============================================================ full forward
def forward(model: Transformer, tokens=None, embeds=None, prefix_embeds=None,
            return_hidden: bool = False, remat: bool = True, mesh=None,
            batch_sharded: bool = True):
    """Full-sequence forward: tokens (B, S_text) or embeds (B, S, d), with
    optional prefix_embeds (B, P, d) in front. Returns (logits (B, S, V),
    aux) -- or (final-norm hidden states (B, S, d), aux) with
    ``return_hidden``; aux is the sum of the MoE layers' router losses
    (fp32), 0 without experts. With ``remat``, a forward that builds a
    graph (grad mode on, a parameter that requires a gradient) runs each
    block -- for the hybrid each group -- through
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of kept, as the reference's ``jax.checkpoint``;
    the numbers are the same either way. On a mesh (the model's own;
    ``mesh=`` may only restate it, :func:`placement`) the inputs are this
    rank's rows and the MoE runs its ``weight_gather`` plan (aux: the
    mean over ``data`` of the shards' sums when ``batch_sharded``, one
    all-reduce whose backward passes the cotangent through); a trainable
    model's gradient flows through the mesh's collectives (the module
    docstring; under ``cfg.seq_parallel`` the residual stream between
    blocks is the rank's S slice, the module docstring's
    sequence parallelism)."""
    at = placement(model, mesh, batch_sharded)
    mesh, seq = at.mesh, seq_parallel(model.cfg, at.mesh)
    h = _inputs(model, tokens, embeds, prefix_embeds, mesh)
    if seq:
        h = _to_slices(h, model.cfg, mesh)
    h, aux = _run_layers(model, h, remat=remat and _differentiated(model),
                         at=at)
    if model.cfg.num_experts and batch_sharded and SH.is_sharded(mesh) \
            and mesh.data > 1:  # weight_gather's pmean, once for the sum
        aux = sum_fp32(aux, mesh, "data") / mesh.data
    h = final_norm(model, h, seq)
    if seq:
        h = gather_replicated(h, mesh, "model", 1)
    if return_hidden:
        return h, aux
    return lm_logits(model, h, at.mesh), aux


# =============================================================== loss/train
def _data_split(mesh) -> bool:
    """Whether ``mesh`` splits the batch: more than one data shard."""
    return mesh is not None and mesh.data > 1


def _global_mean(s: torch.Tensor, n: torch.Tensor, mesh) -> torch.Tensor:
    """sum(s) / max(sum(n), 1) over the data shards, on every rank: the
    count summed over ``data`` first (no gradient), each rank's term its s
    over that count, the terms summed over ``data`` (backward: the
    cotangent itself, so a shard's s gets 1 / the global count)."""
    n = mesh.sum(n.detach(), "data")
    return sum_fp32(s / torch.clamp(n, min=1.0), mesh, "data")


def cross_entropy(logits: torch.Tensor, labels, weights=None,
                  mesh=None) -> torch.Tensor:
    """Mean token CE of logits (..., V) at labels (...), the log-softmax
    in fp32; with ``weights`` (...), the weighted sum over max(sum(w),
    1). With a ``mesh`` of more than one data shard, the logits are this
    shard's rows and the CE is the global batch's: the sums over every
    shard divided by the global count (or sum(w))."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = torch.as_tensor(labels, device=logits.device).long()
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    if weights is not None:
        w = torch.as_tensor(weights, device=logits.device).to(torch.float32)
    if _data_split(mesh):
        if weights is None:
            return _global_mean(-torch.sum(ll), torch.tensor(
                float(ll.numel()), device=ll.device), mesh)
        return _global_mean(-torch.sum(ll * w), torch.sum(w), mesh)
    if weights is None:
        return -torch.mean(ll)
    return -torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1.0)


def chunked_cross_entropy(model: Transformer, h: torch.Tensor, labels,
                          weights, chunk: int, mesh=None) -> torch.Tensor:
    """The CE of the logits of hidden states h (B, S, d), one sequence
    chunk at a time: the (B, S, V) logits are never held (the peak is
    (B, chunk, V)), and under autograd each chunk goes through
    ``torch.utils.checkpoint``, so the backward recomputes its logits
    instead of keeping them. ``min(chunk, S)`` must divide S (the
    reference asserts it; here ``ValueError``). On a ``mesh`` (the
    model's by default) the logits are the vocab-gathered ones and, with
    more than one data shard, the CE is the global batch's
    (:func:`cross_entropy`)."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunked_cross_entropy: the sequence length {S} "
                         f"is not a multiple of the chunk {chunk}")
    dev = h.device
    mesh = mesh or model.mesh
    labels = torch.as_tensor(labels, device=dev).long()
    if weights is not None:
        weights = torch.as_tensor(weights, device=dev).to(torch.float32)

    def body(hc, lc, wc):
        logp = torch.log_softmax(lm_logits(model, hc, mesh).to(
            torch.float32), dim=-1)
        ll = torch.gather(logp, -1, lc[..., None])[..., 0]
        if wc is None:
            return -torch.sum(ll), torch.tensor(float(ll.numel()),
                                                device=dev)
        return -torch.sum(ll * wc), torch.sum(wc)

    remat = torch.is_grad_enabled() and (h.requires_grad
                                         or _differentiated(model))
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for c0 in range(0, S, chunk):
        args = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                None if weights is None else weights[:, c0:c0 + chunk])
        s, n = (checkpoint(body, *args, use_reentrant=False) if remat
                else body(*args))
        tot, cnt = tot + s, cnt + n
    if _data_split(mesh):
        return _global_mean(tot, cnt, mesh)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(model: Transformer, batch: dict, mesh=None):
    """(loss, (ce, aux)) of a batch {"labels" (B, S_text), and "tokens"
    (B, S_text) or "embeds" (B, S, d), optionally "prefix_embeds" (B, P,
    d) and "loss_weights" (B, S_text)}: loss = ce + router_aux_coef *
    aux. The prefix positions (vlm) carry no LM loss. With
    ``cfg.ce_chunk`` the CE is :func:`chunked_cross_entropy`'s. On a mesh
    (the model's own; ``mesh=`` may only restate it, :func:`placement`)
    the batch is this rank's data shard's rows, and the loss is the
    global batch's on every rank: the CE over every shard's tokens and
    the aux the mean over ``data``."""
    cfg = model.cfg
    mesh = placement(model, mesh).mesh
    labels = batch["labels"]
    out, aux = forward(model, tokens=batch.get("tokens"),
                       embeds=batch.get("embeds"),
                       prefix_embeds=batch.get("prefix_embeds"),
                       return_hidden=bool(cfg.ce_chunk), mesh=mesh)
    pad = out.shape[1] - labels.shape[1]
    if pad:  # prefix positions (vlm) carry no LM loss
        out = out[:, pad:]
    if cfg.ce_chunk:
        ce = chunked_cross_entropy(model, out, labels,
                                   batch.get("loss_weights"), cfg.ce_chunk,
                                   mesh)
    else:
        ce = cross_entropy(out, labels, batch.get("loss_weights"), mesh)
    return ce + cfg.router_aux_coef * aux, (ce, aux)


def data_replicated(model: Transformer) -> list:
    """The names of the parameters whole on every data shard (no
    ``"data"`` entry in their spec): the norms, the router, Mamba1's
    conv, dt and A/D leaves, an unsplit vocab's; on a mesh with more than
    one data shard their gradients are summed over ``data``."""
    if not _data_split(model.mesh):
        return []
    return [name for name, (spec, _) in model.leaf_specs().items()
            if "data" not in spec]


def loss_and_grads(model: Transformer, batch: dict, mesh=None):
    """(loss, (ce, aux), {parameter name: gradient}) of :func:`loss_fn`
    on ``batch``, the gradient of each of this rank's blocks: zeros for a
    parameter the loss does not reach (the untied embedding of an
    ``embeds`` model), as the reference's; on a mesh with more than one
    data shard the :func:`data_replicated` leaves' gradients summed over
    ``data`` in one all-reduce (the FSDP blocks hold theirs already)."""
    mesh = placement(model, mesh).mesh
    params = dict(model.named_parameters())
    loss, (ce, aux) = loss_fn(model, batch, mesh)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(params.items(), grads)}
    summed = data_replicated(model)
    if summed:
        flat = mesh.all_reduce_(torch.cat(
            [grads[n].reshape(-1) for n in summed]), "data")
        for n, g in zip(summed, flat.split([grads[n].numel()
                                            for n in summed])):
            grads[n] = g.view_as(grads[n])
    return loss, (ce, aux), grads


def make_train_step(model: Transformer, lr: float = 3e-4, mesh=None):
    """(opt, train_step): AdamW(lr, weight_decay=0.01) and a step
    ``train_step(opt_state, batch) -> (opt_state, {"loss", "ce",
    "aux"})`` that takes one backward of :func:`loss_fn`
    (:func:`loss_and_grads`) and updates the model's parameters in
    place. The model must be trainable; the state is
    ``opt.init(dict(model.named_parameters()))``. On a mesh (the model's
    own; ``mesh=`` may only restate it) ``batch`` is this rank's rows and
    AdamW updates each rank's blocks."""
    mesh = placement(model, mesh).mesh
    params = dict(model.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("make_train_step needs a trainable model "
                         "(init_model(..., trainable=True))")
    opt = AdamW(lr=lr, weight_decay=0.01)

    def train_step(opt_state, batch):
        loss, (ce, aux), grads = loss_and_grads(model, batch, mesh)
        _, opt_state = opt.apply(grads, opt_state, params)
        return opt_state, {"loss": loss.detach(), "ce": ce.detach(),
                           "aux": aux.detach()}

    return opt, train_step


# ================================================================== caches
def attn_cache_shape(cfg: ArchConfig, B: int, S_max: int):
    return (B, S_max, cfg.num_kv_heads, cfg.resolved_head_dim)


def _state_shapes(cfg: ArchConfig, B: int):
    """The conv and ssm state shapes of the L Mamba layers: (L, B, K-1,
    di) and (L, B, di, N) for Mamba1, (L, B, K-1, di+2N) and (L, B, nh,
    p, N) for the hybrid's Mamba2."""
    nl, di, N, K = cfg.num_layers, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.family == "ssm":
        return (nl, B, K - 1, di), (nl, B, di, N)
    p = cfg.ssm_headdim
    return (nl, B, K - 1, di + 2 * N), (nl, B, di // p, p, N)


def _kv_layers(cfg: ArchConfig) -> int:
    """The KV caches' leading axis: L, or the hybrid's J groups (one set
    of caches for each run of the shared block)."""
    return num_groups(cfg) if cfg.family == "hybrid" else cfg.num_layers


def _cache_shapes(cfg: ArchConfig, B: int, S_max: int, mesh=None,
                  batch_sharded: bool = True) -> dict:
    """{name: shape} of :func:`init_caches`' caches for a global batch of
    B, cut to this rank's blocks by :func:`cache_layout` on a mesh."""
    shapes = {}
    if cfg.family in ("ssm", "hybrid"):
        shapes["conv"], shapes["ssm"] = _state_shapes(cfg, B)
    if cfg.family != "ssm":
        kv = (_kv_layers(cfg),) + attn_cache_shape(cfg, B, S_max)
        shapes["k"] = shapes["v"] = kv
        if cfg.kv_cache_dtype == "int8" and cfg.family != "hybrid":
            shapes["k_scale"] = shapes["v_scale"] = kv[:-1] + (1,)
    if not SH.is_sharded(mesh):
        return shapes
    layout = cache_layout(cfg, batch_sharded, mesh.model)
    return {n: SH.local_shape(shp, layout[n][0], mesh.shape, layout[n][1],
                              name=f"cache {n}")
            for n, shp in shapes.items()}


def init_caches(cfg: ArchConfig, B: int, S_max: int,
                dtype: torch.dtype = torch.bfloat16, device=None, mesh=None,
                batch_sharded: bool = True) -> dict:
    """Zero decode caches on ``device`` (``cuda`` unless ``"cpu"``).
    S_max = window size for sliding-window decode. ``dtype`` is the KV
    dtype (bf16, as the reference, whatever ``cfg.dtype``); with
    ``kv_cache_dtype="int8"`` the caches are int8 codes with bf16
    per-(token, head) scales. The ssm family's caches are the conv
    states (L, B, K-1, di) in ``dtype`` and the ssm states (L, B, di, N)
    in fp32, whatever S_max. The hybrid's are conv (L, B, K-1, di+2N) in
    ``dtype``, ssm (L, B, nh, p, N) fp32 and k/v (J, B, S_max, KVH, hd)
    in ``dtype`` (the reference's are bf16 whatever ``kv_cache_dtype``:
    an int8 cache is refused with ``ValueError``). On a ``mesh``, B is
    the global batch and the caches are this rank's blocks
    (:func:`cache_layout`): B / data rows when ``batch_sharded``, KVH /
    model heads (every head under ``attn_shard="head_dim"``), d_inner /
    model channels (the hybrid's: its heads' channels and B, C)."""
    dev = resolve_device(device)
    if cfg.family == "hybrid" and cfg.kv_cache_dtype == "int8":
        raise ValueError(f"{cfg.name}: the hybrid's KV caches are bf16 "
                         "(the reference has no int8 hybrid cache)")
    kv = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    dtypes = {"conv": dtype, "ssm": torch.float32, "k": kv, "v": kv,
              "k_scale": torch.bfloat16, "v_scale": torch.bfloat16}
    return {n: torch.zeros(shp, dtype=dtypes[n], device=dev) for n, shp in
            _cache_shapes(cfg, B, S_max, mesh, batch_sharded).items()}


# ================================================================== prefill
@torch.no_grad()
def prefill(model: Transformer, tokens=None, embeds=None, prefix_embeds=None,
            mesh=None, batch_sharded: bool = True,
            moe_serving_mode: str = "weight_gather"):
    """Run the full prompt; return (last-token logits (B, V), caches
    {"k", "v"} of shape (L, B, S, KVH, hd) in the activation dtype,
    filled with the S positions). The ssm family's caches are the states
    after the prompt: {"conv": (L, B, K-1, di) in the activation dtype,
    "ssm": (L, B, di, N) fp32}; the hybrid's are {"conv": (L, B, K-1,
    di+2N), "ssm": (L, B, nh, p, N) fp32, "k", "v": (J, B, S, KVH, hd)}.
    On a mesh (the model's own; ``mesh=`` may only restate it,
    :func:`placement`) the inputs are this rank's B rows (the module
    docstring), the logits are every rank's exact gather, and the caches
    hold the rank's heads or channels (:func:`cache_layout`). Under
    ``cfg.seq_parallel`` the layers run on S slices (the module
    docstring); the caches are whole over S."""
    cfg = model.cfg
    at = placement(model, mesh, batch_sharded, moe_serving_mode)
    seq = seq_parallel(cfg, at.mesh)
    h = _inputs(model, tokens, embeds, prefix_embeds, at.mesh)
    B, S, _ = h.shape
    shapes = _cache_shapes(cfg, B, S, at.mesh, batch_sharded=False)
    caches = {n: torch.empty(shapes[n], dtype=torch.float32 if n == "ssm"
                             else h.dtype, device=h.device)
              for n in ("conv", "ssm", "k", "v") if n in shapes}
    if seq:
        h = _to_slices(h, cfg, at.mesh)
    h, _ = _run_layers(model, h, caches, at=at)
    if seq:
        h = gather_replicated(h, at.mesh, "model", 1)
    h = final_norm(model, h[:, -1:])
    return lm_logits(model, h, at.mesh)[:, 0], caches


# ================================================================== decode
def _quant(x: torch.Tensor):
    """Per-(token, head) symmetric int8: codes and bf16 scales."""
    s = torch.amax(x.abs(), dim=-1, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def _attn_decode(h, blk: Block, cfg: ArchConfig, caches: dict, i: int,
                 pos: int, window: bool, rope, mesh=None):
    """h (B,1,d) against cache slot i's positions (layer i, or the
    hybrid's group i); writes this token's k, v (int8 codes and scales
    with ``kv_cache_dtype="int8"``) into position ``pos`` (``pos % S_c``
    with ``window``, a ring buffer)."""
    dt = _dt(cfg)
    x = L.apply_norm(h, blk.norm1, cfg)
    q, k, v = blk.attn.qkv(x, mesh)
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
    return h + blk.attn.out(o, mesh)


def _ssm_decode(h, blk: MambaBlock, cfg: ArchConfig, caches: dict, i: int,
                mesh=None):
    """h (B, 1, d) through Mamba layer i from its states, which are
    overwritten with the new ones."""
    x = L.apply_norm(h[:, 0], blk.norm, cfg)
    state = {"conv": caches["conv"][i], "ssm": caches["ssm"][i]}
    if cfg.family == "ssm":
        y, state = SS.mamba1_decode(x, state, blk.mamba, cfg, mesh)
    else:
        y, state = SS.mamba2_decode(x, state, blk.mamba, cfg, mesh)
    caches["conv"][i], caches["ssm"][i] = state["conv"], state["ssm"]
    return h + y[:, None]


@torch.no_grad()
def decode_step(model: Transformer, caches: dict, token=None, embed=None,
                pos=None, window: bool = False, mesh=None,
                batch_sharded: bool = True,
                moe_serving_mode: str = "weight_gather"):
    """One serving step: next-token logits (B, V) given the caches at
    position ``pos`` (an int). token (B,) or embed (B, d). The caches are
    updated in place and returned. The ssm family reads no position: its
    caches are the states after the tokens so far. ``moe_serving_mode``
    is the reference's knob; without a mesh both modes run the same
    local MoE path. On a mesh (the model's own; ``mesh=`` may only
    restate it, :func:`placement`) token or embed are this rank's rows
    and the caches its blocks (:func:`init_caches`).

    The reference's decode returns the conv states in the activation
    dtype, so a conv cache in another dtype (bf16 caches under an fp32
    model) takes the activation dtype here, once; in bf16 serving the two
    agree and nothing is copied."""
    cfg = model.cfg
    at = placement(model, mesh, batch_sharded, moe_serving_mode)
    if embed is not None:
        h = torch.as_tensor(embed, device=model.device)[:, None, :].to(
            _dt(cfg))
    else:
        h = embed_tokens(model, torch.as_tensor(token)[:, None], at.mesh)
    if "conv" in caches and caches["conv"].dtype != h.dtype:
        caches["conv"] = caches["conv"].to(h.dtype)
    rope = (None if cfg.family == "ssm" else
            _rope(torch.tensor([int(pos)], device=h.device), cfg))
    k = cfg.shared_attn_every
    for i, blk in enumerate(model.layers):
        if isinstance(blk, MambaBlock):
            h = _ssm_decode(h, blk, cfg, caches, i, at.mesh)
            if model.shared is None or (i + 1) % k:
                continue
            blk, i = model.shared, i // k
        h = _attn_decode(h, blk, cfg, caches, i, int(pos), window, rope,
                         at.mesh)
        h, _ = _ffn_full(h, blk, cfg, at)
    h = final_norm(model, h)
    return lm_logits(model, h[:, 0], at.mesh), caches


def make_serve_step(model: Transformer, window: bool = False, mesh=None,
                    batch_sharded: bool = True,
                    moe_serving_mode: str = "weight_gather"):
    """The decode step as a closure ``serve_step(caches, token_or_embed,
    pos)`` (an embedding for a model that takes embeddings). ``mesh``
    may only restate the model's own (:func:`placement`)."""
    def serve_step(caches, token_or_embed, pos):
        kw = ({"embed": token_or_embed} if model.cfg.embeds_in
              else {"token": token_or_embed})
        return decode_step(model, caches, pos=pos, window=window, mesh=mesh,
                           batch_sharded=batch_sharded,
                           moe_serving_mode=moe_serving_mode, **kw)

    return serve_step
