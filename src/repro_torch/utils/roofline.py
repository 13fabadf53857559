"""Three-term roofline of an LM step (NVIDIA H100 constants).

The port's counterpart of ``repro/utils/roofline.py``, line for line::

    compute term    = FLOPs_per_chip / peak_FLOP/s
    memory term     = HBM_bytes_per_chip / HBM_bw
    collective term = collective_bytes_per_chip / link_bw

with the card's constants (``launch/mesh.py``: NVIDIA H100 80GB HBM3,
700 W). The reference reads its per-chip numbers from XLA's cost
analysis of the compiled SPMD step; torch has no such analysis, so here
the three inputs are counts:

  * ``flops``: the step's FLOPs from the shapes (:func:`lm_step_flops`),
    the checkpoint's recompute and attention's S^2 terms included;
  * ``hbm_bytes``: a lower bound (:func:`lm_train_hbm_bytes`): the
    parameters, gradients and AdamW's two moments each read and written
    once a step, plus the activations saved across the checkpoint, each
    written once and read once;
  * ``coll_bytes``: the bytes a rank's collectives moved, as its
    :class:`~repro_torch.launch.mesh.Mesh` counts them
    (``collective_counts``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    flops: float  # per chip
    hbm_bytes: float  # per chip
    coll_bytes: float  # per chip
    model_flops: float  # useful 6ND (or 2ND) per chip

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time if terms overlap perfectly."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the remat / redundancy gauge."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model-FLOPs utilisation at the roofline."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS_BF16) / self.t_bound

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "model_flops_per_chip": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_per_chip(cfg, shape_kind: str, tokens: int, chips: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference, split per chip."""
    n = cfg.active_param_count()
    mult = 6 if shape_kind == "train" else 2
    return mult * n * tokens / chips


# ------------------------------------------------------------ the counts
def matmul_params(cfg) -> int:
    """The weights one token multiplies in the layers, counted from the
    shapes: attention's wq, wk, wv, wo (H hd, KVH hd and d wide), the
    MLP's two or three (d, d_ff) matrices, or the router and top_k of the
    E experts; Mamba1's in_proj, x_proj, dt_proj and out_proj; Mamba2's
    in_proj and out_proj; the hybrid's shared block once per group. The
    head is not among them (:func:`lm_step_flops` counts it)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
    if cfg.num_experts:
        mlp = d * cfg.num_experts + cfg.top_k * 3 * d * cfg.d_ff
    di, N = cfg.d_inner, cfg.ssm_state
    if cfg.family == "ssm":
        R = cfg.resolved_dt_rank
        return cfg.num_layers * (d * 2 * di + di * (R + 2 * N) + R * di
                                 + di * d)
    if cfg.family == "hybrid":
        nh = di // cfg.ssm_headdim
        groups = cfg.num_layers // cfg.shared_attn_every
        return (cfg.num_layers * (d * (2 * di + 2 * N + nh) + di * d)
                + groups * (attn + mlp))
    return cfg.num_layers * (attn + mlp)


def _mixer_flops(cfg, B: int, S: int) -> float:
    """The forward FLOPs outside the weight products: causal attention's
    two S^2 products, 2 B H hd S (S + 1) / 2 each, per attention unit;
    the causal conv (2 K a channel and token); Mamba1's scan (6 a
    channel, state and token: the decay, its product and the two
    multiply-adds); Mamba2's chunked SSD's products (per token and chunk
    length l: 2 l N for C.B, and per head 2 l p for the weighted sum and
    4 p N for the chunk states and their read-out)."""
    T, hd = B * S, cfg.resolved_head_dim
    attn = 2 * B * cfg.num_heads * hd * S * (S + 1)
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.family == "ssm":
        return cfg.num_layers * T * di * (2 * K + 6 * N)
    if cfg.family == "hybrid":
        p, l = cfg.ssm_headdim, min(cfg.ssd_chunk, S)
        nh = di // p
        per_token = (2 * K * (di + 2 * N) + 2 * l * N
                     + nh * (2 * l * p + 4 * p * N))
        return (cfg.num_layers * T * per_token
                + cfg.num_layers // cfg.shared_attn_every * attn)
    return cfg.num_layers * attn


def _units_last_product(cfg) -> tuple[int, int]:
    """(the checkpointed units of a forward, the weights of each unit's
    last product that the backward does not read): a layer ending in w2
    (d_ff x d) or Mamba1's out_proj (d_inner x d); the hybrid's group
    ending in the shared block's w2; an MoE layer none (its combine
    reads the experts' outputs for the gates' gradient)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return cfg.num_layers, cfg.d_inner * d
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every, cfg.d_ff * d
    return cfg.num_layers, 0 if cfg.num_experts else cfg.d_ff * d


def lm_step_flops(cfg, B: int, S: int, train: bool = True,
                  remat: bool = True) -> float:
    """The FLOPs of one step on a batch of B x S tokens, from the shapes.
    F = 2 T :func:`matmul_params` + the mixers' (:func:`_mixer_flops`),
    H = 2 T d V (the head). Training: 3 (F + H) (the forward and a
    backward of twice its work); with ``remat`` each unit's forward runs
    again in its recompute, less its last product (torch's checkpoint
    stops once it has rebuilt what the backward reads, and a product's
    backward does not read its output); with ``cfg.ce_chunk`` H once more
    (the chunked CE's recompute). A prefill (``train`` False): F + 2 B d
    V (the last position's logits)."""
    T = B * S
    F = 2 * T * matmul_params(cfg) + _mixer_flops(cfg, B, S)
    head = 2 * cfg.d_model * cfg.vocab_size
    if not train:
        return F + B * head
    units, last = _units_last_product(cfg)
    recompute = F - units * 2 * T * last if remat else 0
    return 3 * F + recompute + (3 + bool(cfg.ce_chunk)) * T * head


def lm_train_hbm_bytes(cfg, params: int, B: int, S: int,
                       units: int) -> float:
    """A lower bound on one training step's device-memory traffic on a
    rank holding ``params`` parameters and feeding B x S positions
    through ``units`` checkpointed units: the parameters, their
    gradients and AdamW's two moments (each ``cfg.param_dtype``), each
    read once and written once; and each unit's saved input (B, S, d) in
    ``cfg.dtype``, written in the forward and read in the recompute."""
    p = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return 4 * 2 * p * params + 2 * units * B * S * cfg.d_model * a
