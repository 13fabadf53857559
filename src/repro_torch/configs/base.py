"""Architecture config schema for the model zoo (the port's own copy of
``repro/configs/base.py``; the two are kept field for field alike).

Every architecture is expressed as an ``ArchConfig``; the model builder
(`repro_torch.models.transformer`) consumes it. `reduced()` yields the
smoke-test variant (2 layers, d_model<=256, <=4 experts) the CPU tests
run. The port serves every family.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    source: str  # citation (hf:... / arXiv:...)

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int | None = None  # default d_model // num_heads

    # layer flavour
    mlp_type: Literal["swiglu", "gelu"] = "swiglu"
    norm_type: Literal["rmsnorm", "nonparametric"] = "rmsnorm"  # olmo: nonparametric
    qkv_bias: bool = False  # qwen1.5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0  # 0 = dense MLP
    top_k: int = 0
    router_aux_coef: float = 0.01  # load-balance loss (divide-and-conquer health)

    # SSM (mamba)
    ssm_version: int = 0  # 0 = none, 1 = mamba1, 2 = mamba2
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64  # mamba2 head dim
    dt_rank: int | None = None  # mamba1; default ceil(d_model/16)

    # hybrid (zamba2): shared transformer block applied every k ssm layers
    shared_attn_every: int = 0  # 0 = disabled

    # modality frontend stub (vlm / audio): model consumes embeddings
    embeds_in: bool = False
    num_prefix_embeds: int = 0  # e.g. vision patches prepended (vlm)

    # long-context variant
    sliding_window: int = 8192  # used only by long_500k decode for attn archs

    # training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # sharding strategy knobs (§Perf variants; defaults = baseline plan)
    seq_parallel: bool = False  # shard inter-block activations on S over
    #                             'model' (Megatron-SP style)
    attn_shard: str = "heads"  # "heads" | "head_dim" — which attention
    #                            axis the 'model' mesh axis shards
    kv_cache_dtype: str = "bf16"  # "bf16" | "int8" (quantised serving
    #                               cache with per-(token,head) scales)
    ce_chunk: int = 0  # >0: compute logits+CE in sequence chunks of this
    #                    size (remat'd) instead of materialising (B,S,V)

    # lowering knobs (dry-run cost probes flip these; defaults are the
    # production values)
    unroll_layers: bool = False  # unroll layer/attn-chunk scans so XLA's
    #                              cost_analysis sees every iteration
    attn_chunk: int = 512  # query-chunk size of chunked causal attention
    ssd_chunk: int = 64  # mamba2 SSD chunk length

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-self.d_model // 16)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can run long_500k natively (without the sliding-window variant)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/flavour, tiny dims."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        # keep GQA ratio flavour: if original had kv < heads, keep kv < heads
        if 0 < self.num_kv_heads < self.num_heads:
            kv = max(1, heads // 2)
        if self.num_heads == 0:  # attention-free ssm
            heads, kv = 0, 0
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=(d_model // heads) if heads else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=min(self.ssm_headdim, 32),
            shared_attn_every=2 if self.shared_attn_every else 0,
            sliding_window=64,
            num_prefix_embeds=min(self.num_prefix_embeds, 8),
        )

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        per_layer = 0
        if self.family == "ssm" or self.ssm_version:
            di, N = self.d_inner, self.ssm_state
            if self.ssm_version == 1:
                per_layer += d * 2 * di + di * self.ssm_conv
                per_layer += di * (self.resolved_dt_rank + 2 * N)
                per_layer += self.resolved_dt_rank * di + di * N + di + di * d
            else:  # mamba2
                nheads = di // self.ssm_headdim
                per_layer += d * (2 * di + 2 * N + nheads) + di * self.ssm_conv
                per_layer += nheads + di * d
        if self.family != "ssm" and not (self.family == "hybrid"):
            per_layer += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.num_experts:
            per_layer += d * self.num_experts
            per_layer += self.num_experts * 3 * d * self.d_ff
        elif self.d_ff and self.family != "ssm":
            mult = 3 if self.mlp_type == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        n += L * per_layer
        if self.shared_attn_every:
            mult = 3 if self.mlp_type == "swiglu" else 2
            n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                 + self.num_heads * hd * d + mult * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """N_active for MoE/hybrid rooflines (6*N_active*D): params that
        actually multiply each token. MoE: only top-k experts. Hybrid: the
        shared transformer block runs L/shared_attn_every times, so its
        params count that many times."""
        full = self.param_count()
        d = self.d_model
        if self.num_experts:
            unused = self.num_layers * (self.num_experts - self.top_k) \
                * 3 * d * self.d_ff
            full -= unused
        if self.shared_attn_every:
            hd = self.resolved_head_dim
            mult = 3 if self.mlp_type == "swiglu" else 2
            shared = (d * self.num_heads * hd
                      + 2 * d * self.num_kv_heads * hd
                      + self.num_heads * hd * d + mult * d * self.d_ff)
            reps = self.num_layers // self.shared_attn_every
            full += (reps - 1) * shared
        return full
