"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. Simplification noted in DESIGN.md: the shared
transformer block is applied every `shared_attn_every` Mamba2 layers
(Zamba2 additionally concatenates the original embedding into the shared
block input; we apply the block on the running hidden state)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", source="arXiv:2411.15242",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_version=2, ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_headdim=64,
    shared_attn_every=6, mlp_type="swiglu",
)
