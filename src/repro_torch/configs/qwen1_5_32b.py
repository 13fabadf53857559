"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family, 32B dims]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064, head_dim=128,
    mlp_type="swiglu", qkv_bias=True, rope_theta=1000000.0,
)
