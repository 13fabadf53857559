"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense", source="hf:meta-llama/Llama-3.2-1B",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    mlp_type="swiglu", rope_theta=500000.0, tie_embeddings=True,
)
