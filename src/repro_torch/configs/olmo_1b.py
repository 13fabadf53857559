"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense", source="arXiv:2402.00838",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304, head_dim=128,
    mlp_type="swiglu", norm_type="nonparametric", tie_embeddings=True,
)
