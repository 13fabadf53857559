"""internvl2-2b [vlm] — InternViT frontend (STUB embeddings per the
modality carve-out) + InternLM2-1.8B language backbone [arXiv:2404.16821].
`input_specs` provides 256 precomputed patch embeddings per image."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm", source="arXiv:2404.16821",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    mlp_type="swiglu", num_prefix_embeds=256,
)
