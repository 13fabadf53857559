"""musicgen-medium [audio] — decoder-only LM over EnCodec tokens
[arXiv:2306.05284]. The EnCodec/conv frontend is a STUB per the modality
carve-out: `input_specs` provides precomputed frame embeddings (B,S,d);
the decoder predicts codebook tokens (vocab 2048)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", source="arXiv:2306.05284",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    mlp_type="gelu", embeds_in=True,
)
