"""falcon-mamba-7b [ssm] — attention-free Mamba1 [arXiv:2410.05355]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm", source="arXiv:2410.05355",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_version=1, ssm_state=16, ssm_expand=2, ssm_conv=4,
)
