"""Architecture registry: ``--arch <id>`` lookup + input-shape contracts.

The port's counterpart of ``repro/configs/__init__.py``. The reference's
``input_specs`` builds ``jax.ShapeDtypeStruct`` stand-ins for the XLA dry
run and has no counterpart here: PyTorch runs eagerly and the port has no
dry run (``ROADMAP.md`` A15).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCHS = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-32b": "qwen1_5_32b",
    "zamba2-2.7b": "zamba2_2_7b",
    "olmo-1b": "olmo_1b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "internvl2-2b": "internvl2_2b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "musicgen-medium": "musicgen_medium",
    "dbrx-132b": "dbrx_132b",
}

# The four workload shapes.
INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.CONFIG


def uses_sliding_window(cfg: ArchConfig, shape_name: str) -> bool:
    """long_500k needs sub-quadratic attention: SSM/hybrid run natively,
    attention archs use the sliding-window decode variant."""
    return shape_name == "long_500k" and cfg.family != "ssm"


def decode_cache_len(cfg: ArchConfig, shape_name: str) -> int:
    spec = INPUT_SHAPES[shape_name]
    if uses_sliding_window(cfg, shape_name):
        return min(cfg.sliding_window, spec["seq_len"])
    return spec["seq_len"]
