"""The hybrid family's (zamba2) shared attention block on a CUDA card:
B6 on its q, k, v against the plain version, once per group in a
prefill (moved out of ``test_torch_hybrid.py``).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_hybrid_card.py``.
Every test needs a card and skips without one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.kernels.flash_attention import flash_attention as tk
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as T

ARCH = "zamba2-2.7b"


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b6_on_the_shared_blocks_qkv(cuda, dtype):
    """B6 on the q, k, v the shared block makes from a reduced model's
    hidden states on the card (hd 64, no copy where TMA reads in place)
    against its plain version, and the model's prefill launches it once
    per group."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                              num_layers=4, dtype=dtype)
    model = tmodels.init_model(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 8, (2, 64))).to(cuda)
    h = T.embed_tokens(model, toks)
    blk = model.shared
    q, k, v = blk.attn.qkv(tlayers.apply_norm(h, blk.norm1, cfg))
    rope = T._rope(torch.arange(64, device=cuda), cfg)
    q, k = tlayers.apply_rope(q, *rope), tlayers.apply_rope(k, *rope)
    got = attention_ops.causal_attention(q, k, v)
    want = attention_ops.plain_attention(q, k, v)
    tol = {"float32": 2e-5, "bfloat16": 3e-2}[dtype]  # tests/test_kernels.py:133
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    before = tk.LAUNCHES["flash_attention"]
    tmodels.prefill(model, tokens=toks)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_attention"] == before + T.num_groups(cfg)
