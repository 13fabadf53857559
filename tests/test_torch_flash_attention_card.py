"""Flash attention (B6) on a CUDA card, held against the port's own plain
version.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda
tests/test_torch_flash_attention_card.py``. Every test needs a card and
skips without one. Bars as ``tests/test_kernels.py``'s: fp32 within
2e-5, bf16 within 3e-2; a kernel's repeat and a strided view bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as tk
from repro_torch.kernels.flash_attention import ops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, B, S, H, hd, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or H
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, kvh, hd)).astype(np.float32),
            rng.normal(size=(B, S, kvh, hd)).astype(np.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,kvh,hd", [
    (2, 32, 3, 3, 16), (2, 64, 3, 3, 16), (2, 48, 3, 3, 16),
    (1, 32, 2, 2, 8), (2, 37, 8, 2, 64), (1, 130, 4, 1, 128),
    (1, 1, 2, 1, 64), (2, 256, 32, 8, 64),
    # hd 80, S ragged against the 128-row tile, GQA rep 4
    (1, 1, 8, 2, 80), (1, 127, 8, 2, 80), (1, 129, 8, 2, 80),
    (2, 577, 32, 8, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_card(cuda, B, S, H, kvh, hd, dtype, causal):
    q, k, v = (t.to(cuda) for t in _torch(_qkv(10, B, S, H, hd, kvh), dtype))
    before = tk.LAUNCHES["flash_attention"]
    got = ops.causal_attention(q, k, v, causal=causal)
    again = ops.causal_attention(q, k, v, causal=causal)
    want = ops.plain_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_attention"] == before + 2
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [("float32", 64), ("bfloat16", 64),
                                      ("bfloat16", 80)])
def test_kernel_reads_strided_projections(cuda, dtype, hd):
    """q, k, v as (B, S, heads, hd) views of one fused projection (head
    dim unit-stride, other strides not packed) give the same bits as
    contiguous copies (bf16: read in place by TMA)."""
    B, S, H, kvh = 2, 70, 8, 2
    rng = np.random.default_rng(11)
    fused = torch.from_numpy(rng.normal(size=(B, S, (H + 2 * kvh) * hd))
                             .astype(np.float32)).to(cuda,
                                                     getattr(torch, dtype))
    q = fused[..., :H * hd].view(B, S, H, hd)
    k = fused[..., H * hd:(H + kvh) * hd].view(B, S, kvh, hd)
    v = fused[..., (H + kvh) * hd:].view(B, S, kvh, hd)
    got = tk.flash_attention(q, k, v)
    want = tk.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_copies_what_tma_cannot_read(cuda):
    """A bf16 q whose position stride is not a multiple of 16 bytes is
    copied before the tensor-core body reads it: same bits as the
    contiguous tensor."""
    B, S, H, hd = 1, 129, 4, 16
    rng = np.random.default_rng(13)
    wide = torch.from_numpy(rng.normal(size=(B, S, H * hd + 4)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q = wide[..., :H * hd].view(B, S, H, hd)
    assert not tk.tma_ready(q)
    k = v = q.contiguous()
    got = tk.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.flash_attention(q.contiguous(), k, v))
