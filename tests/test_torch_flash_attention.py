"""Flash attention (B6) in the port against the JAX reference on the same
numpy inputs.

On the CPU the port's plain versions (``layers.chunked_causal_attention``
for causal attention, ``ref.attention_ref`` otherwise, behind
``ops.causal_attention``) are held against the reference's jnp oracles
``repro.kernels.flash_attention.ref.attention_ref`` and
``repro.models.layers.chunked_causal_attention``, at the bars of
``tests/test_kernels.py``: fp32 within 2e-5, bf16 within 3e-2. The
reference's Pallas kernel is not run here (its interpret mode needs a
TPU compiler-params class this jax lacks). The tests that hold the
CUDA kernel against the plain version on a card are jax-free, in
``tests/test_torch_flash_attention_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import flash_attention as tk
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref as t_attention_ref,
)
from repro_torch.models import layers as tlayers

# one compilation per shape instead of one per jnp op
j_attention_ref = jax.jit(attention_ref, static_argnames="causal")
j_chunked = jax.jit(jlayers.chunked_causal_attention,
                    static_argnames="chunk")

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, B, S, H, hd, kvh=None):
    rng = np.random.default_rng(seed)
    kvh = kvh or H
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, kvh, hd)).astype(np.float32),
            rng.normal(size=(B, S, kvh, hd)).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------ plain vs reference
@pytest.mark.parametrize("S", [32, 64, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_causal_matches_reference(S, dtype):
    """ops.causal_attention on CPU tensors against the reference's
    attention_ref, at tests/test_kernels.py's flash-attention shapes."""
    arrays = _qkv(3, 2, S, 3, 16)
    want = j_attention_ref(*_jax(arrays, dtype))
    got = ops.causal_attention(*_torch(arrays, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, S, 3, 16)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("chunk", [8, 16, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_causal_matches_reference_layer(chunk, dtype):
    arrays = _qkv(5, 2, 64, 4, 16)
    want = j_chunked(*_jax(arrays, dtype), chunk=chunk)
    got = tlayers.chunked_causal_attention(*_torch(arrays, dtype),
                                           chunk=chunk)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_non_causal_matches_reference(dtype):
    arrays = _qkv(4, 1, 32, 2, 8)
    want = j_attention_ref(*_jax(arrays, dtype), causal=False)
    got = ops.causal_attention(*_torch(arrays, dtype), causal=False)
    _close(got, want, TOL[dtype])
    torch.testing.assert_close(
        t_attention_ref(*_torch(arrays, dtype), causal=False), got, rtol=0,
        atol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_reads_kv_head_h_over_rep(causal):
    """KVH < H: query head h reads KV head h // rep, as the reference's
    repeat_kv broadcasts; the h % KVH pairing gives other numbers."""
    H, kvh = 8, 2
    arrays = _qkv(6, 2, 40, H, 16, kvh)
    jq, jk, jv = _jax(arrays, "float32")
    want = j_attention_ref(jq, jlayers.repeat_kv(jk, H // kvh),
                           jlayers.repeat_kv(jv, H // kvh), causal=causal)
    q, k, v = _torch(arrays, "float32")
    got = ops.causal_attention(q, k, v, causal=causal)
    _close(got, want, TOL["float32"])
    np.testing.assert_array_equal(
        tlayers.repeat_kv(k, H // kvh).numpy(),
        np.asarray(jlayers.repeat_kv(jk, H // kvh)))
    modulo = torch.arange(H) % kvh
    wrong = t_attention_ref(q, k[:, :, modulo], v[:, :, modulo], causal=causal)
    assert float((wrong - got).abs().max()) > 0.1


@pytest.mark.parametrize("S,chunk", [(37, 512), (37, 16), (600, 512)])
def test_odd_sequence_lengths(S, chunk):
    """Any S works in the port (the reference's chunked path asserts
    S % chunk == 0): ragged last chunks against attention_ref."""
    arrays = _qkv(7, 1, S, 2, 8)
    want = j_attention_ref(*_jax(arrays, "float32"))
    got = ops.causal_attention(*_torch(arrays, "float32"), chunk=chunk)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_head_dim_80_matches_reference(causal, dtype):
    """hd 80 (zamba2-2.7b: 2560 / 32) on the plain version against the
    reference's jnp oracle and, causal, its model layer (GQA rep 4)."""
    H, kvh = 8, 2
    arrays = _qkv(12, 2, 40, H, 80, kvh)
    jq, jk, jv = _jax(arrays, dtype)
    jk, jv = (jlayers.repeat_kv(t, H // kvh) for t in (jk, jv))
    got = ops.causal_attention(*_torch(arrays, dtype), causal=causal)
    assert got.shape == (2, 40, H, 80)
    _close(got, j_attention_ref(jq, jk, jv, causal=causal), TOL[dtype])
    if causal:
        _close(got, j_chunked(jq, jk, jv, chunk=8), TOL[dtype])


def test_head_dims_include_80():
    assert 80 in tk.HEAD_DIMS
    assert set(tk.TENSOR_CORE_HEAD_DIMS) == {16, 64, 80, 128}
    assert set(tk.TENSOR_CORE_HEAD_DIMS) < set(tk.HEAD_DIMS)


def test_kernel_strides_and_tma_rules():
    """The strides the kernel is handed: a tensor's own, with any size-1
    dimension given a packed stride; TMA wants 16-byte multiples."""
    B, S, H, kvh, hd = 2, 5, 4, 2, 80
    fused = torch.zeros(B, S, (H + 2 * kvh) * hd, dtype=torch.bfloat16)
    q = fused[..., :H * hd].view(B, S, H, hd)
    k = fused[..., H * hd:(H + kvh) * hd].view(B, S, kvh, hd)
    assert tk.kernel_strides(q) == q.stride()[:3]
    assert tk.kernel_strides(k) == k.stride()[:3]
    assert tk.tma_ready(q) and tk.tma_ready(k)
    one = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 64), (3, 5, 7, 1))
    assert tk.kernel_strides(one) == (64, 64, 64)
    assert tk.tma_ready(one)
    odd = torch.zeros(B, S, H * 16 + 4, dtype=torch.bfloat16)[
        ..., :H * 16].view(B, S, H, 16)  # position stride 68: not 16 bytes
    assert not tk.tma_ready(odd)
    shifted = torch.zeros(B * S * H * 16 + 1, dtype=torch.bfloat16)[1:].view(
        B, S, H, 16)  # base 2 bytes past an aligned one
    assert not tk.tma_ready(shifted)


def test_cpu_tensor_takes_the_plain_version():
    q, k, v = _torch(_qkv(8, 2, 24, 4, 8, 2), "float32")
    before = tk.LAUNCHES["flash_attention"]
    got = ops.causal_attention(q, k, v)
    assert tk.LAUNCHES["flash_attention"] == before
    assert torch.equal(got, ops.plain_attention(q, k, v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.flash_attention(q, k, v)  # the kernel takes no CPU tensor


def test_input_rules():
    q, k, v = _torch(_qkv(9, 1, 8, 4, 8, 2), "float32")
    with pytest.raises(ValueError, match="multiple of"):
        ops.causal_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="float32 or all"):
        ops.causal_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="float32 or all"):
        ops.causal_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match=r"\(B, S, KVH, hd\)"):
        ops.causal_attention(q, k[:, :4], v[:, :4])
