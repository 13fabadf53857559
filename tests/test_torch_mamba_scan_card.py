"""The Mamba1 selective scan (B7) on a CUDA card, held against the port's
own plain versions (moved out of ``tests/test_torch_mamba_scan.py``, whose
CPU tests hold those plain versions against the JAX reference).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_mamba_scan_card.py``
(``chip_smoke.py`` phase 27). Every test needs a card and skips without
one. The contract mode against ``ops.plain_scan`` within rtol = atol =
2e-5 and bit for bit at every G, the gated mode against the unfused
composition (torch's softplus, the plain scan, torch's silu gate) bit for
bit, chained halves bitwise one call, and the state-size rule.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan as tk
from repro_torch.kernels.mamba_scan import ops

TOL = 2e-5  # tests/test_kernels.py:175


def _inputs(seed, B, S, di, N, h0=False):
    """dt = softplus(normal), x, B, C normal, A = -exp(0.5 normal), D
    normal, h0 normal (or None), as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt = np.log1p(np.exp(f(B, S, di))).astype(np.float32)
    return [dt, f(B, S, di), f(B, S, N), f(B, S, N),
            -np.exp(0.5 * f(di, N)).astype(np.float32), f(di),
            f(B, di, N) if h0 else None]


def _torch(arrays, xbc_dtype=torch.float32, device="cpu"):
    out = [None if a is None else torch.from_numpy(a).to(device)
           for a in arrays]
    for i in (1, 2, 3):
        out[i] = out[i].to(xbc_dtype)
    return out


def _gated_inputs(seed, B, S, di, N, h0=False):
    """The gated scan's inputs as numpy float32: dt_raw 3 normal with
    every 7th value above softplus's threshold (20), dt_bias normal - 3,
    x, B, C normal, A_log 0.5 normal, D, z normal, h0 normal (or None)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt_raw = 3 * f(B, S, di)
    dt_raw.reshape(-1)[::7] = 21 + np.abs(dt_raw.reshape(-1)[::7])
    return [dt_raw, f(di) - 3, f(B, S, di), f(B, S, N), f(B, S, N),
            0.5 * f(di, N), f(di), f(B, S, di), f(B, di, N) if h0 else None]


def _gated_torch(arrays, dtype=torch.float32, device="cpu"):
    """dt_raw, x, B, C and z in ``dtype``; the rest float32."""
    out = [None if a is None else torch.from_numpy(a).to(device)
           for a in arrays]
    for i in (0, 2, 3, 4, 7):
        out[i] = out[i].to(dtype)
    return out


def _composition(t):
    """The model's unfused composition around the plain scan."""
    dt_raw, dt_bias, x, B_in, C_in, A_log, D, z, h0 = t
    dt = F.softplus(dt_raw.float() + dt_bias)
    y, h = ops.plain_scan(dt, x, B_in, C_in, -torch.exp(A_log), D, h0)
    return (y * F.silu(z.float())).to(x.dtype), h


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _strided_bc(arrays, dtype, device):
    """B and C as column slices of one (B, S, R + 2N) tensor, R = 5."""
    Bsz, S, N = arrays[2].shape
    fused = torch.zeros((Bsz, S, 5 + 2 * N), dtype=dtype, device=device)
    fused[..., 5:5 + N] = torch.from_numpy(arrays[2]).to(device, dtype)
    fused[..., 5 + N:] = torch.from_numpy(arrays[3]).to(device, dtype)
    return fused[..., 5:5 + N], fused[..., 5 + N:]


CARD_SHAPES = [(2, 16, 32, 8, False), (2, 32, 64, 16, True),
               (2, 8, 16, 4, False), (3, 37, 100, 16, True),
               (1, 70, 40, 32, True), (4, 1, 520, 16, True),
               (2, 300, 257, 4, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,h0", CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda, B, S, di, N, h0, dtype):
    arrays = _inputs(7, B, S, di, N, h0)
    t = _torch(arrays, getattr(torch, dtype), cuda)
    t[2], t[3] = _strided_bc(arrays, getattr(torch, dtype), cuda)
    before = tk.LAUNCHES["mamba1_scan"]
    y, h = ops.selective_scan(*t)
    y2, h2 = ops.selective_scan(*t)
    py, ph = ops.plain_scan(*t)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mamba1_scan"] == before + 2
    assert y.dtype == h.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(h, h2)
    torch.testing.assert_close(y, py, rtol=TOL, atol=TOL)
    torch.testing.assert_close(h, ph, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_kernel_chained_halves_bitwise(cuda):
    t = _torch(_inputs(8, 2, 96, 64, 16), torch.bfloat16, cuda)
    y, h = tk.mamba1_scan(*t)
    ya, ha = tk.mamba1_scan(*(a[:, :41] for a in t[:4]), t[4], t[5])
    yb, hb = tk.mamba1_scan(*(a[:, 41:] for a in t[:4]), t[4], t[5], ha)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([ya, yb], dim=1), y) and torch.equal(hb, h)


@pytest.mark.cuda
def test_kernel_refuses_other_state_sizes(cuda):
    t = _torch(_inputs(9, 1, 4, 8, 6), torch.float32, cuda)
    with pytest.raises(ValueError, match="state size"):
        tk.mamba1_scan(*t)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,h0", CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_equals_plain_bitwise_on_card(cuda, B, S, di, N, h0, dtype):
    """The contract mode at every G equals plain_scan bit for bit (the
    same fp32 operations in the same order)."""
    arrays = _inputs(7, B, S, di, N, h0)
    t = _torch(arrays, getattr(torch, dtype), cuda)
    t[2], t[3] = _strided_bc(arrays, getattr(torch, dtype), cuda)
    py, ph = ops.plain_scan(*t)
    for g in (g for g in tk.GROUPS if g <= N):
        y, h = tk.mamba1_scan(*t, group=g)
        torch.cuda.synchronize()
        assert torch.equal(y, py) and torch.equal(h, ph), g


def _gated_on_card(arrays, dtype, device, R=5):
    """The gated inputs on the card, with B and C column slices of one
    (B, S, R + 2N) tensor and z the second half of one (B, S, 2 di)."""
    t = _gated_torch(arrays, dtype, device)
    Bsz, S, N = arrays[3].shape
    di = arrays[2].shape[2]
    fused = torch.zeros((Bsz, S, R + 2 * N), dtype=dtype, device=device)
    fused[..., R:R + N], fused[..., R + N:] = t[3], t[4]
    xz = torch.zeros((Bsz, S, 2 * di), dtype=dtype, device=device)
    xz[..., di:] = t[7]
    t[3], t[4], t[7] = fused[..., R:R + N], fused[..., R + N:], xz[..., di:]
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,h0", CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_kernel_equals_composition_on_card(cuda, B, S, di, N, h0,
                                                 dtype):
    """The gated mode at every G equals the unfused composition (torch's
    softplus, the plain scan, torch's silu gate) on the card bit for bit,
    repeatably, through the entry the model calls."""
    t = _gated_on_card(_gated_inputs(15, B, S, di, N, h0),
                       getattr(torch, dtype), cuda)
    wy, wh = _composition(t)
    before = tk.LAUNCHES["mamba1_scan_gated"]
    y, h = ops.gated_selective_scan(*t)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["mamba1_scan_gated"] == before + 1
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    assert torch.equal(y, wy) and torch.equal(h, wh)
    for g in (g for g in tk.GROUPS if g <= N):
        gy, gh = tk.mamba1_scan_gated(*t, group=g)
        torch.cuda.synchronize()
        assert torch.equal(gy, wy) and torch.equal(gh, wh), g


@pytest.mark.cuda
def test_gated_kernel_chained_halves_bitwise(cuda):
    t = _gated_on_card(_gated_inputs(16, 2, 96, 64, 16), torch.bfloat16,
                       cuda)
    y, h = tk.mamba1_scan_gated(*t)
    first, second = list(t), list(t)
    for i in (0, 2, 3, 4, 7):
        first[i], second[i] = t[i][:, :41], t[i][:, 41:]
    ya, ha = tk.mamba1_scan_gated(*first)
    second[8] = ha
    yb, hb = tk.mamba1_scan_gated(*second)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([ya, yb], dim=1), y) and torch.equal(hb, h)
