"""The gated scan's backward kernel (B7's gradient) on a CUDA card, held
against its plain version, ``ops.plain_gated_scan_backward`` (whose CPU
tests against autograd and the JAX reference are in
``tests/test_torch_mamba_scan_backward.py``).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_mamba_scan_backward_card.py`` (``chip_smoke.py`` phase
27). Every test needs a card and skips without one. Bars: the
per-(b, t, c) gradients (ddt_raw, dx, dz) and dh0 bit for bit (the same
fp32 operations in the same order); the sums (ddt_bias, dB_in, dC_in,
dA_log, dD, in fp32) within 1e-6 of the sum of their terms' magnitudes +
1e-7 (summed in another order); two launches bit for bit; the gradient
through ``ops.gated_selective_scan`` 's Function within 1e-6 max|g| (fp32)
or one bf16 ulp of max|g| (bf16) of autograd of the plain composition.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import mamba_scan as tk
from repro_torch.kernels.mamba_scan import ops

SUM_REL, SUM_ABS = 1e-6, 1e-7
PER_ELEMENT = ("dt_raw", "x", "z", "h0")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, B, S, di, N, dtype, h0, device, R=5):
    """The gated scan's inputs on the card as the model gives them (B and
    C column slices of one (B, S, R + 2N) tensor, z the second half of one
    (B, S, 2 di)), dy and dhT: dt_raw 3 normal with every 7th value above
    softplus's threshold, dt_bias normal - 3, A_log 0.5 normal, the rest
    normal."""
    rng = np.random.default_rng(seed)

    def f(*shape, dt=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device, dt)

    dt_raw = 3 * f(B, S, di)
    dt_raw.view(-1)[::7] = 24 + dt_raw.view(-1)[::7].abs()
    xdb, xz = f(B, S, R + 2 * N, dt=dtype), f(B, S, 2 * di, dt=dtype)
    args = [dt_raw.to(dtype), f(di) - 3, f(B, S, di, dt=dtype),
            xdb[..., R:R + N], xdb[..., R + N:], 0.5 * f(di, N), f(di),
            xz[..., di:], f(B, di, N) if h0 else None]
    return args, f(B, S, di, dt=dtype), f(B, di, N)


def _check_against_plain(args, dy, dhT):
    """The kernel against the plain version at the file's bars; the
    kernel twice, bit for bit."""
    got = tk.mamba1_scan_gated_backward(*args, dy, dhT)
    again = tk.mamba1_scan_gated_backward(*args, dy, dhT)
    want = ops.plain_gated_scan_backward(*args, dy, dhT)
    mags = ops.gated_scan_backward_magnitudes(*args, dy, dhT)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(tk.GATED_INPUTS, got, again, want):
        if w is None:
            assert g is None and g2 is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), f"{name} not repeatable"
        if name in PER_ELEMENT:
            assert torch.equal(g, w), (
                f"{name}: {int((g != w).sum())} elements differ, max |err| "
                f"{float((g.float() - w.float()).abs().max()):.3e}")
        else:
            err = (g - w).abs()
            assert bool((err <= SUM_REL * mags[name] + SUM_ABS).all()), (
                f"{name}: max |err| {float(err.max()):.3e}")


CARD_SHAPES = [(2, 16, 32, 8, False), (2, 37, 100, 16, True),
               (1, 70, 40, 32, True), (2, 120, 257, 4, False),
               (4, 1, 520, 16, True), (2, 19, 130, 16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,h0", CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_on_card(cuda, B, S, di, N, h0,
                                               dtype):
    """Ragged di, N 4-32, S from one step to 18 chunks (mostly not a
    multiple of one), h0 given or not, B and C strided slices, z half of
    a projection."""
    args, dy, dhT = _inputs(21, B, S, di, N, getattr(torch, dtype), h0,
                            cuda)
    before = tk.LAUNCHES["mamba1_scan_gated_backward"]
    _check_against_plain(args, dy, dhT)
    assert tk.LAUNCHES["mamba1_scan_gated_backward"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_with_one_output_gradient(cuda, dtype):
    """dy without dhT (the model's call) and dhT without dy."""
    args, dy, dhT = _inputs(25, 2, 37, 100, 16, getattr(torch, dtype), True,
                            cuda)
    _check_against_plain(args, dy, None)
    _check_against_plain(args, None, dhT)


@pytest.mark.cuda
@pytest.mark.parametrize("needs", [
    (False, True, False, True, False, True, False, True, False),
    (True, False, True, False, True, False, True, False, True)])
def test_backward_kernel_follows_needs(cuda, needs):
    args, dy, dhT = _inputs(22, 2, 40, 72, 16, torch.bfloat16, True, cuda)
    full = tk.mamba1_scan_gated_backward(*args, dy, dhT)
    got = tk.mamba1_scan_gated_backward(*args, dy, dhT, needs=needs)
    torch.cuda.synchronize()
    for name, g, f, need in zip(tk.GATED_INPUTS, got, full, needs):
        if need:
            assert torch.equal(g, f), name
        else:
            assert g is None, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_gradient_uses_the_kernel(cuda, dtype):
    """``ops.gated_selective_scan`` on the card: one forward launch and
    one backward kernel launch, the gradients at the Function's bars
    against autograd of the plain composition, and no plain backward."""
    dt = getattr(torch, dtype)
    args, dy, dhT = _inputs(23, 2, 64, 96, 16, dt, True, cuda)
    plain_calls = []
    oracle = ops.gated_scan_backward_plain

    def counting(*a, **k):
        plain_calls.append(1)
        return oracle(*a, **k)

    ops.gated_scan_backward_plain = counting
    try:
        leaves = [a.clone().requires_grad_() for a in args]
        before = dict(tk.LAUNCHES)
        y, hT = ops.gated_selective_scan(*leaves)
        got = torch.autograd.grad([y, hT], leaves, [dy, dhT])
        torch.cuda.synchronize()
        assert tk.LAUNCHES["mamba1_scan_gated"] == \
            before["mamba1_scan_gated"] + 1
        assert tk.LAUNCHES["mamba1_scan_gated_backward"] == \
            before["mamba1_scan_gated_backward"] + 1
        assert not plain_calls
    finally:
        ops.gated_scan_backward_plain = oracle
    leaves = [a.clone().requires_grad_() for a in args]
    y, hT = ops.plain_gated_scan(*leaves)
    want = torch.autograd.grad([y, hT], leaves, [dy, dhT])
    for name, g, w, a in zip(tk.GATED_INPUTS, got, want, args):
        top = float(w.float().abs().max())
        bar = (1e-6 * top if a.dtype == torch.float32 else
               torch.finfo(a.dtype).eps * 2.0 ** np.floor(np.log2(top)))
        err = float((g.float() - w.float()).abs().max())
        assert g.dtype == w.dtype and err <= bar, (
            f"{name}: {err:.3e} > {bar:.3e}")


@pytest.mark.cuda
def test_backward_kernel_refuses_other_state_sizes(cuda):
    args, dy, dhT = _inputs(24, 1, 4, 8, 6, torch.float32, False, cuda)
    with pytest.raises(ValueError, match="state size"):
        tk.mamba1_scan_gated_backward(*args, dy, dhT)
