"""The Eq. 9 direction kernel (B3) on a CUDA card, held against the
port's own plain version (moved out of ``test_torch_direction.py``).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_direction_card.py``.
Every test needs a card and skips without one. B3 is called through its
operator (``kernels/_ops.py``), whose CUDA kernel is the launch.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.owlqn_direction import owlqn_direction as tk
from repro_torch.kernels.owlqn_direction.ref import owlqn_direction_ref

RTOL, ATOL = 1e-5, 1e-6
LAM_BETA = [(0.0, 0.0), (1.0, 1.0), (0.5, 0.0), (0.0, 0.7), (0.3, 0.2)]


def _inputs(seed, d=64, m2=8):
    """Theta with exact zeros, -0.0 entries and whole zero rows; a grad
    with some exact zeros and small entries (soft-threshold edges)."""
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(d, m2)).astype(np.float32)
    theta[rng.random((d, m2)) < 0.4] = 0.0
    theta[rng.random((d, m2)) < 0.05] = -0.0
    theta[0] = 0.0
    theta[rng.random(d) < 0.2] = 0.0
    grad = rng.normal(size=(d, m2)).astype(np.float32)
    grad[rng.random((d, m2)) < 0.05] = 0.0
    grad[1] *= 0.01  # a zero-free row whose soft-threshold hits 0
    return theta, grad


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m2", [2, 24, 70, 128])
def test_direction_kernel_matches_plain_on_card(cuda, m2):
    theta, grad = _inputs(10, d=5000, m2=m2)
    t, g = torch.from_numpy(theta).to(cuda), torch.from_numpy(grad).to(cuda)
    for lam, beta in LAM_BETA:
        got = tk.owlqn_direction(t, g, lam, beta)
        want = owlqn_direction_ref(t, g, lam, beta)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        assert torch.equal(got == 0, want == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m2", [24, 70])
def test_direction_kernel_bitwise_plain_on_card(cuda, m2):
    """B3 equals its plain version bit for bit (the zero pattern too), on
    aligned tensors and on views one float off 16-byte alignment (the
    warp-per-row design), and is repeatable."""
    theta, grad = _inputs(11, d=5000, m2=m2)
    t, g = torch.from_numpy(theta).to(cuda), torch.from_numpy(grad).to(cuda)
    flat = torch.zeros(2 * theta.size + 2, device=cuda)
    tu = flat[1:theta.size + 1].view(theta.shape)
    gu = flat[theta.size + 2:].view(grad.shape)
    tu.copy_(t)
    gu.copy_(g)
    for lam, beta in LAM_BETA:
        got = tk.owlqn_direction(t, g, lam, beta)
        want = owlqn_direction_ref(t, g, lam, beta)
        unaligned = tk.owlqn_direction(tu, gu, lam, beta)
        again = tk.owlqn_direction(t, g, lam, beta)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) == 0.0, (lam, beta)
        assert torch.equal(got == 0, want == 0)
        assert torch.equal(unaligned, got) and torch.equal(again, got)
