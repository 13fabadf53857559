"""The port's Eq. 9 direction (``repro_torch.kernels.owlqn_direction``,
``repro_torch.core.direction``), regularisers and L-BFGS history against
the JAX reference on the same numpy inputs.

Tolerances: rtol 1e-5 / atol 1e-6 (``tests/test_kernels.py:89-90``), and
the zero/non-zero pattern of the direction EQUAL exactly, on inputs with
exact-zero elements, -0.0 and whole zero rows (case c). The
``cuda``-marked tests hold the Eq. 9 kernel (B3) against its plain
version on a card -- bitwise at 2m = 24 and 70, where the plain version's
row sums take the kernel's association -- with both of its designs (the
row tile on aligned tensors, a warp per row on an unaligned view), and
skip without one.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import direction as jdir
from repro.core import regularizers as jreg
from repro.kernels.owlqn_direction.owlqn_direction import (
    owlqn_direction as jkernel,
)
from repro.optim import lbfgs as jlbfgs
from repro_torch.core import direction as tdir
from repro_torch.core import regularizers as treg
from repro_torch.kernels.owlqn_direction import owlqn_direction as tk
from repro_torch.kernels.owlqn_direction.ref import owlqn_direction_ref
from repro_torch.optim import lbfgs as tlbfgs

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


@pytest.mark.parametrize("lam,beta", LAM_BETA)
@pytest.mark.parametrize("m2", [8, 24, 70])
def test_direction_matches_reference(lam, beta, m2):
    theta, grad = _inputs(int(lam * 10 + beta * 100) + m2, m2=m2)
    want = np.asarray(jdir.descent_direction(jnp.asarray(theta),
                                             jnp.asarray(grad), lam, beta))
    got = tdir.descent_direction(torch.from_numpy(theta),
                                 torch.from_numpy(grad), lam, beta).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


@pytest.mark.parametrize("lam,beta", [(1.0, 1.0), (0.5, 0.0), (0.0, 0.7)])
def test_direction_matches_interpret_kernel(lam, beta):
    theta, grad = _inputs(3, d=64, m2=24)
    want = np.asarray(jkernel(jnp.asarray(theta), jnp.asarray(grad), lam,
                              beta, block_rows=16, interpret=True))
    got = owlqn_direction_ref(torch.from_numpy(theta),
                              torch.from_numpy(grad), lam, beta).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def test_lam_zero_reduces_to_owlqn_pseudogradient():
    beta = 0.4
    theta, grad = _inputs(4)
    d = tdir.descent_direction(torch.from_numpy(theta),
                               torch.from_numpy(grad), 0.0, beta).numpy()
    pg = np.zeros_like(grad)
    nz = theta != 0
    pg[nz] = grad[nz] + beta * np.sign(theta[nz])
    left, right = grad - beta, grad + beta
    pg[~nz & (left > 0)] = left[~nz & (left > 0)]
    pg[~nz & (right < 0)] = right[~nz & (right < 0)]
    np.testing.assert_allclose(d, -pg, rtol=RTOL, atol=ATOL)


def test_orthant_helpers_and_dirderiv_match_reference():
    theta, grad = _inputs(5)
    rng = np.random.default_rng(6)
    dvec = rng.normal(size=theta.shape).astype(np.float32)
    dvec[rng.random(theta.shape) < 0.2] = 0.0
    jt, jg, jd = (jnp.asarray(a) for a in (theta, grad, dvec))
    tt, tg, td = (torch.from_numpy(a) for a in (theta, grad, dvec))
    np.testing.assert_array_equal(tdir.project_orthant(tt, td).numpy(),
                                  np.asarray(jdir.project_orthant(jt, jd)))
    np.testing.assert_array_equal(tdir.choose_orthant(tt, td).numpy(),
                                  np.asarray(jdir.choose_orthant(jt, jd)))
    np.testing.assert_allclose(tdir.row_norm_keepdims(tt).numpy(),
                               np.asarray(jdir.row_norm_keepdims(jt)),
                               rtol=RTOL, atol=ATOL)
    for lam, beta in LAM_BETA:
        np.testing.assert_allclose(
            float(tdir.directional_derivative(tt, tg, td, lam, beta)),
            float(jdir.directional_derivative(jt, jg, jd, lam, beta)),
            rtol=1e-5, atol=1e-5)
    d = tdir.descent_direction(tt, tg, 0.3, 0.2)  # a descent direction
    assert float(tdir.directional_derivative(tt, tg, d, 0.3, 0.2)) < 0.0


def test_regularizers_match_reference():
    theta, _ = _inputs(7)
    jt, tt = jnp.asarray(theta), torch.from_numpy(theta)
    for name in ("l1_norm", "l21_norm"):
        np.testing.assert_allclose(float(getattr(treg, name)(tt)),
                                   float(getattr(jreg, name)(jt)), rtol=1e-6)
    np.testing.assert_allclose(treg.row_norms(tt).numpy(),
                               np.asarray(jreg.row_norms(jt)), rtol=1e-6)
    for name in ("nonzero_count", "nonzero_feature_count"):
        assert int(getattr(treg, name)(tt)) == int(getattr(jreg, name)(jt))


def test_direction_refuses_bad_shapes_and_the_kernel_cpu_tensors():
    theta, grad = _inputs(8)
    with pytest.raises(ValueError):
        tdir.descent_direction(torch.from_numpy(theta),
                               torch.from_numpy(grad[:-1]), 0.1, 0.1)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tk.owlqn_direction(torch.from_numpy(theta), torch.from_numpy(grad),
                           0.1, 0.1)
    assert tk.LAUNCHES == before


# ------------------------------------------------------------- L-BFGS
def test_lbfgs_ring_buffer_matches_reference_history():
    """Push more pairs than the memory holds (the ring wraps), one of them
    with y.s < 0 (masked); the two-loop must equal the reference's."""
    rng = np.random.default_rng(9)
    shape, memory = (30, 4), 3
    jh = jlbfgs.init_history(jnp.zeros(shape, jnp.float32), memory)
    th = tlbfgs.init_history(torch.zeros(shape), memory)
    for i in range(5):
        s = rng.normal(size=shape).astype(np.float32)
        y = (s * 0.5 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if i == 3:
            y = -y  # y.s < 0: stored but masked
        jh = jlbfgs.push(jh, jnp.asarray(s), jnp.asarray(y))
        tlbfgs.push(th, torch.from_numpy(s), torch.from_numpy(y))
        d = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jlbfgs.two_loop(jh, jnp.asarray(d)))
        got = tlbfgs.two_loop(th, torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(th.gamma), float(jh.gamma),
                                   rtol=1e-6)
    order = th.newest_first()
    assert [th.valid[i] for i in order] == list(np.asarray(jh.valid)[::-1])
    assert tlbfgs.any_valid(th)


def test_lbfgs_empty_history_is_identity():
    th = tlbfgs.init_history(torch.zeros(5, 2), 4)
    d = torch.arange(10.0).view(5, 2)
    assert torch.equal(tlbfgs.two_loop(th, d), d)
    assert not tlbfgs.any_valid(th)


# ------------------------------------------------------------ on the card
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
