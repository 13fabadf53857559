"""The port's dense fused Eq. 2 forward (B5) against the JAX reference on
the same numpy inputs: the plain version against the Pallas kernel in
interpret mode and against its jnp oracle, at the shapes and bars of
``tests/test_kernels.py`` (fp32 rtol/atol 1e-5, bf16 2e-2), plus the
input rules the kernel and its plain version share. The CUDA kernel
against the plain version on a card is ``test_torch_lsplm_fused_card.py``'s
(it imports no JAX).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.lsplm_fused.lsplm_fused import lsplm_fused_forward as jfused
from repro.kernels.lsplm_fused.ref import lsplm_forward_ref as jref
from repro_torch.kernels.lsplm_fused import lsplm_fused as tk
from repro_torch.kernels.lsplm_fused.ops import lsplm_forward

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, d, m, x_scale=0.3, w_scale=0.1):
    rng = np.random.default_rng(seed)
    return ((x_scale * rng.normal(size=(b, d))).astype(np.float32),
            (w_scale * rng.normal(size=(d, m))).astype(np.float32),
            (w_scale * rng.normal(size=(d, m))).astype(np.float32))


def _both(arrays, dtype):
    """The same values in each package's dtype (bf16: both round the
    float32 numbers to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,d,m,bb,bd", [
    (64, 128, 12, 32, 64),
    (128, 256, 4, 128, 256),
    (32, 512, 1, 32, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_and_oracle(b, d, m, bb, bd, dtype):
    (jx, ju, jw), (tx, tu, tw) = _both(_inputs(0, b, d, m), dtype)
    tol = DTYPES[dtype][2]
    got = lsplm_forward(tx, tu, tw)
    assert got.dtype == tx.dtype and got.shape == (b,)
    got = got.float().numpy()
    kernel = jfused(jx, ju, jw, block_b=bb, block_d=bd, interpret=True)
    for want in (kernel, jref(jx, ju, jw)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("b,d", [(50, 100), (1, 7), (33, 130), (257, 513)])
def test_plain_matches_reference_on_ragged_shapes(b, d):
    (jx, ju, jw), (tx, tu, tw) = _both(_inputs(8, b, d, 5), "float32")
    got = lsplm_forward(tx, tu, tw).numpy()
    want = jfused(jx, ju, jw, block_b=32, block_d=64, interpret=True)
    assert got.shape == (b,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jref(jx, ju, jw)),
                               rtol=1e-5, atol=1e-5)


def test_probability_range_and_theta_halves():
    x, u, w = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 8, 2.0, 1.0))
    p = lsplm_forward(x, u, w)
    assert bool(((p >= 0) & (p <= 1)).all())
    theta = torch.cat([u, w], dim=1)  # the port's one (d, 2m) Theta
    assert torch.equal(lsplm_forward(x, theta[:, :8], theta[:, 8:]), p)


def test_bad_inputs_are_refused():
    x, u, w = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 3))
    with pytest.raises(ValueError, match=r"\[1, 128\]"):
        lsplm_forward(x, torch.zeros(16, 129), torch.zeros(16, 129))
    with pytest.raises(ValueError, match=r"\[1, 128\]"):
        lsplm_forward(x, u[:, :0], w[:, :0])
    with pytest.raises(ValueError, match="shape|must be"):
        lsplm_forward(x, u[:8], w[:8])
    with pytest.raises(ValueError, match="float32 or all"):
        lsplm_forward(x, u.double(), w.double())
    with pytest.raises(ValueError, match="float32 or all"):
        lsplm_forward(x, u.bfloat16(), w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.lsplm_fused_forward(x, u, w)  # the kernel takes no CPU tensor


@pytest.mark.parametrize("d,chunks", [(0, 1), (1, 1), (2048, 1),
                                      (2049, 2), (32768, 16), (32769, 17)])
def test_chunk_count_depends_on_d_alone(d, chunks):
    """The kernel splits d into chunks of CHUNK columns; how many is a
    function of d alone (so a row's sum order never depends on B)."""
    assert tk.CHUNK == 2048 and tk.CHUNK % 128 == 0
    assert tk.num_chunks(d) == chunks


# The cuda-marked tests of this file are in ``tests/test_torch_lsplm_fused_card.py``,
# which imports no JAX, so the card's machine collects them.
