"""The port's dense fused Eq. 2 forward (B5) against the JAX reference on
the same numpy inputs: the plain version against the Pallas kernel in
interpret mode and against its jnp oracle, at the shapes and bars of
``tests/test_kernels.py`` (fp32 rtol/atol 1e-5, bf16 2e-2), plus the
input rules the kernel and its plain version share. The ``cuda``-marked
tests hold the CUDA kernel against the plain version on a card (bitwise
repeatable, a row's bits independent of its batch, Theta's strided
halves taken as they lie) and skip without one.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.lsplm_fused.lsplm_fused import lsplm_fused_forward as jfused
from repro.kernels.lsplm_fused.ref import lsplm_forward_ref as jref
from repro_torch.kernels.lsplm_fused import lsplm_fused as tk
from repro_torch.kernels.lsplm_fused.ops import lsplm_forward
from repro_torch.kernels.lsplm_fused.ref import lsplm_forward_ref

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


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,m", [(64, 128, 12), (128, 256, 4),
                                   (32, 512, 1), (50, 100, 5), (1, 7, 5),
                                   (257, 513, 5), (300, 4000, 12),
                                   (70, 300, 64), (40, 200, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda, b, d, m, dtype):
    _, (x, u, w) = _both(_inputs(3, b, d, m), dtype)
    x, u, w = x.to(cuda), u.to(cuda), w.to(cuda)
    tol = DTYPES[dtype][2]
    before = tk.LAUNCHES["lsplm_fused_forward"]
    got = lsplm_forward(x, u, w)
    again = lsplm_forward(x, u, w)
    want = lsplm_forward_ref(x, u, w)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["lsplm_fused_forward"] == before + 2
    assert got.dtype == x.dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    theta = torch.cat([u, w], dim=1)
    assert torch.equal(lsplm_forward(x, theta[:, :m], theta[:, m:]), got)
    rows = [0, b // 2, b - 1]
    assert torch.equal(lsplm_forward(x[rows], u, w), got[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(1, 2048 + 37), (33, 3 * 2048 + 512),
                                 (33, 2048 - 8), (1, 5000 + 3),
                                 (1100, 2048 + 37), (1100, 2 * 2048 + 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_split_over_d_on_card(cuda, b, d, dtype):
    """d not a multiple of the chunk (and, for odd d, x's rows read
    element by element), B = 1, 33 and 1,100: within the bar of the
    plain version and bitwise repeatable."""
    _, (x, u, w) = _both(_inputs(4, b, d, 12), dtype)
    x, u, w = x.to(cuda), u.to(cuda), w.to(cuda)
    tol = DTYPES[dtype][2]
    got = lsplm_forward(x, u, w)
    again = lsplm_forward(x, u, w)
    want = lsplm_forward_ref(x, u, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_row_alone_equals_row_in_batch_of_3276(cuda, dtype):
    """A row scored alone gives the same bits as the same row inside the
    dense test batch's 3,276 rows, at d = 32,768 (16 chunks)."""
    b, d = 3276, 32768
    _, (x, u, w) = _both(_inputs(5, b, d, 12), dtype)
    x, u, w = x.to(cuda), u.to(cuda), w.to(cuda)
    batch = lsplm_forward(x, u, w)
    for row in (0, 1, 1637, b - 1):
        alone = lsplm_forward(x[row:row + 1], u, w)
        assert torch.equal(alone, batch[row:row + 1])
