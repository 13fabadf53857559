"""The dense fused Eq. 2 forward (B5) on a CUDA card, held against the
port's own plain version (moved out of ``test_torch_lsplm_fused.py``).

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda
tests/test_torch_lsplm_fused_card.py``. Every test needs a card and skips
without one. Bars as ``tests/test_kernels.py``'s: fp32 rtol/atol 1e-5,
bf16 2e-2; bitwise repeatable, a row's bits independent of its batch,
Theta's strided halves taken as they lie.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lsplm_fused import lsplm_fused as tk
from repro_torch.kernels.lsplm_fused.ops import lsplm_forward
from repro_torch.kernels.lsplm_fused.ref import lsplm_forward_ref

DTYPES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 2e-2)}


def _inputs(seed, b, d, m, x_scale=0.3, w_scale=0.1):
    rng = np.random.default_rng(seed)
    return ((x_scale * rng.normal(size=(b, d))).astype(np.float32),
            (w_scale * rng.normal(size=(d, m))).astype(np.float32),
            (w_scale * rng.normal(size=(d, m))).astype(np.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(DTYPES[dtype][0]) for a in arrays]


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
    x, u, w = _torch(_inputs(3, b, d, m), dtype)
    x, u, w = x.to(cuda), u.to(cuda), w.to(cuda)
    tol = DTYPES[dtype][1]
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
    x, u, w = _torch(_inputs(4, b, d, 12), dtype)
    x, u, w = x.to(cuda), u.to(cuda), w.to(cuda)
    tol = DTYPES[dtype][1]
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
    x, u, w = _torch(_inputs(5, b, d, 12), dtype)
    x, u, w = x.to(cuda), u.to(cuda), w.to(cuda)
    batch = lsplm_forward(x, u, w)
    for row in (0, 1, 1637, b - 1):
        alone = lsplm_forward(x[row:row + 1], u, w)
        assert torch.equal(alone, batch[row:row + 1])
