"""The port's fused sparse forward (``repro_torch.kernels.lsplm_sparse_fused``)
against the JAX reference on the same numpy inputs.

On the CPU the port's ops take their plain versions (the CUDA kernels run
only on a card); the reference runs both its jnp path and its Pallas
kernels in interpret mode. Tolerances: z rtol 1e-5 / atol 1e-6 and p atol
1e-6, because fp32 sums reassociate across the two frameworks; dedup ids
are equal exactly. The ``cuda``-marked tests hold the kernels against the
plain versions on a card and skip without one.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.lsplm_sparse_fused import ops as jops
from repro.kernels.lsplm_sparse_fused import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.lsplm_sparse_fused import lsplm_sparse_fused as tk
from repro_torch.kernels.lsplm_sparse_fused import ops as tops
from repro_torch.kernels.lsplm_sparse_fused import ref as tref

Z_RTOL, Z_ATOL, P_ATOL = 1e-5, 1e-6, 1e-6
D, M = 3001, 4  # padded rows (pad id D-1), regions


def _inputs(seed, n=24, k=12, d=D, m=M):
    """Padded theta, int8 codes/scales of it, and ids/vals with pad slots,
    a duplicate pair and a triple in every row."""
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(d, 2 * m)) * 0.3).astype(np.float32)
    theta[-1] = 0.0
    scales = (np.abs(theta).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    codes = np.rint(theta / safe[:, None]).astype(np.int8)
    ids = rng.integers(0, d - 1, (n, k)).astype(np.int32)
    ids[:, 1] = ids[:, 0]
    ids[:, 3] = ids[:, 0]
    ids[:, ::5] = d - 1
    vals = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    return theta, codes, scales, ids, vals


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("mode", ["jnp", "interpret"])
@pytest.mark.parametrize("dedup", [True, False])
def test_sparse_gather_matmul_matches_reference(mode, dedup):
    theta, _, _, ids, vals = _inputs(0)
    want = np.asarray(jops.sparse_gather_matmul(*_j(ids, vals, theta),
                                                mode=mode, dedup=dedup))
    got = tops.sparse_gather_matmul(*_t(ids, vals, theta), dedup=dedup)
    np.testing.assert_allclose(got.numpy(), want, rtol=Z_RTOL, atol=Z_ATOL)


@pytest.mark.parametrize("mode", ["jnp", "interpret"])
def test_lsplm_sparse_forward_matches_reference(mode):
    theta, _, _, ids, vals = _inputs(1)
    want = np.asarray(jops.lsplm_sparse_forward(*_j(ids, vals, theta),
                                                mode=mode))
    got = tops.lsplm_sparse_forward(*_t(ids, vals, theta))
    assert got.shape == (ids.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=P_ATOL)


@pytest.mark.parametrize("mode", ["jnp", "interpret"])
def test_int8_ops_match_reference(mode):
    _, codes, scales, ids, vals = _inputs(2)
    jargs = _j(ids, vals, codes, scales)
    targs = _t(ids, vals, codes, scales)
    np.testing.assert_allclose(
        tops.sparse_gather_matmul_int8(*targs).numpy(),
        np.asarray(jops.sparse_gather_matmul_int8(*jargs, mode=mode)),
        rtol=Z_RTOL, atol=Z_ATOL)
    np.testing.assert_allclose(
        tops.lsplm_sparse_forward_int8(*targs).numpy(),
        np.asarray(jops.lsplm_sparse_forward_int8(*jargs, mode=mode)),
        rtol=0, atol=P_ATOL)


@pytest.mark.parametrize("k", [1, 2, 5, 12, 33])
def test_dedup_tile_ids_matches_reference(k):
    rng = np.random.default_rng(3 + k)
    ids = rng.integers(0, 9, (40, k)).astype(np.int32)  # many duplicates
    vals = rng.normal(size=(40, k)).astype(np.float32)
    want_ids, want_vals = jops.dedup_tile_ids(*_j(ids, vals), 8)
    got_ids, got_vals = tops.dedup_tile_ids(*_t(ids, vals), 8)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_vals.numpy(), np.asarray(want_vals),
                               rtol=Z_RTOL, atol=Z_ATOL)


def test_heads_match_reference():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(17, 2 * M)).astype(np.float32) * 3
    np.testing.assert_allclose(tops.finalize_p(torch.from_numpy(z)).numpy(),
                               np.asarray(jops.finalize_p(jnp.asarray(z))),
                               rtol=0, atol=P_ATOL)
    for got, want in zip(tops.logps_from_z(torch.from_numpy(z)),
                         jops.logps_from_z(jnp.asarray(z))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=Z_RTOL, atol=Z_ATOL)
    th = rng.normal(size=(5, 2 * M)).astype(np.float32)
    np.testing.assert_array_equal(tops.pad_theta(torch.from_numpy(th)).numpy(),
                                  np.asarray(jops.pad_theta(jnp.asarray(th))))


def test_ref_oracle_matches_reference():
    theta, _, _, ids, vals = _inputs(5)
    np.testing.assert_allclose(
        tref.sparse_matmul_ref(*_t(ids, vals, theta)).numpy(),
        np.asarray(jref.sparse_matmul_ref(*_j(ids, vals, theta))),
        rtol=Z_RTOL, atol=Z_ATOL)
    np.testing.assert_allclose(
        tref.lsplm_sparse_forward_ref(*_t(ids, vals, theta)).numpy(),
        np.asarray(jref.lsplm_sparse_forward_ref(*_j(ids, vals, theta))),
        rtol=0, atol=P_ATOL)
    for got, want in zip(tref.lsplm_sparse_logps_ref(*_t(ids, vals, theta)),
                         jref.lsplm_sparse_logps_ref(*_j(ids, vals, theta))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=Z_RTOL, atol=Z_ATOL)


# ------------------------------------------------ in-port properties
def test_plain_int8_equals_dequantised_fp32_bitwise():
    """The plain int8 path forms each row as ``code * scale`` before the
    same slot-ordered accumulation, so it IS the fp32 path on the
    dequantised Theta."""
    _, codes, scales, ids, vals = _inputs(7)
    c, s = _t(codes, scales)
    deq = c.to(torch.float32) * s[:, None]
    i, v = _t(ids, vals)
    assert torch.equal(tops.sparse_gather_matmul_int8(i, v, c, s),
                       tops.sparse_gather_matmul(i, v, deq))


def test_plain_rows_do_not_depend_on_the_batch():
    """A row's z is the same bits alone or inside any batch, and extra
    trailing pad slots change nothing (the engine's bitwise claims)."""
    theta, _, _, ids, vals = _inputs(8)
    t, i, v = _t(theta, ids, vals)
    batch = tops.sparse_gather_matmul(i, v, t)
    for r in (0, 7, 23):
        assert torch.equal(tops.sparse_gather_matmul(i[r:r + 1], v[r:r + 1],
                                                     t)[0], batch[r])
    wide_i = torch.cat([i, torch.full((i.shape[0], 5), D - 1,
                                      dtype=torch.int32)], dim=1)
    wide_v = torch.cat([v, torch.zeros((v.shape[0], 5))], dim=1)
    assert torch.equal(tops.sparse_gather_matmul(wide_i, wide_v, t), batch)


def test_ops_reject_bad_models():
    _, codes, scales, ids, vals = _inputs(9)
    i, v, c, s = _t(ids, vals, codes, scales)
    with pytest.raises(ValueError):
        tops.sparse_gather_matmul_int8(i, v, c.to(torch.int16), s)
    with pytest.raises(ValueError):
        tops.sparse_gather_matmul_int8(i, v, c, s[:-1])
    with pytest.raises(ValueError):
        tops.sparse_gather_matmul(i, v, torch.zeros((D, 3)))


@pytest.mark.parametrize("wrapper", ["lsplm_sparse_fused_forward",
                                     "lsplm_sparse_fused_int8_forward"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The kernel wrappers launch on CUDA tensors or raise: the CPU is
    served by the plain versions in ops.py, never by a fallback."""
    _, codes, scales, ids, vals = _inputs(10)
    i, v, c, s = _t(ids, vals, codes, scales)
    args = (i, v, c.to(torch.float32)) if wrapper.endswith("fused_forward") \
        else (i, v, c, s)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tk, wrapper)(*args)
    assert tk.LAUNCHES == before


def test_build_finds_the_cuda_source():
    srcs = _build.sources()
    assert "lsplm_sparse_fused" in srcs
    path = _build.library_path(srcs["lsplm_sparse_fused"])
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path(srcs["lsplm_sparse_fused"])  # stable
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dedup", [True, False])
def test_kernels_match_plain_on_card(cuda, dedup):
    theta, codes, scales, ids, vals = _inputs(11, n=300, k=40)
    t, c, s, i, v = (x.to(cuda) for x in _t(theta, codes, scales, ids, vals))
    z_ref = tops._chunked_zmap(i, v, t)
    zi_ref = tops._chunked_zmap_int8(i, v, c, s)
    ki, kv = tops.dedup_tile_ids(i, v, D - 1) if dedup else (i, v)
    p, z = tk.lsplm_sparse_fused_forward(ki, kv, t)
    pi, zi = tk.lsplm_sparse_fused_int8_forward(ki, kv, c, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(z, z_ref, rtol=Z_RTOL, atol=Z_ATOL)
    torch.testing.assert_close(p, tops.finalize_p(z_ref), rtol=0, atol=P_ATOL)
    torch.testing.assert_close(zi, zi_ref, rtol=Z_RTOL, atol=Z_ATOL)
    torch.testing.assert_close(pi, tops.finalize_p(zi_ref), rtol=0,
                               atol=P_ATOL)
