"""The port's fused sparse forward (``repro_torch.kernels.lsplm_sparse_fused``)
against the JAX reference on the same numpy inputs.

On the CPU the port's ops take their plain versions (the CUDA kernels run
only on a card); the reference runs both its jnp path and its Pallas
kernels in interpret mode. Tolerances: z rtol 1e-5 / atol 1e-6 and p atol
1e-6, because fp32 sums reassociate across the two frameworks; dedup ids
are equal exactly. The kernels' own tests on a card (against the port's
plain versions, no JAX) are in ``tests/test_torch_sparse_card.py``.
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


@pytest.mark.parametrize("planned", [False, True])
def test_lsplm_sparse_forward_grad_matches_reference(planned):
    """The p-level backward (dp -> dz by the Eq. 2 head's derivative ->
    scatter) against jax.grad of the reference's planned/unplanned
    ``lsplm_sparse_forward``, and gradcheck'd in float64."""
    import jax
    from repro.kernels.lsplm_sparse_scatter.plan import (
        build_transpose_plan as jbuild)
    from repro_torch.kernels.lsplm_sparse_scatter.plan import (
        build_transpose_plan as tbuild)

    theta, _, _, ids, vals = _inputs(3)
    w = np.random.default_rng(4).normal(size=ids.shape[0]).astype(np.float32)
    jplan = jbuild(ids, D, pad_id=D - 1) if planned else None
    tplan = tbuild(ids, D, pad_id=D - 1) if planned else None
    want = jax.grad(lambda t, v: (jnp.asarray(w) * jops.lsplm_sparse_forward(
        jnp.asarray(ids), v, t, mode="jnp", plan=jplan)).sum(),
        argnums=(0, 1))(*_j(theta, vals))
    t, v = (a.requires_grad_(True) for a in _t(theta, vals))
    (torch.from_numpy(w) * tops.lsplm_sparse_forward(
        torch.from_numpy(ids), v, t, plan=tplan)).sum().backward()
    for got, ref in zip((t.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    small = torch.from_numpy(ids[:4, :6] % 40)
    small[:, ::5] = 40  # pad slots, their values 0 as the layout asks
    v64 = torch.from_numpy(vals[:4, :6]).double()
    v64[:, ::5] = 0.0
    t64 = torch.from_numpy(theta[:41]).double()
    t64[-1] = 0.0
    plan = tbuild(small, 41, pad_id=40) if planned else None
    assert torch.autograd.gradcheck(
        lambda t_, v_: tops.lsplm_sparse_forward(small, v_, t_, plan=plan),
        (t64.requires_grad_(True), v64.requires_grad_(True)))


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


def _dup_inputs(seed, n, k, d=D, m=M):
    """_inputs with longer runs of equal ids (2, 3, 5 and 17 slots where K
    allows), ids equal to the pad id, and one all-pad row."""
    theta, codes, scales, ids, vals = _inputs(seed, n=n, k=k, d=d, m=m)
    rng = np.random.default_rng(seed + 100)
    start = 0
    for run in (2, 3, 5, 17):
        if start + run > k:
            break
        ids[:, start:start + run] = rng.integers(0, d - 1, (n, 1))
        start += run
    ids[:, -1] = d - 1
    ids[-1] = d - 1
    vals[-1] = 0.0
    return theta, codes, scales, ids, vals


@pytest.mark.parametrize("k", [12, 40, 64])
def test_plain_dedup_composition_matches_reference(k):
    """The witness the card's fused dedup is held to bitwise -- the plain
    forward on ``dedup_tile_ids``' output, fp32 and int8 -- against the
    reference's interpret-mode kernel with its dedup on."""
    theta, codes, scales, ids, vals = _dup_inputs(20 + k, n=24, k=k)
    t, c, s, i, v = _t(theta, codes, scales, ids, vals)
    di, dv = tops.dedup_tile_ids(i, v, D - 1)
    want = np.asarray(jops.sparse_gather_matmul(
        *_j(ids, vals, theta), mode="interpret", dedup=True))
    np.testing.assert_allclose(tops._chunked_zmap(di, dv, t).numpy(), want,
                               rtol=Z_RTOL, atol=Z_ATOL)
    want8 = np.asarray(jops.sparse_gather_matmul_int8(
        *_j(ids, vals, codes, scales), mode="interpret", dedup=True))
    np.testing.assert_allclose(
        tops._chunked_zmap_int8(di, dv, c, s).numpy(), want8, rtol=Z_RTOL,
        atol=Z_ATOL)


def _run_sum(vals):
    """A run's sum as the kernel forms it: the Hillis-Steele steps of
    ``dedup_tile_ids`` applied to the run alone (element r adds element
    r - s when r >= s), read at its last element."""
    acc = [np.float32(v) for v in vals]
    s = 1
    while s < len(acc):
        acc = [acc[r] if r < s else np.float32(acc[r - s] + acc[r])
               for r in range(len(acc))]
        s *= 2
    return acc[-1]


@pytest.mark.parametrize("k", [8, 24, 40, 65])
def test_dedup_sums_depend_only_on_the_run(k):
    """The in-kernel dedup's premise: ``dedup_tile_ids`` gives each distinct
    id, ascending, the scan of its own run's values in slot order, whatever
    the rest of the row holds -- so a warp can sum each run alone."""
    _, _, _, ids, vals = _dup_inputs(30 + k, n=37, k=k)
    got_ids, got_vals = tops.dedup_tile_ids(*_t(ids, vals), D - 1)
    for r in range(ids.shape[0]):
        uniq = np.unique(ids[r])
        want = [_run_sum(vals[r][ids[r] == u]) for u in uniq]
        np.testing.assert_array_equal(got_ids[r, :len(uniq)].numpy(), uniq)
        assert (got_ids[r, len(uniq):] == D - 1).all()
        np.testing.assert_array_equal(got_vals[r, :len(uniq)].numpy(),
                                      np.array(want, np.float32))


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


@pytest.mark.parametrize("case", ["k_limit", "z_add_width", "z_add_alone",
                                  "session_shape", "session_dtype"])
def test_kernel_wrappers_check_arguments_before_the_device(case):
    """The K limit of the in-kernel dedup and the addend's shapes are
    refused on any device, before the CUDA check, and launch nothing."""
    _, codes, scales, ids, vals = _inputs(13, n=6, k=8)
    i, v, c, s = _t(ids, vals, codes, scales)
    kw = dict(dedup=True, z_add=torch.zeros((2, 2 * M)),
              session=torch.zeros((6,), dtype=torch.int64))
    match = "session"
    if case == "k_limit":
        wide = tk.MAX_DEDUP_K + 1
        i = torch.full((6, wide), D - 1, dtype=torch.int32)
        v = torch.zeros((6, wide))
        match = str(tk.MAX_DEDUP_K)
    elif case == "z_add_width":
        kw["z_add"] = torch.zeros((2, 2 * M + 2))
        match = "z_add"
    elif case == "z_add_alone":
        kw.pop("session")
        match = "together"
    elif case == "session_shape":
        kw["session"] = torch.zeros((5,), dtype=torch.int64)
    else:
        kw["session"] = torch.zeros((6,), dtype=torch.float32)
    before = dict(tk.LAUNCHES)
    for call in (lambda: tk.lsplm_sparse_fused_forward(
            i, v, c.to(torch.float32), **kw),
                 lambda: tk.lsplm_sparse_fused_int8_forward(i, v, c, s, **kw)):
        with pytest.raises(ValueError, match=match):
            call()
    assert tk.LAUNCHES == before
    assert tk.MAX_DEDUP_K >= 1024  # the engine rounds K above 64 up by 64


def test_build_finds_the_cuda_source():
    srcs = _build.sources()
    assert "lsplm_sparse_fused" in srcs
    path = _build.library_path(srcs["lsplm_sparse_fused"])
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path(srcs["lsplm_sparse_fused"])  # stable
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
