"""The port's sparse backward (``repro_torch.kernels.lsplm_sparse_scatter``)
against the JAX reference on the same numpy inputs.

The transpose plan is host numpy in both packages, so every leaf the
reference has must be EQUAL. dTheta is held against the reference's jnp
class-gather path and, on one tiny input, its Pallas kernel in interpret
mode, at rtol 1e-5 / atol 1e-6 (fp32 sums reassociate across the
frameworks); the pad row's and untouched rows' cotangents must be exactly
0. ``ref.scatter_runs_ref`` (B2's association in plain PyTorch) is held
against the reference at the cross-package bar |err| <= 1e-5 * sum|terms|
+ 1e-6, and bitwise against a per-piece loop in numpy float32. The
run-length kernel's (B2's) tests on a card -- bitwise ``scatter_runs_ref``
and the plain class gathers at that bar, bitwise repeatable -- are in
``tests/test_torch_sparse_card.py`` (no JAX).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.lsplm_sparse_scatter import ops as jops
from repro.kernels.lsplm_sparse_scatter import plan as jplan
from repro.kernels.lsplm_sparse_scatter import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.lsplm_sparse_scatter import lsplm_sparse_scatter as tk
from repro_torch.kernels.lsplm_sparse_scatter import ops as tops
from repro_torch.kernels.lsplm_sparse_scatter import plan as tplan
from repro_torch.kernels.lsplm_sparse_scatter import ref as tref

RTOL, ATOL = 1e-5, 1e-6
B2_REL, B2_ABS = 1e-5, 1e-6  # |err| <= B2_REL * sum |terms| + B2_ABS
LEAVES = ("row_ids", "sample_sorted", "slot_sorted", "order", "rank",
          "inv_compact", "inv_sorted")


def _batch(seed, n=40, k=8, d=300, zipf=False, pad_every=3):
    """ids (n, k) over d+1 padded rows (pad id d) with pad slots, vals,
    and an upstream dz (n, 2m=8)."""
    rng = np.random.default_rng(seed)
    if zipf:
        ids = (d * rng.random((n, k)) ** 10.0).astype(np.int32)
    else:
        ids = rng.integers(0, d, (n, k)).astype(np.int32)
    if pad_every:
        ids[:, ::pad_every] = d
    vals = rng.normal(size=(n, k)).astype(np.float32)
    vals[ids == d] = 0.0
    dz = rng.normal(size=(n, 8)).astype(np.float32)
    return ids, vals, dz


def _plans(ids, rows, pad_id):
    return (jplan.build_transpose_plan(ids, rows, pad_id=pad_id),
            tplan.build_transpose_plan(ids, rows, pad_id=pad_id))


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("zipf,pad_id", [(False, 300), (True, 300),
                                         (False, None), (True, None)])
def test_plan_leaves_equal_reference(zipf, pad_id):
    ids, _, _ = _batch(1, zipf=zipf)
    jp, tp = _plans(ids, 301, pad_id)
    for f in LEAVES:
        got = getattr(tp, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    assert tp.class_width == jp.class_width
    for f in ("class_src", "class_samp", "class_mask"):
        assert len(getattr(tp, f)) == len(getattr(jp, f))
        for a, b in zip(getattr(tp, f), getattr(jp, f)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for f in ("num_rows", "num_entries", "num_kept", "num_unique"):
        assert getattr(tp, f) == getattr(jp, f), f
    if pad_id is not None:
        assert not (tp.row_ids == pad_id).any()  # pad entries dropped


def test_plan_edges_and_validation():
    empty = tplan.build_transpose_plan(np.full((3, 4), 9, np.int32), 10,
                                       pad_id=9)
    assert empty.num_kept == 0 and empty.num_unique == 0
    assert empty.piece_start.tolist() == [0]
    assert empty.run_piece_start.tolist() == [0]
    with pytest.raises(ValueError, match="out of range"):
        tplan.build_transpose_plan(np.array([[0, 10]]), 10)
    with pytest.raises(ValueError, match="entries"):
        empty.validate((4, 4), 10)
    with pytest.raises(ValueError, match="rows"):
        empty.validate((3, 4), 11)
    moved = empty.to("cpu")
    assert moved.device == torch.device("cpu")


@pytest.mark.parametrize("piece", [1, 3, 256])
def test_run_pieces_tile_the_runs(piece):
    """Pieces tile the sorted entries in order, never cross a run and
    hold at most ``piece`` entries; each run owns a contiguous range."""
    ids, _, _ = _batch(2, n=64, zipf=True)
    p = tplan.build_transpose_plan(ids, 301, pad_id=300)
    uniq, counts = np.unique(p.row_ids.numpy(), return_counts=True)
    run_start = np.concatenate([[0], np.cumsum(counts)])
    ps, pr, rps, tps = (t.numpy() for t in tplan.run_pieces(
        torch.from_numpy(run_start), piece))
    assert ps[0] == 0 and ps[-1] == p.num_kept and (np.diff(ps) > 0).all()
    assert (np.diff(ps) <= piece).all()
    assert rps[-1] == pr.size and (np.diff(rps) >= 1).all()
    for u in range(uniq.size):
        own = np.arange(rps[u], rps[u + 1])
        assert (pr[own] == u).all()
        assert ps[own[0]] == run_start[u] and ps[own[-1] + 1] == run_start[u + 1]
    # a task owns exactly the pieces that start in one TASK-entry window,
    # each window holding a piece start has a task, in window order
    window = ps[:-1] // tplan.TASK
    assert tps[0] == 0 and tps[-1] == pr.size and (np.diff(tps) > 0).all()
    assert tps.size - 1 == np.unique(window).size
    for t in range(tps.size - 1):
        assert (window[tps[t]:tps[t + 1]] == window[tps[t]]).all()
    if piece == 256:  # the plan's own tables
        np.testing.assert_array_equal(p.piece_start.numpy(), ps)
        np.testing.assert_array_equal(p.run_piece_start.numpy(), rps)
        np.testing.assert_array_equal(p.task_piece_start.numpy(), tps)


# ------------------------------------------------------ dTheta, dvals
@pytest.mark.parametrize("zipf", [False, True])
def test_scatter_add_planned_matches_reference(zipf):
    ids, vals, dz = _batch(3, zipf=zipf)
    jp, tp = _plans(ids, 301, 300)
    want = np.asarray(jops.scatter_add_planned(jp, jnp.asarray(vals),
                                               jnp.asarray(dz), mode="jnp"))
    got = tops.scatter_add_planned(tp, torch.from_numpy(vals),
                                   torch.from_numpy(dz))
    assert got.shape == (301, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    touched = np.zeros(301, bool)
    touched[ids[ids != 300]] = True
    assert (got.numpy()[~touched] == 0.0).all()  # pad + untouched: exact 0


def test_scatter_add_planned_matches_interpret_kernel():
    """One tiny case (E <= 256) against the reference's Pallas kernel in
    interpret mode, with a hot id whose run is most of the batch."""
    ids, vals, dz = _batch(4, n=16, k=6, d=40, pad_every=4)
    ids[:, 1] = 7
    jp, tp = _plans(ids, 41, 40)
    want = np.asarray(jops.scatter_add_planned(
        jp, jnp.asarray(vals), jnp.asarray(dz), mode="interpret"))
    got = tops.scatter_add_planned(tp, torch.from_numpy(vals),
                                   torch.from_numpy(dz))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got[40] == 0).all()


def test_unplanned_and_oracles_match_reference():
    ids, vals, dz = _batch(5)
    i, v, z = (torch.from_numpy(a) for a in (ids, vals, dz))
    want = np.asarray(jops.scatter_add_ref(*(jnp.asarray(a)
                                             for a in (ids, vals, dz)), 301))
    np.testing.assert_allclose(tops.scatter_add_unplanned(i, v, z, 301,
                                                          300).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    theta = np.random.default_rng(6).normal(size=(301, 8)).astype(np.float32)
    theta[-1] = 0.0
    jdv, jdt = jref.scatter_bwd_ref(*(jnp.asarray(a)
                                      for a in (ids, vals, theta, dz)))
    tdv, tdt = tref.scatter_bwd_ref(i, v, torch.from_numpy(theta), z)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(jdv), rtol=RTOL,
                               atol=ATOL)


def test_dvals_match_reference():
    ids, vals, dz = _batch(7, zipf=True)
    theta = np.random.default_rng(8).normal(size=(301, 8)).astype(np.float32)
    theta[-1] = 0.0
    jp, tp = _plans(ids, 301, 300)
    want = np.asarray(jops.dvals_planned(jp, jnp.asarray(theta),
                                         jnp.asarray(dz), ids.shape))
    t, z = torch.from_numpy(theta), torch.from_numpy(dz)
    got = tops.dvals_planned(tp, t, z, ids.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got.numpy()[ids == 300] == 0.0).all()
    np.testing.assert_allclose(
        tops.dvals_unplanned(torch.from_numpy(ids), t, z).numpy(), want,
        rtol=RTOL, atol=ATOL)


def test_sorted_runs_match_the_plan():
    """The unplanned card path sorts on the device; on any device its
    layout equals the host plan's kernel leaves."""
    ids, _, _ = _batch(9, n=50, zipf=True)
    tp = tplan.build_transpose_plan(ids, 301, pad_id=300)
    lay = tops.sorted_runs(torch.from_numpy(ids), 301, 300)
    for f in ("order", "row_ids", "sample_sorted", "piece_start",
              "piece_run", "run_piece_start", "task_piece_start",
              "inv_sorted"):
        got = getattr(lay, f)
        assert got.dtype == torch.int32, f  # as B2 reads them
        np.testing.assert_array_equal(got.numpy(), getattr(tp, f).numpy(),
                                      err_msg=f)
    assert lay.num_entries == tp.num_entries


def test_kernel_wrapper_refuses_cpu_tensors():
    ids, vals, dz = _batch(10)
    tp = tplan.build_transpose_plan(ids, 301, pad_id=300)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tk.lsplm_sparse_scatter(tp, torch.from_numpy(vals).reshape(-1),
                                torch.from_numpy(dz))
    assert tk.LAUNCHES == before


def test_build_finds_the_scatter_source():
    srcs = _build.sources()
    assert "lsplm_sparse_scatter" in srcs and "owlqn_direction" in srcs
    path = _build.library_path(srcs["lsplm_sparse_scatter"])
    assert path.parent == _build.BUILD_DIR


# ------------------------------------- B2's association (scatter_runs_ref)
def _runs_cases():
    """(tag, ids, vals, dz, rows, pad_id): uniform ids, Zipf ids, a hot run
    cut into three pieces, pad slots, and all-unique ids."""
    rng = np.random.default_rng(12)
    cases = []
    for tag, kw in (("uniform", dict(n=60)), ("zipf", dict(n=60, zipf=True)),
                    ("pad ids", dict(n=60, pad_every=2))):
        ids, vals, dz = _batch(int(rng.integers(1 << 16)), **kw)
        cases.append((tag, ids, vals, dz, 301, 300))
    ids, vals, dz = _batch(13, n=300, k=4, d=300, pad_every=0)
    ids[:, :2] = 17  # one run of 600 entries: pieces of 256, 256, 88
    cases.append(("hot run", ids, vals, dz, 301, 300))
    ids = rng.permutation(300)[:240].astype(np.int32).reshape(40, 6)
    vals = rng.normal(size=ids.shape).astype(np.float32)
    dz = rng.normal(size=(40, 8)).astype(np.float32)
    cases.append(("all-unique", ids, vals, dz, 301, 300))
    return cases


RUNS_CASES = _runs_cases()


@pytest.mark.parametrize("case", RUNS_CASES, ids=[c[0] for c in RUNS_CASES])
def test_scatter_runs_ref_matches_reference(case):
    """B2's association against the reference's jnp class-gather path and
    its index_add oracle; pad and untouched rows exactly 0; the card-sorted
    layout gives the plan's bits."""
    tag, ids, vals, dz, rows, pad = case
    jp, tp = _plans(ids, rows, pad)
    v, z = torch.from_numpy(vals), torch.from_numpy(dz)
    got = tref.scatter_runs_ref(tp, v, z, rows)
    assert got.shape == (rows, dz.shape[1]) and got.dtype == torch.float32
    scale = tref.scatter_add_ref(torch.from_numpy(ids), v.abs(), z.abs(),
                                 rows).numpy()
    for want in (jops.scatter_add_planned(jp, jnp.asarray(vals),
                                          jnp.asarray(dz), mode="jnp"),
                 jops.scatter_add_ref(jnp.asarray(ids), jnp.asarray(vals),
                                      jnp.asarray(dz), rows)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= B2_REL * scale + B2_ABS).all(), (tag, err.max())
    touched = np.zeros(rows, bool)
    touched[ids[ids != pad]] = True
    assert not touched[pad]
    assert (got.numpy()[~touched] == 0.0).all()
    lay = tops.sorted_runs(torch.from_numpy(ids), rows, pad)
    assert torch.equal(tref.scatter_runs_ref(lay, v, z, rows), got)
    if tag == "hot run":
        assert tp.piece_run.numel() == tp.num_unique + 2


@pytest.mark.parametrize("case", RUNS_CASES[1:4],
                         ids=[c[0] for c in RUNS_CASES[1:4]])
def test_scatter_runs_ref_is_b2s_association(case):
    """Bit for bit a loop in numpy float32: each piece from 0 in entry
    order (rounded product, rounded add), each run's partials from 0 in
    piece order."""
    _, ids, vals, dz, rows, pad = case
    tp = tplan.build_transpose_plan(ids, rows, pad_id=pad)
    flat = vals.reshape(-1)
    order, samp = tp.order.numpy(), tp.sample_sorted.numpy()
    ps, rps = tp.piece_start.numpy(), tp.run_piece_start.numpy()
    partial = []
    for p in range(ps.size - 1):
        acc = np.zeros(dz.shape[1], np.float32)
        for e in range(ps[p], ps[p + 1]):
            acc = acc + np.float32(flat[order[e]]) * dz[samp[e]]
        partial.append(acc)
    want = np.zeros((rows, dz.shape[1]), np.float32)
    row_ids = tp.row_ids.numpy()
    for u in range(rps.size - 1):
        acc = np.zeros(dz.shape[1], np.float32)
        for q in range(rps[u], rps[u + 1]):
            acc = acc + partial[q]
        want[row_ids[ps[rps[u]]]] = acc
    got = tref.scatter_runs_ref(tp, torch.from_numpy(vals),
                                torch.from_numpy(dz), rows).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
