"""The port's id-range routing and plan slicing (``repro_torch.shard.
partition`` and ``plan_slicing``) against the reference's
(``repro.shard``), on the same numpy inputs, on the CPU.

Bars, all exact:
  * partitions (equal, balanced, their bounds, ``shard_of``,
    ``rows_per_shard``) equal the reference's; ``pad_rows``/``unpad_rows``
    as the reference's on the same Theta;
  * ``route_ids`` / ``route_batch``: local ids, values, their k order, the
    local pad id ``rows_per_shard``, the routed K and the rebased session
    ids bit for bit;
  * ``slice_plan`` / ``restrict_plan`` / ``shard_plan_grid``: every plan
    field the reference also has bit for bit the reference's (its
    unstacked cells), and every field of the port's plan, B2's schedule
    included, bit for bit the port's own ``build_transpose_plan`` of the
    routed local batch.
Seeded grid as ``tests/test_shard_plan.py``'s, all-pad and empty-shard
edges included.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data.sparse import generate_sparse as jgenerate
from repro.kernels.lsplm_sparse_scatter.plan import (
    build_transpose_plan as jbuild,
)
from repro.shard import partition as jpart
from repro.shard import plan_slicing as jslice
from repro_torch.data.sparse import generate_sparse as tgenerate
from repro_torch.kernels.lsplm_sparse_scatter.plan import (
    build_transpose_plan as tbuild,
)
from repro_torch.shard import partition as tpart
from repro_torch.shard import plan_slicing as tslice

GRID = [
    # (seed, N, K, d, S, zipf_power or None, pad_frac)
    (0, 24, 6, 200, 4, None, 0.0),
    (1, 32, 9, 500, 3, 6.0, 0.25),
    (2, 16, 4, 120, 5, 3.0, 0.5),
    (3, 8, 3, 64, 2, None, 0.9),   # nearly all pad
    (4, 40, 12, 1000, 7, 8.0, 0.1),  # hot head, many shards
    (5, 6, 2, 50, 6, None, 1.0),   # all pad: every shard empty
]
REF_FIELDS = ("row_ids", "sample_sorted", "slot_sorted", "order", "rank",
              "inv_compact", "inv_sorted", "num_rows", "num_entries",
              "num_kept", "num_unique", "class_width")
CLASS_FIELDS = ("class_src", "class_samp", "class_mask")


def _make(seed, N, K, d, power, pad_frac):
    rng = np.random.default_rng(seed)
    if power is None:
        ids = rng.integers(0, d, (N, K))
    else:
        ids = (d * (rng.random((N, K)) ** power)).astype(np.int64)
    ids[rng.random((N, K)) < pad_frac] = d
    vals = rng.normal(size=(N, K)).astype(np.float32)
    vals[ids == d] = 0.0
    return ids, vals, rng


def _bounds(rng, d, S, empty=False):
    cuts = np.sort(rng.choice(np.arange(1, d), S - 1, replace=False))
    if empty and S > 2:
        cuts[1] = cuts[0]  # shard 1 owns no id
    return np.concatenate([[0], cuts, [d]])


def _a(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_matches_reference(got, want):
    """Every field the reference's plan has, bitwise."""
    for f in REF_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, (int, tuple)):
            assert g == w, f
        else:
            np.testing.assert_array_equal(_a(g), np.asarray(w), err_msg=f)
    for f in CLASS_FIELDS:
        for g, w in zip(getattr(got, f), getattr(want, f), strict=True):
            np.testing.assert_array_equal(_a(g), np.asarray(w), err_msg=f)


def _assert_plans_equal(got, want):
    """Every field of two port plans, bitwise."""
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, tuple) and g and isinstance(g[0], torch.Tensor):
            assert len(g) == len(w), f.name
            for x, y in zip(g, w):
                assert torch.equal(x, y), f.name
        elif isinstance(g, torch.Tensor):
            assert torch.equal(g, w), f.name
        else:
            assert g == w, f.name


# ------------------------------------------------------------ partitions
@pytest.mark.parametrize("rows,shards", [(100, 4), (10, 3), (7, 7),
                                         (1_000_001, 2)])
def test_make_partition_matches_reference(rows, shards):
    t, j = tpart.make_partition(rows, shards), jpart.make_partition(rows,
                                                                    shards)
    np.testing.assert_array_equal(t.bounds, j.bounds)
    assert (t.rows_per_shard, t.is_uniform) == (j.rows_per_shard,
                                                j.is_uniform)
    ids = np.arange(rows + 2)
    np.testing.assert_array_equal(t.shard_of(ids), j.shard_of(ids))


@pytest.mark.parametrize("seed,power", [(0, 4.0), (1, 10.0), (2, None)])
def test_balanced_partition_matches_reference(seed, power):
    rng = np.random.default_rng(seed)
    d, S = 5000, 5
    ids = (rng.integers(0, d, (256, 12)) if power is None
           else (d * rng.random((256, 12)) ** power).astype(np.int64))
    ids[rng.random(ids.shape) < 0.1] = d
    t = tpart.balanced_partition(d, S, torch.from_numpy(ids), pad_id=d)
    j = jpart.balanced_partition(d, S, ids, pad_id=d)
    np.testing.assert_array_equal(t.bounds, j.bounds)
    # no signal: equal ranges
    none = np.full((4, 3), d)
    assert (tpart.balanced_partition(d, S, none, pad_id=d)
            == tpart.make_partition(d, S))


def test_pad_unpad_and_shard_rows_match_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    theta = rng.normal(size=(10, 4)).astype(np.float32)
    t, j = tpart.Partition([0, 1, 5, 10]), jpart.Partition([0, 1, 5, 10])
    padded = t.pad_rows(torch.from_numpy(theta))
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(j.pad_rows(jnp.asarray(theta))))
    np.testing.assert_array_equal(t.unpad_rows(padded).numpy(), theta)
    for s in range(3):
        np.testing.assert_array_equal(t.shard_rows(padded, s).numpy(),
                                      padded[s * 5:(s + 1) * 5].numpy())
    hist = torch.stack([padded, 2 * padded])  # (M, rows, 2m)
    assert torch.equal(t.shard_rows(hist, 2), hist[:, 10:15])
    u = torch.from_numpy(theta)
    assert tpart.make_partition(10, 2).pad_rows(u) is u
    with pytest.raises(ValueError, match="rows"):
        t.pad_rows(u[:9])
    with pytest.raises(ValueError):
        tpart.Partition([1, 5])


# --------------------------------------------------------------- routing
@pytest.mark.parametrize("seed,N,K,d,S,power,pad_frac", GRID)
@pytest.mark.parametrize("k_multiple", [1, 4])
def test_route_ids_bitwise_reference(seed, N, K, d, S, power, pad_frac,
                                     k_multiple):
    ids, vals, rng = _make(seed, N, K, d, power, pad_frac)
    b = _bounds(rng, d, S, empty=seed % 2 == 1)
    t, j = tpart.Partition(b), jpart.Partition(b)
    got = tpart.route_ids(t, torch.from_numpy(ids), torch.from_numpy(vals),
                          pad_id=d, k_multiple=k_multiple)
    want = jpart.route_ids(j, ids, vals, pad_id=d, k_multiple=k_multiple)
    assert got[2] == want[2]
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == tpart.shard_slot_width(t, ids, pad_id=d,
                                            k_multiple=k_multiple)


def test_route_ids_refuses_what_the_reference_refuses():
    part = tpart.make_partition(10, 2)
    with pytest.raises(ValueError, match="outside partition"):
        tpart.route_ids(part, np.array([[11]]), np.ones((1, 1), np.float32),
                        pad_id=99)
    with pytest.raises(ValueError, match="too small"):
        tpart.route_ids(part, np.array([[1, 2, 3]]),
                        np.ones((1, 3), np.float32), pad_id=10, shard_k=2)


@pytest.mark.parametrize("data_shards,balanced", [(1, False), (2, True),
                                                  (4, False)])
def test_route_batch_bitwise_reference(data_shards, balanced):
    d, S = 600, 3
    kw = dict(num_features=d, num_user_features_range=(360, d), sessions=16,
              ads_per_session=3, active_user=6, active_ad=4, seed=5)
    jb = jgenerate(**kw)
    tb = tgenerate(**kw, device="cpu")
    j = (jpart.balanced_partition(d, S, np.asarray(jb.user_ids),
                                  np.asarray(jb.ad_ids), pad_id=d)
         if balanced else jpart.make_partition(d, S))
    t = tpart.Partition(j.bounds)
    got = tpart.route_batch(tb, t, data_shards=data_shards)
    want = jpart.route_batch(jb, j, data_shards=data_shards)
    for f in ("user_ids", "user_vals", "ad_ids", "ad_vals", "session_id",
              "y"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("num_features", "rows_per_shard", "data_shards", "bounds"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.partition == t
    # the grid of unpadded cells: the reference's cells before its
    # stack_plans pads them
    for side, ids in (("user_plan", jb.user_ids), ("ad_plan", jb.ad_ids)):
        grid = getattr(got, side)
        ref = jslice.shard_plan_grid(
            getattr(jb, side), j, num_cols=ids.shape[1],
            data_shards=data_shards, shard_k=getattr(got, side[:-5]
                                                     + "_ids").shape[-1])
        assert len(grid) == data_shards and all(len(r) == S for r in grid)
        for g_row, r_row in zip(grid, ref):
            for g, r in zip(g_row, r_row):
                _assert_matches_reference(g, r)
    # generate_sparse(shards=) routes the same batch
    routed = tgenerate(**kw, device="cpu", shards=t, data_shards=data_shards)
    assert torch.equal(routed.ad_ids, got.ad_ids)
    _assert_plans_equal(routed.ad_plan[-1][-1], got.ad_plan[-1][-1])


def test_route_batch_refuses_what_the_reference_refuses():
    b = tgenerate(num_features=100, num_user_features_range=(60, 100),
                  sessions=6, ads_per_session=2, active_user=3, active_ad=2,
                  seed=0, with_plans=False, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tpart.route_batch(b, tpart.make_partition(100, 2), data_shards=4)
    with pytest.raises(ValueError, match="partition covers"):
        tpart.route_batch(b, tpart.make_partition(99, 3))
    perm = b._replace(session_id=b.session_id.flip(0))
    with pytest.raises(ValueError, match="contiguous"):
        tpart.route_batch(perm, tpart.make_partition(100, 2), data_shards=2)


def test_cell_is_a_single_device_batch_over_the_shard_block():
    d = 600
    routed = tgenerate(num_features=d, num_user_features_range=(360, d),
                       sessions=16, active_user=6, active_ad=4, seed=5,
                       device="cpu", shards=3, data_shards=2)
    R = routed.rows_per_shard
    cell = routed.cell(1, 2)
    b = cell.batch
    assert (cell.data_rank, cell.model_rank, cell.data_shards,
            cell.num_shards, cell.rows_per_shard) == (1, 2, 2, 3, R)
    assert b.num_features == R and b.user_plan.num_rows == R + 1
    assert torch.equal(b.ad_ids, routed.ad_ids[2, 32:])
    assert torch.equal(b.user_ids, routed.user_ids[2, 8:])
    assert int(b.session_id.max()) < 8
    with pytest.raises(ValueError, match="outside"):
        routed.cell(2, 0)


# -------------------------------------------------------------- slicing
@pytest.mark.parametrize("seed,N,K,d,S,power,pad_frac", GRID)
def test_slice_plan_bitwise_reference_and_own_build(seed, N, K, d, S, power,
                                                    pad_frac):
    ids, vals, rng = _make(seed, N, K, d, power, pad_frac)
    b = _bounds(rng, d, S, empty=seed % 2 == 0)
    t, j = tpart.Partition(b), jpart.Partition(b)
    got = tslice.slice_plan(tbuild(ids, d + 1, pad_id=d), t, num_cols=K)
    want = jslice.slice_plan(jbuild(ids, d + 1, pad_id=d), j, num_cols=K)
    ids_r, _, _ = tpart.route_ids(t, ids, vals, pad_id=d)
    assert len(got) == len(want) == S
    for s in range(S):
        _assert_matches_reference(got[s], want[s])
        _assert_plans_equal(got[s], tbuild(ids_r[s], t.rows_per_shard + 1,
                                           pad_id=t.rows_per_shard))


@pytest.mark.parametrize("seed,N,K,d,S,power,pad_frac", GRID[:5])
@pytest.mark.parametrize("data_shards", [2, 4])
def test_shard_plan_grid_bitwise_reference_and_own_build(
        seed, N, K, d, S, power, pad_frac, data_shards):
    N = -(-N // data_shards) * data_shards
    ids, vals, rng = _make(seed, N, K, d, power, pad_frac)
    b = _bounds(rng, d, S)
    t, j = tpart.Partition(b), jpart.Partition(b)
    ids_r, _, Ks = tpart.route_ids(t, ids, vals, pad_id=d)
    got = tslice.shard_plan_grid(tbuild(ids, d + 1, pad_id=d), t,
                                 num_cols=K, data_shards=data_shards,
                                 shard_k=Ks)
    want = jslice.shard_plan_grid(jbuild(ids, d + 1, pad_id=d), j,
                                  num_cols=K, data_shards=data_shards,
                                  shard_k=Ks)
    n_l, R = N // data_shards, t.rows_per_shard
    for blk in range(data_shards):
        for s in range(S):
            _assert_matches_reference(got[blk][s], want[blk][s])
            own = tbuild(ids_r[s, blk * n_l:(blk + 1) * n_l], R + 1,
                         pad_id=R)
            _assert_plans_equal(got[blk][s], own)


@pytest.mark.parametrize("n0,n1", [(0, 0), (3, 3), (7, 8), (0, 24), (2, 10),
                                   (21, 24)])
def test_restrict_plan_bitwise_reference_and_own_build(n0, n1):
    ids, _, _ = _make(9, 24, 5, 300, None, 0.3)
    got = tslice.restrict_plan(tbuild(ids, 301, pad_id=300), n0, n1,
                               num_cols=5)
    want = jslice.restrict_plan(jbuild(ids, 301, pad_id=300), n0, n1,
                                num_cols=5)
    _assert_matches_reference(got, want)
    _assert_plans_equal(got, tbuild(ids[n0:n1], 301, pad_id=300))


def test_slicing_refuses_what_the_reference_refuses():
    ids = np.array([[0, 1], [2, 3]])
    plan = tbuild(ids, 5, pad_id=4)
    with pytest.raises(ValueError, match="does not divide"):
        tslice.slice_plan(plan, tpart.make_partition(4, 2), num_cols=3)
    with pytest.raises(ValueError, match="too small"):
        tslice.slice_plan(plan, tpart.make_partition(4, 1), num_cols=2,
                          shard_k=1)
    for n0, n1 in [(-1, 2), (2, 1), (0, 3)]:
        with pytest.raises(ValueError, match="bad sample range"):
            tslice.restrict_plan(plan, n0, n1, num_cols=2)
    with pytest.raises(ValueError, match="does not divide"):
        tslice.shard_plan_grid(plan, tpart.make_partition(4, 2), num_cols=2,
                               data_shards=3)
    assert (tslice.default_shard_k(plan, tpart.make_partition(4, 2), 2)
            == jslice.default_shard_k(jbuild(ids, 5, pad_id=4),
                                      jpart.make_partition(4, 2), 2))
