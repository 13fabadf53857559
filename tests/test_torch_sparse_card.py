"""The fused sparse forward (B1, B4) and the run-length dTheta scatter
(B2) on a CUDA card, held against the port's own plain versions.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_sparse_card.py``
(``chip_smoke.py`` phase 27). Every test needs a card and skips without
one. The tests up to ``test_scatter_kernel_bitwise_runs_ref_on_card``
hold the kernels against the plain versions at the CPU tests'
tolerances (z rtol 1e-5 / atol 1e-6, p atol 1e-6; B2 bitwise
``ref.scatter_runs_ref`` and within 1e-5 * sum|terms| + 1e-6 of the plain
class gathers). The rest hold the autotune knobs (``repro_torch.tune``):
every ``block_n`` x ``copy`` of B1, every ``block_n`` of B4 and every
``block_e`` of B2 gives the default launch's output bit for bit, the ops'
call sites take the table and the overrides, and a knob the launch
cannot hold raises.
"""
import numpy as np
import pytest
import torch

from repro_torch import tune
from repro_torch.kernels.lsplm_sparse_fused import lsplm_sparse_fused as fk
from repro_torch.kernels.lsplm_sparse_fused import ops as fops
from repro_torch.kernels.lsplm_sparse_scatter import lsplm_sparse_scatter as sk
from repro_torch.kernels.lsplm_sparse_scatter import ops as sops
from repro_torch.kernels.lsplm_sparse_scatter import plan as tplan
from repro_torch.kernels.lsplm_sparse_scatter import ref as sref

Z_RTOL, Z_ATOL, P_ATOL = 1e-5, 1e-6, 1e-6
B2_REL, B2_ABS = 1e-5, 1e-6  # |err| <= B2_REL * sum |terms| + B2_ABS
D, M = 3001, 4  # padded rows (pad id D-1), regions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def no_table():
    """An empty active table and no overrides; the lazy committed-file
    load is re-armed on exit."""
    tune.set_active_table(tune.AutotuneTable())
    tune.clear_overrides()
    yield
    tune.set_active_table(None)
    tune.clear_overrides()


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


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _scatter_batch(seed, n=40, k=8, d=300, zipf=False, pad_every=3):
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


# ------------------------------------------------ B1 and B4 against plain
@pytest.mark.cuda
@pytest.mark.parametrize("dedup", [True, False])
def test_kernels_match_plain_on_card(cuda, dedup):
    theta, codes, scales, ids, vals = _inputs(11, n=300, k=40)
    t, c, s, i, v = (x.to(cuda) for x in _t(theta, codes, scales, ids, vals))
    z_ref = fops._chunked_zmap(i, v, t)
    zi_ref = fops._chunked_zmap_int8(i, v, c, s)
    ki, kv = fops.dedup_tile_ids(i, v, D - 1) if dedup else (i, v)
    p, z = fk.lsplm_sparse_fused_forward(ki, kv, t)
    pi, zi = fk.lsplm_sparse_fused_int8_forward(ki, kv, c, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(z, z_ref, rtol=Z_RTOL, atol=Z_ATOL)
    torch.testing.assert_close(p, fops.finalize_p(z_ref), rtol=0, atol=P_ATOL)
    torch.testing.assert_close(zi, zi_ref, rtol=Z_RTOL, atol=Z_ATOL)
    torch.testing.assert_close(pi, fops.finalize_p(zi_ref), rtol=0,
                               atol=P_ATOL)


@pytest.mark.cuda
def test_forward_p_keeps_the_kernel_p_and_its_grad_on_card(cuda):
    """The differentiable p-level op returns B1's own p, planned or not,
    and its planned and unplanned gradients agree with the CPU's."""
    from repro_torch.kernels.lsplm_sparse_scatter.plan import (
        build_transpose_plan)

    theta, _, _, ids, vals = _inputs(12, n=300, k=40)
    vals[ids == D - 1] = 0.0  # padded COO: the plan drops the pad slots
    t, i, v = (x.to(cuda) for x in _t(theta, ids, vals))
    p_kernel = fk.lsplm_sparse_fused_forward(i, v, t, dedup=True)[0]
    plan = build_transpose_plan(ids, D, pad_id=D - 1).to(cuda)
    grads = []
    for pl in (None, plan):
        tt = t.clone().requires_grad_(True)
        p = fops.lsplm_sparse_forward(i, v, tt, plan=pl)
        assert torch.equal(p, p_kernel)
        p.sum().backward()
        grads.append(tt.grad)
    tc = torch.from_numpy(theta).requires_grad_(True)
    fops.lsplm_sparse_forward(*_t(ids, vals), tc).sum().backward()
    for g in grads:
        torch.testing.assert_close(g.cpu(), tc.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("k", [8, 24, 40, 64, 65, 200])
def test_fused_dedup_is_bitwise_the_pre_pass_on_card(cuda, n, k):
    """dedup=True in the kernel gives (z, p) bit for bit what
    ``dedup_tile_ids`` followed by the kernel with dedup=False gives, for
    B1 and B4; B4 with dedup on is bitwise B1 on the dequantised Theta;
    both stay within the plain version's tolerances."""
    theta, codes, scales, ids, vals = _dup_inputs(40 + k, n=n, k=k)
    t, c, s, i, v = (x.to(cuda) for x in _t(theta, codes, scales, ids, vals))
    deq = c.to(torch.float32) * s[:, None]
    di, dv = fops.dedup_tile_ids(i, v, D - 1)
    fused = fk.lsplm_sparse_fused_forward(i, v, t, dedup=True)
    pre = fk.lsplm_sparse_fused_forward(di, dv, t)
    fused8 = fk.lsplm_sparse_fused_int8_forward(i, v, c, s, dedup=True)
    pre8 = fk.lsplm_sparse_fused_int8_forward(di, dv, c, s)
    on_deq = fk.lsplm_sparse_fused_forward(i, v, deq, dedup=True)
    torch.cuda.synchronize()
    for a, b in ((fused, pre), (fused8, pre8), (fused8, on_deq)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    z_ref = fops._chunked_zmap(i, v, t)
    torch.testing.assert_close(fused[1], z_ref, rtol=Z_RTOL, atol=Z_ATOL)
    torch.testing.assert_close(fused[0], fops.finalize_p(z_ref), rtol=0,
                               atol=P_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("session_dtype", [torch.int32, torch.int64])
def test_bundle_addend_matches_index_select_add_on_card(cuda, session_dtype):
    """The ad-side launch with the user rows' z as its addend: z bitwise
    ``z_user.index_select(0, session) + z_ad``, p within 1e-6 of
    ``finalize_p``; ``ops.bundle_forward`` is those two launches."""
    theta, codes, scales, uids, uvals = _dup_inputs(50, n=8, k=24)
    _, _, _, aids, avals = _dup_inputs(51, n=256, k=16)
    t, c, s, ui, uv, ai, av = (x.to(cuda) for x in _t(
        theta, codes, scales, uids, uvals, aids, avals))
    session = torch.arange(8, device=cuda).repeat_interleave(32).to(
        session_dtype)
    for rows, fn in (((t,), fk.lsplm_sparse_fused_forward),
                     ((c, s), fk.lsplm_sparse_fused_int8_forward)):
        z_user = fn(ui, uv, *rows, dedup=True, head=False)[1]
        z_ad = fn(ai, av, *rows, dedup=True)[1]
        p, z = fn(ai, av, *rows, dedup=True, z_add=z_user, session=session)
        torch.cuda.synchronize()
        want = z_user.index_select(0, session.long()) + z_ad
        assert torch.equal(z, want)
        torch.testing.assert_close(p, fops.finalize_p(want), rtol=0,
                                   atol=P_ATOL)
        kw = dict(theta=t) if len(rows) == 1 else dict(codes=c, scales=s)
        before = dict(fk.LAUNCHES)
        pb, zb = fops.bundle_forward(ui, uv, ai, av, session, **kw)
        assert sum(fk.LAUNCHES.values()) - sum(before.values()) == 2
        assert torch.equal(pb, p) and torch.equal(zb, z)


@pytest.mark.cuda
def test_k_limit_on_card(cuda):
    """Past MAX_DEDUP_K slots the card path refuses dedup=True (no quiet
    route back to the torch pre-pass) and still serves dedup=False."""
    k = fk.MAX_DEDUP_K + 1
    theta = torch.zeros((D, 2 * M), device=cuda)
    ids = torch.full((2, k), D - 1, dtype=torch.int32, device=cuda)
    vals = torch.zeros((2, k), device=cuda)
    with pytest.raises(ValueError, match=str(fk.MAX_DEDUP_K)):
        fops.sparse_gather_matmul(ids, vals, theta)
    z = fops.sparse_gather_matmul(ids, vals, theta, dedup=False)
    assert torch.equal(z, torch.zeros_like(z))


# ------------------------------------------------ B2 against plain
@pytest.mark.cuda
@pytest.mark.parametrize("zipf,piece_split", [(False, False), (True, False),
                                              (True, True)])
def test_scatter_kernel_matches_plain_on_card(cuda, zipf, piece_split):
    n = 3000 if piece_split else 200  # a hot run of > 256 entries
    ids, vals, dz = _scatter_batch(11, n=n, zipf=zipf)
    tp = tplan.build_transpose_plan(ids, 301, pad_id=300).to(cuda)
    v, z = torch.from_numpy(vals).to(cuda), torch.from_numpy(dz).to(cuda)
    got = sops.scatter_add_planned(tp, v, z)
    again = sops.scatter_add_planned(tp, v, z)
    plain = sops._compact_classes(tp, v, z).index_select(0, tp.inv_compact)
    scale = sops._compact_classes(tp, v.abs(), z.abs()).index_select(
        0, tp.inv_compact)
    runs = sref.scatter_runs_ref(tp, v, z, 301)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # no float atomics: bitwise repeatable
    assert torch.equal(got, runs)  # B2's association
    assert bool(((got - plain).abs() <= B2_REL * scale + B2_ABS).all())
    untouched = tp.inv_sorted == tp.num_unique
    assert bool((got[untouched] == 0).all())
    unplanned = sops.scatter_add_unplanned(torch.from_numpy(ids).to(cuda), v,
                                           z, 301, 300)
    assert torch.equal(unplanned, got)  # same sorted layout, same kernel


@pytest.mark.cuda
@pytest.mark.parametrize("m2,offset", [(8, 0), (24, 0), (24, 1), (6, 0),
                                       (70, 0), (128, 0)])
def test_scatter_kernel_bitwise_runs_ref_on_card(cuda, m2, offset):
    """Every copy width and column count: 16-byte copies (2m % 4 == 0 and
    an aligned dz), 4-byte ones (2m = 6, or dz one float off alignment),
    2m up to 128; a hot run of several pieces, pad slots."""
    rng = np.random.default_rng(14)
    ids, vals, _ = _scatter_batch(15, n=3000, zipf=True)
    tp = tplan.build_transpose_plan(ids, 301, pad_id=300).to(cuda)
    flat = torch.from_numpy(rng.normal(size=3000 * m2 + offset).astype(
        np.float32)).to(cuda)
    z = flat[offset:].view(3000, m2)
    v = torch.from_numpy(vals).to(cuda)
    got = sops.scatter_add_planned(tp, v, z)
    want = sref.scatter_runs_ref(tp, v, z, 301)
    unplanned = sops.scatter_add_unplanned(torch.from_numpy(ids).to(cuda), v,
                                           z, 301, 300)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(unplanned, got)
    assert bool((got[tp.inv_sorted == tp.num_unique] == 0).all())
    # every run ticket is back at 0 for the next call
    assert not any(bool(t.any()) for t in sk._TICKETS.values())


# ------------------------------------------------ the autotune knobs
@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(1, 8, 4), (300, 40, 4), (2100, 12, 12),
                                   (4096, 24, 12), (2048, 64, 16)])
@pytest.mark.parametrize("dedup", [True, False])
def test_every_b1_b4_config_is_bitwise_the_default_on_card(cuda, n, k, m,
                                                           dedup):
    """Every block_n x copy of B1 and every block_n of B4 gives (p, z) bit
    for bit what the rule's launch gives; a block_n the shared-memory
    budget cannot hold raises and launches nothing."""
    theta, codes, scales, ids, vals = _dup_inputs(60 + k, n=n, k=k, m=m)
    t, c, s, i, v = (x.to(cuda) for x in _t(theta, codes, scales, ids, vals))
    want = fk.lsplm_sparse_fused_forward(i, v, t, dedup=dedup)
    want8 = fk.lsplm_sparse_fused_int8_forward(i, v, c, s, dedup=dedup)
    for bn in fk.BLOCK_N_GRID:
        for int8, fn, rows, copies, ref in (
                (False, fk.lsplm_sparse_fused_forward, (t,),
                 (tune.COPY_LANE, tune.COPY_PIECE), want),
                (True, fk.lsplm_sparse_fused_int8_forward, (c, s), (None,),
                 want8)):
            fits = bn <= fk.max_block_n(k, 2 * m, int8=int8, dedup=dedup)
            for copy in copies:
                kw = {"block_n": bn} if copy is None else {"block_n": bn,
                                                           "copy": copy}
                if not fits:
                    before = dict(fk.LAUNCHES)
                    with pytest.raises(ValueError, match="block_n"):
                        fn(i, v, *rows, dedup=dedup, **kw)
                    assert fk.LAUNCHES == before
                    continue
                got = fn(i, v, *rows, dedup=dedup, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                                   ref[1])


@pytest.mark.cuda
def test_b1_configs_keep_the_bundle_addend_bitwise_on_card(cuda):
    theta, codes, scales, uids, uvals = _dup_inputs(52, n=8, k=24)
    _, _, _, aids, avals = _dup_inputs(53, n=256, k=16)
    t, ui, uv, ai, av = (x.to(cuda) for x in _t(theta, uids, uvals, aids,
                                                  avals))
    session = torch.arange(8, device=cuda).repeat_interleave(32)
    z_user = fk.lsplm_sparse_fused_forward(ui, uv, t, dedup=True,
                                           head=False)[1]
    want = fk.lsplm_sparse_fused_forward(ai, av, t, dedup=True,
                                         z_add=z_user, session=session)
    for bn in fk.BLOCK_N_GRID:
        for copy in (tune.COPY_LANE, tune.COPY_PIECE):
            got = fk.lsplm_sparse_fused_forward(
                ai, av, t, dedup=True, z_add=z_user, session=session,
                block_n=bn, copy=copy)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m2", [8, 24, 128])
def test_every_b2_block_e_is_bitwise_the_default_on_card(cuda, m2, no_table):
    """Every block_e gives B2's default output bit for bit (so
    ``scatter_runs_ref``'s), planned and card-sorted, with every run
    ticket back at 0; one whose buffers do not fit raises."""
    rng = np.random.default_rng(16)
    ids, vals, _ = _scatter_batch(17, n=3000, zipf=True)
    tp = tplan.build_transpose_plan(ids, 301, pad_id=300).to(cuda)
    z = torch.from_numpy(rng.normal(size=(3000, m2)).astype(np.float32)).to(
        cuda)
    v = torch.from_numpy(vals).to(cuda).reshape(-1)
    want = sk.lsplm_sparse_scatter(tp, v, z)
    assert torch.equal(want, sref.scatter_runs_ref(tp, v, z, 301))
    for e in sk.BLOCK_E_GRID:
        if e > sk.max_block_e(m2):
            with pytest.raises(ValueError, match="block_e"):
                sk.lsplm_sparse_scatter(tp, v, z, block_e=e)
            continue
        got = sk.lsplm_sparse_scatter(tp, v, z, block_e=e)
        tune.set_overrides(block_e=e)  # through the ops' call sites
        planned = sops.scatter_add_planned(tp, v, z)
        unplanned = sops.scatter_add_unplanned(
            torch.from_numpy(ids).to(cuda), v, z, 301, 300)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(planned, want) and torch.equal(unplanned, want)
        assert not any(bool(t.any()) for t in sk._TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n,want", [(1, 1), (132, 1), (133, 2), (264, 2),
                                    (265, 4), (528, 4), (529, 8),
                                    (65_536, 8)])
def test_launch_rule_rows_a_block_on_card(cuda, n, want):
    """The .cu's rule, which every launch took before the tune table:
    rows a block by N."""
    for int8 in (False, True):
        assert fk.launch_config(n, 24, 24, int8=int8, dedup=True)[0] == want


@pytest.mark.cuda
def test_launch_rule_copy_scheme_and_budget_on_card(cuda):
    lane, piece = tune.COPY_LANE, tune.COPY_PIECE
    assert fk.launch_config(2047, 24, 24, int8=False, dedup=True)[1] == lane
    assert fk.launch_config(2048, 24, 24, int8=False, dedup=True)[1] == piece
    assert fk.launch_config(4096, 24, 24, int8=True, dedup=True)[1] == lane
    # 2m = 128 fp32 rows at K = 40 with the dedup: 17,696 B a row, so the
    # rule halves 8 rows to 2, and an explicit 4 raises
    assert fk.max_block_n(40, 128, int8=False, dedup=True) == 2
    assert fk.launch_config(4096, 40, 128, int8=False, dedup=True)[0] == 2
    with pytest.raises(ValueError, match="block_n=4 does not fit"):
        fk.launch_config(4096, 40, 128, int8=False, dedup=True, block_n=4)
    assert fk.launch_config(4096, 40, 128, int8=True, dedup=True,
                            block_n=4)[0] == 4  # int8 rows: a quarter
    assert fk.launch_config(64, 8, 8, int8=False, dedup=False, block_n=8,
                            copy=piece) == (8, piece)
    assert sk.max_block_e(128) == 256 and sk.max_block_e(24) == 512


@pytest.mark.cuda
def test_knobs_the_launch_cannot_hold_raise_on_card(cuda, no_table):
    """No silent clamp: an explicit block_n over the 48 KB budget, or off
    the grid, raises before anything launches, from the wrapper and
    through an override; the rule's own halving still serves."""
    k, m2 = 40, 128
    theta = torch.zeros((D, m2), device=cuda)
    ids = torch.full((8, k), D - 1, dtype=torch.int32, device=cuda)
    vals = torch.zeros((8, k), device=cuda)
    before = dict(fk.LAUNCHES)
    for kw, match in (({"block_n": 4}, "block_n=4 does not fit"),
                      ({"block_n": 3}, "block_n must be one of"),
                      ({"copy": 3}, "copy")):
        with pytest.raises(ValueError, match=match):
            fk.lsplm_sparse_fused_forward(ids, vals, theta, dedup=True, **kw)
    assert fk.LAUNCHES == before
    tune.set_overrides(block_n=4)
    with pytest.raises(ValueError, match="block_n=4 does not fit"):
        fops.sparse_gather_matmul(ids, vals, theta)
    tune.clear_overrides()
    z = fops.sparse_gather_matmul(ids, vals, theta)  # the rule: 1 row
    assert torch.equal(z, torch.zeros_like(z))
    assert fk.launch_config(8, k, m2, int8=False, dedup=True) == (
        1, tune.COPY_LANE)
    dz = torch.zeros((8, m2), device=cuda)
    tp = tplan.build_transpose_plan(np.zeros((8, k), np.int32), D).to(cuda)
    with pytest.raises(ValueError, match="block_e=512 does not fit"):
        sk.lsplm_sparse_scatter(tp, vals.reshape(-1), dz, block_e=512)
    with pytest.raises(ValueError, match="block_e must be one of"):
        sk.lsplm_sparse_scatter(tp, vals.reshape(-1), dz, block_e=100)


@pytest.mark.cuda
def test_ops_take_the_table_and_keep_their_bits_on_card(cuda, no_table):
    """The call sites read the card's table entry and the overrides at
    each launch's shape; the training forward and gradient and the
    bundle scores are bitwise the empty table's."""
    theta, codes, scales, ids, vals = _dup_inputs(71, n=600, k=24, m=12)
    vals[ids == D - 1] = 0.0
    t, c, s, i, v = (x.to(cuda) for x in _t(theta, codes, scales, ids, vals))
    plan = tplan.build_transpose_plan(ids, D, pad_id=D - 1).to(cuda)
    session = torch.arange(8, device=cuda).repeat_interleave(75)

    def run():
        tt = t.clone().requires_grad_(True)
        z = fops.sparse_gather_matmul(i, v, tt, plan=plan)
        g = torch.autograd.grad(z.square().sum(), tt)[0]
        b = fops.bundle_forward(i[:8], v[:8], i, v, session, theta=t)
        b8 = fops.bundle_forward(i[:8], v[:8], i, v, session, codes=c,
                                 scales=s)
        torch.cuda.synchronize()
        return z.detach(), g, *b, *b8

    want = run()
    backend = tune.backend_key(cuda)
    table = tune.AutotuneTable()
    table.put(backend, "fused_fwd", tune.fused_envelope(600, 24, 24),
              {"block_n": 2, "copy": tune.COPY_PIECE})
    table.put(backend, "fused_fwd_int8", tune.fused_envelope(8, 24, 24),
              {"block_n": 8})
    table.put(backend, "scatter", tune.scatter_envelope(plan.num_kept, 24),
              {"block_e": 512})
    tune.set_active_table(table)
    assert fops._knobs("fused_fwd", i, t) == {"block_n": 2,
                                              "copy": tune.COPY_PIECE}
    got = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tune.set_overrides(block_n=1, copy=tune.COPY_LANE, block_e=128)
    got = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
