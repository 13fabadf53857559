"""The sharded sparse path's kernels on a CUDA card: B1, B2 and B3 run on a
rank's cell of a routed batch (local ids, the shard's padded row block),
held against the port's own plain versions; and a 1 x 1 mesh is bit for
bit the unsharded path on the card.

This file imports only torch, numpy, pytest and ``repro_torch`` (no JAX),
so pytest collects it on a machine that has the card but not the JAX
reference: ``python -m pytest -q -m cuda tests/test_torch_shard_card.py``
(``chip_smoke.py`` phase 27). Every test needs a card and skips without
one. Bars: B1's z rtol 1e-5 / atol 1e-6 against the plain gather; B2
bitwise ``ref.scatter_runs_ref`` with the pad row and the rows past the
shard's range exactly 0; B3 bitwise its plain version on the card at
2m = 24.
"""
import numpy as np
import pytest
import torch

from repro_torch import dist as tdist
from repro_torch.core.objective import nll_sparse
from repro_torch.data.sparse import generate_sparse, sparse_loss_and_grad
from repro_torch.kernels.lsplm_sparse_fused import ops as fops
from repro_torch.kernels.lsplm_sparse_scatter import ops as sops
from repro_torch.kernels.lsplm_sparse_scatter import ref as sref
from repro_torch.kernels.owlqn_direction import ops as dops
from repro_torch.kernels.owlqn_direction.ref import owlqn_direction_ref
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.owlqn_plus import OWLQNPlus
from repro_torch.shard.partition import balanced_partition, make_partition
from repro_torch.shard.step import (
    make_sharded_sparse_loss,
    sharded_sparse_loss_and_grad,
)

Z_RTOL, Z_ATOL = 1e-5, 1e-6
D, M, SESSIONS, DATA, MODEL = 3000, 4, 32, 2, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(shards=None, data_shards=1):
    return generate_sparse(num_features=D,
                           num_user_features_range=(int(0.6 * D), D),
                           sessions=SESSIONS, active_user=12, active_ad=6,
                           seed=5, shards=shards, data_shards=data_shards,
                           device="cpu")


def _partitions():
    b = _batch()
    return {"equal": make_partition(D, MODEL),
            "balanced": balanced_partition(D, MODEL, b.user_ids, b.ad_ids,
                                           pad_id=D)}


def _cells(part):
    routed = _batch(part, DATA)
    for b in range(DATA):
        for s in range(MODEL):
            yield routed.cell(b, s).batch


def _block(rows, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy((0.3 * rng.normal(size=(rows, 2 * M)))
                         .astype(np.float32))
    return fops.pad_theta(t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["equal", "balanced"])
def test_b1_on_routed_cells_matches_plain(cuda, name):
    part = _partitions()[name]
    tp = _block(part.rows_per_shard, 1)
    for cell in _cells(part):
        for ids, vals in ((cell.user_ids, cell.user_vals),
                          (cell.ad_ids, cell.ad_vals)):
            want = fops.sparse_gather_matmul(ids, vals, tp)
            got = fops.sparse_gather_matmul(ids.to(cuda), vals.to(cuda),
                                            tp.to(cuda)).cpu()
            torch.testing.assert_close(got, want, rtol=Z_RTOL, atol=Z_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["equal", "balanced"])
def test_b2_on_cell_plans_bitwise_runs_ref(cuda, name):
    part = _partitions()[name]
    R = part.rows_per_shard
    rng = np.random.default_rng(2)
    for i, cell in enumerate(_cells(part)):
        lo, hi = part.ranges()[i % MODEL]
        for ids, vals, plan in ((cell.user_ids, cell.user_vals,
                                 cell.user_plan),
                                (cell.ad_ids, cell.ad_vals, cell.ad_plan)):
            dz = torch.from_numpy(rng.normal(size=(ids.shape[0], 2 * M))
                                  .astype(np.float32))
            want = sref.scatter_runs_ref(plan, vals, dz, R + 1)
            got = sops.scatter_add_planned(plan.to(cuda), vals.to(cuda),
                                           dz.to(cuda)).cpu()
            assert torch.equal(got, want)
            assert not got[hi - lo:].any()  # pad rows and the pad row


@pytest.mark.cuda
@pytest.mark.parametrize("lam,beta", [(0.05, 0.05), (0.5, 0.0)])
def test_b3_on_rank_rows_matches_plain(cuda, lam, beta):
    """At the paper's 2m = 24, where the plain version's row sums take
    the kernel's association (``tests/test_torch_direction.py``), on each
    rank's rows of a balanced partition, the pad rows included."""
    part = _partitions()["balanced"]
    rng = np.random.default_rng(3)
    for s, (lo, hi) in enumerate(part.ranges()):
        theta = torch.from_numpy(rng.normal(size=(part.rows_per_shard, 24))
                                 .astype(np.float32))
        theta[hi - lo:] = 0.0  # the pad rows of a short range
        theta[::7] = 0.0
        grad = torch.from_numpy(rng.normal(size=theta.shape)
                                .astype(np.float32))
        grad[hi - lo:] = 0.0
        t, g = theta.to(cuda), grad.to(cuda)
        want = owlqn_direction_ref(t, g, lam, beta)
        got = dops.direction(t, g, lam, beta)
        assert torch.equal(got, want)
        assert not got[hi - lo:].any()


@pytest.mark.cuda
def test_one_by_one_mesh_bitwise_unsharded_on_card(cuda):
    mesh = Mesh(1, 1)
    plain = generate_sparse(num_features=D,
                            num_user_features_range=(int(0.6 * D), D),
                            sessions=SESSIONS, active_user=12, active_ad=6,
                            seed=5, device=cuda)
    cell = tdist.shard_sparse_batch(mesh, _batch(1, 1), cuda)
    rng = np.random.default_rng(4)
    theta0 = torch.from_numpy((0.02 * rng.normal(size=(D, 2 * M)))
                              .astype(np.float32)).to(cuda)
    l1, g1 = sparse_loss_and_grad(theta0, plain)
    l2, g2 = sharded_sparse_loss_and_grad(theta0, cell, mesh)
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    single = OWLQNPlus(lambda t: sparse_loss_and_grad(t, plain), lam=0.05,
                       beta=0.05, loss=lambda t: nll_sparse(t, plain))
    loss_and_grad, loss = make_sharded_sparse_loss(cell, mesh)
    sharded = tdist.make_distributed_step(
        OWLQNPlus(loss_and_grad, lam=0.05, beta=0.05, loss=loss), mesh)
    s1, s2 = single.init(theta0), single.init(theta0)
    for _ in range(4):
        s1, st1 = single.step(s1)
        s2, st2 = sharded(s2)
        assert st1 == st2
    assert torch.equal(s1.theta, s2.theta)
