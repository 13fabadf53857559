"""The port's sharded LS-PLM training (``repro_torch.shard.step``,
``repro_torch.dist``, ``launch.mesh``, the mesh-aware OWLQN+, the sharded
stream and the drivers' ``--mesh-data``/``--mesh-model``) against the
reference's SINGLE-DEVICE path on the CPU.

The reference's own sharded step raises under jax 0.9.0 (ROADMAP C), so
it cannot be the oracle: the port's meshes are held against
``repro.data.sparse.sparse_loss_and_grad``, ``repro.core.objective.
smooth_loss_and_grad(common_feature=True)`` and ``repro.optim.OWLQNPlus``
on the same numpy inputs (``tests/test_shard_step.py``'s sizes: d = 600,
m = 4, 32 sessions x 4 ads, Theta0 nonzero only on rows some id touches).

The meshes run as spawned gloo ranks (``launch.mesh.run_ranks``). Their
workers are this module's ``_*_worker`` functions, so a rank imports this
module: it imports no JAX at module level (the reference is imported
inside the tests, in the parent), and a rank returns numpy arrays.

Bars: loss rtol 2e-5; gradient atol 3e-5 after dividing by g_scale; six
OWLQN+ steps f rtol 2e-4, Theta rtol 2e-3 / atol 2e-5, the zero pattern
exactly equal, untouched and pad rows exactly 0; every rank's f, step
size and nnz bitwise equal at every step; within the port bitwise: a
1 x 1 mesh and the unsharded path, two runs of one mesh, the sharded
stream's full window under reset and the sharded full batch, a resumed
sharded stream and the run it continues.
"""
import functools
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import dist as tdist
from repro_torch.core.direction import (
    descent_direction,
    directional_derivative,
)
from repro_torch.core.objective import (
    nll_common_feature,
    nll_sparse,
    smooth_loss_and_grad,
)
from repro_torch.data.common_feature import pad_to_multiple
from repro_torch.data.sparse import build_batch_plans, generate_sparse
from repro_torch.data.synthetic_ctr import CTRDataConfig, generate
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.optim.owlqn_plus import OWLQNPlus
from repro_torch.shard.partition import balanced_partition, make_partition
from repro_torch.shard.step import (
    make_sharded_sparse_loss,
    sharded_sparse_loss_and_grad,
    sharded_sparse_nll,
)
from repro_torch.stream import DayStream, StreamTrainer

D, M, LAM, STEPS = 600, 4, 0.5, 6
SPARSE = dict(num_features=D, num_user_features_range=(360, D), sessions=32,
              ads_per_session=4, active_user=8, active_ad=5, seed=3)
DENSE_CFG = dict(num_user_features=24, num_ad_features=24, noise_features=8)
STREAM = dict(days=3, d=600, m=2, sessions=16, k=(6, 4), lam=0.1)
MESHES = [(2, 4), (4, 2), (2, 2), (1, 2), (2, 1)]
LOSS_RTOL, GRAD_ATOL = 2e-5, 3e-5
F_RTOL, THETA_RTOL, THETA_ATOL = 2e-4, 2e-3, 2e-5


def _sparse_theta0(batch) -> np.ndarray:
    """0.02 N(0, 1) from seed 0 on the rows some id touches, 0 elsewhere
    (``tests/test_shard_step.py``'s Theta0)."""
    seen = np.zeros(D, bool)
    for ids in (batch.user_ids.numpy(), batch.ad_ids.numpy()):
        seen[ids[ids < D]] = True
    return (0.02 * np.random.default_rng(0).normal(size=(D, 2 * M))
            * seen[:, None]).astype(np.float32)


def _dense_problem():
    cfg = CTRDataConfig(**DENSE_CFG)
    batch, _ = generate(cfg, 64, seed=3, device="cpu", with_dense=False)
    theta0 = (0.02 * np.random.default_rng(0).normal(
        size=(cfg.num_features, 2 * M))).astype(np.float32)
    return cfg, batch, theta0


def _trajectory(step, state, steps=STEPS):
    stats = []
    for _ in range(steps):
        state, s = step(state)
        stats.append((s.f_new, s.alpha, s.nnz))
    return state, stats


def _world_worker(rank, dev, shapes, tmp):
    """One rank of a world that runs each (data, model) mesh of
    ``shapes`` in turn (:func:`_mesh_worker`), then, given ``tmp``, the
    2 x 2 stream (:func:`_stream_worker`)."""
    out = {shape: _mesh_worker(rank, *shape) for shape in shapes}
    if tmp is not None:
        out["stream"] = _stream_worker(rank, tmp)
    return out


def _mesh_worker(rank, data, model):
    """One rank of a (data, model) mesh: the sparse loss and gradient at
    Theta0 over equal and balanced ranges (with and without the data-axis
    dTheta sum), STEPS sharded OWLQN+ steps twice, and the dense mesh's
    loss, gradient and STEPS steps; gathered arrays unpadded."""
    mesh = Mesh(data, model)
    batch = generate_sparse(**SPARSE, with_plans=False, device="cpu")
    theta0 = torch.from_numpy(_sparse_theta0(batch))
    out = {"rank": rank, "grad": {}, "grad_local": {}, "loss": {},
           "pad_max": {}}
    parts = {"equal": make_partition(D, model),
             "balanced": balanced_partition(D, model, batch.user_ids,
                                            batch.ad_ids, pad_id=D)}
    for name, part in parts.items():
        cell = tdist.shard_sparse_batch(
            mesh, build_batch_plans(batch, shards=part, data_shards=data))
        block = part.shard_rows(part.pad_rows(theta0), mesh.model_rank)
        loss, grad = sharded_sparse_loss_and_grad(block, cell, mesh)
        leaf = block.clone().requires_grad_(True)
        (local,) = torch.autograd.grad(sharded_sparse_nll(leaf, cell, mesh),
                                       leaf)
        lo, hi = part.ranges()[mesh.model_rank]
        out["pad_max"][name] = float(grad[hi - lo:].abs().sum())
        out["loss"][name] = float(loss)
        out["grad"][name] = part.unpad_rows(mesh.gather_rows(grad)).numpy()
        out["grad_local"][name] = part.unpad_rows(
            mesh.gather_rows(local)).numpy()
        if name == "equal":  # f'(Theta; d) of the Eq. 9 direction
            d = descent_direction(block, grad, LAM, LAM)
            out["dir_deriv"] = float(directional_derivative(
                block, grad, d, LAM, LAM, reduce=mesh.sum_model))
    part = parts["equal"]
    cell = tdist.shard_sparse_batch(
        mesh, build_batch_plans(batch, shards=part, data_shards=data))
    loss_and_grad, loss = make_sharded_sparse_loss(cell, mesh)
    opt = OWLQNPlus(loss_and_grad, lam=LAM, beta=LAM, loss=loss,
                    reduce=mesh.sum_model)
    block = part.shard_rows(part.pad_rows(theta0), mesh.model_rank)
    runs = [_trajectory(opt.step, opt.init(block)) for _ in range(2)]
    out["stats"] = [stats for _, stats in runs]
    out["thetas"] = [part.unpad_rows(mesh.gather_rows(st.theta)).numpy()
                     for st, _ in runs]
    out["collectives"] = mesh.collective_counts()

    cfg, dbatch, dtheta0 = _dense_problem()
    dpart = make_partition(cfg.num_features, model)
    local = tdist.shard_batch(mesh, pad_to_multiple(dbatch, data),
                              common_feature=True, partition=dpart)
    dblock = dpart.shard_rows(dpart.pad_rows(torch.from_numpy(dtheta0)),
                              mesh.model_rank)
    loss_and_grad, loss = tdist.make_sharded_dense_loss(local, mesh,
                                                        common_feature=True)
    dloss, dgrad = loss_and_grad(dblock)
    out["dense_loss"] = float(dloss)
    out["dense_grad"] = dpart.unpad_rows(mesh.gather_rows(dgrad)).numpy()
    dopt = OWLQNPlus(loss_and_grad, lam=LAM, beta=LAM, loss=loss,
                     reduce=mesh.sum_model)
    st, out["dense_stats"] = _trajectory(dopt.step, dopt.init(dblock))
    out["dense_theta"] = dpart.unpad_rows(mesh.gather_rows(st.theta)).numpy()
    return out


def _stream_problem():
    s = STREAM
    stream = DayStream(s["days"], sessions_per_day=s["sessions"],
                       num_features=s["d"], active_user=s["k"][0],
                       active_ad=s["k"][1], seed=4)
    theta0 = torch.from_numpy((0.01 * np.random.default_rng(0).normal(
        size=(s["d"], 2 * s["m"]))).astype(np.float32))
    return stream, theta0


def _stream_worker(rank, tmp):
    """One rank of a 2 x 2 mesh's stream: the full window under reset
    against the sharded full batch, a two-window run with both history
    policies, and a mid-stream checkpoint resumed."""
    mesh = Mesh(2, 2)
    s = STREAM
    stream, theta0 = _stream_problem()
    part = make_partition(s["d"], mesh.model)
    full = build_batch_plans(stream.window(s["days"] - 1, s["days"]),
                             shards=part, data_shards=mesh.data)
    loss_and_grad, loss = make_sharded_sparse_loss(
        tdist.shard_sparse_batch(mesh, full), mesh)
    opt = OWLQNPlus(loss_and_grad, lam=s["lam"], beta=s["lam"], loss=loss)
    st, stats = _trajectory(tdist.make_distributed_step(opt, mesh),
                            opt.init(part.shard_rows(part.pad_rows(theta0),
                                                     mesh.model_rank)), 3)
    tr = StreamTrainer(stream, lam=s["lam"], beta=s["lam"], window=s["days"],
                       inner_iters=3, mesh=mesh, device="cpu")
    state, trace = tr.run(tr.init(theta0)._replace(day=s["days"] - 1),
                          days=1)
    out = {"full_fs": list(trace[0].fs), "batch_fs": [x[0] for x in stats],
           "full_equal": bool(torch.equal(state.opt.theta, st.theta))}
    for history in ("reset", "carry"):
        tr = StreamTrainer(stream, lam=s["lam"], beta=s["lam"], window=2,
                           inner_iters=2, history=history, mesh=mesh,
                           device="cpu")
        fin, trace = tr.run(tr.init(theta0))
        out[history] = ([f for w in trace for f in w.fs],
                        tr.theta(fin).numpy())
    mid, _ = tr.run(tr.init(theta0), days=2)
    path = tr.save(f"{tmp}/stream.npz", mid)
    torch.distributed.barrier()
    back = tr.load(path, theta0)
    (fin_a, ta), (fin_b, tb) = tr.run(mid, days=1), tr.run(back, days=1)
    out["resume"] = (back.day, [w.fs for w in ta] == [w.fs for w in tb],
                     bool(torch.equal(tr.theta(fin_a), tr.theta(fin_b))))
    return out


# one spawned world per size runs every mesh of that size (a spawn costs
# seconds; the meshes' groups are made in one world in turn)
WORLDS = {8: ((2, 4), (4, 2)), 4: ((2, 2),), 2: ((1, 2), (2, 1))}


@functools.lru_cache(maxsize=None)
def _world_run(size):
    """Every rank's results of the world of ``size`` ranks (the 2 x 2
    world also runs the stream, its checkpoint in a temporary directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(_world_worker, size, WORLDS[size],
                         tmp if size == 4 else None)


def _mesh_run(data, model):
    return [r[(data, model)] for r in _world_run(data * model)]


@functools.lru_cache(maxsize=None)
def _reference_sparse():
    import jax
    import jax.numpy as jnp

    from repro.data.sparse import generate_sparse as jgenerate
    from repro.data.sparse import sparse_loss_and_grad
    from repro.optim import OWLQNPlus as JOWLQN

    jb = jgenerate(**SPARSE)
    theta0 = jnp.asarray(_sparse_theta0(generate_sparse(
        **SPARSE, with_plans=False, device="cpu")))
    loss, grad = jax.jit(sparse_loss_and_grad)(theta0, jb)
    opt = JOWLQN(lambda t: sparse_loss_and_grad(t, jb), lam=LAM, beta=LAM)
    st, step, fs = opt.init(theta0), jax.jit(opt.step), []
    for _ in range(STEPS):
        st, stats = step(st)
        fs.append(float(stats.f_new))
    from repro.core.direction import descent_direction as jdesc
    from repro.core.direction import directional_derivative as jdd

    dd = float(jdd(theta0, grad, jdesc(theta0, grad, LAM, LAM), LAM, LAM))
    return (float(loss), np.asarray(grad), fs,
            np.asarray(jax.device_get(st.theta)), np.asarray(theta0) != 0,
            dd)


@functools.lru_cache(maxsize=None)
def _reference_dense():
    import jax
    import jax.numpy as jnp

    from repro.core.objective import smooth_loss_and_grad
    from repro.data import CTRDataConfig as JCfg
    from repro.data import generate as jgen
    from repro.data import pad_to_multiple as jpad
    from repro.optim import OWLQNPlus as JOWLQN

    jb, _ = jgen(JCfg(**DENSE_CFG), num_sessions=64, seed=3)
    jb = jax.tree.map(jnp.asarray, jpad(jb, 1))
    theta0 = jnp.asarray(_dense_problem()[2])

    def lg(t):
        return smooth_loss_and_grad(t, jb, common_feature=True)

    loss, grad = jax.jit(lg)(theta0)
    opt = JOWLQN(lg, lam=LAM, beta=LAM)
    st, step, fs = opt.init(theta0), jax.jit(opt.step), []
    for _ in range(STEPS):
        st, stats = step(st)
        fs.append(float(stats.f_new))
    return float(loss), np.asarray(grad), fs, np.asarray(st.theta)


def _close_theta(got, want):
    np.testing.assert_allclose(got, want, rtol=THETA_RTOL, atol=THETA_ATOL)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


# ------------------------------------------------------------- the step
@pytest.mark.parametrize("data,model", MESHES)
def test_sharded_loss_and_grad_match_single_device_reference(data, model):
    """Equal and balanced ranges; pad rows' dTheta exactly 0; and the gate
    needs the data-axis dTheta sum: each data block's share alone misses
    it (on a mesh with data > 1). The directional derivative of the Eq. 9
    direction, summed over ``model``, at the loss's bar."""
    loss, grad, _, _, seen, dd = _reference_sparse()
    g_scale = max(1.0, float(np.abs(grad).max()))
    ranks = _mesh_run(data, model)
    for name in ("equal", "balanced"):
        for r in ranks:
            np.testing.assert_allclose(r["loss"][name], loss,
                                       rtol=LOSS_RTOL)
            assert r["pad_max"][name] == 0.0
        g = ranks[0]["grad"][name]
        np.testing.assert_allclose(g / g_scale, grad / g_scale,
                                   atol=GRAD_ATOL)
        assert not g[~seen.any(axis=1)].any()  # untouched rows exactly 0
        local = ranks[0]["grad_local"][name]
        missed = float(np.abs(local - grad).max()) / g_scale
        assert missed > GRAD_ATOL if data > 1 else missed <= GRAD_ATOL
    for r in ranks:
        np.testing.assert_allclose(r["dir_deriv"], dd, rtol=LOSS_RTOL)


@pytest.mark.parametrize("data,model", MESHES)
def test_sharded_owlqn_steps_match_single_device_reference(data, model):
    """Six steps: f, Theta, the exact zero pattern and the untouched rows
    against the reference; every rank's f, step size and nnz bitwise
    equal at every step; a second run of the mesh bitwise the first."""
    _, _, fs, theta, seen, _ = _reference_sparse()
    ranks = _mesh_run(data, model)
    r0 = ranks[0]
    for r in ranks:
        assert r["stats"][0] == r0["stats"][0]
    assert r0["stats"][0] == r0["stats"][1]
    assert np.array_equal(r0["thetas"][0], r0["thetas"][1])
    np.testing.assert_allclose([s[0] for s in r0["stats"][0]], fs,
                               rtol=F_RTOL)
    _close_theta(r0["thetas"][0], theta)
    assert not r0["thetas"][0][~seen].any()
    # one z sum per loss evaluation and the optimizer's dots go over
    # model; the dTheta sums and the NLLs over data
    counts = r0["collectives"]
    assert (counts["model"]["all_reduce"] > 0) == (model > 1)
    assert (counts["data"]["all_reduce"] > 0) == (data > 1)


@pytest.mark.parametrize("data,model", MESHES[:3])
def test_dense_mesh_matches_single_device_reference(data, model):
    """The dense common-feature path on the mesh against the reference's
    single-device ``smooth_loss_and_grad(common_feature=True)`` and six
    OWLQN+ steps."""
    loss, grad, fs, theta = _reference_dense()
    g_scale = max(1.0, float(np.abs(grad).max()))
    ranks = _mesh_run(data, model)
    r0 = ranks[0]
    np.testing.assert_allclose(r0["dense_loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(r0["dense_grad"] / g_scale, grad / g_scale,
                               atol=GRAD_ATOL)
    assert all(r["dense_stats"] == r0["dense_stats"] for r in ranks)
    np.testing.assert_allclose([s[0] for s in r0["dense_stats"]], fs,
                               rtol=F_RTOL)
    _close_theta(r0["dense_theta"], theta)


def test_one_by_one_mesh_is_the_unsharded_path_bitwise():
    """No process group: the routed single cell, the sharded loss and the
    mesh-aware OWLQN+ give the unsharded bits, sparse and dense."""
    mesh = Mesh(1, 1)
    batch = generate_sparse(**SPARSE, device="cpu")
    theta0 = torch.from_numpy(_sparse_theta0(batch))
    plain = OWLQNPlus(lambda t: smooth_loss_and_grad(t, batch), lam=LAM,
                      beta=LAM, loss=lambda t: nll_sparse(t, batch))
    cell = tdist.shard_sparse_batch(mesh, build_batch_plans(batch, shards=1))
    loss_and_grad, loss = make_sharded_sparse_loss(cell, mesh)
    sharded = OWLQNPlus(loss_and_grad, lam=LAM, beta=LAM, loss=loss,
                        reduce=mesh.sum_model)
    a = _trajectory(plain.step, plain.init(theta0))
    b = _trajectory(sharded.step, sharded.init(theta0))
    assert a[1] == b[1] and torch.equal(a[0].theta, b[0].theta)

    cfg, dbatch, dtheta0 = _dense_problem()
    dbatch = pad_to_multiple(dbatch, 1)
    dplain = OWLQNPlus(
        lambda t: smooth_loss_and_grad(t, dbatch, common_feature=True),
        lam=LAM, beta=LAM, loss=lambda t: nll_common_feature(t, dbatch))
    lg, lo = tdist.make_sharded_dense_loss(
        tdist.shard_batch(mesh, dbatch, common_feature=True), mesh,
        common_feature=True)
    dsharded = OWLQNPlus(lg, lam=LAM, beta=LAM, loss=lo,
                         reduce=mesh.sum_model)
    t0 = torch.from_numpy(dtheta0)
    a = _trajectory(dplain.step, dplain.init(t0))
    b = _trajectory(dsharded.step, dsharded.init(t0))
    assert a[1] == b[1] and torch.equal(a[0].theta, b[0].theta)


def test_mesh_guards():
    """A cell must meet the mesh it was routed for (the reference's
    ``_check_mesh``), and a mesh needs its process group."""
    routed = build_batch_plans(generate_sparse(**SPARSE, device="cpu"),
                               shards=2, data_shards=1)
    with pytest.raises(ValueError, match="routed for"):
        tdist.shard_sparse_batch(Mesh(1, 1), routed)
    with pytest.raises(ValueError, match="routed for"):
        sharded_sparse_nll(torch.zeros(300, 2 * M), routed.cell(0, 1),
                           Mesh(1, 1))
    with pytest.raises(RuntimeError, match="process group"):
        Mesh(2, 2)


# ------------------------------------------------------------ the stream
def test_sharded_stream_on_a_2x2_mesh():
    """The full window under reset is bitwise the sharded full batch; two
    windows of a drifting stream with both history policies match the
    unsharded stream; a mid-stream checkpoint resumes bitwise."""
    ranks = [r["stream"] for r in _world_run(4)]
    r0 = ranks[0]
    assert r0["full_fs"] == r0["batch_fs"] and r0["full_equal"]
    stream, theta0 = _stream_problem()
    for history in ("reset", "carry"):
        tr = StreamTrainer(stream, lam=STREAM["lam"], beta=STREAM["lam"],
                           window=2, inner_iters=2, history=history,
                           device="cpu")
        fin, trace = tr.run(tr.init(theta0))
        fs, theta = r0[history]
        np.testing.assert_allclose(fs, [f for w in trace for f in w.fs],
                                   rtol=F_RTOL)
        _close_theta(theta, tr.theta(fin).numpy())
    assert all(r["resume"] == (2, True, True) for r in ranks)


# ----------------------------------------------------------- the drivers
DRIVERS = {
    "sparse": ["--sparse", "--sparse-features", "5000", "--sessions", "64",
               "--regions", "4", "--lam", "0.05", "--beta", "0.05",
               "--iters", "6"],
    "dense": ["--sessions", "64", "--iters", "6", "--lam", "0.1", "--beta",
              "0.1"],
    "stream": ["--stream", "--window", "2", "--inner-iters", "3",
               "--sessions", "32", "--sparse-features", "400", "--regions",
               "4", "--lam", "0.25", "--beta", "0.25", "--drift", "0.06",
               "--days", "3"],
}
MESH_FLAGS = ["--mesh-data", "2", "--mesh-model", "2", "--device", "cpu"]


@pytest.mark.parametrize("mode", list(DRIVERS))
def test_launch_train_on_a_2x2_mesh(mode, tmp_path, capfd):
    """``launch.train --mesh-data 2 --mesh-model 2 --device cpu`` in each
    mode against its unsharded run; every rank's scalars bitwise equal;
    the unpadded checkpoint loads in the reference's ``io.checkpoint``
    and gives the run's objective there; a sharded stream's ``--resume``
    continues bit for bit where the whole run goes."""
    argv = DRIVERS[mode] + ["--device", "cpu"]
    single = ttrain.run(argv)
    ck = str(tmp_path / "mesh.npz")
    mesh = ttrain.run(DRIVERS[mode] + MESH_FLAGS + ["--ckpt", ck])
    out = capfd.readouterr().out  # rank 0 prints from its own process
    assert "mesh: data=2 x model=2" in out and "backend=gloo" in out
    assert len(mesh["ranks"]) == 4
    if mode == "stream":
        fs = [f for w in mesh["windows"] for f in w["fs"]]
        ref = [f for w in single["windows"] for f in w["fs"]]
        np.testing.assert_allclose(fs, ref, rtol=F_RTOL)
        _close_theta(mesh["theta"].numpy(), single["theta"].numpy())
        assert all(r["windows"] == mesh["ranks"][0]["windows"]
                   for r in mesh["ranks"])
        # --ckpt after day 1, then --resume: bit for bit the whole run
        argv = DRIVERS["stream"][:-2] + MESH_FLAGS  # without --days
        part = str(tmp_path / "part.npz")
        ttrain.run(argv + ["--days", "2", "--ckpt", part])
        resumed = ttrain.run(argv + ["--days", "3", "--ckpt", part,
                                     "--resume"])
        assert resumed["resumed_at"] == 2
        assert resumed["windows"][-1]["fs"] == mesh["windows"][-1]["fs"]
        assert torch.equal(resumed["theta"], mesh["theta"])
        return
    fs = [r["f_new"] for r in mesh["iters"]]
    ref = [r["f_new"] for r in single["iters"]]
    np.testing.assert_allclose(fs, ref, rtol=F_RTOL)
    assert all(r["iters"] == mesh["ranks"][0]["iters"] for r in mesh["ranks"])
    assert mesh["test_auc"] is not None

    import jax
    import jax.numpy as jnp

    from repro.core import regularizers as jreg
    from repro.core.objective import nll_common_feature as jnll_cf
    from repro.core.objective import nll_sparse as jnll_sparse
    from repro.data import CTRDataConfig as JCfg
    from repro.data import generate as jgen
    from repro.data.sparse import generate_sparse as jgenerate
    from repro.io import checkpoint as jckpt

    d, m = (5000, 4) if mode == "sparse" else (128, 12)
    theta = jckpt.load(ck, {"theta": jnp.zeros((d, 2 * m), jnp.float32)})[
        "theta"]
    if mode == "sparse":
        nll = jnll_sparse(theta, jgenerate(
            num_features=d, num_user_features_range=(3000, d), sessions=64,
            seed=1))
    else:
        jb, _ = jgen(JCfg(num_user_features=64, num_ad_features=48,
                          noise_features=16, seed=0), 64, seed=1)
        nll = jnll_cf(theta, jax.tree.map(jnp.asarray, jb))
    lam = 0.05 if mode == "sparse" else 0.1
    f = float(nll + lam * jreg.l21_norm(theta) + lam * jreg.l1_norm(theta))
    np.testing.assert_allclose(f, fs[-1], rtol=LOSS_RTOL)


def test_launch_train_mesh_flag_checks():
    base = DRIVERS["sparse"] + ["--device", "cpu"]
    for extra, why in ((["--mesh-data", "2"], "set together"),
                       (["--mesh-model", "2"], "set together"),
                       (["--mesh-data", "3", "--mesh-model", "1"],
                        "must divide"),
                       (["--mesh-data", "2", "--mesh-model", "2", "--tune"],
                        "--tune")):
        with pytest.raises(SystemExit, match=why):
            ttrain.run(base + extra)


def test_launch_train_joins_a_torchrun_world(monkeypatch):
    """With ``RANK``/``WORLD_SIZE`` set (as ``torchrun`` sets them) the
    driver joins the world it is given instead of spawning ranks: here a
    world of one on localhost, bitwise the in-process 1 x 1 run; a mesh
    of another size than the world is refused."""
    import socket

    import torch.distributed as dist

    argv = DRIVERS["sparse"] + ["--device", "cpu"]
    one = ["--mesh-data", "1", "--mesh-model", "1"]
    alone = ttrain.run(argv + one)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(key, value)
    try:
        joined = ttrain.run(argv + one)
        assert dist.is_initialized() and dist.get_world_size() == 1
        with pytest.raises(SystemExit, match="torchrun started 1"):
            ttrain.run(argv + ["--mesh-data", "2", "--mesh-model", "1"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert joined["iters"] == [
        {**r, "wall_s": j["wall_s"]} for r, j in zip(alone["iters"],
                                                    joined["iters"])]
    assert joined["ranks"][0]["backend"] is None  # a 1 x 1 mesh
