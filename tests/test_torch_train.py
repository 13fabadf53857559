"""The port's sparse training slice against the JAX reference on the same
numpy inputs: the batch generator, the sparse objective and its gradient,
OWLQN+ trajectories, the metrics, the training driver and checkpoints.

Bars (the repo's own, ``tests/test_shard_step.py:59-109``): loss rtol
2e-5; dTheta atol 3e-5 after dividing by ``g_scale = max(1, max|g|)``;
after 6 OWLQN+ steps f rtol 2e-4, Theta rtol 2e-3 / atol 2e-5 and the
zero pattern EQUAL. Generated arrays and plan leaves are equal exactly.
Both packages get the same numpy Theta0. That a gradient is bitwise
repeatable on a card is ``test_torch_train_card.py``'s (it imports no
JAX).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.data.sparse as jsparse
import repro.eval.metrics as jmetrics
import repro.io.checkpoint as jckpt
from repro.obs.ledger import validate_file as reference_validate_file
from repro.optim import OWLQNPlus as JOWLQN
from repro_torch import convert
from repro_torch.core import objective as tobj
from repro_torch.data import sparse as tsparse
from repro_torch.eval import metrics as tmetrics
from repro_torch.io import checkpoint as tckpt
from repro_torch.kernels.lsplm_sparse_fused import ops as fops
from repro_torch.kernels.lsplm_sparse_scatter.plan import build_transpose_plan
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.optim import owlqn_plus as towlqn

FIELDS = ("user_ids", "user_vals", "ad_ids", "ad_vals", "session_id", "y")
D = 3000


def _gen_kwargs(d=D, sessions=96, seed=1):
    return dict(num_features=d, num_user_features_range=(int(0.6 * d), d),
                sessions=sessions, seed=seed)


@pytest.fixture(scope="module")
def batches():
    """(reference batch, port batch) from the same generator call."""
    kw = _gen_kwargs()
    return jsparse.generate_sparse(**kw), tsparse.generate_sparse(
        **kw, device="cpu")


def _theta0(d, m, seed=0, seen_of=None):
    theta = (0.02 * np.random.default_rng(seed).normal(size=(d, 2 * m))
             ).astype(np.float32)
    if seen_of is not None:  # untouched rows start at exact zero
        seen = np.zeros(d, bool)
        for ids in (seen_of.user_ids, seen_of.ad_ids):
            flat = np.asarray(ids).reshape(-1)
            seen[flat[flat < d]] = True
        theta *= seen[:, None]
    return theta


# -------------------------------------------------------------- the data
@pytest.mark.parametrize("kw", [_gen_kwargs(seed=5),
                                _gen_kwargs(d=1000, sessions=7, seed=0),
                                dict(num_features=2000, sessions=10, seed=3,
                                     num_user_features_range=(1500, 2000),
                                     ads_per_session=2, active_user=5,
                                     active_ad=3)])
def test_generate_sparse_equals_reference_bitwise(kw):
    jb = jsparse.generate_sparse(**kw)
    tb = tsparse.generate_sparse(**kw, device="cpu")
    for f in FIELDS:
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tb.num_features == jb.num_features
    for side in ("user_plan", "ad_plan"):
        for f in ("row_ids", "order", "rank", "inv_compact", "inv_sorted"):
            np.testing.assert_array_equal(
                getattr(getattr(tb, side), f).numpy(),
                np.asarray(getattr(getattr(jb, side), f)), err_msg=f)
    np.testing.assert_array_equal(tsparse.to_dense(tb), jsparse.to_dense(jb))


def test_planted_truth_helpers_equal_reference():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 10**6, (6, 5))
    np.testing.assert_array_equal(tsparse.planted_id_weight(ids, 31),
                                  jsparse.planted_id_weight(ids, 31))


def test_sparse_batch_from_numpy_carries_a_reference_batch(batches):
    jb, tb = batches
    fields = {f: np.asarray(getattr(jb, f)) for f in FIELDS}
    got = convert.sparse_batch_from_numpy(
        {f: a.copy() for f, a in fields.items()}, jb.num_features, "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(tb, f)), f
    assert torch.equal(got.ad_plan.inv_sorted, tb.ad_plan.inv_sorted)
    with pytest.raises(ValueError, match="missing"):
        convert.sparse_batch_from_numpy({"y": fields["y"]}, D, "cpu")


# ---------------------------------------------------------- the objective
@pytest.mark.parametrize("m,planned", [(4, True), (4, False), (12, True)])
def test_nll_sparse_loss_and_grad_match_reference(batches, m, planned):
    jb, tb = batches
    if not planned:
        jb = jb._replace(user_plan=None, ad_plan=None)
        tb = tb._replace(user_plan=None, ad_plan=None)
    theta = _theta0(D, m, seed=m)
    l_ref, g_ref = jax.jit(jsparse.sparse_loss_and_grad)(jnp.asarray(theta),
                                                         jb)
    l_got, g_got = tsparse.sparse_loss_and_grad(torch.from_numpy(theta), tb)
    np.testing.assert_allclose(float(l_got), float(l_ref), rtol=2e-5)
    g_scale = max(1.0, float(jnp.abs(g_ref).max()))
    np.testing.assert_allclose(g_got.numpy() / g_scale,
                               np.asarray(g_ref) / g_scale, atol=3e-5)
    touched = np.zeros(D, bool)
    for ids in (jb.user_ids, jb.ad_ids):
        flat = np.asarray(ids).reshape(-1)
        touched[flat[flat < D]] = True
    assert (g_got.numpy()[~touched] == 0.0).all()  # untouched rows: exact 0
    np.testing.assert_allclose(
        float(tobj.objective(torch.from_numpy(theta), tb, 0.0, 0.0)),
        float(l_ref), rtol=2e-5)


@pytest.mark.parametrize("planned", [True, False])
def test_gather_matmul_gradcheck_float64(planned):
    """The autograd Function's backward (dTheta and dvals, planned and
    unplanned) against finite differences, in float64 on the CPU path."""
    rng = np.random.default_rng(11)
    n, k, rows = 6, 5, 13
    ids = rng.integers(0, rows - 1, (n, k)).astype(np.int32)
    ids[:, 1] = ids[:, 0]  # a duplicate in every row
    ids[:, -1] = rows - 1  # pad slots (value 0)
    vals = rng.normal(size=(n, k))
    vals[:, -1] = 0.0
    theta = rng.normal(size=(rows, 4))
    theta[-1] = 0.0
    plan = (build_transpose_plan(ids, rows, pad_id=rows - 1) if planned
            else None)
    i = torch.from_numpy(ids)
    v = torch.tensor(vals, dtype=torch.float64, requires_grad=True)
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda vv, tt: fops.sparse_gather_matmul(i, vv, tt, plan=plan),
        (v, t))


def test_logps_and_plan_checks():
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 9, (4, 3)).astype(np.int32)
    theta = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    lp1, lp0 = fops.lsplm_sparse_logps(torch.from_numpy(ids),
                                       torch.ones(4, 3), theta)
    np.testing.assert_allclose(torch.logaddexp(lp1, lp0).numpy(), 0.0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        fops.sparse_gather_matmul(torch.from_numpy(ids), torch.ones(4, 3),
                                  theta, plan=build_transpose_plan(ids, 11))


# -------------------------------------------------------------- OWLQN+
def _port_opt(tb, lam, beta):
    return towlqn.OWLQNPlus(lambda t: tobj.smooth_loss_and_grad(t, tb),
                            lam=lam, beta=beta,
                            loss=lambda t: tobj.nll_sparse(t, tb))


@pytest.mark.parametrize("seen_only", [True, False])
def test_owlqn_six_steps_match_reference(batches, seen_only):
    jb, tb = batches
    m, lam, beta = 4, 0.5, 0.5
    theta0 = _theta0(D, m, seed=3, seen_of=jb if seen_only else None)
    jopt = JOWLQN(lambda t: jsparse.sparse_loss_and_grad(t, jb), lam=lam,
                  beta=beta)
    js = jopt.init(jnp.asarray(theta0))
    jstep = jax.jit(jopt.step)
    topt = _port_opt(tb, lam, beta)
    ts = topt.init(torch.from_numpy(theta0))
    f_ref, f_got = [], []
    for _ in range(6):
        js, jstats = jstep(js)
        ts, tstats = topt.step(ts)
        f_ref.append(float(jstats.f_new))
        f_got.append(tstats.f_new)
        assert tstats.ls_iters == int(jstats.ls_iters)
        assert tstats.nnz == int(jstats.nnz)
    np.testing.assert_allclose(f_got, f_ref, rtol=2e-4)
    want, got = np.asarray(js.theta), ts.theta.numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    assert f_got[-1] < float(tobj.objective(torch.from_numpy(theta0), tb,
                                            lam, beta))


def test_owlqn_run_stops_on_the_same_iteration(batches):
    jb, tb = batches
    theta0 = _theta0(D, 4, seed=4, seen_of=jb)
    jtheta, jtrace = JOWLQN(lambda t: jsparse.sparse_loss_and_grad(t, jb),
                            lam=0.5, beta=0.5).run(jnp.asarray(theta0),
                                                   max_iters=25, tol=2e-3)
    seen = []
    ttheta, ttrace = _port_opt(tb, 0.5, 0.5).run(
        torch.from_numpy(theta0), max_iters=25, tol=2e-3,
        callback=lambda k, s: seen.append(k))
    assert len(jtrace) < 25  # the stagnation stop fired
    assert len(ttrace) == len(jtrace) and seen == list(range(len(ttrace)))
    np.testing.assert_allclose([s.f_new for s in ttrace],
                               [float(s.f_new) for s in jtrace], rtol=2e-4)


def test_owlqn_degenerate_inputs():
    """A zero gradient at Theta = 0 is optimal: ||d|| = 0 stops the run at
    once; the objective helper adds the regularisers."""
    opt = towlqn.OWLQNPlus(lambda t: (t.sum() * 0, torch.zeros_like(t)),
                           lam=0.1, beta=0.1)
    theta, trace = opt.run(torch.zeros(5, 4), max_iters=5)
    assert len(trace) == 1 and trace[0].grad_norm == 0.0
    assert torch.equal(theta, torch.zeros(5, 4))
    t = torch.ones(2, 2)
    np.testing.assert_allclose(float(opt.objective(t)),
                               0.1 * 2 * np.sqrt(2) + 0.1 * 4, rtol=1e-6)


# -------------------------------------------------------------- metrics
def test_metrics_match_reference():
    rng = np.random.default_rng(13)
    y = (rng.random(500) < 0.3).astype(np.float32)
    p = np.round(rng.random(500), 2)  # ties exercise the midrank
    for name in ("auc", "log_loss", "calibration_ratio",
                 "normalized_entropy"):
        assert getattr(tmetrics, name)(y, p) == getattr(jmetrics, name)(y, p)
    edges = np.linspace(0, 1, 6)
    np.testing.assert_array_equal(tmetrics.bucketed_calibration(y, p, edges),
                                  jmetrics.bucketed_calibration(y, p, edges))
    assert tmetrics.report(y, p) == jmetrics.report(y, p)
    assert tmetrics.auc(np.ones(3), np.arange(3.0)) == 0.5


# ------------------------------------------------------- driver, files
def test_launch_train_sparse_end_to_end_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "lsplm")
    ledger = str(tmp_path / "ledger.jsonl")
    report = ttrain.run(["--sparse", "--sparse-features", "50000",
                         "--sessions", "256", "--regions", "4", "--lam",
                         "0.05", "--beta", "0.05", "--iters", "10",
                         "--device", "cpu", "--ckpt", ckpt,
                         "--ledger-out", ledger,
                         "--trace-out", str(tmp_path / "trace.json")])
    its = report["iters"]
    assert len(its) == 10 and report["device"] == "cpu"
    assert its[-1]["f_new"] < its[0]["f"]  # f falls
    assert its[-1]["nnz"] < its[0]["nnz"]  # nnz falls
    assert report["test_auc"] > 0.5
    assert "test_auc" in its[0] and "test_auc" in its[5]
    assert reference_validate_file(ledger) == []
    out = capsys.readouterr().out
    assert out.count("iter ") == 10 and "transpose plan" in out
    # the port's checkpoint loads in the reference, and back
    path = report["ckpt"]
    assert path.endswith(".npz")
    like = {"theta": jnp.zeros((50000, 8), jnp.float32)}
    theta = jckpt.load(path, like)["theta"]
    assert theta.shape == (50000, 8) and (theta != 0).sum() == its[-1]["nnz"]
    back = tckpt.load(path, {"theta": torch.zeros(50000, 8)})["theta"]
    np.testing.assert_array_equal(back.numpy(), np.asarray(theta))
    assert ttrain.main(["--sparse", "--sparse-features", "20000",
                        "--sessions", "40", "--regions", "2", "--iters", "1",
                        "--device", "cpu"]) == 0


def test_checkpoint_load_restores_structure_and_refuses_mismatches(tmp_path):
    class Pair(tuple):
        pass

    tree = {"theta": np.arange(6, dtype=np.float32).reshape(3, 2),
            "step": 7, "hist": [np.ones(2, np.int32), np.zeros(1)]}
    path = jckpt.save(str(tmp_path / "ref"), tree)
    like = {"theta": torch.zeros(3, 2, dtype=torch.float64), "step": 0,
            "hist": [np.zeros(2, np.int32), np.zeros(1)]}
    got = tckpt.load(path, like)
    assert got["step"] == 7 and isinstance(got["step"], int)
    assert got["theta"].dtype == torch.float64
    np.testing.assert_array_equal(got["theta"].numpy(), tree["theta"])
    np.testing.assert_array_equal(got["hist"][0], tree["hist"][0])
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(path, {**like, "theta": torch.zeros(2, 2)})
    with pytest.raises(KeyError):
        tckpt.load(path, {"other": torch.zeros(1)})


def test_launch_train_refuses_what_is_not_ported():
    # --stream and --drift-ref are ported (tests/test_torch_stream.py)
    # --tune/--chunk are ported (tests/test_torch_tune.py)
    # --mesh-data/--mesh-model are ported (tests/test_torch_shard_step.py)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.run(["--sparse", "--iters", "1"])


def test_launch_serve_trains_first_without_a_checkpoint(capsys):
    report = tserve.run(["--sparse-features", "20000", "--sessions", "64",
                         "--regions", "2", "--train-iters", "3",
                         "--requests", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "OWLQN+ iters on d=20,000" in out
    assert report["num_features"] == 20000 and report["regions"] == 2
    assert 0 < report["rows_alive"] < 20000  # real L2,1 sparsity


def test_sparse_problem_matches_reference_and_its_float64_witness():
    """The drivers' shared set-up: the batch equals the reference
    generator's at the drivers' user-id range, Theta0 is 0.01 N(0, 1)
    from ``seed``, and the float64 problem (the on-card smoke's witness)
    starts from the same Theta0 and tracks the float32 trajectory within
    the repo's 6-step bars."""
    d, m, sessions = 5000, 4, 64
    jb = jsparse.generate_sparse(num_features=d,
                                 num_user_features_range=(3000, d),
                                 sessions=sessions, seed=1)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        batch, theta0, opt = ttrain.sparse_problem(
            d, m, sessions, lam=0.05, beta=0.05, seed=0, batch_seed=1,
            device="cpu", dtype=dtype)
        assert theta0.dtype == dtype and batch.ad_vals.dtype == dtype
        for f in FIELDS:
            want = np.asarray(getattr(jb, f))
            np.testing.assert_array_equal(
                getattr(batch, f).numpy().astype(want.dtype), want)
        state = opt.init(theta0)
        for _ in range(3):
            state, stats = opt.step(state)
        runs[dtype] = (theta0, state.theta, stats.f_new)
    (t0_32, th_32, f_32), (t0_64, th_64, f_64) = runs.values()
    np.testing.assert_array_equal(
        t0_32.numpy(), (0.01 * np.random.default_rng(0).normal(
            size=(d, 2 * m))).astype(np.float32))
    assert torch.equal(t0_64.float(), t0_32)
    assert abs(f_32 - f_64) <= 2e-4 * abs(f_64)
    np.testing.assert_allclose(th_32.double().numpy(), th_64.numpy(),
                               rtol=2e-3, atol=2e-5)


# The cuda-marked tests of this file are in ``tests/test_torch_train_card.py``,
# which imports no JAX, so the card's machine collects them.
