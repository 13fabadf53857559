"""The port's dense slice against the JAX reference on the same numpy
inputs: the common-feature data, the dense and Eq. 13 objectives and
their gradients, the model's predictors, dense OWLQN+ trajectories,
dense scoring of full, pruned and int8 models, and the dense training
driver with its checkpoints.

Bars (the repo's own): generated arrays and batch utilities equal
exactly; loss rtol 2e-5; dTheta atol 3e-5 after dividing by
``g_scale = max(1, max|g|)``; the common-feature loss equal to the dense
one within 1e-4 (``benchmarks/bench_common_feature.py:57``); after 6
OWLQN+ steps f rtol 2e-4, Theta rtol 2e-3 / atol 2e-5 and the zero
pattern EQUAL (``tests/test_shard_step.py:59-109``); scores p atol 1e-6
across packages, pruned <= 1e-6 from full, int8 <= 1e-2 from fp32. Both
packages get the same numpy Theta0. The ``cuda``-marked tests run the
dense path on a card and skip without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.data.sparse as jsparse
import repro.io.checkpoint as jckpt
import repro.serve as jserve
from repro.obs.ledger import validate_file as reference_validate_file
from repro.optim import OWLQNPlus as JOWLQN
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.core import objective as tobj
from repro_torch import data as tdata
from repro_torch import serve as tserve
from repro_torch.io import checkpoint as tckpt
from repro_torch.kernels.lsplm_fused import lsplm_fused as b5
from repro_torch.launch import train as ttrain
from repro_torch.optim import owlqn_plus as towlqn

CF_FIELDS = ("x_common", "x_noncommon", "session_id", "y")
CFG = dict(num_user_features=24, num_ad_features=20, noise_features=6)


def _cfg(**kw):
    return jdata.CTRDataConfig(**{**CFG, **kw}), tdata.CTRDataConfig(
        **{**CFG, **kw})


@pytest.fixture(scope="module")
def batches():
    """(reference batch, port batch) of 64 sessions from one config."""
    jcfg, tcfg = _cfg()
    jb, _ = jdata.generate(jcfg, 64, seed=1)
    tb, _ = tdata.generate(tcfg, 64, seed=1, device="cpu")
    return jb, tb


def _theta0(d, m, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).normal(size=(d, 2 * m))
            ).astype(np.float32)


def _assert_cf_equal(tb, jb, with_weight=False):
    for f in CF_FIELDS + (("weight",) if with_weight else ()):
        want, got = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


# -------------------------------------------------------------- the data
@pytest.mark.parametrize("kw,sessions,seed", [
    ({}, 16, 0),
    (dict(density=0.3, ads_per_session=2, noise_features=0, seed=3), 9, 7),
    (dict(num_user_features=64, num_ad_features=48, noise_features=16,
          true_regions=3, label_noise=0.1), 40, None),
])
def test_generate_equals_reference_bitwise(kw, sessions, seed):
    jcfg, tcfg = _cfg(**kw)
    assert tcfg.num_features == jcfg.num_features
    jb, jx = jdata.generate(jcfg, sessions, seed=seed)
    tb, tx = tdata.generate(tcfg, sessions, seed=seed, device="cpu")
    _assert_cf_equal(tb, jb)
    np.testing.assert_array_equal(tx.numpy(), jx)
    dense = tdata.to_dense_batch(tb)
    jdense = jdata.to_dense_batch(jb)
    np.testing.assert_array_equal(dense.x.numpy(), np.asarray(jdense.x))
    np.testing.assert_array_equal(dense.y.numpy(), np.asarray(jdense.y))
    lean, none = tdata.generate(tcfg, sessions, seed=seed, device="cpu",
                                with_dense=False)
    assert none is None
    _assert_cf_equal(lean, jb)


def test_train_val_test_equals_reference():
    jcfg, tcfg = _cfg()
    for (jb, jx), (tb, tx) in zip(
            jdata.train_val_test(jcfg, (12, 4, 5), seed=2),
            tdata.train_val_test(tcfg, (12, 4, 5), seed=2, device="cpu")):
        _assert_cf_equal(tb, jb)
        np.testing.assert_array_equal(tx.numpy(), jx)
    assert tdata.auc is not None and tdata.auc(
        np.array([0, 1, 1]), np.array([0.1, 0.9, 0.8])) == 1.0


@pytest.mark.parametrize("multiple", [1, 3, 7])
def test_pad_to_multiple_equals_reference(batches, multiple):
    jb, tb = batches
    jp, tp = jdata.pad_to_multiple(jb, multiple), tdata.pad_to_multiple(
        tb, multiple)
    _assert_cf_equal(tp, jp, with_weight=True)
    # a weighted batch is padded again with fresh weights, as there
    _assert_cf_equal(tdata.pad_to_multiple(tp, 5),
                     jdata.pad_to_multiple(jp, 5), with_weight=True)


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_shard_sessions_and_costs_equal_reference(batches, shards):
    jb, tb = batches
    for js, ts in zip(jdata.shard_sessions(jb, shards),
                      tdata.shard_sessions(tb, shards), strict=True):
        _assert_cf_equal(ts, js)
    for compressed in (True, False):
        assert tdata.memory_bytes(tb, compressed) == jdata.memory_bytes(
            jb, compressed)
        assert tdata.flops_per_eval(tb, 12, compressed) == \
            jdata.flops_per_eval(jb, 12, compressed)


def test_common_feature_batch_from_numpy_carries_a_reference_batch(batches):
    jb, tb = batches
    jw = jdata.pad_to_multiple(jb, 5)
    got = convert.common_feature_batch_from_numpy(jw, "cpu")
    _assert_cf_equal(got, jw, with_weight=True)
    assert convert.common_feature_batch_from_numpy(jb, "cpu").weight is None


# ---------------------------------------------------------- the objective
@pytest.mark.parametrize("form", ["dense", "common_feature"])
@pytest.mark.parametrize("m,pad", [(4, 1), (12, 1), (3, 7)])
def test_nll_loss_and_grad_match_reference(batches, form, m, pad):
    jb, tb = batches
    jb, tb = jdata.pad_to_multiple(jb, pad), tdata.pad_to_multiple(tb, pad)
    cf = form == "common_feature"
    if not cf:
        jd, td = jdata.to_dense_batch(jb), tdata.to_dense_batch(tb)
        jb = jcore.CTRBatch(x=jnp.asarray(jd.x), y=jnp.asarray(jd.y),
                            weight=jnp.asarray(jb.weight))
        tb = tcore.CTRBatch(x=td.x, y=td.y, weight=tb.weight)
    else:
        jb = jax.tree.map(jnp.asarray, jb)
    theta = _theta0(CFG["num_user_features"] + CFG["num_ad_features"]
                    + CFG["noise_features"], m, seed=m)
    l_ref, g_ref = jax.jit(lambda t: jcore.smooth_loss_and_grad(
        t, jb, common_feature=cf))(jnp.asarray(theta))
    l_got, g_got = tcore.smooth_loss_and_grad(torch.from_numpy(theta), tb,
                                              common_feature=cf)
    np.testing.assert_allclose(float(l_got), float(l_ref), rtol=2e-5)
    g_scale = max(1.0, float(jnp.abs(g_ref).max()))
    np.testing.assert_allclose(g_got.numpy() / g_scale,
                               np.asarray(g_ref) / g_scale, atol=3e-5)
    for lam, beta in ((0.0, 0.0), (0.7, 0.3)):
        np.testing.assert_allclose(
            float(tobj.objective(torch.from_numpy(theta), tb, lam, beta,
                                  common_feature=cf)),
            float(jcore.objective(jnp.asarray(theta), jb, lam, beta,
                                  common_feature=cf)), rtol=2e-5)


def test_common_feature_loss_equals_dense_loss(batches):
    _, tb = batches
    theta = torch.from_numpy(_theta0(50, 12, seed=5))
    dense = tdata.to_dense_batch(tb)
    l_cf = float(tcore.nll_common_feature(theta, tb))
    l_dense = float(tcore.nll(theta, tcore.CTRBatch(x=dense.x, y=dense.y)))
    assert abs(l_cf - l_dense) / abs(l_dense) < 1e-4
    assert tcore.is_sparse_batch(jsparse.generate_sparse(
        num_features=100, num_user_features_range=(60, 100), sessions=2))
    assert not tcore.is_sparse_batch(tb)


# -------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(9)
    theta = (0.5 * rng.normal(size=(40, 12))).astype(np.float32)
    x = rng.normal(size=(3, 11, 40)).astype(np.float32)
    return theta, x


def test_predictors_match_reference(model):
    theta, x = model
    jp = jcore.params_from_theta(jnp.asarray(theta))
    tt = torch.from_numpy(theta)
    tp = tcore.params_from_theta(tt)
    assert tp.u._base is tt and tp.w._base is tt  # views, no copies
    assert torch.equal(tp.theta, tt)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    p = tcore.predict_proba(tp, tx)
    assert p.shape == (3, 11)
    np.testing.assert_allclose(p.numpy(), np.asarray(jcore.predict_proba(
        jp, jx)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcore.foe_mixture_proba(tp, tx).numpy(),
                               p.numpy(), rtol=1e-6, atol=1e-7)
    for got, want in zip(tcore.predict_logits_stable(tp, tx),
                         jcore.predict_logits_stable(jp, jx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    for div, fit in (("softmax", "identity"), ("identity", "sigmoid"),
                     ("softmax", "sigmoid")):
        jcfg = jcore.LSPLMConfig(num_features=40, num_regions=6,
                                 dividing=div, fitting=fit)
        tcfg = tcore.LSPLMConfig(num_features=40, num_regions=6,
                                 dividing=div, fitting=fit)
        np.testing.assert_allclose(
            tcore.predict_proba(tp, tx, tcfg).numpy(),
            np.asarray(jcore.predict_proba(jp, jx, jcfg)),
            rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="link"):
        tcore.predict_proba(tp, tx, tcore.LSPLMConfig(
            num_features=40, dividing="identity", link="logit"))


def test_sparse_predictors_match_reference():
    d, m = 300, 3
    jb = jsparse.generate_sparse(num_features=d,
                                 num_user_features_range=(180, d),
                                 sessions=6, seed=4, with_plans=False)
    ids = np.concatenate([np.asarray(jb.user_ids)[np.asarray(
        jb.session_id)], np.asarray(jb.ad_ids)], axis=1)
    vals = np.concatenate([np.asarray(jb.user_vals)[np.asarray(
        jb.session_id)], np.asarray(jb.ad_vals)], axis=1)
    theta = _theta0(d, m, seed=6)
    jp = jcore.params_from_theta(jnp.asarray(theta))
    tp = tcore.params_from_theta(torch.from_numpy(theta))
    np.testing.assert_allclose(
        tcore.predict_proba_sparse(tp, torch.from_numpy(ids),
                                   torch.from_numpy(vals)).numpy(),
        np.asarray(jcore.predict_proba_sparse(jp, jnp.asarray(ids),
                                              jnp.asarray(vals), mode="jnp")),
        rtol=0, atol=1e-6)
    for got, want in zip(
            tcore.predict_logits_stable_sparse(tp, torch.from_numpy(ids),
                                               torch.from_numpy(vals)),
            jcore.predict_logits_stable_sparse(jp, jnp.asarray(ids),
                                               jnp.asarray(vals),
                                               mode="jnp")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_init_params_draws_from_the_generator():
    cfg = tcore.LSPLMConfig(num_features=500, num_regions=7)
    a = tcore.init_params(cfg, torch.Generator().manual_seed(3))
    b = tcore.init_params(cfg, torch.Generator().manual_seed(3))
    c = tcore.init_params(cfg, torch.Generator().manual_seed(4), scale=0.5)
    assert a.u.shape == a.w.shape == (500, 7) and a.u.dtype == torch.float32
    assert torch.equal(a.u, b.u) and torch.equal(a.w, b.w)
    assert not torch.equal(a.u, a.w) and not torch.equal(a.u, c.u)
    assert abs(float(a.u.std()) - 1e-2) < 1e-3
    assert abs(float(c.w.std()) - 0.5) < 5e-2


# -------------------------------------------------------------- OWLQN+
def test_dense_owlqn_six_steps_match_reference():
    jcfg, tcfg = _cfg()
    jb, _ = jdata.generate(jcfg, 96, seed=1)
    jb = jax.tree.map(jnp.asarray, jdata.pad_to_multiple(jb, 1))
    tb = tdata.pad_to_multiple(
        tdata.generate(tcfg, 96, seed=1, device="cpu")[0], 1)
    m, lam, beta = 4, 0.5, 0.5
    theta0 = _theta0(tcfg.num_features, m, seed=3, scale=0.01)
    jopt = JOWLQN(lambda t: jcore.smooth_loss_and_grad(
        t, jb, common_feature=True), lam=lam, beta=beta)
    js, jstep = jopt.init(jnp.asarray(theta0)), jax.jit(jopt.step)
    topt = towlqn.OWLQNPlus(
        lambda t: tcore.smooth_loss_and_grad(t, tb, common_feature=True),
        lam=lam, beta=beta,
        loss=lambda t: tcore.nll_common_feature(t, tb))
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
    assert 0 < tstats.nnz < theta0.size  # the pattern is not trivial


# ------------------------------------------------------------ scoring
@pytest.fixture(scope="module")
def pruned_theta():
    rng = np.random.default_rng(2)
    th = (rng.normal(size=(300, 8)) * 0.3).astype(np.float32)
    th[rng.random(300) >= 0.3] = 0.0
    x = (rng.normal(size=(37, 300)) * (rng.random((37, 300)) < 0.2)
         ).astype(np.float32)
    return th, x


@pytest.mark.parametrize("form", ["full", "pruned", "int8"])
def test_score_dense_matches_reference(pruned_theta, form):
    theta, x = pruned_theta
    jmodel, tmodel = jnp.asarray(theta), torch.from_numpy(theta)
    if form != "full":
        jmodel, tmodel = jserve.compress(jmodel), tserve.compress(tmodel)
    if form == "int8":
        jmodel, tmodel = jserve.quantize(jmodel), tserve.quantize(tmodel)
    want = np.asarray(jserve.score_dense(jmodel, jnp.asarray(x)))
    got = tserve.score_dense(tmodel, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (37,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the unified entry takes dense rows as a tensor or an array
    assert torch.equal(tserve.predict(tmodel, torch.from_numpy(x)), got)
    assert torch.equal(tserve.predict(tmodel, x), got)
    full = tserve.score_dense(torch.from_numpy(theta), torch.from_numpy(x))
    bar = 1e-2 if form == "int8" else 1e-6
    assert float((got - full).abs().max()) <= bar
    assert tserve.score_dense(tmodel, torch.from_numpy(
        np.stack([x, x]))).shape == (2, 37)
    with pytest.raises(ValueError, match="columns"):
        tserve.score_dense(tmodel, torch.from_numpy(x[:, :-1]))


def test_artifact_loaders_default_to_the_card(pruned_theta, tmp_path):
    path = tserve.save_artifact(str(tmp_path / "art"),
                                tserve.compress(torch.from_numpy(
                                    pruned_theta[0])))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.load_artifact(path)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert.artifact_from_numpy(convert.to_numpy(
                tserve.load_artifact(path, device="cpu")))
    art = tserve.load_artifact(path, device="cpu")
    assert art.theta.device.type == "cpu"


# ------------------------------------------------------- driver, files
def test_dense_problem_matches_reference_set_up():
    jcfg, tcfg = _cfg(seed=4)
    batch, theta0, opt = ttrain.dense_problem(tcfg, 5, 30, lam=0.1,
                                              beta=0.2, seed=7, device="cpu")
    jb, _ = jdata.generate(jcfg, 30, seed=1)
    _assert_cf_equal(batch, jdata.pad_to_multiple(jb, 1), with_weight=True)
    np.testing.assert_array_equal(theta0.numpy(), (0.01 * np.random.
                                  default_rng(7).normal(size=(50, 10)))
                                  .astype(np.float32))
    assert (opt.lam, opt.beta) == (0.1, 0.2)
    test = ttrain.dense_test_batch(tcfg, 30, device="cpu")
    jt, jx = jdata.generate(jcfg, 64, seed=2)
    np.testing.assert_array_equal(test.x.numpy(), jx)
    np.testing.assert_array_equal(test.y.numpy(), jt.y)


def test_launch_train_dense_end_to_end_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "lsplm")
    ledger = str(tmp_path / "ledger.jsonl")
    report = ttrain.run(["--iters", "10", "--device", "cpu", "--ckpt",
                         ckpt, "--ledger-out", ledger])
    its = report["iters"]
    assert report["mode"] == "dense" and report["device"] == "cpu"
    assert report["num_features"] == 128 and report["samples"] == 16000
    assert len(its) == 10
    assert its[-1]["f_new"] < its[0]["f"]  # f falls
    assert its[-1]["nnz"] < its[0]["nnz"]  # nnz falls
    assert report["test_auc"] > 0.5
    assert [k for k, r in enumerate(its) if "test_auc" in r] == [0, 5, 9]
    assert reference_validate_file(ledger) == []
    out = capsys.readouterr().out
    assert "dense mode: d=128" in out and out.count("iter ") == 10
    assert "nnz=    927" in out  # rendered with nnz_width=7
    # the port's checkpoint loads in the reference, and back
    path = report["ckpt"]
    like = {"theta": jnp.zeros((128, 24), jnp.float32)}
    theta = jckpt.load(path, like)["theta"]
    assert (theta != 0).sum() == its[-1]["nnz"]
    back = tckpt.load(path, {"theta": torch.zeros(128, 24)})["theta"]
    np.testing.assert_array_equal(back.numpy(), np.asarray(theta))
    # a reference checkpoint scores in the port as in the reference
    ref_path = jckpt.save(str(tmp_path / "ref"), {"theta": theta})
    t_ref = tckpt.load(ref_path, {"theta": torch.zeros(128, 24)})["theta"]
    x = np.random.default_rng(0).normal(size=(9, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tserve.predict(t_ref, x).numpy(),
        np.asarray(jserve.predict(jnp.asarray(theta), jnp.asarray(x))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_launch_train_runs_a_prebuilt_problem_as_its_own(mode):
    """``run(argv, prebuilt=...)`` trains the problem it is handed just as
    the driver trains the one it builds from the same flags."""
    if mode == "dense":
        argv = ["--sessions", "300", "--lam", "0.1", "--beta", "0.1"]
        cfg = tdata.CTRDataConfig(num_user_features=64, num_ad_features=48,
                                  noise_features=16, seed=0)
        prebuilt = (ttrain.dense_problem(cfg, 12, 300, lam=0.1, beta=0.1,
                                         seed=0, device="cpu"),
                    ttrain.dense_test_batch(cfg, 300, device="cpu"))
    else:
        argv = ["--sparse", "--sparse-features", "20000", "--sessions", "64",
                "--regions", "4", "--lam", "0.05", "--beta", "0.05"]
        prebuilt = (ttrain.sparse_problem(20000, 4, 64, lam=0.05, beta=0.05,
                                          seed=0, batch_seed=1, device="cpu"),
                    ttrain.sparse_test_batch(20000, 64, seed=2, device="cpu"))
    argv += ["--iters", "6", "--device", "cpu"]
    own = ttrain.run(argv)
    handed = ttrain.run(argv, prebuilt=prebuilt)
    assert own["mode"] == handed["mode"] == mode
    for a, b in zip(own["iters"], handed["iters"], strict=True):
        a.pop("wall_s"), b.pop("wall_s")
        assert a == b


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_path_on_card_matches_cpu(cuda, batches):
    _, tb = batches
    cb = tdata.pad_to_multiple(tb, 1)
    gb = cb._replace(**{f: getattr(cb, f).to(cuda) for f in CF_FIELDS
                        + ("weight",)})
    theta = torch.from_numpy(_theta0(50, 12, seed=11))
    l_c, g_c = tcore.smooth_loss_and_grad(theta, cb, common_feature=True)
    l_g, g_g = tcore.smooth_loss_and_grad(theta.to(cuda), gb,
                                          common_feature=True)
    np.testing.assert_allclose(float(l_g), float(l_c), rtol=2e-5)
    g_scale = max(1.0, float(g_c.abs().max()))
    np.testing.assert_allclose(g_g.cpu().numpy() / g_scale,
                               g_c.numpy() / g_scale, atol=3e-5)
    x = tdata.to_dense_batch(tb).x
    before = b5.LAUNCHES["lsplm_fused_forward"]
    p_g = tserve.predict(theta.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert b5.LAUNCHES["lsplm_fused_forward"] == before + 1
    torch.testing.assert_close(p_g.cpu(), tserve.predict(theta, x),
                               rtol=1e-5, atol=1e-6)
