"""The port's serving path (``repro_torch.serve`` + ``repro_torch.launch.serve``)
against the JAX reference (``repro.serve``) on the same numpy inputs, and
the port's own bitwise claims, on the CPU.

Cross-package gates: compress/quantize leaves equal exactly; scores at
p atol 1e-6 (fp32 sums reassociate across frameworks). In-port claims are
bitwise: pruned == full Theta, single == batched, coalesced ==
per-envelope per ticket, int8-native == dequantise-then-fp32.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.serve as jserve
from repro.obs.ledger import validate_file as reference_validate_file
from repro_torch import convert
from repro_torch.launch import serve as tlaunch
import repro_torch.serve as tserve
from repro_torch.serve import engine as tengine
from repro_torch.serve import score as tscore
from repro_torch.serve.traffic import (
    MicroBatchQueue,
    QueueConfig,
    poisson_arrivals,
)

P_ATOL = 1e-6
D, M = 4000, 4


@pytest.fixture(scope="module")
def theta():
    """A pruned-looking Theta: ~10% of rows alive, the rest exactly 0."""
    rng = np.random.default_rng(0)
    th = (rng.normal(size=(D, 2 * M)) * 0.3).astype(np.float32)
    th[rng.random(D) >= 0.1] = 0.0
    return th


def _requests(num, seed):
    return tengine.synthetic_requests(num, num_features=D, seed=seed)


def _jax_bundle(req):
    n = req.ad_ids.shape[0]
    return jserve.ScoreBundle(
        user_ids=jnp.asarray(req.user_ids[None], jnp.int32),
        user_vals=jnp.asarray(req.user_vals[None]),
        ad_ids=jnp.asarray(req.ad_ids, jnp.int32),
        ad_vals=jnp.asarray(req.ad_vals),
        session_id=jnp.zeros((n,), jnp.int32))


def _torch_bundle(req):
    n = req.ad_ids.shape[0]
    return tscore.ScoreBundle(
        user_ids=torch.from_numpy(req.user_ids[None]),
        user_vals=torch.from_numpy(req.user_vals[None]),
        ad_ids=torch.from_numpy(req.ad_ids),
        ad_vals=torch.from_numpy(req.ad_vals),
        session_id=torch.zeros((n,), dtype=torch.int64))


# ---------------------------------------------------------- artifacts
def test_compress_and_quantize_leaves_equal_reference(theta):
    jart = jserve.compress(jnp.asarray(theta))
    tart = tserve.compress(torch.from_numpy(theta))
    for f in ("theta", "remap", "alive_ids"):
        np.testing.assert_array_equal(getattr(tart, f).numpy(),
                                      np.asarray(getattr(jart, f)))
    assert tart.num_features == jart.num_features == D
    assert tart.num_alive == jart.num_alive
    jq, tq = jserve.quantize(jart), tserve.quantize(tart)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.deployed_bytes == jq.deployed_bytes
    np.testing.assert_array_equal(
        tserve.dequantize(tq).theta.numpy(),
        np.asarray(jserve.dequantize(jq).theta))


def test_compress_keeps_the_input_device_and_rejects_bad_shapes(theta):
    art = tserve.compress(torch.from_numpy(theta))
    assert art.theta.device.type == "cpu" and art.theta.shape[0] == art.num_alive + 1
    assert float(art.theta[-1].abs().max()) == 0.0
    with pytest.raises(ValueError):
        tserve.compress(theta[:, :3])


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_jax_saved_artifact_scores_in_port(theta, tmp_path, form):
    jart = jserve.compress(jnp.asarray(theta))
    if form == "int8":
        jart = jserve.quantize(jart)
    path = jserve.save_artifact(str(tmp_path / "jax_art"), jart)
    tart = convert.load_artifact(path, device="cpu")
    assert type(tart).__name__ == type(jart).__name__
    for req in _requests(2, seed=1):
        want = np.asarray(jserve.score_bundles(jart, _jax_bundle(req),
                                               mode="jnp"))
        got = tscore.score_bundles(tart, _torch_bundle(req)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_port_saved_artifact_scores_in_reference(theta, tmp_path, form):
    tart = tserve.compress(torch.from_numpy(theta))
    if form == "int8":
        tart = tserve.quantize(tart)
    path = tserve.save_artifact(str(tmp_path / "port_art"), tart)
    jart = jserve.load_artifact(path)
    assert type(jart).__name__ == type(tart).__name__
    # the in-memory crossing gives the same arrays as the file
    arrays = convert.to_numpy(tart)
    rebuilt = convert.artifact_from_numpy(arrays, device="cpu")
    for f in tart._fields:
        if f != "num_features":
            assert torch.equal(getattr(rebuilt, f), getattr(tart, f))
    for req in _requests(2, seed=2):
        want = tscore.score_bundles(tart, _torch_bundle(req)).numpy()
        got = np.asarray(jserve.score_bundles(jart, _jax_bundle(req),
                                              mode="jnp"))
        np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)


def test_numpy_theta_resolves_to_the_card(theta):
    """A numpy Theta has no device: scoring and compress put it where
    every entry point of the port defaults to, the card (raising without
    one); a tensor stays on its device; device="cpu" is honoured."""
    ids = np.zeros((2, 3), np.int32)
    vals = np.ones((2, 3), np.float32)
    assert tscore.as_model(theta, device="cpu").device.type == "cpu"
    assert tscore.as_model(torch.from_numpy(theta)).device.type == "cpu"
    calls = (lambda: tscore.as_model(theta),
             lambda: tscore.score_sparse(theta, ids, vals),
             lambda: tscore.predict(theta, (ids, vals)),
             lambda: tscore.score_dense(theta, np.zeros((1, D), np.float32)),
             lambda: tserve.compress(theta))
    if torch.cuda.is_available():
        assert tscore.as_model(theta).device.type == "cuda"
        assert tserve.compress(theta).theta.device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_theta_from_numpy_checks_its_input(theta):
    t = convert.theta_from_numpy(theta, "cpu")
    assert t.dtype == torch.float32 and t.shape == theta.shape
    with pytest.raises(ValueError):
        convert.theta_from_numpy(theta.astype(np.float64), "cpu")
    with pytest.raises(ValueError):
        convert.theta_from_numpy(theta[:, :3], "cpu")
    with pytest.raises(ValueError):
        tserve.artifact_from_numpy({"theta": theta})


# ---------------------------------------------------------- scoring
@pytest.mark.parametrize("mode", ["jnp", "interpret"])
def test_score_bundles_matches_reference(theta, mode):
    """A G=2 bundle batch, fp32 and int8 artifacts, against the
    reference's jnp path and its interpret-mode Pallas kernels."""
    g, n = 2, 6
    reqs = _requests(g, seed=3)
    reqs = [r._replace(ad_ids=r.ad_ids[:n], ad_vals=r.ad_vals[:n])
            for r in reqs]
    ku = max(r.user_ids.shape[0] for r in reqs)
    ka = max(r.ad_ids.shape[1] for r in reqs)
    ui = np.full((g, ku), D, np.int32)
    uv = np.zeros((g, ku), np.float32)
    ai = np.full((g * n, ka), D, np.int32)
    av = np.zeros((g * n, ka), np.float32)
    for s, r in enumerate(reqs):
        ui[s, :r.user_ids.shape[0]] = r.user_ids
        uv[s, :r.user_vals.shape[0]] = r.user_vals
        ai[s * n:(s + 1) * n, :r.ad_ids.shape[1]] = r.ad_ids
        av[s * n:(s + 1) * n, :r.ad_vals.shape[1]] = r.ad_vals
    sid = np.repeat(np.arange(g), n)
    jb = jserve.ScoreBundle(*(jnp.asarray(x) for x in (ui, uv, ai, av)),
                            jnp.asarray(sid, jnp.int32))
    tb = tscore.ScoreBundle(*(torch.from_numpy(x) for x in (ui, uv, ai, av)),
                            torch.from_numpy(sid))
    jart = jserve.compress(jnp.asarray(theta))
    for jm, tm in ((jart, tserve.compress(torch.from_numpy(theta))),
                   (jserve.quantize(jart),
                    tserve.quantize(tserve.compress(
                        torch.from_numpy(theta))))):
        want = np.asarray(jserve.score_bundles(jm, jb, mode=mode))
        got = tscore.score_bundles(tm, tb).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)


def test_score_sparse_and_predict_match_reference(theta):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, D, (32, 9)).astype(np.int32)
    vals = rng.normal(size=(32, 9)).astype(np.float32)
    want = np.asarray(jserve.score_sparse(jnp.asarray(theta), jnp.asarray(ids),
                                          jnp.asarray(vals), mode="jnp"))
    got = tscore.score_sparse(torch.from_numpy(theta), ids, vals).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)
    np.testing.assert_array_equal(
        tscore.predict(torch.from_numpy(theta), (ids, vals)).numpy(), got)
    req = _requests(1, seed=5)[0]
    np.testing.assert_array_equal(
        tscore.predict(torch.from_numpy(theta), _torch_bundle(req)).numpy(),
        tscore.score_bundles(torch.from_numpy(theta),
                             _torch_bundle(req)).numpy())
    x = (rng.normal(size=(2, D)) * (rng.random((2, D)) < 0.05)).astype(
        np.float32)  # dense rows take the dense path, as in the reference
    np.testing.assert_allclose(
        tscore.predict(torch.from_numpy(theta), x).numpy(),
        np.asarray(jserve.predict(jnp.asarray(theta), jnp.asarray(x))),
        rtol=0, atol=P_ATOL)


# ------------------------------------------- transpose plans (C1)
def _planned_batches(seed):
    """The same plan-carrying batch from both packages' generators (their
    arrays are equal bit for bit), and the port's copy without plans."""
    from repro.data.sparse import generate_sparse as jgenerate
    from repro_torch.data.sparse import generate_sparse as tgenerate

    kw = dict(num_features=D, num_user_features_range=(D // 2, D),
              sessions=8, seed=seed)
    jb = jgenerate(**kw)  # with_plans=True
    tb = tgenerate(**kw, device="cpu")
    assert tb.user_plan is not None and tb.ad_plan is not None
    np.testing.assert_array_equal(tb.ad_ids.numpy(), np.asarray(jb.ad_ids))
    return jb, tb, tb._replace(user_plan=None, ad_plan=None)


def test_score_sparse_with_plan_bitwise_equals_unplanned(theta):
    _, tb, _ = _planned_batches(7)
    th = torch.from_numpy(theta)
    bare = tscore.score_sparse(th, tb.ad_ids, tb.ad_vals)
    assert torch.equal(tscore.score_sparse(th, tb.ad_ids, tb.ad_vals,
                                           plan=tb.ad_plan), bare)
    lp = tscore.score_sparse_logps(th, tb.ad_ids, tb.ad_vals,
                                   plan=tb.ad_plan)
    for a, b in zip(lp, tscore.score_sparse_logps(th, tb.ad_ids,
                                                  tb.ad_vals)):
        assert torch.equal(a, b)
    from repro_torch.core import lsplm as tlsplm

    params = tlsplm.params_from_theta(th)
    assert torch.equal(tlsplm.predict_proba_sparse(
        params, tb.ad_ids, tb.ad_vals, plan=tb.ad_plan), bare)
    for a, b in zip(tlsplm.predict_logits_stable_sparse(
            params, tb.ad_ids, tb.ad_vals, plan=tb.ad_plan), lp):
        assert torch.equal(a, b)


def test_predict_threads_plans_and_grads_match_reference(theta):
    """predict() keeps a SparseCTRBatch's plans on a full model: the
    forward is the bare batch's, and the planned autograd gradient equals
    the reference's jax.grad of its own planned predict (the bars of
    tests/test_serve_score.py::test_predict_threads_plans_and_grads)."""
    import jax

    jb, planned, bare = _planned_batches(9)
    th = torch.from_numpy(theta)
    assert torch.equal(tscore.predict(th, planned), tscore.predict(th, bare))
    grads = []
    for batch in (planned, bare):
        t = th.clone().requires_grad_(True)
        tscore.predict(t, batch).sum().backward()
        grads.append(t.grad.numpy())
    want = jax.grad(lambda t: jserve.predict(t, jb).sum())(jnp.asarray(theta))
    for g in grads:
        np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_planned_scoring_bitwise_equals_unplanned_on_card(theta):
    """On the card a planned score_sparse / predict_proba_sparse returns
    the fused kernel's p, bit for bit the unplanned call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.core import lsplm as tlsplm

    _, tb, _ = _planned_batches(7)
    th = torch.from_numpy(theta).cuda()
    ids, vals = tb.ad_ids.cuda(), tb.ad_vals.cuda()
    plan = tb.ad_plan.to(th.device)
    bare = tscore.score_sparse(th, ids, vals)
    assert torch.equal(tscore.score_sparse(th, ids, vals, plan=plan), bare)
    params = tlsplm.params_from_theta(th)
    assert torch.equal(tlsplm.predict_proba_sparse(params, ids, vals,
                                                   plan=plan), bare)
    assert torch.equal(tlsplm.predict_proba_sparse(params, ids, vals), bare)


@pytest.mark.parametrize("call", ["score_sparse", "score_sparse_logps",
                                  "bundle_logits", "score_bundles"])
def test_plans_on_a_pruned_artifact_raise(theta, call):
    _, tb, _ = _planned_batches(7)
    art = tserve.compress(torch.from_numpy(theta))
    bundle = tscore.ScoreBundle(tb.user_ids, tb.user_vals, tb.ad_ids,
                                tb.ad_vals, tb.session_id)
    fn = getattr(tscore, call)
    with pytest.raises(ValueError, match="full Theta layout"):
        if call.startswith("score_sparse"):
            fn(art, tb.ad_ids, tb.ad_vals, plan=tb.ad_plan)
        else:
            fn(art, bundle, user_plan=tb.user_plan, ad_plan=tb.ad_plan)
    if call.startswith("score_sparse"):  # the full model takes the plan
        fn(torch.from_numpy(theta), tb.ad_ids, tb.ad_vals, plan=tb.ad_plan)


def test_predict_on_an_artifact_drops_plans(theta):
    _, planned, bare = _planned_batches(9)
    art = tserve.compress(torch.from_numpy(theta))
    assert torch.equal(tscore.predict(art, planned), tscore.predict(art, bare))
    assert torch.equal(tscore.predict(art, planned),
                       tscore.predict(torch.from_numpy(theta), bare))


def test_pruned_scoring_bitwise_equals_full(theta):
    art = tserve.compress(torch.from_numpy(theta))
    rng = np.random.default_rng(6)
    ids = rng.integers(0, D, (64, 16)).astype(np.int32)
    vals = rng.normal(size=(64, 16)).astype(np.float32)
    assert torch.equal(tscore.score_sparse(torch.from_numpy(theta), ids, vals),
                       tscore.score_sparse(art, ids, vals))
    for req in _requests(5, seed=7):
        assert torch.equal(tscore.score_bundles(torch.from_numpy(theta),
                                                _torch_bundle(req)),
                           tscore.score_bundles(art, _torch_bundle(req)))


def test_int8_native_bitwise_equals_dequantised(theta):
    q = tserve.quantize(tserve.compress(torch.from_numpy(theta)))
    deq = tserve.dequantize(q)
    model = tscore.as_model(q)
    assert model.is_int8 and model.theta is None
    for req in _requests(5, seed=8):
        assert torch.equal(tscore.score_bundles(q, _torch_bundle(req)),
                           tscore.score_bundles(deq, _torch_bundle(req)))
        dp = (tscore.score_bundles(q, _torch_bundle(req))
              - tscore.score_bundles(torch.from_numpy(theta),
                                     _torch_bundle(req))).abs().max()
        assert float(dp) <= 1e-2


def test_naive_bundles_match_shared(theta):
    for req in _requests(3, seed=9):
        b = _torch_bundle(req)
        np.testing.assert_allclose(
            tscore.score_bundles_naive(torch.from_numpy(theta), b).numpy(),
            tscore.score_bundles(torch.from_numpy(theta), b).numpy(), rtol=0,
            atol=P_ATOL)


# ---------------------------------------------------------- engine
@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_engine_matches_reference_engine(theta, form):
    jart = jserve.compress(jnp.asarray(theta))
    tart = tserve.compress(torch.from_numpy(theta))
    if form == "int8":
        jart, tart = jserve.quantize(jart), tserve.quantize(tart)
    jeng = jserve.ScoringEngine(jart, mode="jnp")
    teng = tengine.ScoringEngine(tart, device="cpu")
    reqs = _requests(12, seed=10)
    assert [teng.envelope(r) for r in reqs] == [jeng.envelope(r) for r in reqs]
    for got, want in zip(teng.score_batch(reqs), jeng.score_batch(reqs)):
        np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)
    assert teng.stats.dispatches == jeng.stats.dispatches
    assert teng.stats.slots == jeng.stats.slots
    assert all(k[-1] == form for k in teng.envelope_keys)


def test_engine_single_equals_batched_and_pruned_equals_full(theta):
    reqs = _requests(20, seed=11)
    full = tengine.ScoringEngine(theta, device="cpu")
    pruned = tengine.ScoringEngine(tserve.compress(torch.from_numpy(theta)),
                                   device="cpu")
    single = full.score_many(reqs)
    for a, b, c in zip(single, full.score_batch(reqs),
                       pruned.score_batch(reqs)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert full.stats.requests == 40 and full.stats.dispatches < 40


def test_engine_builds_no_entry_after_warm(theta):
    rng = np.random.default_rng(12)
    eng = tengine.ScoringEngine(tserve.quantize(tserve.compress(
        torch.from_numpy(theta))),
                                device="cpu")
    reqs = _requests(30, seed=13)
    envs = tengine.envelope_closure({eng.envelope(r) for r in reqs})
    eng.warm(envs, batch_sizes=eng.g_buckets)
    built = eng.stats.compiles
    assert built == len(envs) * len(eng.g_buckets)
    assert eng.stats.dispatches == 0  # warm-up dispatches are not booked
    for _ in range(3):
        order = rng.permutation(len(reqs))
        eng.score_batch([reqs[i] for i in order])
    eng.score_many(reqs)
    widest = tuple(max(e[i] for e in envs) for i in range(3))
    eng.score_batch_at(reqs[:5], widest)
    assert eng.stats.compiles == built, "steady state built an entry"


def test_engine_envelope_rules(theta):
    assert tengine.round_up(9, (8, 16)) == 16
    assert tengine.round_up(17, (8, 16)) == 32
    with pytest.raises(ValueError):
        tengine.round_up(0, (8,))
    eng = tengine.ScoringEngine(theta, device="cpu", k_buckets=(4, 8),
                                n_buckets=(2, 4))
    req = tengine.synthetic_requests(1, num_features=D, k_user=(5, 5),
                                     k_ad=(3, 3), n_ads=(3, 3))[0]
    assert eng.envelope(req) == (8, 4, 4)
    with pytest.raises(ValueError):
        eng.score_batch_at([req], (4, 4, 4))


def test_synthetic_requests_equal_reference():
    for a, b in zip(tengine.synthetic_requests(5, num_features=D, seed=14),
                    jserve.synthetic_requests(5, num_features=D, seed=14)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_coalesced_queue_bitwise_equals_per_envelope(theta):
    art = tserve.compress(torch.from_numpy(theta))
    reqs = _requests(24, seed=15)
    arrivals = poisson_arrivals(len(reqs), qps=500.0, seed=16)

    def run(coalesce):
        q = MicroBatchQueue(tengine.ScoringEngine(art, device="cpu"),
                            QueueConfig(max_batch=8, max_delay_us=2000.0,
                                        coalesce=coalesce))
        for t, r in zip(arrivals, reqs):
            q.flush_due(t)
            q.submit(r, t)
        q.flush_due(arrivals[-1] + 1.0)
        q.drain(arrivals[-1] + 1.0)
        return q

    off, on = run(False), run(True)
    got_off = {c.ticket: c.scores for c in off.completions}
    got_on = {c.ticket: c.scores for c in on.completions}
    assert got_off.keys() == got_on.keys() and len(got_off) == len(reqs)
    for t in got_off:
        np.testing.assert_array_equal(got_off[t], got_on[t])
    assert on.stats.flushes["coalesced"] > 0


# ---------------------------------------------------------- the driver
def test_launch_serve_end_to_end_on_cpu(theta, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt.npz")
    np.savez(ckpt, theta=theta)
    ledger = str(tmp_path / "ledger.jsonl")
    report = tlaunch.run(["--ckpt", ckpt, "--requests", "24", "--int8",
                          "--load-qps", "1000,20000", "--coalesce",
                          "--real-clock", "--device", "cpu",
                          "--artifact", str(tmp_path / "art"),
                          "--ledger-out", ledger,
                          "--metrics-out", str(tmp_path / "m.json"),
                          "--trace-out", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "pruned scoring bit-identical" in out
    assert "single-vs-batched scores bit-identical" in out
    assert report["device"] == "cpu" and report["rows_alive"] > 0
    assert report["int8_max_dp"] <= 1e-2
    assert len(report["load"]) == 2 and len(report["real_clock"]) == 2
    assert all(r["served"] == 24 for r in report["load"])
    assert report_engine_steady(report)
    assert reference_validate_file(ledger) == []
    art = jserve.load_artifact(str(tmp_path / "art.npz"))
    assert art.num_features == D
    assert tlaunch.main(["--ckpt", ckpt, "--requests", "4",
                         "--device", "cpu"]) == 0


def report_engine_steady(report):
    eng = report["engine"]
    return eng["requests"] == 48 and eng["dispatches"] > 0


def test_launch_serve_refuses_what_it_cannot_do(tmp_path):
    ckpt = str(tmp_path / "c.npz")
    np.savez(ckpt, weights=np.zeros((3, 4), np.float32))
    with pytest.raises(SystemExit, match="theta"):
        tlaunch.run(["--ckpt", ckpt, "--device", "cpu"])
    with pytest.raises(SystemExit, match="load-qps"):
        tlaunch.run(["--ckpt", ckpt, "--real-clock", "--device", "cpu"])
