"""The port's ports of three reference examples (``examples/
quickstart_torch.py``, ``serve_lsplm_torch.py`` and
``train_sparse_production_torch.py``) against the reference examples'
own code, at small sizes on the CPU.

Each reference example is loaded from its file, and its pieces run at
the test's size with the reference's APIs (its ``fit`` and
``make_model``; its module constants set to the test's width); the
port's example runs at the same size through its ``run``. Both start
from the same numpy seeds. Bars: test AUC to 1e-4; the nonzero count,
the kept features and the alive rows exactly; the final objective f at
rtol 2e-4 after the OWLQN+ steps; the scores at the serving bar (p atol
1e-6, ``tests/test_torch_serve.py``). Timings are printed by the
examples only and not compared.
"""
import importlib.util
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
AUC_TOL, F_RTOL, P_ATOL = 1e-4, 2e-4, 1e-6


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CPU = torch.device("cpu")


def test_quickstart_matches_the_reference_example():
    import jax.numpy as jnp

    from repro.core import CTRBatch, predict_proba, regularizers
    from repro.core.lsplm import params_from_theta
    from repro.data import CTRDataConfig, auc, generate, to_dense_batch

    sizes = dict(sessions=1000, test_sessions=300, lr_iters=10, iters=20)
    got = _example("quickstart_torch").run(CPU, **sizes)
    ref = _example("quickstart")
    cfg = CTRDataConfig(num_user_features=24, num_ad_features=24,
                        noise_features=8, true_regions=4, seed=0)
    train = to_dense_batch(generate(cfg, sizes["sessions"], seed=1)[0])
    test = to_dense_batch(generate(cfg, sizes["test_sessions"], seed=2)[0])
    tb = CTRBatch(x=jnp.asarray(train.x), y=jnp.asarray(train.y))
    for key, m, lam, iters in (("lr", 1, 0.0, sizes["lr_iters"]),
                               ("lsplm", 12, 1.0, sizes["iters"])):
        theta, tr = ref.fit(tb, cfg.num_features, m=m, lam=lam, beta=1.0,
                            iters=iters)
        p = np.asarray(predict_proba(params_from_theta(theta),
                                     jnp.asarray(test.x)))
        want = got[key]
        assert want["iters"] == len(tr)
        np.testing.assert_allclose(want["f"], float(tr[-1].f_new),
                                   rtol=F_RTOL)
        assert abs(want["auc"] - auc(test.y, p)) <= AUC_TOL
    s, t = got["lsplm"], np.asarray(theta)
    assert s["nnz"] == int(regularizers.nonzero_count(theta))
    assert s["features"] == int(regularizers.nonzero_feature_count(theta))
    assert s["noise_nnz"] == int((t[-cfg.noise_features:] != 0).sum())


def test_serve_example_matches_the_reference_example():
    import jax.numpy as jnp

    from repro.data.sparse import generate_sparse
    from repro.serve import (
        ScoreBundle,
        ScoringEngine,
        compress,
        score_bundles,
        score_sparse,
        synthetic_requests,
    )

    d, rows, sessions, requests = 20_000, 256, 8, 32
    got = _example("serve_lsplm_torch").run(CPU, d=d, rows=rows,
                                            sessions=sessions,
                                            requests=requests, iters=1)
    ref = _example("serve_lsplm")
    ref.D = d
    theta = ref.make_model()
    art = compress(theta)
    assert got["alive"] == art.num_alive
    rng = np.random.default_rng(1)
    ids = jnp.asarray(rng.integers(0, d, (rows, 24)), jnp.int32)
    vals = jnp.asarray(rng.normal(size=(rows, 24)).astype(np.float32) / 5.0)
    np.testing.assert_array_equal(got["p_full"], got["p_pruned"])
    np.testing.assert_allclose(got["p_pruned"], np.asarray(
        score_sparse(art, ids, vals)), rtol=0, atol=P_ATOL)
    batch = generate_sparse(num_features=d,
                            num_user_features_range=(3 * d // 5, d),
                            sessions=sessions, ads_per_session=30, seed=2,
                            with_plans=False)
    bundle = ScoreBundle(batch.user_ids, batch.user_vals, batch.ad_ids,
                         batch.ad_vals, batch.session_id)
    np.testing.assert_allclose(got["p_shared"], np.asarray(
        score_bundles(art, bundle)), rtol=0, atol=P_ATOL)
    np.testing.assert_allclose(got["p_shared"], got["p_naive"], rtol=1e-5,
                               atol=1e-6)
    engine = ScoringEngine(art)
    reqs = synthetic_requests(requests, num_features=d, seed=3)
    engine.warm({engine.envelope(r) for r in reqs})
    warm = engine.stats.compiles
    want = engine.score_many(reqs)
    e = got["engine"]
    assert e["compiles"] == e["warm_compiles"]
    assert engine.stats.compiles == warm
    assert (e["requests"], e["buckets"], e["compiles"]) == (
        engine.stats.requests, len(engine.stats.bucket_hits),
        engine.stats.compiles)
    for a, b in zip(got["engine_scores"], want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=P_ATOL)


def test_sparse_production_matches_the_reference_example():
    import jax.numpy as jnp

    from repro.data.sparse import (
        generate_sparse,
        sparse_loss_and_grad,
        sparse_predict,
    )
    from repro.eval import report
    from repro.optim import OWLQNPlus

    d, m, sessions, test_sessions, iters = 20_000, 4, 256, 64, 8
    got = _example("train_sparse_production_torch").run(
        CPU, d=d, m=m, sessions=sessions, test_sessions=test_sessions,
        iters=iters)
    users = (3 * d // 5, d)  # the example's default range at its width
    train = generate_sparse(num_features=d, num_user_features_range=users,
                            sessions=sessions, seed=1)
    test = generate_sparse(num_features=d, num_user_features_range=users,
                           sessions=test_sessions, seed=2)
    theta0 = jnp.asarray(0.01 * np.random.default_rng(0).normal(
        size=(d, 2 * m)), jnp.float32)
    opt = OWLQNPlus(lambda t: sparse_loss_and_grad(t, train), lam=0.05,
                    beta=0.05)
    theta, trace = opt.run(theta0, max_iters=iters)
    assert got["iters"] == len(trace)
    np.testing.assert_allclose(got["f"], [float(s.f_new) for s in trace],
                               rtol=F_RTOL)
    r = report(np.asarray(test.y), np.asarray(sparse_predict(theta, test)))
    assert abs(got["report"]["auc"] - r["auc"]) <= AUC_TOL
    assert got["alive_rows"] == int(
        (np.abs(np.asarray(theta)).sum(1) > 0).sum())
