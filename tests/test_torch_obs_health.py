"""The port's health monitoring, drift references and run reports
(``repro_torch.obs.{drift,monitor,report}``, the ledger's stream and
``alert`` kinds and observers, ``serve --monitor --drift-ref``) against
the JAX reference's ``repro.obs`` on the same numpy inputs.

Bars: integer counts, alert sequences and rendered text are EQUAL; float
reference arrays and divergences agree to 1e-12 (both packages run the
same numpy arithmetic in float64).
"""
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.obs.report as jreport
import repro.serve as jserve
from repro.serve.engine import BundleRequest as JBundleRequest
from repro_torch import obs as tobs
from repro_torch.launch import serve as tserve
from repro_torch.obs import report as treport
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.compress import compress, load_artifact, save_artifact
from repro_torch.serve.engine import BundleRequest, ScoringEngine
from repro_torch.stream import DayStream

FLOAT_TOL = 1e-12
REF_FIELDS = ("score_edges", "score_counts", "bucket_p", "bucket_y",
              "top_ids", "top_counts")


def _eval_pass(seed=0, n=4000, d=1000, hot=0.8):
    """A held-out pass with a hot-headed id distribution (the reference
    test's generator)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.02, 0.9, n)
    y = (rng.uniform(size=n) < p).astype(np.float64)
    ids = np.minimum(rng.geometric(1 - hot, size=(n, 8)) - 1, d - 1)
    return p, y, ids


def _refs_equal(port, ref):
    for f in REF_FIELDS:
        a, b = np.asarray(getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL,
                                       err_msg=f)
    assert port.num_features == ref.num_features
    assert port.ratio == pytest.approx(ref.ratio, abs=FLOAT_TOL)


# ------------------------------------------------------------ drift
@pytest.mark.parametrize("bins,top_m,d", [(20, 128, 1000), (10, 32, 1000),
                                          (7, 4096, 300)])
def test_capture_reference_equals_reference(bins, top_m, d):
    p, y, ids = _eval_pass(n=3000, d=d)
    ids = ids.copy()
    ids[::7, -1] = d  # pad ids are dropped on both sides
    kw = dict(num_features=d, bins=bins, top_m=top_m)
    _refs_equal(tobs.capture_reference(p, y, ids, **kw),
                jobs.capture_reference(p, y, ids, **kw))


def test_psi_and_kl_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = rng.integers(0, 50, 24)
        b = rng.integers(0, 50, 24)
        b[rng.integers(0, 24, 3)] = 0  # empty buckets stay finite
        assert tobs.psi(a, b) == pytest.approx(jobs.psi(a, b),
                                               abs=FLOAT_TOL)
        assert tobs.kl(a, b) == pytest.approx(jobs.kl(a, b), abs=FLOAT_TOL)
    assert tobs.psi(a, a) == 0.0
    with pytest.raises(ValueError, match="empty histogram"):
        tobs.psi(np.zeros(4), a[:4])


def test_drift_reference_files_load_across_packages(tmp_path):
    p, y, ids = _eval_pass(n=600, d=300)
    tref = tobs.capture_reference(p, y, ids, num_features=300)
    jref = jobs.capture_reference(p, y, ids, num_features=300)
    t_path = tobs.save_drift_reference(str(tmp_path / "port"), tref)
    j_path = jobs.save_drift_reference(str(tmp_path / "ref"), jref)
    assert t_path.endswith(".npz") and j_path.endswith(".npz")
    with np.load(t_path) as a, np.load(j_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    _refs_equal(tobs.load_drift_reference(j_path), jref)
    _refs_equal(jobs.load_drift_reference(t_path), jref)
    plain = str(tmp_path / "plain.npz")
    np.savez(plain, theta=np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="no drift reference"):
        tobs.load_drift_reference(plain)


def test_artifacts_with_drift_reference_load_across_packages(tmp_path):
    p, y, ids = _eval_pass(n=600, d=300)
    ref = tobs.capture_reference(p, y, ids, num_features=300)
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(300, 4)).astype(np.float32)
    theta[100:] = 0.0
    art = compress(torch.from_numpy(theta))  # on the tensor's device
    plain = save_artifact(str(tmp_path / "plain"), art)
    emb = save_artifact(str(tmp_path / "emb"), art, drift_ref=ref)
    _refs_equal(tobs.load_drift_reference(emb), ref)
    _refs_equal(jobs.load_drift_reference(emb), ref)
    a0, a1 = load_artifact(plain, "cpu"), load_artifact(emb, "cpu")
    assert torch.equal(a0.theta, a1.theta) and torch.equal(a0.remap, a1.remap)
    # the reference's embedded artifact serves and arms in the port
    jart = jserve.compress(theta)
    j_emb = jserve.save_artifact(str(tmp_path / "j_emb"), jart,
                                 drift_ref=jobs.capture_reference(
                                     p, y, ids, num_features=300))
    served = load_artifact(j_emb, "cpu")
    np.testing.assert_array_equal(served.theta.numpy(), np.asarray(jart.theta))
    _refs_equal(tobs.load_drift_reference(j_emb), ref)
    jback = jserve.load_artifact(emb)
    np.testing.assert_array_equal(np.asarray(jback.theta), a1.theta.numpy())


# ---------------------------------------------------------- monitor
RULES = ("lat: serve.p99_wall_us <= 1500 for 2/2",
         "serve.occupancy >= 0.5 for 3/3",
         "eval.next_day_nll <= 0.6 for 2/2",
         "calib.ratio <= 1.1 for 2/2",
         "calib.ratio >= 0.9 for 2/2",
         "drift.score_psi <= 0.25 for 2/2",
         "drift.id_psi <= 0.25 for 2/2")


def _drive(pkg, requests_cls):
    """One scripted run of records, dispatch feeds and labelled
    predictions through ``pkg``'s monitor; returns its alert records
    (without timestamps) and its final signals."""
    led = pkg.RunLedger(None)
    mon = pkg.HealthMonitor([pkg.parse_rule(r) for r in RULES],
                            window=16, eval_every=4,
                            registry=MetricsRegistry()).attach(led)
    p, y, ids = _eval_pass(n=2000, d=500)
    mon.arm_drift(pkg.capture_reference(p, y, ids, num_features=500),
                  min_count=64)
    rng = np.random.default_rng(9)
    for k in range(96):
        shift = 0.0 if k < 40 else 0.35  # the traffic cools after k = 40
        n = 12
        scores = [np.clip(rng.uniform(0.02, 0.9, n) + shift, 0, 1)
                  for _ in range(3)]
        reqs = [requests_cls(
            user_ids=np.minimum(rng.geometric(0.2 if k < 40 else 0.01,
                                              size=16) - 1, 499),
            user_vals=np.ones(16, np.float32),
            ad_ids=rng.integers(0, 500, (n, 8)),
            ad_vals=np.ones((n, 8), np.float32)) for _ in range(3)]
        led.emit("serve_dispatch", envelope=[4, 16, 8, n], g=4,
                 requests=3, candidates=3 * n, occupancy=0.75 - k / 200,
                 wall_s=(0.001 if k % 30 < 20 else 0.004),
                 flush_reason="full", queue_delay_us=50.0)
        mon.observe_dispatch(scores, reqs)
        if k % 8 == 7:
            pp = rng.uniform(0.02, 0.9, 200)
            yy = (rng.uniform(size=200) < pp * (1.0 if k < 48 else 0.6))
            mon.observe_predictions(pp, yy.astype(np.float64))
            led.emit("stream_eval", day=k // 8, next_day_nll=0.5 + k / 150,
                     next_day_auc=0.7)
    mon.evaluate()
    alerts = [{k: v for k, v in a.items() if k != "t"} for a in mon.alerts()]
    return alerts, led.events("alert"), mon.signals(), mon.summary()


def test_monitor_alert_sequence_equals_reference():
    t_alerts, t_led, t_sig, t_sum = _drive(tobs, BundleRequest)
    j_alerts, j_led, j_sig, j_sum = _drive(jobs, JBundleRequest)
    assert t_alerts == j_alerts
    assert len(t_alerts) >= 4
    assert {a["state"] for a in t_alerts} == {"firing", "cleared"}
    assert [{k: v for k, v in a.items() if k != "t"} for a in t_led] == \
        [{k: v for k, v in a.items() if k != "t"} for a in j_led]
    assert set(t_sig) == set(j_sig)
    for k, v in j_sig.items():
        if v is None:
            assert t_sig[k] is None, k
        else:
            assert t_sig[k] == pytest.approx(v, abs=FLOAT_TOL), k
    assert t_sum["active"] == j_sum["active"]
    for a in t_led:
        assert tobs.validate_event(a) is None


def test_monitor_views_rules_and_null_default():
    w = tobs.RollingWindow(maxlen=4)
    assert w.percentile(99) is None and w.mean() is None
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        w.push(v)
    assert len(w) == 4 and w.last() == 5.0 and w.percentile(0) == 2.0
    for text in ("serve.p99_wall_us <= 250000",
                 "lat: serve.p99_wall_us <= 2.5e5 for 5/2",
                 "calib.ratio >= 0.75"):
        assert tuple(tobs.parse_rule(text)) == tuple(jobs.parse_rule(text))
    for bad in ("nonsense", "sig < 5", "sig <= ", "sig <= 1 for 0/3"):
        with pytest.raises(ValueError):
            tobs.parse_rule(bad)
    assert [tuple(r) for r in tobs.default_rules()] == \
        [tuple(r) for r in jobs.default_rules()]
    assert tobs.get_monitor() is tobs.NULL_MONITOR
    assert not tobs.NULL_MONITOR.enabled
    assert tobs.NULL_MONITOR.observe_dispatch([], []) is None
    assert tobs.NULL_MONITOR.summary() == {"signals": {}, "active": [],
                                           "alerts": 0}


def test_ledger_observers_and_monitor_reentrancy():
    led = tobs.RunLedger(None)
    seen = []
    led.add_observer(seen.append)
    led.add_observer(seen.append)  # subscribed once
    mon = tobs.HealthMonitor(
        [tobs.parse_rule("serve.p99_wall_us <= 1 for 1/1")], eval_every=1,
        registry=MetricsRegistry()).attach(led)
    led.emit("serve_dispatch", envelope=[1, 8, 8, 4], g=1, requests=1,
             candidates=4, occupancy=1.0, wall_s=0.01,
             flush_reason="direct", queue_delay_us=0.0)
    # the monitor's alert went back into the ledger without recursing
    assert [e["kind"] for e in led.events()] == ["serve_dispatch", "alert"]
    assert [e["kind"] for e in seen] == ["serve_dispatch", "alert"]
    mon.detach()
    led.remove_observer(seen.append)
    led.emit("stream_eval", day=0, next_day_nll=0.5)
    assert len(seen) == 2 and len(mon.alerts()) == 1
    assert tobs.NULL_LEDGER.add_observer(seen.append) is None


def test_configure_monitor_and_report_install_and_restore(tmp_path):
    out = str(tmp_path / "run.html")
    session = tobs.configure(monitor=True, report_out=out,
                             meta={"driver": "t"})
    try:
        assert tobs.get_monitor() is session.monitor
        assert session.monitor.enabled and tobs.get_ledger().enabled
        tobs.get_ledger().emit("stream_eval", day=0, next_day_nll=0.5)
    finally:
        session.close()
    assert tobs.get_monitor() is tobs.NULL_MONITOR
    assert tobs.get_ledger() is tobs.NULL_LEDGER
    with open(out) as f:
        assert f.read().startswith("<!doctype html>")


# ----------------------------------------------------------- report
def _ledger(path):
    led = tobs.RunLedger(path)
    led.emit("run_meta", driver="repro_torch.launch.train", mode="stream",
             backend="cpu", device_count=1, argv=["--stream"],
             device_name="cpu")
    for k, (f, nnz) in enumerate([(100.0, 50), (90.0, 40), (85.5, 38)]):
        led.emit("train_iter", step=k, f=f + 1, f_new=f, alpha=0.5,
                 grad_norm=0.1, nnz=nnz, ls_iters=1, test_auc=0.7 + k / 100,
                 wall_s=0.01 * (k + 1))
    led.emit("stream_window", day=0, days_in_window=1, plan_s=0.01,
             compile_s=0.0, build_s=0.02, wait_s=0.0, prefetched=False,
             step_s=0.2, carry="reset", alpha=0.5, nnz=38, fs=[2.0, 1.5])
    led.emit("stream_eval", day=0, next_day_nll=0.512345,
             next_day_auc=0.698765, text="day   0 ...")
    led.emit("stream_summary", windows=2, build_seconds=0.1,
             wait_seconds=0.02, prefetched_build_seconds=0.05,
             prefetched_wait_seconds=0.01, overlap_ratio=0.8)
    for reason, wall in (("full", 0.002), ("deadline", 0.001),
                         ("full", 0.003)):
        led.emit("serve_dispatch", envelope=[4, 8, 8, 2], g=4, requests=4,
                 candidates=8, occupancy=1.0, wall_s=wall,
                 flush_reason=reason, queue_delay_us=100.0)
    led.emit("alert", rule="lat", state="firing",
             signal="serve.p99_wall_us", value=3000.0, threshold=2500.0,
             op="<=", breach_n=3, clear_n=3)
    led.close()
    return path


def test_reports_byte_identical_across_packages(tmp_path):
    path = _ledger(str(tmp_path / "run.jsonl"))
    events = tobs.read_jsonl(path)
    assert jobs.validate_file(path) == [] and tobs.validate_file(path) == []
    t_rep, j_rep = treport.build_report(events), jreport.build_report(events)
    assert t_rep == j_rep
    assert treport.render_md(t_rep) == jreport.render_md(j_rep)
    assert treport.render_html(t_rep) == jreport.render_html(j_rep)
    for fmt in ("md", "html"):
        t_out, j_out = str(tmp_path / f"t.{fmt}"), str(tmp_path / f"j.{fmt}")
        assert treport.main([path, "--format", fmt, "--out", t_out]) == 0
        assert jreport.main([path, "--format", fmt, "--out", j_out]) == 0
        with open(t_out, "rb") as a, open(j_out, "rb") as b:
            assert a.read() == b.read()


def test_report_cli_rejects_bad_ledgers(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "nope", "t": 1.0}\n')
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert treport.main([str(tmp_path / "missing.jsonl")]) == 1
    assert treport.main([str(bad)]) == 1
    assert treport.main([str(empty)]) == 1
    assert "FAIL" in capsys.readouterr().err


def test_render_stream_day_equals_reference():
    recs = [dict(day=d, days_in_window=w, fs=[f * 2, f], alpha=a, nnz=n,
                 build_s=b, step_s=s)
            for d, w, f, a, n, b, s in ((0, 1, 498.2571, 1.0, 320, 0.0031,
                                         0.018),
                                        (12, 2, 12345.678, 0.0694, 1234567,
                                         1.5, 12.25),
                                        (3, 3, -1.5, 0.5, 0, 0.0, 0.0))]
    for rec in recs:
        assert tobs.render_stream_day(rec) == jobs.render_stream_day(rec)


# ---------------------------------------------- serving with the monitor
def _day_requests(batch, ads_per=4):
    ui, uv = batch.user_ids.numpy(), batch.user_vals.numpy()
    ai, av = batch.ad_ids.numpy(), batch.ad_vals.numpy()
    per = ai.shape[0] // ui.shape[0]
    return [BundleRequest(user_ids=ui[s], user_vals=uv[s],
                          ad_ids=ai[s * per:s * per + ads_per],
                          ad_vals=av[s * per:s * per + ads_per])
            for s in range(ui.shape[0])]


@pytest.mark.parametrize("drift,expect_alert", [(0.5, True), (0.0, False)])
def test_id_psi_detector_on_daystream_replay(drift, expect_alert):
    """The reference's planted-drift check on the port's engine: day 0 is
    identical across drift values, so one day-0 reference serves both
    replays; the drifted stream's later days fire the id-PSI rule and
    the stationary stream does not."""
    d, sessions = 2000, 64
    stream = DayStream(6, sessions_per_day=sessions, num_features=d,
                       drift=drift, seed=3)
    day0 = stream.day(0)
    ids0 = np.concatenate([day0.user_ids.numpy().ravel(),
                           day0.ad_ids.numpy().ravel()])
    scores0 = np.random.default_rng(5).uniform(0.05, 0.95, 4000)
    labels0 = np.random.default_rng(6).uniform(size=4000) < scores0
    ref = tobs.capture_reference(scores0, labels0.astype(float), ids0,
                                 num_features=d)
    led = tobs.RunLedger(None)
    mon = tobs.HealthMonitor(
        [tobs.parse_rule("drift.id_psi <= 0.25 for 2/2")],
        eval_every=32, registry=MetricsRegistry()).attach(led)
    mon.arm_drift(ref, id_window=1 << 16, min_count=1024)
    theta = (0.05 * np.random.default_rng(4).normal(size=(d, 4))
             ).astype(np.float32)
    engine = ScoringEngine(compress(torch.from_numpy(theta)), device="cpu")
    prev, prev_led = tobs.set_monitor(mon), tobs.set_ledger(led)
    try:
        for day in (4, 5):
            for req in _day_requests(stream.day(day)):
                engine.score(req)
        mon.evaluate()
    finally:
        tobs.set_monitor(prev)
        tobs.set_ledger(prev_led)
    fired = [a for a in mon.alerts() if a["state"] == "firing"]
    if expect_alert:
        assert fired and fired[0]["rule"] == "drift.id_psi", mon.signals()
        assert led.events("alert")
    else:
        assert not fired, fired
        assert mon.signals()["drift.id_psi"] is not None


def test_unmonitored_engine_feeds_nothing():
    theta = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    engine = ScoringEngine(compress(torch.from_numpy(theta)), device="cpu")
    mon = tobs.HealthMonitor([], registry=MetricsRegistry())
    mon.arm_drift(tobs.capture_reference(*_eval_pass(n=500, d=300),
                                         num_features=300), min_count=1)
    reqs = [BundleRequest(user_ids=np.arange(8), user_vals=np.ones(8),
                          ad_ids=np.arange(16).reshape(4, 4) + 20,
                          ad_vals=np.ones((4, 4)))] * 4
    engine.score_batch(reqs)  # the null monitor is the default
    assert mon.signals()["drift.score_psi"] is None
    prev = tobs.set_monitor(mon)
    try:
        for r in reqs:
            engine.score(r)
    finally:
        tobs.set_monitor(prev)
    sig = mon.signals()
    assert sig["drift.score_psi"] is not None
    assert sig["drift.id_psi"] is not None


def test_serve_driver_monitor_and_drift_ref(tmp_path):
    d = 2000
    p, y, ids = _eval_pass(n=800, d=d)
    dref = tobs.save_drift_reference(
        str(tmp_path / "dref"), tobs.capture_reference(p, y, ids,
                                                       num_features=d))
    ledger = str(tmp_path / "serve.jsonl")
    rep = tserve.run(["--sparse-features", str(d), "--sessions", "64",
                      "--train-iters", "2", "--requests", "64", "--int8",
                      "--monitor", "--drift-ref", dref, "--ledger-out",
                      ledger, "--device", "cpu"])
    sig = rep["monitor"]["signals"]
    for k in ("drift.score_psi", "drift.score_kl", "drift.id_psi"):
        assert np.isfinite(sig[k]), k
    assert "serve.p99_wall_us" in sig
    assert tobs.get_monitor() is tobs.NULL_MONITOR  # restored on close
    assert jobs.validate_file(ledger) == []
    kinds = {e["kind"] for e in tobs.read_jsonl(ledger)}
    assert "serve_dispatch" in kinds
    with pytest.raises(SystemExit, match="--monitor"):
        tserve.run(["--drift-ref", dref, "--device", "cpu"])
