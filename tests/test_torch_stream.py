"""The port's streaming slice (``repro_torch.stream``, the ``--stream``
driver, stream checkpoints) against the JAX reference on the same numpy
inputs, and the reference's own streaming gates re-proved inside the port.

Bars (the repo's own, ``tests/test_shard_step.py:59-109``): over at most
6 OWLQN+ steps f rtol 2e-4, Theta rtol 2e-3 / atol 2e-5 and the zero
pattern EQUAL. Day batches, plans and checkpoint leaves are equal
exactly. Both packages get the same numpy Theta0. Everything runs on the
CPU (``device="cpu"``); the card's counterparts are in
``tests/test_torch_stream_card.py``.
"""
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.sparse as jsparse
import repro.launch.train as jtrain_driver
import repro.stream as jstream
from repro.obs.ledger import validate_file as reference_validate_file
from repro_torch import obs as tobs
from repro_torch.core.objective import nll_sparse, smooth_loss_and_grad
from repro_torch.data.sparse import build_batch_plans
from repro_torch.io import checkpoint as tckpt
from repro_torch.launch import train as ttrain
from repro_torch.optim.owlqn_plus import OWLQNPlus
from repro_torch.stream import (
    DayStream,
    PlannerStats,
    PreparedWindow,
    StreamTrainer,
    WindowPlanner,
    concat_batches,
    plan_window,
)

FIELDS = ("user_ids", "user_vals", "ad_ids", "ad_vals", "session_id", "y")
F_RTOL, TH_RTOL, TH_ATOL = 2e-4, 2e-3, 2e-5
SMALL = dict(sessions_per_day=16, num_features=1200, active_user=6,
             active_ad=4, seed=2)


def _theta0(d, m=2, seed=0):
    return (0.01 * np.random.default_rng(seed).normal(size=(d, 2 * m))
            ).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _batches_equal(port, ref):
    for f in FIELDS:
        want, got = np.asarray(getattr(ref, f)), _np(getattr(port, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert port.num_features == ref.num_features


def _trainers(days=3, history="reset", overlap=True, window=2, inner=2,
              lam=0.1, beta=0.1, **over):
    kw = {**SMALL, **over}
    j = jstream.StreamTrainer(jstream.DayStream(days, **kw), lam=lam,
                              beta=beta, window=window, inner_iters=inner,
                              history=history, overlap=overlap)
    t = StreamTrainer(DayStream(days, **kw), lam=lam, beta=beta,
                      window=window, inner_iters=inner, history=history,
                      overlap=overlap, device="cpu")
    return j, t


def _assert_at_bars(port_fs, ref_fs, port_theta, ref_theta):
    np.testing.assert_allclose(np.asarray(port_fs), np.asarray(ref_fs),
                               rtol=F_RTOL)
    th, want = _np(port_theta), np.asarray(ref_theta)
    np.testing.assert_allclose(th, want, rtol=TH_RTOL, atol=TH_ATOL)
    np.testing.assert_array_equal(th == 0, want == 0)


# ---------------------------------------------------------------- source
@pytest.mark.parametrize("binary_vals", [True, False])
def test_days_and_windows_equal_reference_bitwise(binary_vals):
    kw = dict(sessions_per_day=24, num_features=3000, active_user=8,
              active_ad=5, seed=7, drift=0.05, binary_vals=binary_vals)
    js, ts = jstream.DayStream(6, **kw), DayStream(6, **kw)
    for t in (0, 2, 5):
        _batches_equal(ts.day(t), js.day(t))
        assert ts.day(t).user_ids.device.type == "cpu"  # host arrays
    for t, w in ((0, 1), (1, 4), (3, 2), (5, 3)):
        _batches_equal(ts.window(t, w), js.window(t, w))
    assert ts.window(3, 2).user_plan is None


def test_cache_eviction_regenerates_identically():
    kw = dict(SMALL, cache_days=2)
    js, ts = jstream.DayStream(5, **kw), DayStream(5, **kw)
    first = ts.day(0)
    for t in range(1, 5):
        ts.day(t)
    assert len(ts._cache) == 2 and 0 not in ts._cache
    again = ts.day(0)
    assert again is not first
    _batches_equal(again, js.day(0))
    _batches_equal(first, js.day(0))


def test_concat_batches_rejects_mismatched_widths_like_reference():
    a = DayStream(1, **SMALL).day(0)
    b = DayStream(1, **dict(SMALL, active_ad=5)).day(0)
    ja = jstream.DayStream(1, **SMALL).day(0)
    jb = jstream.DayStream(1, **dict(SMALL, active_ad=5)).day(0)
    with pytest.raises(ValueError, match="disagree"):
        jstream.concat_batches([ja, jb])
    with pytest.raises(ValueError, match="disagree"):
        concat_batches([a, b])
    with pytest.raises(ValueError, match="at least one"):
        concat_batches([])
    # one batch: the same arrays, plans dropped
    planned = build_batch_plans(a)
    assert concat_batches([planned]).user_plan is None
    assert concat_batches([planned]).ad_ids is a.ad_ids


def test_stream_protocol_and_bounds():
    s = DayStream(3, **SMALL)
    assert len(s) == 3 and len(list(s)) == 3
    with pytest.raises(IndexError):
        s.day(3)
    with pytest.raises(ValueError, match=">= 1"):
        s.window(1, 0)
    with pytest.raises(ValueError, match="num_days"):
        DayStream(0)


# --------------------------------------------------------------- planner
def test_plan_window_equals_reference_plans():
    kw = dict(SMALL, num_features=1500, seed=3)
    raw = DayStream(4, **kw).window(2, 2)
    want = jsparse.build_batch_plans(jstream.DayStream(4, **kw).window(2, 2))
    got = plan_window(raw)
    for side in ("user_plan", "ad_plan"):
        g, w = getattr(got, side), getattr(want, side)
        for f in ("row_ids", "order", "rank", "inv_compact", "inv_sorted",
                  "sample_sorted", "slot_sorted"):
            np.testing.assert_array_equal(_np(getattr(g, f)),
                                          np.asarray(getattr(w, f)))
        assert g.class_width == tuple(w.class_width)
    # the sharded form routes like the reference's (ids and values bit
    # for bit); a mesh without a partition raises as the reference's does
    from repro.shard.partition import make_partition as jmake
    from repro_torch.shard.partition import make_partition as tmake

    jraw = jstream.DayStream(4, **kw).window(2, 2)
    routed = plan_window(raw, partition=tmake(1500, 3), data_shards=2)
    want = jstream.planner.plan_window(jraw, partition=jmake(1500, 3),
                                       data_shards=2)
    for f in ("user_ids", "user_vals", "ad_ids", "ad_vals", "session_id"):
        np.testing.assert_array_equal(_np(getattr(routed, f)),
                                      np.asarray(getattr(want, f)))
    with pytest.raises(ValueError, match="partition"):
        plan_window(raw, mesh=object())


def _build(day: int) -> PreparedWindow:
    time.sleep(0.05)  # measurable build
    return PreparedWindow(day=day, batch=("batch", day), step=None)


@pytest.mark.parametrize("overlap", [False, True])
def test_planner_returns_same_windows(overlap):
    planner = WindowPlanner(_build, overlap=overlap)
    with planner:
        got = []
        for t in range(3):
            win = planner.get(t)
            planner.prefetch(t + 1)
            got.append(win)
            time.sleep(0.08)  # "device work" the build can hide behind
    assert [w.day for w in got] == [0, 1, 2]
    assert [w.batch for w in got] == [("batch", t) for t in range(3)]
    assert all(w.build_seconds > 0 and w.compile_seconds == 0.0
               for w in got)
    st = planner.stats
    assert st.windows == 3 and st.build_seconds >= 3 * 0.05
    if overlap:
        assert [w.prefetched for w in got] == [False, True, True]
        assert st.prefetched_build_seconds > 0
        assert st.overlap_ratio > 0.5, st
    else:
        assert st.prefetched_build_seconds == 0.0
        assert st.overlap_ratio == 0.0


def test_planner_inline_get_close_and_zero_ratio():
    planner = WindowPlanner(_build, overlap=True)
    with planner:
        win = planner.get(5)  # never prefetched -> builds inline
    assert win.day == 5 and not win.prefetched
    assert planner.stats.wait_seconds >= win.build_seconds
    assert planner.stats.prefetched_build_seconds == 0.0
    pending = WindowPlanner(_build, overlap=True)
    pending.prefetch(0)
    pending.close()  # must not hang or raise
    assert pending.stats.windows == 0
    assert pending.stats.overlap_ratio == 0.0
    assert PlannerStats(3, 1.0, 1.0, 0.0, 0.0).overlap_ratio == 0.0


# ---------------------------------------- trajectories against the reference
@pytest.mark.parametrize("history", ["reset", "carry"])
@pytest.mark.parametrize("overlap", [False, True])
def test_stream_trajectory_matches_reference(history, overlap):
    """3 windows x 2 inner iterations (6 OWLQN+ steps) from the same
    Theta0: f, Theta and the zero pattern at the repo's bars."""
    j, t = _trainers(history=history, overlap=overlap)
    th0 = _theta0(SMALL["num_features"])
    js, jtrace = j.run(j.init(jnp.asarray(th0)))
    ts, ttrace = t.run(t.init(th0))
    assert ts.day == js.day == 3
    assert [w.days_in_window for w in ttrace] == [1, 2, 2]
    _assert_at_bars([w.fs for w in ttrace], [w.fs for w in jtrace],
                    t.theta(ts), j.theta(js))
    assert [w.nnz for w in ttrace] == [w.nnz for w in jtrace]
    assert int(ts.opt.step) == int(js.opt.step)


# ------------------------------------------------- the port's own gates
@pytest.mark.parametrize("overlap", [False, True])
def test_full_window_reset_equals_full_batch_bitwise(overlap):
    """window = the whole dataset under "reset" -> the full-batch OWLQN+
    trajectory, bit for bit (same f trace, same Theta)."""
    days, iters = 3, 4
    s = DayStream(days, **SMALL)
    theta0 = torch.from_numpy(_theta0(s.num_features))
    full = build_batch_plans(s.window(days - 1, days))
    opt = OWLQNPlus(lambda th: smooth_loss_and_grad(th, full), lam=0.1,
                    beta=0.1, loss=lambda th: nll_sparse(th, full))
    st = opt.init(theta0)
    fs_ref = []
    for _ in range(iters):
        st, stats = opt.step(st)
        fs_ref.append(stats.f_new)
    tr = StreamTrainer(s, lam=0.1, beta=0.1, window=days, inner_iters=iters,
                       history="reset", overlap=overlap, device="cpu")
    state = tr.init(theta0)._replace(day=days - 1)
    state, trace = tr.run(state, days=1)
    assert list(trace[0].fs) == fs_ref
    assert torch.equal(tr.theta(state), st.theta)
    assert state.day == days and trace[0].days_in_window == days


def test_exact_zero_sparsity_across_window_boundaries():
    days = 3
    s = DayStream(days, **dict(SMALL, num_features=4000))
    d = s.num_features
    tr = StreamTrainer(s, lam=0.3, beta=0.3, window=1, inner_iters=3,
                       device="cpu")
    state = tr.init(_theta0(d))
    checked = 0
    for t in range(days):
        prev = tr.theta(state).numpy().copy() if t else None
        state, _ = tr.run(state, days=1)
        th = tr.theta(state).numpy()
        wb = s.window(t, 1)
        touched = np.zeros(d, bool)
        for ids in (wb.user_ids.numpy(), wb.ad_ids.numpy()):
            touched[ids.reshape(-1)] = True
        if prev is not None:
            keep = ~prev.any(axis=1) & ~touched
            assert not th[keep].any(), int((th[keep] != 0).sum())
            checked += int(keep.sum())
    assert checked > 0, "no exact-zero untouched rows crossed a boundary"


def test_history_carry_counts_steps_across_windows():
    _, tr = _trainers(history="carry", window=2, inner=2)
    state, trace = tr.run(tr.init(_theta0(SMALL["num_features"])))
    assert state.day == 3 and len(trace) == 3
    assert int(state.opt.step) == 6
    assert all(np.isfinite(f) for w in trace for f in w.fs)


def test_streaming_beats_train_once_on_next_day_nll():
    """The drifted-stream gate at the reference test's sizes: the same
    total iteration budget, streamed warm starts vs everything on day 0."""
    d, m, days = 400, 4, 6
    s = DayStream(days + 1, sessions_per_day=192, num_features=d,
                  active_user=8, active_ad=5, drift=0.06, head_width=0.06,
                  head_frac=0.85, seed=11)
    theta0 = _theta0(d, m=m)
    held = s.day(days)

    def nll(trainer, state):
        return float(nll_sparse(trainer.theta(state), held)) / held.y.shape[0]

    base = StreamTrainer(s, lam=0.25, beta=0.25, window=1,
                         inner_iters=5 * days, device="cpu")
    sb, _ = base.run(base.init(theta0), days=1)
    stream = StreamTrainer(s, lam=0.25, beta=0.25, window=2, inner_iters=5,
                           device="cpu")
    ss, _ = stream.run(stream.init(theta0), days=days)
    assert nll(stream, ss) < nll(base, sb) - 0.02, (nll(stream, ss),
                                                    nll(base, sb))


@pytest.mark.parametrize("history", ["reset", "carry"])
def test_checkpoint_roundtrip_resumes_exactly(tmp_path, history):
    """save -> load -> continue == continue uninterrupted, and running
    twice from one state gives one result (the carry run copies the
    history it would otherwise update in place)."""
    _, tr = _trainers(days=4, history=history)
    theta0 = _theta0(SMALL["num_features"])
    mid, _ = tr.run(tr.init(theta0), days=2)
    path = tr.save(str(tmp_path / "stream"), mid)
    assert path.endswith(".npz")
    back = tr.load(path, theta0)
    assert back.day == 2 and type(back.day) is int
    assert type(back.opt.step) is int and back.opt.step == mid.opt.step
    assert torch.equal(back.opt.theta, mid.opt.theta)
    # the saved form of the restored state is the file, leaf for leaf
    again = tr.save(str(tmp_path / "again.npz"), back)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fin_a, tr_a = tr.run(mid, days=2)
    fin_b, tr_b = tr.run(back, days=2)
    fin_c, tr_c = tr.run(mid, days=2)  # mid was not changed by fin_a's run
    assert [w.fs for w in tr_a] == [w.fs for w in tr_b] == \
        [w.fs for w in tr_c]
    assert torch.equal(fin_a.opt.theta, fin_b.opt.theta)
    assert torch.equal(fin_a.opt.theta, fin_c.opt.theta)
    assert fin_a.day == fin_b.day == 4


def test_checkpoint_rejects_mismatched_shapes(tmp_path):
    s = DayStream(2, **SMALL)
    tr = StreamTrainer(s, lam=0.1, beta=0.1, inner_iters=1, device="cpu")
    state, _ = tr.run(tr.init(_theta0(s.num_features)), days=1)
    path = tr.save(str(tmp_path / "stream.npz"), state)
    with pytest.raises(ValueError, match="different configuration"):
        tr.load(path, _theta0(s.num_features // 2))
    other = StreamTrainer(s, lam=0.1, beta=0.1, memory=5, device="cpu")
    with pytest.raises(ValueError, match="different configuration"):
        other.load(path, _theta0(s.num_features))
    tckpt.save(str(tmp_path / "theta.npz"), {"theta": _theta0(8)})
    with pytest.raises(KeyError, match="not a stream state"):
        tr.load(str(tmp_path / "theta.npz"), _theta0(s.num_features))


def test_planner_stats_populated_and_days_bounds():
    s = DayStream(2, **SMALL)
    tr = StreamTrainer(s, lam=0.1, beta=0.1, inner_iters=1, device="cpu")
    state, trace = tr.run(tr.init(_theta0(s.num_features)))
    assert tr.planner_stats.windows == 2
    assert tr.planner_stats.build_seconds > 0
    assert all(w.build_seconds > 0 and w.step_seconds > 0 for w in trace)
    with pytest.raises(ValueError, match="days"):
        tr.run(state, days=1)
    same, empty = tr.run(state)
    assert empty == [] and same is state


def test_constructor_validation():
    s = DayStream(2, **SMALL)
    with pytest.raises(ValueError, match="history"):
        StreamTrainer(s, lam=0.1, beta=0.1, history="sometimes",
                      device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        StreamTrainer(s, lam=0.1, beta=0.1, window=0, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        StreamTrainer(s, lam=0.1, beta=0.1, inner_iters=0, device="cpu")
    # the sharded stream's checks, as the reference's
    from types import SimpleNamespace

    from repro_torch.shard.partition import make_partition

    for kw, why in (({"partition": make_partition(1200, 2)}, "without a mesh"),
                    ({"mesh": SimpleNamespace(data=1, model=2),
                      "partition": make_partition(1000, 2)}, "covers"),
                    ({"mesh": SimpleNamespace(data=3, model=1)}, "divide")):
        with pytest.raises(ValueError, match=why):
            StreamTrainer(s, lam=0.1, beta=0.1, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamTrainer(s, lam=0.1, beta=0.1)  # the card by default


# ------------------------------------------ checkpoints across packages
def test_reference_stream_checkpoint_resumes_in_port(tmp_path):
    """A reference ``StreamTrainer.save`` file (carry history) loads in
    the port with the same keys and leaves; one further window in each
    package agrees at the bars."""
    j, t = _trainers(days=3, history="carry")
    th0 = _theta0(SMALL["num_features"])
    jmid, _ = j.run(j.init(jnp.asarray(th0)), days=2)
    ref_path = str(tmp_path / "ref.npz")
    j.save(ref_path, jmid)
    back = t.load(ref_path, th0)
    assert back.day == 2 and int(back.opt.step) == int(jmid.opt.step)
    port_path = t.save(str(tmp_path / "port.npz"), back)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files) == \
            sorted(tckpt.STREAM_KEYS)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jfin, jtr = j.run(jmid, days=1)
    tfin, ttr = t.run(back, days=1)
    _assert_at_bars([w.fs for w in ttr], [w.fs for w in jtr],
                    t.theta(tfin), j.theta(jfin))


def test_port_stream_checkpoint_resumes_in_reference(tmp_path):
    j, t = _trainers(days=3, history="carry")
    th0 = _theta0(SMALL["num_features"])
    tmid, _ = t.run(t.init(th0), days=2)
    path = t.save(str(tmp_path / "port.npz"), tmid)
    jback = j.load(path, jnp.asarray(th0))
    assert jback.day == 2
    np.testing.assert_array_equal(np.asarray(jback.opt.theta),
                                  tmid.opt.theta.numpy())
    jfin, jtr = j.run(jback, days=1)
    tfin, ttr = t.run(tmid, days=1)
    _assert_at_bars([w.fs for w in ttr], [w.fs for w in jtr],
                    t.theta(tfin), j.theta(jfin))


# ---------------------------------------------------------------- driver
DEMO = ["--stream", "--days", "3", "--window", "2", "--inner-iters", "5",
        "--sessions", "192", "--sparse-features", "400", "--regions", "4",
        "--lam", "0.25", "--beta", "0.25", "--drift", "0.06"]


def _contains(outer: dict, inner: dict) -> bool:
    return (outer["tid"] == inner["tid"]
            and outer["ts"] <= inner["ts"] + 1e-9
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
            + 1e-9)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """The port's ``--stream`` driver at the demo size with every output
    flag, then ``--resume`` from its checkpoint; and the reference's
    driver on the same flags (its ledger)."""
    tmp = tmp_path_factory.mktemp("stream_driver")
    paths = {k: str(tmp / name) for k, name in (
        ("ledger", "run.jsonl"), ("trace", "trace.json"),
        ("report", "report.md"), ("drift_ref", "dref.npz"),
        ("ckpt", "stream.npz"), ("ref_ledger", "ref.jsonl"))}
    rep = ttrain.run(DEMO + [
        "--device", "cpu", "--ledger-out", paths["ledger"],
        "--trace-out", paths["trace"], "--report-out", paths["report"],
        "--drift-ref", paths["drift_ref"], "--ckpt", paths["ckpt"]])
    resumed = ttrain.run(DEMO + ["--device", "cpu", "--days", "4",
                                 "--ckpt", paths["ckpt"], "--resume"])
    straight = ttrain.run(DEMO + ["--device", "cpu", "--days", "4"])
    argv = sys.argv
    sys.argv = ["repro.launch.train"] + DEMO + [
        "--ledger-out", paths["ref_ledger"]]
    try:
        assert jtrain_driver.main() == 0
    finally:
        sys.argv = argv
    return paths, rep, resumed, straight


def test_stream_driver_ledger_validates_in_both_packages(driver_runs):
    paths, rep, _, _ = driver_runs
    assert reference_validate_file(paths["ledger"]) == []
    assert tobs.validate_file(paths["ledger"]) == []
    recs = tobs.read_jsonl(paths["ledger"])
    assert recs[0]["kind"] == "run_meta" and recs[0]["mode"] == "stream"
    kinds = [r["kind"] for r in recs]
    assert kinds.count("stream_window") == 3
    assert kinds.count("train_iter") == 15
    assert kinds.count("stream_eval") == 2
    summary = [r for r in recs if r["kind"] == "stream_summary"][-1]
    assert summary["windows"] == 3
    assert summary["overlap_ratio"] == rep["overlap_ratio"]
    wins = [r for r in recs if r["kind"] == "stream_window"]
    pre_b = sum(w["build_s"] for w in wins if w["prefetched"])
    pre_w = sum(min(w["wait_s"], w["build_s"]) for w in wins
                if w["prefetched"])
    assert pre_b == pytest.approx(summary["prefetched_build_seconds"])
    assert pre_w == pytest.approx(summary["prefetched_wait_seconds"])
    # the per-day console line is the record's rendering
    texts = [r["text"] for r in recs if r["kind"] == "stream_eval"]
    for w, text in zip(wins, texts):
        assert text.startswith(tobs.render_stream_day(w))


def test_stream_driver_matches_reference_driver(driver_runs):
    """Per-day f and next-day NLL/AUC against the reference driver on the
    same flags, at the bars."""
    paths, rep, _, _ = driver_runs
    ref = tobs.read_jsonl(paths["ref_ledger"])
    port = tobs.read_jsonl(paths["ledger"])
    for kind, field in (("stream_window", "fs"),
                        ("stream_eval", "next_day_nll"),
                        ("stream_eval", "next_day_auc")):
        want = [r[field] for r in ref if r["kind"] == kind]
        got = [r[field] for r in port if r["kind"] == kind]
        assert len(got) == len(want) > 0, (kind, field)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=F_RTOL, err_msg=field)
    assert [r["nnz"] for r in port if r["kind"] == "stream_window"] == \
        [r["nnz"] for r in ref if r["kind"] == "stream_window"]
    assert [w["next_day_nll"] for w in rep["windows"][:2]] == \
        [r["next_day_nll"] for r in port if r["kind"] == "stream_eval"]


def test_stream_driver_spans_nest(driver_runs):
    paths, _, _, _ = driver_runs
    with open(paths["trace"]) as f:
        doc = json.load(f)
    by_name: dict = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["stream/step"]) == 3
    assert len(by_name["train/iter"]) == 15
    assert len(by_name["stream/plan_window"]) == 3
    for it in by_name["train/iter"]:
        assert sum(_contains(st, it) for st in by_name["stream/step"]) == 1
    for sp in by_name["stream/plan"]:
        assert any(_contains(pw, sp) for pw in by_name["stream/plan_window"])
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert any(n.startswith("replanner") for n in threads), threads


def test_stream_driver_outputs_and_resume(driver_runs):
    paths, rep, resumed, straight = driver_runs
    with open(paths["report"]) as f:
        text = f.read()
    assert "## Next-day decay" in text and "## Streaming windows" in text
    ref = tobs.load_drift_reference(paths["drift_ref"])
    assert ref.num_features == 400 and ref.score_counts.sum() == 768
    assert rep["final_day"] == 3 and rep["ckpt"] == paths["ckpt"]
    # --resume continues from the saved cursor: only day 3 is new, and it
    # is bit for bit the day 3 of an uninterrupted 4-day run
    assert resumed["resumed_at"] == 3 and resumed["final_day"] == 4
    assert [w["day"] for w in resumed["windows"]] == [3]
    assert resumed["windows"][0]["fs"] == straight["windows"][3]["fs"]
    assert torch.equal(resumed["theta"], straight["theta"])
    assert tckpt.load_nested(paths["ckpt"])["day"] == 4


def test_stream_driver_refusals(tmp_path):
    with pytest.raises(SystemExit, match="sparse or --stream"):
        ttrain.run(["--drift-ref", str(tmp_path / "x"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="held-out"):
        ttrain.run(["--stream", "--days", "1", "--sessions", "16",
                    "--sparse-features", "400", "--inner-iters", "1",
                    "--drift-ref", str(tmp_path / "d"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.run(DEMO)  # the card by default


def test_sparse_driver_captures_a_drift_reference(tmp_path):
    dref = str(tmp_path / "sparse_ref.npz")
    rep = ttrain.run(["--sparse", "--sparse-features", "3000", "--sessions",
                      "64", "--regions", "2", "--lam", "0.05", "--beta",
                      "0.05", "--iters", "2", "--device", "cpu",
                      "--drift-ref", dref])
    assert rep["drift_ref"] == dref and os.path.exists(dref)
    ref = tobs.load_drift_reference(dref)
    assert ref.num_features == 3000
    assert ref.score_counts.sum() == 4 * max(64 // 5, 32)
