"""Online model-health monitoring: rolling SLO signals, declarative
rules with hysteresis, typed ``alert`` ledger records.

The port's copy of ``repro/obs/monitor.py`` (numpy only). The
:class:`HealthMonitor` is the ACTIVE layer over the passive drift
primitives (``obs.drift``). It consumes the run ledger's ``serve_dispatch`` /
``stream_eval`` records (attached as a ledger observer, so every
instrumented subsystem feeds it for free) plus the drift trackers'
score/id/label streams (fed directly by the scoring engine and the
stream trainer's eval callback), folds them into rolling windows, and
evaluates declarative SLO rules::

    serve.p99_wall_us <= 250000 for 3/3
    calib.ratio >= 0.75
    drift.id_psi <= 0.25 for 2/2

A rule states a REQUIREMENT; it breaches when the requirement is
violated. HYSTERESIS keeps alerts from flapping: a rule must breach on
``breach_n`` CONSECUTIVE evaluations to fire and hold on ``clear_n``
consecutive OK evaluations to clear — one noisy window never pages, and
one lucky window never silences a real regression. State changes emit
typed ``alert`` ledger records (validated like every other kind) and
feed the ``obs_alerts``/``obs_alert_active`` registry series, so both
the post-hoc report (``repro_torch.obs.report``) and a live ``--metrics-out``
snapshot carry the alert history.

Signals a rule can reference (``signals()``; a signal that is not warm
yet reads ``None`` and its rules are SKIPPED, never breached):

  * ``serve.p50_wall_us`` / ``serve.p99_wall_us`` — dispatch wall
  * ``serve.p99_queue_delay_us``                  — micro-batch delay
  * ``serve.occupancy``                           — real/padded slots
  * ``queue.pending`` / ``queue.rejected``        — registry view
  * ``eval.next_day_nll`` / ``eval.next_day_auc`` — stream eval
  * ``calib.ratio`` / ``calib.bucket_dev``        — calibration tracker
  * ``drift.score_psi`` / ``drift.score_kl`` /
    ``drift.id_psi``                              — drift trackers

Disabled fast path: the process default is :data:`NULL_MONITOR`
(``enabled = False``); the engine's per-dispatch feed is guarded behind
one attribute load, and evaluation batches behind ``eval_every`` so the
monitored dispatch pays little over the unmonitored one.
"""
from __future__ import annotations

import re
import threading
from collections import deque
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.drift import (
    CalibrationTracker,
    DriftReference,
    IdTrafficTracker,
    ScoreDriftTracker,
)
from repro_torch.obs.ledger import NULL_LEDGER


_MAX_PENDING = 512  # drift-buffer backstop when nothing ever evaluates


def _subsample(arr: np.ndarray, cap: int) -> np.ndarray:
    """Deterministic stride subsample down to at most ``cap`` elements
    (0 = no cap). No RNG: a replayed request stream feeds the trackers
    identically every run."""
    arr = arr.ravel()
    if not cap or arr.size <= cap:
        return arr
    return arr[:: -(-arr.size // cap)]


class RollingWindow:
    """Bounded deque of floats with percentile/mean views (None while
    empty — "no data" must never read as "0 and breaching")."""

    def __init__(self, maxlen: int = 256):
        self._vals: deque[float] = deque(maxlen=maxlen)

    def push(self, value: float) -> None:
        self._vals.append(float(value))

    def __len__(self) -> int:
        return len(self._vals)

    def percentile(self, q: float) -> float | None:
        if not self._vals:
            return None
        return float(np.percentile(np.fromiter(self._vals, np.float64), q))

    def mean(self) -> float | None:
        if not self._vals:
            return None
        return float(np.fromiter(self._vals, np.float64).mean())

    def last(self) -> float | None:
        return self._vals[-1] if self._vals else None


class SLORule(NamedTuple):
    """One declarative health requirement (see module docstring)."""

    name: str
    signal: str
    op: str  # "<=" (stay below) or ">=" (stay above)
    threshold: float
    breach_n: int = 3  # consecutive breaching evals to FIRE
    clear_n: int = 3  # consecutive OK evals to CLEAR

    def ok(self, value: float) -> bool:
        if self.op == "<=":
            return value <= self.threshold
        return value >= self.threshold


_RULE_RE = re.compile(
    r"^\s*(?:(?P<name>[\w.-]+)\s*:)?\s*(?P<signal>[\w.]+)\s*"
    r"(?P<op><=|>=)\s*(?P<thr>[-+eE\d.]+)"
    r"(?:\s+for\s+(?P<breach>\d+)/(?P<clear>\d+))?\s*$")


def parse_rule(text: str) -> SLORule:
    """``"[name:] signal <=|>= threshold [for B/C]"`` -> :class:`SLORule`
    (name defaults to the signal; B/C default to 3/3)."""
    m = _RULE_RE.match(text)
    if m is None:
        raise ValueError(
            f"bad SLO rule {text!r}; expected "
            f"'[name:] signal <=|>= threshold [for B/C]'")
    breach = int(m["breach"]) if m["breach"] else 3
    clear = int(m["clear"]) if m["clear"] else 3
    if breach < 1 or clear < 1:
        raise ValueError(f"rule {text!r}: B/C must be >= 1")
    return SLORule(name=m["name"] or m["signal"], signal=m["signal"],
                   op=m["op"], threshold=float(m["thr"]),
                   breach_n=breach, clear_n=clear)


def default_rules() -> list[SLORule]:
    """The drivers' ``--monitor`` rule set: serving SLOs loose enough
    for shared CI runners, calibration band and the conventional 0.25
    PSI drift thresholds."""
    return [parse_rule(r) for r in (
        "serve.p99_wall_us <= 250000 for 3/3",
        "serve.p99_queue_delay_us <= 100000 for 3/3",
        "serve.occupancy >= 0.05 for 3/3",
        "calib.ratio <= 1.3 for 3/3",
        "calib.ratio >= 0.75 for 3/3",
        "drift.score_psi <= 0.25 for 2/2",
        "drift.id_psi <= 0.25 for 2/2",
    )]


class _RuleState:
    __slots__ = ("breaches", "oks", "active")

    def __init__(self):
        self.breaches = 0
        self.oks = 0
        self.active = False


class HealthMonitor:
    """Rolling-window SLO evaluation with hysteresis (module docstring).

    Thread-safe and reentrancy-safe: ingestion takes an RLock, and the
    alert records ``evaluate`` emits are ignored on re-entry, so a
    monitor attached to the very ledger it alerts into cannot recurse.
    """

    enabled = True

    def __init__(self, rules: Sequence[SLORule] | None = None, *,
                 window: int = 256, eval_every: int = 32,
                 registry=None, ledger=None):
        self.rules = list(rules) if rules is not None else default_rules()
        self._eval_every = max(1, int(eval_every))
        self._reg = registry if registry is not None \
            else obs_metrics.get_registry()
        self._ledger = ledger if ledger is not None else NULL_LEDGER
        self._lock = threading.RLock()
        # one deque of (wall_us, queue_delay_us, occupancy) triples —
        # ingest is on the dispatch hot path, so it pays ONE append;
        # the percentile/mean views unpack lazily at evaluation time
        self._disp: deque[tuple] = deque(maxlen=window)
        self._eval: dict[str, float] = {}
        self._score_tracker: ScoreDriftTracker | None = None
        self._id_tracker: IdTrafficTracker | None = None
        self._calib_tracker: CalibrationTracker | None = None
        self._sample_cap = 256
        self._pending_scores: list[np.ndarray] = []
        self._pending_ids: list[np.ndarray] = []
        self._piece_start = 0
        self._states = {r.name: _RuleState() for r in self.rules}
        self._alerts: list[dict] = []
        self._since_eval = 0
        self._attached_to = None
        self._active_gauges: dict[str, obs_metrics.Gauge] = {}

    # ------------------------------------------------------------- wiring
    def attach(self, ledger) -> "HealthMonitor":
        """Subscribe to a ledger's record stream AND alert into it."""
        ledger.add_observer(self.ingest)
        self._attached_to = ledger
        self._ledger = ledger
        return self

    def detach(self) -> None:
        if self._attached_to is not None:
            self._attached_to.remove_observer(self.ingest)
            self._attached_to = None

    def arm_drift(self, ref: DriftReference, *, score_window: int = 4096,
                  id_window: int = 65536, calib_window: int = 4096,
                  min_count: int = 256, sample_cap: int = 256) -> None:
        """Arm the drift/calibration detectors against a train-time
        reference (``repro_torch.obs.drift.capture_reference``).

        ``sample_cap`` bounds the per-call work of the serving-side
        feeds (:meth:`observe_scores` / :meth:`observe_ids`): each call
        is stride-subsampled down to at most that many elements before
        it reaches a tracker. Drift detection is statistical — a big
        dispatch carries thousands of candidate ids, and folding every
        one of them in costs more than the dispatch itself. 0 disables
        the cap (tests that count exact tracker volume)."""
        with self._lock:
            self._sample_cap = int(sample_cap)
            self._pending_scores.clear()  # stale feeds vs the old ref
            self._pending_ids.clear()
            self._score_tracker = ScoreDriftTracker(
                ref, window=score_window, min_count=min_count)
            self._id_tracker = IdTrafficTracker(
                ref, window=id_window, min_count=min_count)
            self._calib_tracker = CalibrationTracker(
                ref, window=calib_window,
                min_count=max(1, min_count // 4))

    # -------------------------------------------------------------- feeds
    def ingest(self, event: dict) -> None:
        """Ledger-observer entry point: fold one record into the
        windows. Alert records are ignored (they are our own output)."""
        kind = event.get("kind")
        if kind == "serve_dispatch":
            with self._lock:
                self._disp.append((event["wall_s"] * 1e6,
                                   event["queue_delay_us"],
                                   event["occupancy"]))
                self._tick()
        elif kind == "stream_eval":
            with self._lock:
                for field in ("next_day_nll", "next_day_auc"):
                    if field in event:
                        self._eval[field] = float(event[field])
                self.evaluate()

    def _sample_pieces(self, arrs) -> list[np.ndarray]:
        """Sample a per-dispatch sequence of arrays down to roughly
        ``sample_cap`` elements BY PIECE: starting from a rotating
        offset, just enough pieces to fill the cap are taken and
        strided down — a hot dispatch touches one or two of its tensors
        instead of all of them, and the rotation works through every
        slot across dispatches."""
        cap = self._sample_cap
        if not cap:
            return [np.asarray(a).ravel() for a in arrs]
        k = len(arrs)
        start = self._piece_start
        self._piece_start = (start + 1) % k
        picked, budget = [], 0
        for j in range(k):
            a = np.asarray(arrs[(start + j) % k])
            picked.append(a)
            budget += a.size
            if budget >= cap:
                break
        stride = -(-budget // cap) if budget > cap else 1
        return [a.ravel()[::stride] for a in picked]

    def observe_dispatch(self, scores, requests) -> None:
        """Combined drift feed for the scoring engine's hot path: ONE
        lock take and one sampled tensor per dispatch. Calls alternate
        between the score and the id stream, and each call samples a
        single rotating request — the trackers' rolling windows span
        hundreds of dispatches, so every request slot still gets
        worked through while the per-dispatch cost stays a small
        fraction of the dispatch wall.

        ``scores`` is the engine's per-request score list, ``requests``
        the matching request sequence (``.user_ids`` / ``.ad_ids``)."""
        if self._score_tracker is None and self._id_tracker is None:
            return
        k = len(requests)
        if k == 0:
            return
        rot = self._piece_start
        self._piece_start = rot + 1
        cap = self._sample_cap
        if rot % 2 == 0:
            if self._score_tracker is None:
                return
            chunk = _subsample(np.asarray(scores[(rot >> 1) % k]), cap)
            with self._lock:
                if self._score_tracker is not None:
                    self._pending_scores.append(chunk)
                    if len(self._pending_scores) >= _MAX_PENDING:
                        self._drain_drift()
        else:
            if self._id_tracker is None:
                return
            r = requests[(rot >> 1) % k]
            pieces = [np.asarray(r.user_ids).ravel(),
                      _subsample(np.asarray(r.ad_ids), cap)]
            with self._lock:
                if self._id_tracker is not None:
                    self._pending_ids.extend(pieces)
                    if len(self._pending_ids) >= _MAX_PENDING:
                        self._drain_drift()

    def observe_scores(self, scores) -> None:
        """Serving-score feed (the engine calls this per dispatch) —
        one array or a sequence of per-request arrays, subsampled to
        the armed ``sample_cap`` and buffered; the trackers fold the
        buffer in at the next evaluation."""
        if self._score_tracker is None:
            return
        if isinstance(scores, (list, tuple)):
            if not scores:
                return
            pieces = self._sample_pieces(scores)
        else:
            pieces = [_subsample(np.asarray(scores), self._sample_cap)]
        with self._lock:
            if self._score_tracker is not None:
                self._pending_scores.extend(pieces)
                if len(self._pending_scores) >= _MAX_PENDING:
                    self._drain_drift()

    def observe_ids(self, ids) -> None:
        """Id-traffic feed (pad ids are filtered by the tracker) —
        same shapes and sampling as :meth:`observe_scores`."""
        if self._id_tracker is None:
            return
        if isinstance(ids, (list, tuple)):
            if not ids:
                return
            pieces = self._sample_pieces(ids)
        else:
            pieces = [_subsample(np.asarray(ids), self._sample_cap)]
        with self._lock:
            if self._id_tracker is not None:
                self._pending_ids.extend(pieces)
                if len(self._pending_ids) >= _MAX_PENDING:
                    self._drain_drift()

    def _drain_drift(self) -> None:
        """Fold buffered score/id chunks into the trackers (caller holds
        the lock). Buffering amortises numpy's fixed per-op cost over
        ``eval_every`` dispatches — one tracker update per evaluation
        instead of one per dispatch keeps the monitored dispatch loop
        close to the unmonitored one."""
        if self._pending_scores:
            self._score_tracker.update(np.concatenate(self._pending_scores))
            self._pending_scores.clear()
        if self._pending_ids:
            self._id_tracker.update(np.concatenate(self._pending_ids))
            self._pending_ids.clear()

    def observe_predictions(self, p, y) -> None:
        """Labeled-prediction feed (stream eval / delayed feedback)."""
        with self._lock:
            if self._calib_tracker is not None:
                self._calib_tracker.update(p, y)

    def _tick(self) -> None:
        self._since_eval += 1
        if self._since_eval >= self._eval_every:
            self.evaluate()

    # ------------------------------------------------------------ signals
    _SIGNAL_NAMES = (
        "serve.p50_wall_us", "serve.p99_wall_us",
        "serve.p99_queue_delay_us", "serve.occupancy",
        "queue.pending", "queue.rejected",
        "eval.next_day_nll", "eval.next_day_auc",
        "calib.ratio", "calib.bucket_dev",
        "drift.score_psi", "drift.score_kl", "drift.id_psi",
    )

    def signals(self) -> dict[str, float | None]:
        """The current rule-addressable signal values (None = not warm)."""
        with self._lock:
            self._drain_drift()
            return {n: self._signal(n) for n in self._SIGNAL_NAMES}

    def _signal(self, name: str) -> float | None:
        """One signal on demand (caller holds the lock and has drained
        the drift buffers) — ``evaluate`` touches only the signals its
        rules actually reference, never the full dict."""
        if name == "serve.p50_wall_us":
            col = self._disp_col(0)
            return None if col is None else float(np.percentile(col, 50))
        if name == "serve.p99_wall_us":
            col = self._disp_col(0)
            return None if col is None else float(np.percentile(col, 99))
        if name == "serve.p99_queue_delay_us":
            col = self._disp_col(1)
            return None if col is None else float(np.percentile(col, 99))
        if name == "serve.occupancy":
            col = self._disp_col(2)
            return None if col is None else float(col.mean())
        if name == "queue.pending":
            return self._registry_value("serve_queue_pending")
        if name == "queue.rejected":
            return self._registry_value("serve_queue_rejected")
        if name == "eval.next_day_nll":
            return self._eval.get("next_day_nll")
        if name == "eval.next_day_auc":
            return self._eval.get("next_day_auc")
        if name == "calib.ratio":
            return None if self._calib_tracker is None \
                else self._calib_tracker.ratio()
        if name == "calib.bucket_dev":
            return None if self._calib_tracker is None \
                else self._calib_tracker.max_bucket_deviation()
        if name == "drift.score_psi":
            return None if self._score_tracker is None \
                else self._score_tracker.psi()
        if name == "drift.score_kl":
            return None if self._score_tracker is None \
                else self._score_tracker.kl()
        if name == "drift.id_psi":
            return None if self._id_tracker is None \
                else self._id_tracker.psi()
        return None

    def _disp_col(self, i: int) -> np.ndarray | None:
        if not self._disp:
            return None
        return np.fromiter((t[i] for t in self._disp), np.float64)

    def _registry_value(self, name: str) -> float | None:
        vals = [s.value for s in self._reg.series() if s.name == name]
        return max(vals) if vals else None

    # ----------------------------------------------------------- evaluate
    def evaluate(self) -> list[dict]:
        """Evaluate every rule against the current signals, advancing
        hysteresis state; returns the alert records emitted (state
        CHANGES only — a steadily-firing rule emits once)."""
        with self._lock:
            self._since_eval = 0
            self._drain_drift()
            sigs: dict[str, float | None] = {}
            emitted = []
            for rule in self.rules:
                if rule.signal not in sigs:
                    sigs[rule.signal] = self._signal(rule.signal)
                value = sigs[rule.signal]
                if value is None or value != value:  # not warm / NaN: skip
                    continue
                st = self._states[rule.name]
                if rule.ok(value):
                    st.oks += 1
                    st.breaches = 0
                    if st.active and st.oks >= rule.clear_n:
                        st.active = False
                        emitted.append(self._emit(rule, "cleared", value))
                else:
                    st.breaches += 1
                    st.oks = 0
                    if not st.active and st.breaches >= rule.breach_n:
                        st.active = True
                        emitted.append(self._emit(rule, "firing", value))
            return emitted

    def _emit(self, rule: SLORule, state: str, value: float) -> dict:
        event = {"kind": "alert", "rule": rule.name, "state": state,
                 "signal": rule.signal, "value": float(value),
                 "threshold": rule.threshold, "op": rule.op,
                 "breach_n": rule.breach_n, "clear_n": rule.clear_n}
        self._alerts.append(dict(event))
        self._reg.counter("obs_alerts", rule=rule.name, state=state).inc()
        gauge = self._active_gauges.get(rule.name)
        if gauge is None:
            gauge = self._reg.gauge("obs_alert_active", rule=rule.name)
            self._active_gauges[rule.name] = gauge
        gauge.set(1.0 if state == "firing" else 0.0)
        if self._ledger.enabled:
            self._ledger.emit(**event)
        return event

    # -------------------------------------------------------------- views
    def alerts(self) -> list[dict]:
        """Every alert state change so far (oldest first)."""
        with self._lock:
            return [dict(a) for a in self._alerts]

    def active_alerts(self) -> list[str]:
        """Names of rules currently firing."""
        with self._lock:
            return [name for name, st in self._states.items() if st.active]

    def summary(self) -> dict:
        """One log-friendly health snapshot."""
        with self._lock:
            sigs = {k: v for k, v in self.signals().items() if v is not None}
            return {"signals": sigs, "active": self.active_alerts(),
                    "alerts": len(self._alerts)}


class NullMonitor:
    """The disabled default: every feed is one early return."""

    enabled = False

    def attach(self, ledger) -> "NullMonitor":
        return self

    def detach(self) -> None:
        return None

    def arm_drift(self, ref, **kwargs) -> None:
        return None

    def ingest(self, event: dict) -> None:
        return None

    def observe_dispatch(self, scores, requests) -> None:
        return None

    def observe_scores(self, scores) -> None:
        return None

    def observe_ids(self, ids) -> None:
        return None

    def observe_predictions(self, p, y) -> None:
        return None

    def evaluate(self) -> list[dict]:
        return []

    def signals(self) -> dict:
        return {}

    def alerts(self) -> list[dict]:
        return []

    def active_alerts(self) -> list[str]:
        return []

    def summary(self) -> dict:
        return {"signals": {}, "active": [], "alerts": 0}


NULL_MONITOR = NullMonitor()
_DEFAULT: HealthMonitor | NullMonitor = NULL_MONITOR


def get_monitor() -> HealthMonitor | NullMonitor:
    """The process default monitor — :data:`NULL_MONITOR` until a driver
    configures ``--monitor`` (see ``repro_torch.obs.configure``)."""
    return _DEFAULT


def set_monitor(monitor: HealthMonitor | NullMonitor,
                ) -> HealthMonitor | NullMonitor:
    """Swap the process default monitor; returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, monitor
    return prev
