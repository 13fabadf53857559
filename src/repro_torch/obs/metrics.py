"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms with labeled series and JSON/JSONL export.

A copy of the reference's ``repro/obs/metrics.py`` (the port imports
nothing from ``repro``). The registry is the ONE place the port's
runtime statistics live: ``serve.engine.EngineStats`` and
``serve.traffic.QueueStats`` are VIEWS over registry series (every field
is read back out of a counter), and the same numbers export as one
machine-readable snapshot (``repro_torch.launch.* --metrics-out``).

Design constraints, in order:

  * THREAD-SAFE: the serving queue's wall-clock pump thread and the
    caller's thread feed the same registry concurrently. Series creation
    locks the registry; every instrument carries its own lock for
    updates.
  * BIT-FOR-BIT: a counter accumulates with plain ``+=`` float
    arithmetic in call order, so derived values match the reference's.
  * CHEAP: an update is one lock + one add. Nothing allocates on the
    hot path; export walks the series only when asked.

Histograms use fixed bucket upper bounds (default: a log-spaced
1 us .. 500 s wall-clock ladder) and support p50/p99-style quantile
estimates by linear interpolation inside the covering bucket, clamped
to the observed min/max.
"""
from __future__ import annotations

import itertools
import json
import threading
from typing import Iterator

# log-spaced seconds ladder: 1us .. 500s (1, 2.5, 5 per decade) — wide
# enough for kernel dispatches and whole-window walls alike
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    b * 10.0 ** e for e in range(-6, 3) for b in (1.0, 2.5, 5.0))

_INSTANCE_IDS: dict[str, itertools.count] = {}
_INSTANCE_LOCK = threading.Lock()


def next_instance(kind: str) -> str:
    """Monotonic per-kind instance label (``"0"``, ``"1"``, ...) so each
    planner/engine/queue object owns its own labeled series."""
    with _INSTANCE_LOCK:
        counter = _INSTANCE_IDS.setdefault(kind, itertools.count())
        return str(next(counter))


def _series_key(name: str, labels: dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically-accumulating float (counts or summed seconds)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def as_dict(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def as_dict(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram (upper bounds + implicit +inf overflow)
    with count/sum/min/max and interpolated quantiles."""

    __slots__ = ("name", "labels", "bounds", "_lock", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, labels: dict[str, str],
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # last = +inf
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        if v != v:  # NaN would poison min/max (min(inf, nan) -> inf but
            # max(-inf, nan) -> nan on some paths) and make quantile()
            # return garbage; reject at the source where the bug is
            raise ValueError(f"histogram {self.name!r}: NaN observation")
        # linear scan is fine: bucket ladders are tens of entries and
        # observations land near the front for sub-second walls
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) by linear interpolation
        inside the covering bucket, clamped to the observed range.

        Edge cases (all tested in ``tests/test_obs.py``): an EMPTY
        histogram returns 0.0 (there is no observed range to clamp to);
        ``q=0`` returns the observed min and ``q=1`` the observed max
        (the clamp, not extrapolation into the bucket bounds); a
        SINGLE-observation series returns that value for every q.
        ``q`` outside [0, 1] raises — a quantile request like 99 where
        0.99 was meant must not silently clamp to the max."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(
                f"quantile q must be in [0, 1], got {q!r} "
                f"(pass 0.99, not 99)")
        with self._lock:
            count = self._count
            counts = list(self._counts)
            lo_obs, hi_obs = self._min, self._max
        if count == 0:
            return 0.0
        rank = q * count
        cum = 0.0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = self.bounds[i] if i < len(self.bounds) else hi_obs
            if c and cum + c >= rank:
                frac = (rank - cum) / c
                est = lo + frac * (max(hi, lo) - lo)
                return min(max(est, lo_obs), hi_obs)
            cum += c
            lo = hi
        return hi_obs

    def as_dict(self) -> dict:
        with self._lock:
            buckets = {("+inf" if i == len(self.bounds)
                        else f"{self.bounds[i]:g}"): c
                       for i, c in enumerate(self._counts) if c}
            out = {"type": "histogram", "count": self._count,
                   "sum": self._sum, "buckets": buckets}
            if self._count:
                out["min"] = self._min
                out["max"] = self._max
        if self._count:
            out["p50"] = self.quantile(0.5)
            out["p99"] = self.quantile(0.99)
        return out


class MetricsRegistry:
    """Thread-safe get-or-create home for labeled metric series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, labels: dict[str, str], **kwargs):
        key = _series_key(name, labels)
        with self._lock:
            inst = self._series.get(key)
            if inst is None:
                inst = cls(name, labels, **kwargs)
                self._series[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"series {key!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def series(self) -> Iterator[Counter | Gauge | Histogram]:
        with self._lock:
            return iter(list(self._series.values()))

    def as_dict(self) -> dict:
        """``{series_key: {type, value | count/sum/buckets/...}}``."""
        with self._lock:
            items = list(self._series.items())
        return {key: inst.as_dict() for key, inst in items}

    def write(self, path: str) -> str:
        """Snapshot to ``path``: ``.jsonl`` writes one series per line,
        anything else one nested JSON document. The write is ATOMIC
        (temp file + ``os.replace``) — a crash mid-snapshot leaves the
        previous file intact, never a truncated JSON artifact."""
        from repro_torch.obs.fileio import atomic_write

        snap = self.as_dict()
        with atomic_write(path) as f:
            if path.endswith(".jsonl"):
                for key, payload in sorted(snap.items()):
                    f.write(json.dumps({"series": key, **payload},
                                       sort_keys=True) + "\n")
            else:
                json.dump(snap, f, indent=2, sort_keys=True)
                f.write("\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem feeds by default."""
    return _DEFAULT


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests); returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, registry
    return prev
