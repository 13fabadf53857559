"""Model-health drift detection: train-time reference snapshots and
online detectors over the serving stream.

The port's copy of ``repro/obs/drift.py`` (numpy only; it imports nothing
of the reference, and the npz layout is the reference's, so a reference
written by either package loads in the other).

LS-PLM's production story ("On the Factory Floor", PAPERS.md
2209.05310) treats calibration and distribution drift as first-class
gates: a model that scores fast but scores the WRONG traffic is worse
than a slow one. This module is the passive half of that gate — the
:class:`~repro_torch.obs.monitor.HealthMonitor` turns its numbers into
alerts.

At TRAIN time, :func:`capture_reference` snapshots what "healthy"
looked like on held-out eval data:

  * the score histogram (fixed [0, 1] buckets) — the serving score
    distribution should keep this shape;
  * per-bucket predicted/empirical click mass — the bucketed
    calibration the online ratio is compared against (the per-bucket
    view is ``repro_torch.eval.metrics.bucketed_calibration``);
  * the top-M id traffic histogram (+ one tail bucket) — the hot head
    of the id stream; :class:`~repro_torch.stream.source.DayStream`'s planted
    drift rotates exactly this head, so the id-traffic PSI below is the
    detector that must fire on a drifted replay.

The reference saves standalone (:func:`save_drift_reference`) or rides
inside a serving-artifact file (``repro_torch.serve.compress.save_artifact``
embeds it under a ``drift_ref/`` prefix the artifact loader ignores).

ONLINE, three rolling trackers consume the serving stream:

  * :class:`ScoreDriftTracker` — PSI and KL divergence of the rolling
    score histogram vs the reference (PSI > 0.25 is the conventional
    "population has shifted" threshold);
  * :class:`IdTrafficTracker` — PSI of the rolling top-id/tail traffic
    histogram vs the reference;
  * :class:`CalibrationTracker` — rolling overall calibration ratio
    (literally ``eval/metrics.calibration_ratio`` over the rolling
    sums) plus the worst per-bucket deviation from the reference's
    bucket ratios.

All three share the chunked-eviction rolling window (whole update
batches are evicted oldest-first once the window overflows), so an
update is a handful of vectorised numpy ops — cheap enough to live on
the engine's dispatch path.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np

from repro_torch.eval.metrics import calibration_ratio

DEFAULT_BINS = 20
DEFAULT_TOP_M = 128
PSI_EPS = 1e-4


class DriftReference(NamedTuple):
    """A train-time health snapshot (see module docstring)."""

    score_edges: np.ndarray  # (B+1,) ascending score-bucket boundaries
    score_counts: np.ndarray  # (B,) reference score histogram
    bucket_p: np.ndarray  # (B,) sum of predicted p per score bucket
    bucket_y: np.ndarray  # (B,) sum of labels per score bucket
    top_ids: np.ndarray  # (M,) hottest ids, sorted ascending
    top_counts: np.ndarray  # (M+1,) their traffic counts + tail bucket
    num_features: int  # d — ids >= d are padding and never counted

    @property
    def num_bins(self) -> int:
        return self.score_counts.shape[0]

    @property
    def ratio(self) -> float:
        """The reference's overall calibration ratio."""
        return calibration_ratio(np.asarray([self.bucket_y.sum()]),
                                 np.asarray([self.bucket_p.sum()]))

    def bucket_ratios(self) -> np.ndarray:
        """Per-bucket reference calibration ratios (inf where a bucket
        saw no clicks)."""
        return np.array([
            calibration_ratio(np.asarray([sy]), np.asarray([sp]))
            for sy, sp in zip(self.bucket_y, self.bucket_p)])


def _score_bins(scores: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bucket index per score; out-of-range clamps into the end bins."""
    return np.clip(np.searchsorted(edges, scores, side="right") - 1,
                   0, edges.size - 2).astype(np.int64)


def capture_reference(scores, labels, ids, *, num_features: int,
                      bins: int = DEFAULT_BINS,
                      top_m: int = DEFAULT_TOP_M) -> DriftReference:
    """Snapshot a held-out eval pass into a :class:`DriftReference`.

    ``scores``/``labels`` are the eval predictions p(y=1|x) and their
    labels; ``ids`` is the raw id traffic that produced them (any
    shape — user and ad id tensors concatenated and raveled; entries
    >= ``num_features`` are padding and are dropped). ``top_m`` caps
    the tracked hot head; everything else lands in one tail bucket.
    """
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels, np.float64).ravel()
    if scores.size == 0:
        raise ValueError("capture_reference needs a non-empty eval pass")
    if scores.shape != labels.shape:
        raise ValueError(
            f"scores/labels disagree: {scores.shape} vs {labels.shape}")
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = _score_bins(scores, edges)
    score_counts = np.bincount(idx, minlength=bins).astype(np.int64)
    bucket_p = np.bincount(idx, weights=scores, minlength=bins)
    bucket_y = np.bincount(idx, weights=labels, minlength=bins)

    flat = np.asarray(ids).ravel()
    flat = flat[(flat >= 0) & (flat < num_features)].astype(np.int64)
    if flat.size == 0:
        raise ValueError("capture_reference saw no real (non-pad) ids")
    uniq, counts = np.unique(flat, return_counts=True)
    keep = min(top_m, uniq.size)
    hot = np.argsort(counts)[::-1][:keep]
    top_ids = np.sort(uniq[hot])
    order = np.searchsorted(np.sort(uniq[hot]), uniq[hot])
    top_counts = np.zeros(keep + 1, np.int64)
    top_counts[order] = counts[hot]
    top_counts[keep] = flat.size - counts[hot].sum()  # tail traffic
    return DriftReference(
        score_edges=edges, score_counts=score_counts,
        bucket_p=bucket_p, bucket_y=bucket_y,
        top_ids=top_ids.astype(np.int64), top_counts=top_counts,
        num_features=int(num_features))


# ------------------------------------------------------------ divergences
def _proportions(counts: np.ndarray, eps: float) -> np.ndarray:
    c = np.asarray(counts, np.float64)
    total = c.sum()
    if total <= 0:
        raise ValueError("divergence over an empty histogram")
    return np.clip(c / total, eps, None)


def psi(ref_counts: np.ndarray, cur_counts: np.ndarray,
        eps: float = PSI_EPS) -> float:
    """Population stability index between two count histograms (bucket
    proportions clipped at ``eps`` so empty buckets stay finite).
    Conventional reading: < 0.1 stable, 0.1-0.25 moderate shift,
    > 0.25 the population has drifted."""
    a = _proportions(ref_counts, eps)
    b = _proportions(cur_counts, eps)
    return float(np.sum((b - a) * np.log(b / a)))


def kl(ref_counts: np.ndarray, cur_counts: np.ndarray,
       eps: float = PSI_EPS) -> float:
    """KL(current || reference) over the same clipped proportions."""
    a = _proportions(ref_counts, eps)
    b = _proportions(cur_counts, eps)
    return float(np.sum(b * np.log(b / a)))


# --------------------------------------------------------- rolling window
class _RollingCounts:
    """Rolling bucket counts with chunked eviction: each ``add`` pushes
    one (n, bincount) chunk; once the total observation count exceeds
    ``capacity``, whole chunks are evicted oldest-first. The window
    therefore holds the most recent ~capacity observations without any
    per-item bookkeeping — every operation is O(buckets)."""

    def __init__(self, num_buckets: int, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._chunks: deque[tuple[int, np.ndarray]] = deque()
        self._counts = np.zeros(num_buckets, np.int64)
        self._total = 0

    def add(self, idx: np.ndarray) -> None:
        if idx.size == 0:
            return
        c = np.bincount(idx, minlength=self._counts.size).astype(np.int64)
        self._chunks.append((int(idx.size), c))
        self._counts += c
        self._total += int(idx.size)
        while self._total > self.capacity and len(self._chunks) > 1:
            n, old = self._chunks.popleft()
            self._counts -= old
            self._total -= n

    @property
    def total(self) -> int:
        return self._total

    @property
    def counts(self) -> np.ndarray:
        return self._counts


class ScoreDriftTracker:
    """Rolling serving-score histogram vs the reference: PSI and KL."""

    def __init__(self, ref: DriftReference, *, window: int = 4096,
                 min_count: int = 256):
        self.ref = ref
        self.min_count = int(min_count)
        self._roll = _RollingCounts(ref.num_bins, window)

    def update(self, scores) -> None:
        s = np.asarray(scores, np.float64).ravel()
        self._roll.add(_score_bins(s, self.ref.score_edges))

    @property
    def ready(self) -> bool:
        return self._roll.total >= self.min_count

    def psi(self) -> float | None:
        if not self.ready:
            return None
        return psi(self.ref.score_counts, self._roll.counts)

    def kl(self) -> float | None:
        if not self.ready:
            return None
        return kl(self.ref.score_counts, self._roll.counts)


class IdTrafficTracker:
    """Rolling top-id/tail traffic histogram vs the reference: PSI.

    Ids map onto the reference's sorted hot head by binary search; any
    id outside it (including ids the reference never saw) books into
    the tail bucket, and pad ids (>= num_features) are dropped — so the
    detector fires when the hot head COOLS, which is exactly what
    ``DayStream``'s planted rotation does."""

    def __init__(self, ref: DriftReference, *, window: int = 65536,
                 min_count: int = 1024):
        self.ref = ref
        self.min_count = int(min_count)
        self._top = np.asarray(ref.top_ids, np.int64)
        self._roll = _RollingCounts(self._top.size + 1, window)

    def update(self, ids) -> None:
        flat = np.asarray(ids).ravel().astype(np.int64)
        flat = flat[(flat >= 0) & (flat < self.ref.num_features)]
        if flat.size == 0:
            return
        pos = np.searchsorted(self._top, flat)
        pos_c = np.minimum(pos, self._top.size - 1)
        hit = self._top[pos_c] == flat
        idx = np.where(hit, pos_c, self._top.size)  # miss -> tail bucket
        self._roll.add(idx)

    @property
    def ready(self) -> bool:
        return self._roll.total >= self.min_count

    def psi(self) -> float | None:
        if not self.ready:
            return None
        return psi(self.ref.top_counts, self._roll.counts)


class CalibrationTracker:
    """Rolling calibration vs the reference, in score buckets.

    ``update(p, y)`` pushes one labeled prediction chunk; ``ratio()``
    is the overall rolling calibration ratio (the same
    ``eval/metrics.calibration_ratio`` arithmetic over the rolling
    sums) and ``max_bucket_deviation()`` the worst per-bucket
    ``|cur/ref - 1|`` over buckets where both sides saw clicks."""

    def __init__(self, ref: DriftReference, *, window: int = 4096,
                 min_count: int = 64, min_bucket: int = 32):
        self.ref = ref
        self.min_count = int(min_count)
        self.min_bucket = int(min_bucket)
        nb = ref.num_bins
        self._chunks: deque[tuple[int, np.ndarray, np.ndarray,
                                  np.ndarray]] = deque()
        self._capacity = int(window)
        self._sum_p = np.zeros(nb)
        self._sum_y = np.zeros(nb)
        self._n = np.zeros(nb, np.int64)
        self._total = 0

    def update(self, p, y) -> None:
        p = np.asarray(p, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        if p.shape != y.shape:
            raise ValueError(f"p/y disagree: {p.shape} vs {y.shape}")
        if p.size == 0:
            return
        nb = self.ref.num_bins
        idx = _score_bins(p, self.ref.score_edges)
        cp = np.bincount(idx, weights=p, minlength=nb)
        cy = np.bincount(idx, weights=y, minlength=nb)
        cn = np.bincount(idx, minlength=nb).astype(np.int64)
        self._chunks.append((p.size, cp, cy, cn))
        self._sum_p += cp
        self._sum_y += cy
        self._n += cn
        self._total += p.size
        while self._total > self._capacity and len(self._chunks) > 1:
            n, op, oy, on = self._chunks.popleft()
            self._sum_p -= op
            self._sum_y -= oy
            self._n -= on
            self._total -= n

    @property
    def ready(self) -> bool:
        return self._total >= self.min_count

    def ratio(self) -> float | None:
        """Rolling overall calibration ratio (None until warm, inf when
        the window holds no clicks — exactly ``calibration_ratio``)."""
        if not self.ready:
            return None
        return calibration_ratio(np.asarray([self._sum_y.sum()]),
                                 np.asarray([self._sum_p.sum()]))

    def max_bucket_deviation(self) -> float | None:
        """Worst ``|rolling_ratio / reference_ratio - 1|`` over buckets
        with >= ``min_bucket`` rolling observations and clicks on both
        sides; None when no bucket qualifies yet."""
        if not self.ready:
            return None
        ok = (self._n >= self.min_bucket) & (self._sum_y > 0) \
            & (self.ref.bucket_y > 0)
        if not ok.any():
            return None
        cur = self._sum_p[ok] / self._sum_y[ok]
        ref = self.ref.bucket_p[ok] / self.ref.bucket_y[ok]
        return float(np.abs(cur / ref - 1.0).max())


# ------------------------------------------------------------ persistence
def save_drift_reference(path: str, ref: DriftReference) -> str:
    """Write a standalone reference file (flat npz under a
    ``drift_ref/`` prefix — the same layout ``serve.compress.
    save_artifact(..., drift_ref=...)`` embeds next to an artifact).
    Returns the real path written (``.npz`` appended when missing)."""
    from repro_torch.io import checkpoint

    return checkpoint.save(path, {"drift_ref": ref})


def load_drift_reference(path: str) -> DriftReference:
    """Load a reference from either a standalone file or an artifact
    file that embedded one; raises ``ValueError`` when the file carries
    no ``drift_ref/`` entries."""
    from repro_torch.io import checkpoint

    data = checkpoint.load_nested(path)
    node = data.get("drift_ref")
    if node is None:
        raise ValueError(
            f"{path!r} carries no drift reference (train with --drift-ref, "
            f"or save_artifact(..., drift_ref=...))")
    missing = [f for f in DriftReference._fields if f not in node]
    if missing:
        raise ValueError(f"{path!r}: drift reference missing {missing}")
    return DriftReference(
        num_features=int(np.asarray(node["num_features"]).item()),
        **{f: np.asarray(node[f]) for f in DriftReference._fields
           if f != "num_features"})
