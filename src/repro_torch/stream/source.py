"""Day-sliced sparse CTR stream — the production cadence of §4.

The port's counterpart of ``repro/stream/source.py``. The paper trains
LS-PLM full-batch, but Alibaba's system retrains as new days of
impressions arrive. :class:`DayStream` models that arrival process: day t
is a session-structured padded-COO
:class:`~repro_torch.data.sparse.SparseCTRBatch` (no transpose plans
attached: planning is the streaming trainer's job, done once per window
on the host by ``repro_torch.stream.planner``), drawn from the same
planted piecewise-linear truth as ``generate_sparse`` (hashed per-id
weights, so an id means the same thing on every day) but with per-day
id-DISTRIBUTION drift: the hot head of the id traffic rotates by
``drift`` of the id space per day.

Every day is drawn by numpy in the reference's order, so its arrays equal
the reference's bit for bit. The batches are HOST tensors (CPU torch
tensors over numpy arrays): the day cache holds no device memory, so a
long stream costs the card nothing, and ``window(t, W)`` concatenates on
the host. The planner moves each planned window to the device once.

Days are deterministic in (seed, day) and cached (bounded: the
``cache_days`` most recent; evicted days regenerate bit-identically).
"""
from __future__ import annotations

import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.data.sparse import SparseCTRBatch, planted_ctr_labels


def concat_batches(batches: Sequence[SparseCTRBatch]) -> SparseCTRBatch:
    """Concatenate session-structured sparse batches (sessions stacked in
    order, session ids re-based so they stay contiguous and ascending).
    All batches must share d and the per-row K widths (true for every
    batch of one :class:`DayStream`). Plans are NOT carried over: a
    concatenation addresses new sample indices, so the caller re-plans.
    The batches must lie on one device; the result lies there too."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    d = batches[0].num_features
    ku = batches[0].user_ids.shape[1]
    ka = batches[0].ad_ids.shape[1]
    for b in batches:
        if b.num_features != d or b.user_ids.shape[1] != ku \
                or b.ad_ids.shape[1] != ka:
            raise ValueError(
                "batches disagree on d or K widths: "
                f"{(b.num_features, b.user_ids.shape[1], b.ad_ids.shape[1])} "
                f"vs {(d, ku, ka)}")
    if len(batches) == 1:
        return batches[0]._replace(user_plan=None, ad_plan=None)
    sids, off = [], 0
    for b in batches:
        sids.append(b.session_id + off)
        off += int(b.user_ids.shape[0])

    def cat(field):
        return torch.cat([getattr(b, field) for b in batches], dim=0)

    return SparseCTRBatch(
        user_ids=cat("user_ids"), user_vals=cat("user_vals"),
        ad_ids=cat("ad_ids"), ad_vals=cat("ad_vals"),
        session_id=torch.cat(sids).to(torch.int32), y=cat("y"),
        num_features=d)


class DayStream:
    """Deterministic per-day sparse CTR batches with id-traffic drift.

    Day t draws user ids from ``[user_lo, d)`` and ad ids from
    ``[0, user_lo)``. A ``head_frac`` share of the traffic is a HOT HEAD
    — exponentially decaying over ids with characteristic width
    ``head_width * span``, centred at an offset that rotates by
    ``drift * span`` ids per day (wrapping) — and the rest is uniform
    background. Labels come from the shared planted truth
    (``planted_ctr_labels``), which depends only on the ids/vals: the
    truth never drifts, only the traffic does, so a model trained on
    recent days generalises to the next day better than a stale one.
    The defaults are the reference's.
    """

    def __init__(self, num_days: int, sessions_per_day: int = 128, *,
                 num_features: int = 100_000,
                 ads_per_session: int = 4,
                 active_user: int = 16, active_ad: int = 8,
                 user_frac: float = 0.6,
                 drift: float = 0.02, head_frac: float = 0.75,
                 head_width: float = 0.08, binary_vals: bool = True,
                 cache_days: int = 16, seed: int = 0):
        if num_days < 1:
            raise ValueError(f"num_days must be >= 1, got {num_days}")
        if sessions_per_day < 1:
            raise ValueError(
                f"sessions_per_day must be >= 1, got {sessions_per_day}")
        self.num_days = int(num_days)
        self.sessions_per_day = int(sessions_per_day)
        self.num_features = int(num_features)
        self.ads_per_session = int(ads_per_session)
        self.active_user = int(active_user)
        self.active_ad = int(active_ad)
        self.user_lo = max(1, int(user_frac * num_features))
        self.drift = float(drift)
        self.head_frac = float(head_frac)
        self.head_width = float(head_width)
        self.binary_vals = bool(binary_vals)
        self.cache_days = max(1, int(cache_days))
        self.seed = int(seed)
        self._cache: dict[int, SparseCTRBatch] = {}
        # the planner thread and the driver's eval can ask for the same
        # day concurrently; generation is deterministic, the lock just
        # stops the work being done twice
        self._lock = threading.Lock()

    # ------------------------------------------------------------- generation
    def _drifted_ids(self, rng, lo: int, hi: int, shape, day: int):
        """``head_frac`` of draws from an exponentially-decaying hot head
        at ``lo + offset(day)`` (wrapping), the rest uniform background."""
        span = hi - lo
        scale = max(1.0, self.head_width * span)
        offset = int(round(self.drift * day * span))
        r = (-scale * np.log1p(-rng.random(shape))).astype(np.int64)
        head = (offset + r) % span
        tail = rng.integers(0, span, shape)
        ids = np.where(rng.random(shape) < self.head_frac, head, tail)
        return lo + ids

    def day(self, t: int) -> SparseCTRBatch:
        """Day t's impressions on the host (no plans attached)."""
        if not 0 <= t < self.num_days:
            raise IndexError(f"day {t} outside [0, {self.num_days})")
        with self._lock:
            return self._day_locked(t)

    def _day_locked(self, t: int) -> SparseCTRBatch:
        if t in self._cache:
            return self._cache[t]
        while len(self._cache) >= self.cache_days:  # drop the oldest
            self._cache.pop(next(iter(self._cache)))
        rng = np.random.default_rng(self.seed * 1_000_003 + t)
        d, g, a = self.num_features, self.sessions_per_day, self.ads_per_session
        b = g * a
        user_ids = self._drifted_ids(rng, self.user_lo, d,
                                     (g, self.active_user), t)
        ad_ids = self._drifted_ids(rng, 0, self.user_lo,
                                   (b, self.active_ad), t)
        if self.binary_vals:
            # production wire format: multi-hot indicators (value 1,
            # scaled so |x| is K-independent)
            user_vals = np.full((g, self.active_user),
                                1.0 / np.sqrt(self.active_user), np.float32)
            ad_vals = np.full((b, self.active_ad),
                              1.0 / np.sqrt(self.active_ad), np.float32)
        else:
            user_vals = rng.normal(size=(g, self.active_user)).astype(
                np.float32) / np.sqrt(self.active_user)
            ad_vals = rng.normal(size=(b, self.active_ad)).astype(
                np.float32) / np.sqrt(self.active_ad)
        session_id = np.repeat(np.arange(g, dtype=np.int32), a)
        y = planted_ctr_labels(user_ids, user_vals, ad_ids, ad_vals,
                               session_id, rng)

        def host(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))

        batch = SparseCTRBatch(
            user_ids=host(user_ids, np.int32),
            user_vals=host(user_vals, np.float32),
            ad_ids=host(ad_ids, np.int32), ad_vals=host(ad_vals, np.float32),
            session_id=host(session_id, np.int32), y=host(y, np.float32),
            num_features=d)
        self._cache[t] = batch
        return batch

    def window(self, t: int, window: int = 1) -> SparseCTRBatch:
        """The sliding training window ending at day t: days
        ``[max(0, t - window + 1), t]`` concatenated on the host (early
        days see fewer than ``window`` days). No plans attached."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        lo = max(0, t - window + 1)
        return concat_batches([self.day(s) for s in range(lo, t + 1)])

    # ------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return self.num_days

    def __iter__(self) -> Iterator[SparseCTRBatch]:
        return (self.day(t) for t in range(self.num_days))
