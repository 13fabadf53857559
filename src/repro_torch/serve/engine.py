"""Batched online scoring engine: bucketed shapes, prebuilt envelopes.

The port's counterpart of ``repro/serve/engine.py``. Online traffic is
ragged: every page view carries its own user id count Ku, per-candidate
id count Ka and candidate count N. The engine

  * pads each request up to a bucketed ENVELOPE (K_user, K_ad, N) (pad
    slots carry the pad id with value 0, padded candidates are sliced off
    the result);
  * STACKS same-envelope requests: :meth:`ScoringEngine.score_batch`
    serves a group as ONE ``G > 1`` bundle call (G bucketed too, pad
    bundles all-pad and sliced off), so the per-dispatch overhead —
    padding, copies, kernel launches, the device sync — amortises over G
    page views;
  * builds, per (G, K_user, K_ad, N, dtype) envelope, ONE entry: pinned
    host buffers for the request tensors, their device twins (filled with
    ``copy_(..., non_blocking=True)``) and the session-id tensor. The
    build counts as one "compile" in :class:`EngineStats` (the reference
    AOT-compiles an executable per envelope here). Envelope keys are the
    ONLY source of builds: once the bucket set is warm, a replay of any
    mix, order or grouping builds ZERO new entries.

Scoring runs the session-shared path (``serve.score.score_bundles``,
Eq. 13) on the device the engine was built for; a dispatch ends with
``torch.cuda.current_stream().synchronize()`` before the host copy of p.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.serve.score import ScoreBundle, as_model, score_bundles

# default bucket edges; above the top edge, round up to a multiple of it
DEFAULT_K_BUCKETS = (8, 16, 24, 32, 48, 64)
DEFAULT_N_BUCKETS = (4, 8, 16, 32, 64)
DEFAULT_G_BUCKETS = (1, 2, 4, 8, 16)


def round_up(x: int, buckets: Sequence[int]) -> int:
    """Smallest bucket edge >= x; past the top edge, next multiple of it
    (the reference's ``repro.tune.round_up`` rule)."""
    if x <= 0:
        raise ValueError(f"dimension must be positive, got {x}")
    for b in buckets:
        if x <= b:
            return b
    top = buckets[-1]
    return -(-x // top) * top


class BundleRequest(NamedTuple):
    """One page view: a user id list + N candidate id lists (original id
    space, no padding — the engine pads)."""

    user_ids: np.ndarray  # (Ku,) int
    user_vals: np.ndarray  # (Ku,) float
    ad_ids: np.ndarray  # (N, Ka) int
    ad_vals: np.ndarray  # (N, Ka) float


class EngineStats:
    """Serving counters (one labeled family per engine) — a view over the
    process metrics registry, with the reference's attribute API."""

    def __init__(self, registry=None):
        reg = registry if registry is not None else obs.get_registry()
        labels = {"engine": obs.next_instance("engine")}
        self._reg, self._labels = reg, labels
        self._requests = reg.counter("serve_requests", **labels)
        self._candidates = reg.counter("serve_candidates", **labels)
        self._dispatches = reg.counter("serve_dispatches", **labels)
        self._slots = reg.counter("serve_slots", **labels)
        self._compiles = reg.counter("serve_compiles", **labels)
        self._compile_s = reg.counter("serve_compile_seconds", **labels)
        self._score_s = reg.counter("serve_score_seconds", **labels)
        self._wall_hist = reg.histogram("serve_dispatch_wall_seconds",
                                        **labels)
        self._hits: dict[tuple, obs.Counter] = {}
        self._first_t: float | None = None
        self._last_t: float | None = None

    def note_compile(self, seconds: float) -> None:
        self._compiles.inc(1.0)
        self._compile_s.inc(seconds)

    def note_dispatch(self, key: tuple, requests: int,
                      candidates: int, wall_s: float) -> None:
        """Book one dispatch: its padded envelope, the real requests and
        candidates it carried, and its wall time."""
        self._score_s.inc(wall_s)
        self._wall_hist.observe(wall_s)
        now = time.perf_counter()
        if self._first_t is None:
            self._first_t = now
        self._last_t = now
        self._dispatches.inc(1.0)
        self._slots.inc(float(key[0]))
        self._requests.inc(float(requests))
        self._candidates.inc(float(candidates))
        hit = self._hits.get(key)
        if hit is None:
            hit = self._reg.counter("serve_bucket_hits",
                                    envelope="x".join(map(str, key)),
                                    **self._labels)
            self._hits[key] = hit
        hit.inc(float(requests))

    @property
    def requests(self) -> int:
        return int(self._requests.value)

    @property
    def candidates(self) -> int:
        return int(self._candidates.value)

    @property
    def dispatches(self) -> int:
        return int(self._dispatches.value)

    @property
    def slots(self) -> int:
        return int(self._slots.value)

    @property
    def compiles(self) -> int:
        """Envelope entries built (the reference's compile count)."""
        return int(self._compiles.value)

    @property
    def compile_seconds(self) -> float:
        return self._compile_s.value

    @property
    def score_seconds(self) -> float:
        return self._score_s.value

    @property
    def bucket_hits(self) -> dict[tuple, int]:
        return {k: int(c.value) for k, c in self._hits.items()}

    @property
    def latency_us(self) -> float:
        """Mean per-request scoring wall time (padding + device + sync);
        batched requests share their dispatch's wall time."""
        return self.score_seconds / self.requests * 1e6 if self.requests else 0.0

    @property
    def candidates_per_sec(self) -> float:
        return self.candidates / self.score_seconds if self.score_seconds else 0.0

    @property
    def occupancy(self) -> float:
        """Real requests per padded bundle slot (1.0 = no G padding)."""
        return self.requests / self.slots if self.slots else 0.0

    @property
    def qps(self) -> float:
        """Observed request rate over the scoring span (first to last
        dispatch); 0 until two dispatches have landed."""
        if self._first_t is None or self._last_t == self._first_t:
            return 0.0
        return self.requests / (self._last_t - self._first_t)

    def as_dict(self) -> dict:
        return {
            "requests": self.requests,
            "candidates": self.candidates,
            "dispatches": self.dispatches,
            "slots": self.slots,
            "occupancy": self.occupancy,
            "qps": self.qps,
            "compiles": self.compiles,
            "compile_seconds": self.compile_seconds,
            "score_seconds": self.score_seconds,
            "latency_us": self.latency_us,
            "candidates_per_sec": self.candidates_per_sec,
            "bucket_hits": {"x".join(map(str, k)): v
                            for k, v in self.bucket_hits.items()},
        }


class _Envelope(NamedTuple):
    """One envelope's prebuilt buffers: host (pinned on a card) and
    device request tensors, and the fixed session ids."""

    host: tuple[torch.Tensor, ...]  # ui, uv, ai, av
    dev: tuple[torch.Tensor, ...]
    session_id: torch.Tensor  # (G*N,) int64 on the device


class ScoringEngine:
    """Steady-state no-rebuild bundle scorer (see module docstring)."""

    def __init__(self, model, *, device=None, dedup: bool = True,
                 k_buckets: Sequence[int] = DEFAULT_K_BUCKETS,
                 n_buckets: Sequence[int] = DEFAULT_N_BUCKETS,
                 g_buckets: Sequence[int] = DEFAULT_G_BUCKETS):
        self.device = resolve_device(device)
        self._model = as_model(model, self.device)
        self._dedup = dedup
        self._k_buckets = tuple(sorted(k_buckets))
        self._n_buckets = tuple(sorted(n_buckets))
        self._g_buckets = tuple(sorted(g_buckets))
        self._pad_id = self._model.num_features  # original-space pad id
        # entries key on the model dtype too, as the reference's cache does
        self._dtype = "int8" if self._model.is_int8 else "fp32"
        self._entries: dict[tuple, _Envelope] = {}
        self.stats = EngineStats()
        self._dispatch_ctx = ("direct", 0.0)  # (flush reason, queue delay us)

    @property
    def g_buckets(self) -> tuple[int, ...]:
        return self._g_buckets

    @property
    def max_batch(self) -> int:
        """Largest bundle count one dispatch carries (top G bucket)."""
        return self._g_buckets[-1]

    @property
    def envelope_keys(self) -> list[tuple]:
        """The (G, Ku, Ka, N, dtype) keys built so far."""
        return list(self._entries)

    def envelope(self, request: BundleRequest) -> tuple[int, int, int]:
        """The (K_user, K_ad, N) bucket this request is served under."""
        ku = round_up(request.user_ids.shape[-1], self._k_buckets)
        ka = round_up(request.ad_ids.shape[-1], self._k_buckets)
        n = round_up(request.ad_ids.shape[0], self._n_buckets)
        return ku, ka, n

    def _entry(self, key: tuple) -> _Envelope:
        entry = self._entries.get(key)
        if entry is None:
            g, ku, ka, n = key[:4]
            t0 = time.perf_counter()
            with obs.get_tracer().span("serve/compile",
                                       envelope="x".join(map(str, key))):
                pin = self.device.type == "cuda"
                host = (torch.empty((g, ku), dtype=torch.int32, pin_memory=pin),
                        torch.empty((g, ku), dtype=torch.float32, pin_memory=pin),
                        torch.empty((g * n, ka), dtype=torch.int32,
                                    pin_memory=pin),
                        torch.empty((g * n, ka), dtype=torch.float32,
                                    pin_memory=pin))
                dev = tuple(torch.empty_like(h, device=self.device)
                            for h in host)
                session = torch.arange(g, device=self.device).repeat_interleave(n)
                entry = _Envelope(host, dev, session)
            self.stats.note_compile(time.perf_counter() - t0)
            self._entries[key] = entry
        return entry

    def _run(self, entry: _Envelope) -> torch.Tensor:
        """Copy the host buffers to the device and score them."""
        for h, d in zip(entry.host, entry.dev):
            d.copy_(h, non_blocking=True)
        ui, uv, ai, av = entry.dev
        return score_bundles(self._model,
                             ScoreBundle(ui, uv, ai, av, entry.session_id),
                             dedup=self._dedup)

    @contextmanager
    def dispatch_context(self, flush_reason: str, queue_delay_us: float):
        """Attribute the dispatches inside this scope to a micro-batch
        flush (the queue wraps its drains in this so ``serve_dispatch``
        ledger records carry the flush reason and queue delay)."""
        prev = self._dispatch_ctx
        self._dispatch_ctx = (flush_reason, float(queue_delay_us))
        try:
            yield
        finally:
            self._dispatch_ctx = prev

    def warm(self, envelopes: Sequence[tuple[int, int, int]], *,
             batch_sizes: Sequence[int] = (1,)) -> None:
        """Build a bucket set (deploy-time, off the request path) and run
        one all-pad dispatch through each new entry, so the first real
        request of every envelope finds everything in place. The warm-up
        dispatches are not booked in the stats."""
        for ku, ka, n in envelopes:
            for g in batch_sizes:
                key = (round_up(g, self._g_buckets), ku, ka, n, self._dtype)
                if key in self._entries:
                    continue
                entry = self._entry(key)
                self._fill(entry, [])
                self._run(entry)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _fill(self, entry: _Envelope, requests: Sequence[BundleRequest]) -> None:
        """Write same-envelope requests into the entry's host buffers:
        request s owns user row s and candidate rows [s*n, (s+1)*n); the
        rest are all-pad (their scores come out 0.5 and are sliced off)."""
        ui, uv, ai, av = (h.numpy() for h in entry.host)
        n = ai.shape[0] // ui.shape[0]
        ui.fill(self._pad_id)
        uv.fill(0.0)
        ai.fill(self._pad_id)
        av.fill(0.0)
        for s, r in enumerate(requests):
            ui[s, :r.user_ids.shape[-1]] = r.user_ids
            uv[s, :r.user_vals.shape[-1]] = r.user_vals
            n_real, ka_real = r.ad_ids.shape
            ai[s * n:s * n + n_real, :ka_real] = r.ad_ids
            av[s * n:s * n + n_real, :ka_real] = r.ad_vals

    def _score_chunk(self, requests: Sequence[BundleRequest],
                     env: tuple[int, int, int]) -> list[np.ndarray]:
        """One dispatch: requests fitting ``env``, len <= max_batch."""
        ku, ka, n = env
        key = (round_up(len(requests), self._g_buckets), ku, ka, n,
               self._dtype)
        entry = self._entry(key)  # build time books separately
        t0 = time.perf_counter()
        with obs.get_tracer().span("serve/dispatch", g=key[0],
                                   envelope="x".join(map(str, key))):
            self._fill(entry, requests)
            p = self._run(entry)
            self._sync()
            p = p.cpu().numpy().reshape(key[0], n)
        wall = time.perf_counter() - t0
        n_cands = sum(r.ad_ids.shape[0] for r in requests)
        self.stats.note_dispatch(key, len(requests), n_cands, wall)
        led = obs.get_ledger()
        if led.enabled:
            reason, qdelay = self._dispatch_ctx
            led.emit(
                "serve_dispatch", envelope=list(key), g=key[0],
                requests=len(requests), candidates=n_cands,
                occupancy=len(requests) / key[0], wall_s=wall,
                flush_reason=reason, queue_delay_us=qdelay)
        out = [p[s, :r.ad_ids.shape[0]] for s, r in enumerate(requests)]
        mon = obs.get_monitor()
        if mon.enabled:
            mon.observe_dispatch(out, requests)
        return out

    def score(self, request: BundleRequest) -> np.ndarray:
        """p(y=1|x) for each of the request's N candidates, in order
        (a G=1 dispatch)."""
        return self._score_chunk([request], self.envelope(request))[0]

    def score_batch(self, requests: Sequence[BundleRequest]) -> list[np.ndarray]:
        """Score a wavefront, batching same-envelope requests into G>1
        dispatches (groups bigger than ``max_batch`` split). Returns
        per-request scores in INPUT order, bitwise what :meth:`score`
        returns for each request alone."""
        results: list[np.ndarray | None] = [None] * len(requests)
        groups: dict[tuple[int, int, int], list[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(self.envelope(r), []).append(i)
        cap = self.max_batch
        for env, idxs in groups.items():
            for s in range(0, len(idxs), cap):
                chunk = idxs[s:s + cap]
                scores = self._score_chunk([requests[i] for i in chunk], env)
                for i, p in zip(chunk, scores):
                    results[i] = p
        return results  # type: ignore[return-value]

    def score_batch_at(self, requests: Sequence[BundleRequest],
                       env: tuple[int, int, int]) -> list[np.ndarray]:
        """Score a wavefront at ONE caller-chosen envelope every request
        must fit — the queue's cross-envelope COALESCED flush. Scores are
        bitwise what per-envelope dispatch returns: widening only adds
        pad slots, which the kernel skips (and the plain version adds as
        exact zeros)."""
        ku, ka, n = env
        for r in requests:
            if (r.user_ids.shape[-1] > ku or r.ad_ids.shape[-1] > ka
                    or r.ad_ids.shape[0] > n):
                raise ValueError(
                    f"request (Ku={r.user_ids.shape[-1]}, "
                    f"Ka={r.ad_ids.shape[-1]}, N={r.ad_ids.shape[0]}) "
                    f"does not fit envelope {env}")
        out: list[np.ndarray] = []
        for s in range(0, len(requests), self.max_batch):
            out += self._score_chunk(requests[s:s + self.max_batch], env)
        return out

    def score_many(self, requests: Sequence[BundleRequest]) -> list[np.ndarray]:
        """One-request-at-a-time replay (the un-batched baseline)."""
        return [self.score(r) for r in requests]


def envelope_closure(
        envelopes: Sequence[tuple[int, int, int]]
) -> set[tuple[int, int, int]]:
    """Close an envelope set under elementwise max (the cross product of
    observed component values): a coalesced flush dispatches at the
    elementwise max of its members, which always lands in this set."""
    envs = list(envelopes)
    if not envs:
        return set()
    kus = {e[0] for e in envs}
    kas = {e[1] for e in envs}
    ns = {e[2] for e in envs}
    return {(ku, ka, n) for ku in kus for ka in kas for n in ns}


def synthetic_requests(num: int, *, num_features: int,
                       k_user: tuple[int, int] = (12, 24),
                       k_ad: tuple[int, int] = (6, 12),
                       n_ads: tuple[int, int] = (10, 30),
                       seed: int = 0) -> list[BundleRequest]:
    """Ragged random request traffic (the reference's generator, same
    numpy draws): every request draws its own Ku, Ka and N uniformly from
    the given ranges (inclusive), ids uniform over the ORIGINAL space."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        ku = int(rng.integers(k_user[0], k_user[1] + 1))
        ka = int(rng.integers(k_ad[0], k_ad[1] + 1))
        n = int(rng.integers(n_ads[0], n_ads[1] + 1))
        out.append(BundleRequest(
            user_ids=rng.integers(0, num_features, (ku,)).astype(np.int32),
            user_vals=(rng.normal(size=(ku,)) / np.sqrt(ku)).astype(np.float32),
            ad_ids=rng.integers(0, num_features, (n, ka)).astype(np.int32),
            ad_vals=(rng.normal(size=(n, ka)) / np.sqrt(ka)).astype(np.float32),
        ))
    return out
