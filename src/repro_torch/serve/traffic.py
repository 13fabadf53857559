"""Traffic shaping for the scoring engine: a micro-batching request
queue and an open-loop Poisson load generator.

The port's copy of ``repro/serve/traffic.py`` (host Python over the
port's :class:`~repro_torch.serve.engine.ScoringEngine`).

The paper's models serve hundreds of millions of users; what makes that
affordable is never scoring one page view per device dispatch. The
:class:`MicroBatchQueue` sits in front of a
:class:`~repro_torch.serve.engine.ScoringEngine` and turns an arrival stream
into the engine's batched ``G > 1`` dispatches:

  * arrivals group by their (Ku, Ka, N) envelope — only same-envelope
    requests can stack into one executable call;
  * a group FLUSHES when it reaches ``max_batch`` requests (full flush:
    best amortisation) or when its oldest request has waited
    ``max_delay_us`` (deadline flush: a tail-latency bound — batching
    may never hold a request longer than the deadline);
  * ADMISSION CONTROL: when ``max_pending`` requests are already queued
    the submit is rejected (load shedding) instead of growing an
    unbounded backlog — under overload the queue degrades to bounded
    latency + explicit drops, never to unbounded wait;
  * CROSS-ENVELOPE COALESCING (``coalesce=True``): when several small
    per-envelope groups are due at once (the low-QPS regime, where
    deadline flushes dominate and every group is tiny), they dispatch in
    ONE device round at the widest due envelope
    (``ScoringEngine.score_batch_at`` — elementwise max of the member
    envelopes, itself a bucket edge) instead of one round each. Scores
    are bitwise what per-envelope dispatch returns (widening only adds
    pad slots, which alias the zero pad row); the flush mix books these
    rounds under reason ``"coalesced"`` with the merged-group count, so
    occupancy gains from coalescing are visible, not silently folded
    into the deadline rows.

Two front-door modes: the virtual-clock methods below (replay,
benchmarks), and :class:`RealClockPump` — a small thread that sleeps to
:meth:`MicroBatchQueue.next_deadline` and calls ``flush_due(now)`` with
WALL time, so the same queue serves live traffic outside a replay loop
(deterministic shutdown: ``stop()`` joins the thread, then drains).

:func:`derive_g_buckets` closes the loop from measurement back to
deploy config: given a queue's measured flush-size mix it derives the
engine ``g_buckets`` set that covers the traffic (and warns when the
top bucket saturates — the signal to raise ``max_batch``).

Time is a caller-supplied virtual clock (monotonic seconds): the queue
never sleeps, it just orders events. A live server would feed
``time.perf_counter()``; tests and the load generator feed synthetic
arrival timestamps, which makes every flush decision deterministic and
replayable. Service times are REAL, though — each flush runs the actual
engine dispatch and the measured wall time advances the (single,
serial) server: flush start = max(trigger time, server free), and every
request in the batch completes when its dispatch finishes. A batch is
sealed at its trigger; arrivals while the server is busy join the next
one.

:func:`replay_open_loop` is the benchmark harness: OPEN-LOOP arrivals
(Poisson with rate ``qps``, drawn up front, independent of completions
— the standard way to measure tail latency without the coordinated-
omission trap of closed-loop clients) replayed through the queue,
reporting p50/p99/mean latency, candidates/sec, achieved QPS, batch
occupancy and drop counts; ``python -m repro_torch.launch.serve
--load-qps`` prints it per offered rate.
"""
from __future__ import annotations

import threading
import time
from typing import Mapping, NamedTuple, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.serve.engine import (
    DEFAULT_G_BUCKETS,
    BundleRequest,
    ScoringEngine,
)


class QueueConfig(NamedTuple):
    """Micro-batching knobs (see module docstring)."""

    max_batch: int = 8  # full-flush size (kept <= engine.max_batch)
    max_delay_us: float = 2_000.0  # deadline: max queueing delay per request
    max_pending: int = 256  # admission: reject submits past this backlog
    coalesce: bool = False  # merge several due groups into one dispatch


class Completion(NamedTuple):
    """One served request: scores + the timeline that produced them."""

    ticket: int
    scores: np.ndarray  # (N_real,) p(y=1|x), request order
    arrival: float  # virtual seconds
    started: float  # flush execution start (>= arrival)
    completed: float  # started + measured dispatch wall time
    reason: str  # "full" | "deadline" | "drain" | "coalesced"

    @property
    def latency_us(self) -> float:
        return (self.completed - self.arrival) * 1e6


class QueueStats:
    """Queue counters (one labeled family per queue) — a registry view
    with the same ``accepted``/``rejected``/``flushes`` API as before."""

    _REASONS = ("full", "deadline", "drain", "coalesced")

    def __init__(self, registry=None):
        reg = registry if registry is not None else obs.get_registry()
        self._reg = reg
        self._labels = {"queue": obs.next_instance("queue")}
        labels = self._labels
        self._accepted = reg.counter("serve_queue_accepted", **labels)
        self._rejected = reg.counter("serve_queue_rejected", **labels)
        self._flushes = {r: reg.counter("serve_queue_flushes",
                                        reason=r, **labels)
                         for r in self._REASONS}
        self._delay_hist = reg.histogram("serve_queue_delay_seconds",
                                         **labels)
        self._pending = reg.gauge("serve_queue_pending", **labels)
        # merged-group count of coalesced rounds (>= 2 per such round):
        # flushes["coalesced"] rounds served this many per-envelope groups
        self._coalesced_groups = reg.counter("serve_queue_coalesced_groups",
                                             **labels)
        # exact flush-size mix {requests in round: rounds} — the input to
        # derive_g_buckets, and how occupancy per reason stays auditable
        self._sizes: dict[int, object] = {}

    def note_accept(self) -> None:
        self._accepted.inc(1.0)

    def note_pending(self, n: int) -> None:
        self._pending.set(float(n))

    def note_reject(self) -> None:
        self._rejected.inc(1.0)

    def note_flush(self, reason: str, queue_delay_s: float,
                   size: int | None = None, groups: int = 1) -> None:
        self._flushes[reason].inc(1.0)
        self._delay_hist.observe(queue_delay_s)
        if groups > 1:
            self._coalesced_groups.inc(float(groups))
        if size is not None:
            counter = self._sizes.get(size)
            if counter is None:
                counter = self._reg.counter("serve_queue_flush_size",
                                            size=str(size), **self._labels)
                self._sizes[size] = counter
            counter.inc(1.0)

    @property
    def accepted(self) -> int:
        return int(self._accepted.value)

    @property
    def rejected(self) -> int:
        return int(self._rejected.value)

    @property
    def flushes(self) -> dict[str, int]:
        return {r: int(c.value) for r, c in self._flushes.items()}

    @property
    def coalesced_groups(self) -> int:
        return int(self._coalesced_groups.value)

    @property
    def flush_sizes(self) -> dict[int, int]:
        """Measured flush-size mix {batch size: flush count}."""
        return {s: int(c.value) for s, c in sorted(self._sizes.items())}

    def as_dict(self) -> dict:
        return {"accepted": self.accepted, "rejected": self.rejected,
                "flushes": dict(self.flushes),
                "coalesced_groups": self.coalesced_groups,
                "flush_sizes": dict(self.flush_sizes)}


class MicroBatchQueue:
    """Deadline-aware micro-batching front of a :class:`ScoringEngine`.

    Single-threaded and virtual-clocked: callers push time forward via
    the ``now`` arguments (monotonic seconds, non-decreasing). Completed
    work accumulates in :attr:`completions` (also returned by the call
    that produced it).
    """

    def __init__(self, engine: ScoringEngine,
                 config: QueueConfig = QueueConfig()):
        if config.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {config.max_batch}")
        self.engine = engine
        self.config = config
        self.stats = QueueStats()
        self.completions: list[Completion] = []
        self._pending: dict[tuple[int, int, int],
                            list[tuple[int, BundleRequest, float]]] = {}
        self._next_ticket = 0
        self._busy_until = 0.0  # virtual time the serial server frees up

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def next_deadline(self) -> float | None:
        """Virtual time the oldest queued request must flush by."""
        oldest = [entries[0][2] for entries in self._pending.values() if entries]
        if not oldest:
            return None
        return min(oldest) + self.config.max_delay_us * 1e-6

    # ------------------------------------------------------------- events
    def submit(self, request: BundleRequest, now: float) -> int | None:
        """Enqueue one request at virtual time ``now``. Returns its
        ticket, or None when admission control sheds it. A group hitting
        ``max_batch`` flushes immediately (trigger time = ``now``)."""
        if self.pending >= self.config.max_pending:
            self.stats.note_reject()
            return None
        ticket = self._next_ticket
        self._next_ticket += 1
        env = self.engine.envelope(request)
        group = self._pending.setdefault(env, [])
        group.append((ticket, request, now))
        self.stats.note_accept()
        self.stats.note_pending(self.pending)
        if len(group) >= self.config.max_batch:
            self._flush(env, now, "full")
        return ticket

    def flush_due(self, now: float) -> list[Completion]:
        """Flush every group whose deadline has passed by ``now``
        (oldest-deadline first). With ``coalesce=True``, due groups merge
        into one dispatch at the widest due envelope while their combined
        size fits ``max_batch`` (bitwise-identical scores — see module
        docstring). Returns the completions produced."""
        delay_s = self.config.max_delay_us * 1e-6
        done: list[Completion] = []
        while True:
            due = sorted((entries[0][2], env)
                         for env, entries in self._pending.items() if entries)
            due = [(arr, env) for arr, env in due if arr + delay_s <= now]
            if not due:
                break
            if self.config.coalesce and len(due) >= 2:
                take: list[tuple[int, int, int]] = []
                total = 0
                for arr, env in due:
                    size = len(self._pending[env])
                    if take and total + size > self.config.max_batch:
                        break
                    take.append(env)
                    total += size
                if len(take) >= 2:
                    done += self._flush_coalesced(take, due[0][0] + delay_s)
                    continue
            oldest, env = due[0]
            done += self._flush(env, oldest + delay_s, "deadline")
        return done

    def drain(self, now: float) -> list[Completion]:
        """Flush everything still queued (shutdown / end of replay)."""
        done: list[Completion] = []
        for env in sorted(self._pending, key=lambda e: self._pending[e][0][2]):
            done += self._flush(env, now, "drain")
        return done

    # ------------------------------------------------------------ internals
    def _flush(self, env: tuple[int, int, int], trigger: float,
               reason: str) -> list[Completion]:
        entries = self._pending.pop(env)
        started = max(trigger, self._busy_until)
        # virtual queueing delay of the OLDEST request in the batch —
        # the figure the deadline bounds
        queue_delay_s = max(0.0, started - entries[0][2])
        self.stats.note_flush(reason, queue_delay_s, size=len(entries))
        self.stats.note_pending(self.pending)
        before = self.engine.stats.score_seconds
        with self.engine.dispatch_context(reason, queue_delay_s * 1e6):
            scores = self.engine.score_batch([r for _, r, _ in entries])
        wall = self.engine.stats.score_seconds - before
        completed = started + wall
        self._busy_until = completed
        out = [Completion(ticket=t, scores=p, arrival=arr, started=started,
                          completed=completed, reason=reason)
               for (t, _, arr), p in zip(entries, scores)]
        self.completions += out
        return out

    def _flush_coalesced(self, envs: Sequence[tuple[int, int, int]],
                         trigger: float) -> list[Completion]:
        """One device round for several due groups: requests merge in
        ticket (= arrival) order and dispatch at the elementwise-max
        envelope of the members, then completions slice back per ticket.
        Widening only adds pad slots (zero pad row), so the scores are
        bitwise what per-envelope dispatch would return."""
        widest = tuple(max(e[i] for e in envs) for i in range(3))
        entries = sorted((t for env in envs for t in self._pending.pop(env)),
                         key=lambda e: e[0])
        started = max(trigger, self._busy_until)
        queue_delay_s = max(0.0, started - min(arr for _, _, arr in entries))
        self.stats.note_flush("coalesced", queue_delay_s,
                              size=len(entries), groups=len(envs))
        self.stats.note_pending(self.pending)
        before = self.engine.stats.score_seconds
        with self.engine.dispatch_context("coalesced", queue_delay_s * 1e6):
            scores = self.engine.score_batch_at(
                [r for _, r, _ in entries], widest)
        wall = self.engine.stats.score_seconds - before
        completed = started + wall
        self._busy_until = completed
        out = [Completion(ticket=t, scores=p, arrival=arr, started=started,
                          completed=completed, reason="coalesced")
               for (t, _, arr), p in zip(entries, scores)]
        self.completions += out
        return out


def poisson_arrivals(num: int, qps: float, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of a rate-``qps`` Poisson
    process: iid exponential gaps, mean 1/qps."""
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=num))


def replay_open_loop(engine: ScoringEngine,
                     requests: Sequence[BundleRequest], *, qps: float,
                     config: QueueConfig = QueueConfig(),
                     seed: int = 0) -> dict:
    """Open-loop load test: replay ``requests`` with Poisson arrivals at
    offered rate ``qps`` through a fresh :class:`MicroBatchQueue`,
    returning the latency/throughput report (see module docstring).

    Warm the engine's envelopes first (``engine.warm(...,
    batch_sizes=engine.g_buckets)``) when measuring steady state —
    envelope builds book separately but would serialise early flushes.
    """
    queue = MicroBatchQueue(engine, config)
    arrivals = poisson_arrivals(len(requests), qps, seed)
    before = engine.stats.as_dict()
    for t, req in zip(arrivals, requests):
        queue.flush_due(t)
        queue.submit(req, t)
    queue.flush_due(arrivals[-1])
    queue.drain(arrivals[-1])
    comps = queue.completions
    lat = np.array([c.latency_us for c in comps]) if comps else np.zeros(1)
    makespan = (max(c.completed for c in comps) - arrivals[0]) if comps else 0.0
    served_candidates = sum(c.scores.shape[0] for c in comps)
    after = engine.stats.as_dict()
    dispatches = after["dispatches"] - before["dispatches"]
    slots = after["slots"] - before["slots"]
    return {
        "offered_qps": qps,
        "requests": len(requests),
        "served": len(comps),
        "rejected": queue.stats.rejected,
        "achieved_qps": float(len(comps) / makespan) if makespan else 0.0,
        "candidates_per_sec":
            float(served_candidates / makespan) if makespan else 0.0,
        "latency_p50_us": float(np.percentile(lat, 50)),
        "latency_p99_us": float(np.percentile(lat, 99)),
        "latency_mean_us": float(lat.mean()),
        "dispatches": dispatches,
        "occupancy": len(comps) / slots if slots else 0.0,
        "flushes": dict(queue.stats.flushes),
        "coalesced_groups": queue.stats.coalesced_groups,
        "flush_sizes": dict(queue.stats.flush_sizes),
        "max_batch": config.max_batch,
        "max_delay_us": config.max_delay_us,
        "max_pending": config.max_pending,
        "coalesce": config.coalesce,
    }


class RealClockPump:
    """Wall-clock front door for a :class:`MicroBatchQueue` (satellite of
    the virtual-clock design): a background thread sleeps until
    :meth:`MicroBatchQueue.next_deadline` and calls ``flush_due(now)``
    with real time, so deadline flushes fire on schedule without any
    caller-driven replay loop. ``submit()`` stamps arrivals with the same
    clock (and still triggers full flushes inline, on the caller's
    thread — the pump only owns deadlines).

    All queue access is serialised under one lock, so the queue itself
    stays single-threaded. Shutdown is DETERMINISTIC: ``stop()`` wakes
    the thread, joins it, then drains the queue — after it returns every
    accepted request has a completion and no timer is live.

    ``clock`` is injectable (default ``time.perf_counter``) so tests can
    drive the pump on a synthetic clock.
    """

    def __init__(self, queue: MicroBatchQueue, *, clock=time.perf_counter):
        self.queue = queue
        self.clock = clock
        self._cond = threading.Condition()
        self._stop = False
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RealClockPump":
        if self._thread is not None:
            raise RuntimeError("pump already started")
        self._stop = False
        self._thread = threading.Thread(target=self._run,
                                        name="repro-serve-pump", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> list[Completion]:
        """Stop the timer thread (join), then drain. Idempotent."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._cond:
            return self.queue.drain(self.clock()) if drain else []

    def __enter__(self) -> "RealClockPump":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- serving
    def submit(self, request: BundleRequest) -> int | None:
        """Enqueue at wall time; returns the ticket (None if shed)."""
        with self._cond:
            ticket = self.queue.submit(request, self.clock())
            self._cond.notify_all()  # re-arm the timer for the new deadline
            return ticket

    def completions(self) -> list[Completion]:
        with self._cond:
            return list(self.queue.completions)

    def _run(self) -> None:
        with self._cond:
            while not self._stop:
                deadline = self.queue.next_deadline()
                if deadline is None:
                    self._cond.wait()  # nothing queued: sleep until submit
                    continue
                wait_s = deadline - self.clock()
                if wait_s > 0:
                    self._cond.wait(timeout=wait_s)
                    continue  # re-check: stop flag / newer deadline
                self.queue.flush_due(self.clock())


def derive_g_buckets(stats, *, max_buckets: int = 6,
                     saturation_frac: float = 0.5) -> tuple[int, ...]:
    """Queue-aware ``g_buckets`` autoscaling: derive the engine bucket
    set from a measured flush-size mix.

    ``stats`` is a :class:`QueueStats` (its :attr:`~QueueStats.flush_sizes`)
    or a plain ``{flush size: count}`` mapping. Each observed size rounds
    up to the next power of two (matching the engine's bucket rounding);
    the bucket set is {1} plus the most-frequent rounded sizes, capped at
    ``max_buckets`` (the top edge is always kept — every observed flush
    must fit). With no observations the builtin default is returned.

    When at least ``saturation_frac`` of flushes land on the TOP bucket,
    an ``obs.log`` warning fires: traffic is pinned at the batch ceiling,
    so raising the queue's ``max_batch`` (then re-deriving) would batch
    deeper instead of splitting rounds.
    """
    if isinstance(stats, QueueStats):
        stats = stats.flush_sizes
    if not isinstance(stats, Mapping):
        raise TypeError(f"expected QueueStats or a mapping, got {type(stats)}")
    weight: dict[int, int] = {}
    for size, count in stats.items():
        size, count = int(size), int(count)
        if size < 1 or count < 1:
            continue
        edge = 1 << (size - 1).bit_length()  # next power of two >= size
        weight[edge] = weight.get(edge, 0) + count
    if not weight:
        return DEFAULT_G_BUCKETS
    top = max(weight)
    edges = {1, top}
    for edge in sorted(weight, key=lambda e: weight[e], reverse=True):
        if len(edges) >= max_buckets:
            break
        edges.add(edge)
    total = sum(weight.values())
    if weight[top] / total >= saturation_frac and top > 1:
        obs.log(f"derive_g_buckets: {weight[top]}/{total} flushes saturate "
                f"the top G bucket ({top}); raise the queue's max_batch and "
                "re-derive to batch deeper", level="warn")
    return tuple(sorted(edges))
