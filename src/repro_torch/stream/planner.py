"""Overlapped host re-planner: build the next window's plans and move them
to the device behind the current window's device steps.

The port's counterpart of ``repro/stream/planner.py``. Per window the
streaming trainer pays host-side costs before the device can step:

  1. slide the window (concatenate the last W days on the host);
  2. build the transpose plans (one argsort + linear passes per id
     tensor, ``data/sparse.build_batch_plans``); on a mesh, route the
     window and slice its plans per (data block, id range) and keep this
     rank's cell (``repro_torch.shard``);
  3. pin the batch and its plans and copy them to the device.

All three are independent of the CURRENT window's device work, so
:class:`WindowPlanner` runs them on one background thread
(``ThreadPoolExecutor``): while the device grinds window t's inner OWLQN+
iterations, the host builds window t+1. The copy runs on a dedicated
``torch.cuda.Stream`` from pinned buffers with ``non_blocking=True`` and
records an event (:func:`to_device`); :meth:`WindowPlanner.get` makes the
consumer's stream wait on that event and marks every tensor of the window
as used on the consumer's stream (``record_stream``), so the caching
allocator never hands its memory out while a step still reads it. This
takes the place of the reference's thread plus AOT compile: there is no
compile, so ``compile_seconds`` stays 0.0. ``overlap=False`` (the
drivers' ``--sync-planner``) builds each window inline in ``get`` and
copies it with plain blocking ``.to(device)`` calls on the consumer's
stream — no thread, no side stream, no event — so it is an independent
witness for the overlapped schedule: a serial schedule, identical
results.

Overlap accounting: every build is timed inside the worker; every
``get`` times how long the trainer actually BLOCKED. The overlap ratio is
the fraction of prefetched build time hidden behind device work —
``1 - wait / build`` over prefetched windows (the first window of a run
has nothing to hide behind and is excluded). The accounting lives in the
metrics registry (``stream_planner_*`` counters, one labelled family per
planner); :attr:`WindowPlanner.stats` reads them back with the
reference's ``+=`` arithmetic in the reference's order. Builds run inside
``stream/plan_window`` spans on the worker thread and blocked time inside
``stream/wait`` on the trainer's thread.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import obs
from repro_torch.data.sparse import build_batch_plans


class PreparedWindow(NamedTuple):
    """Everything the trainer needs to step a window."""

    day: int
    batch: Any          # planned SparseCTRBatch | this rank's ShardCell
    step: Any           # callable(state) -> (state, stats), ready to run
    build_seconds: float = 0.0
    plan_seconds: float = 0.0     # slide + plan + pin + copy share
    compile_seconds: float = 0.0  # always 0.0: nothing is compiled
    wait_seconds: float = 0.0     # how long get() blocked (stamped by planner)
    prefetched: bool = False      # built in the background vs inline
    ready: Any = None   # torch.cuda.Event after the window's H2D copies


class PlannerStats(NamedTuple):
    windows: int                 # windows served
    build_seconds: float         # total host build time (all windows)
    wait_seconds: float          # total time the trainer blocked
    prefetched_build_seconds: float  # build time of prefetched windows
    prefetched_wait_seconds: float   # blocked time on prefetched windows

    @property
    def overlap_ratio(self) -> float:
        """Fraction of prefetched build time hidden behind device work."""
        if self.prefetched_build_seconds <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.prefetched_wait_seconds
                   / self.prefetched_build_seconds)


def plan_window(batch, *, partition=None, data_shards: int = 1, mesh=None):
    """Prepare one window's batch, on the batch's device (the host, for a
    :class:`~repro_torch.stream.source.DayStream` window): attach fresh
    transpose plans; with a ``partition`` also route and slice them for a
    (data x model) mesh (a ``repro_torch.shard.ShardedSparseBatch``), and
    with a ``mesh`` keep this rank's cell of it (a ``ShardCell``)."""
    if partition is None:
        if mesh is not None:
            raise ValueError("mesh given without a partition: the sharded "
                             "stream routes by id range")
        return build_batch_plans(batch)
    sb = build_batch_plans(batch, shards=partition, data_shards=data_shards)
    if mesh is not None:
        from repro_torch.dist import shard_sparse_batch

        sb = shard_sparse_batch(mesh, sb)
    return sb


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor of a batch NamedTuple,
    a plan dataclass or a tuple of tensors (other leaves kept)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if hasattr(obj, "_fields"):
        return obj._replace(**{f: _map_tensors(getattr(obj, f), fn)
                               for f in obj._fields})
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_map_tensors(x, fn) for x in obj)
    return obj


def _tensors(obj):
    """Every tensor of a batch NamedTuple, a plan dataclass or a tuple."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif hasattr(obj, "_fields") or isinstance(obj, tuple):
        for x in obj:
            yield from _tensors(x)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def to_device(batch, device: torch.device, stream=None):
    """Move a planned host batch to ``device``; returns ``(device batch,
    event)``. With a ``stream`` (the overlapped planner's dedicated copy
    stream) every tensor is pinned and copied with ``non_blocking=True``
    on it, and an event is recorded there after the last copy. Without
    one, the copies are plain ``.to(device)`` calls on the current stream
    and the host waits for them to land: no event, no side stream. On
    the CPU the host batch is returned as it is, with no event."""
    if device.type != "cuda":
        return batch, None
    if stream is None:
        moved = _map_tensors(batch, lambda t: t.to(device))
        torch.cuda.synchronize(device)
        return moved, None
    with torch.cuda.device(device), torch.cuda.stream(stream):
        moved = _map_tensors(batch, lambda t: t.pin_memory().to(
            device, non_blocking=True))
        ready = torch.cuda.Event()
        ready.record()
    return moved, ready


class WindowPlanner:
    """Double-buffered background builder of :class:`PreparedWindow`s.

    Protocol (the trainer's loop)::

        for t in days:
            win = planner.get(t)       # blocks only on un-hidden build time
            planner.prefetch(t + 1)    # next window builds DURING stepping
            ... run win.step inner_iters times ...
        planner.close()

    ``overlap=False`` degrades ``get`` to a synchronous build (prefetch
    becomes a no-op) — identical results, serial schedule.
    """

    def __init__(self, build: Callable[[int], PreparedWindow], *,
                 overlap: bool = True, registry=None):
        self._build = build
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="replanner") if overlap else None
        self._pending: dict[int, Future] = {}
        reg = registry if registry is not None else obs.get_registry()
        labels = {"planner": obs.next_instance("planner")}
        self._windows = reg.counter("stream_planner_windows", **labels)
        self._build_s = reg.counter("stream_planner_build_seconds", **labels)
        self._wait_s = reg.counter("stream_planner_wait_seconds", **labels)
        self._pre_build_s = reg.counter(
            "stream_planner_prefetched_build_seconds", **labels)
        self._pre_wait_s = reg.counter(
            "stream_planner_prefetched_wait_seconds", **labels)
        self._build_hist = reg.histogram(
            "stream_planner_build_wall_seconds", **labels)

    @property
    def overlap(self) -> bool:
        return self._pool is not None

    def _timed(self, day: int) -> PreparedWindow:
        t0 = time.perf_counter()
        with obs.get_tracer().span("stream/plan_window", day=day):
            out = self._build(day)
        dt = time.perf_counter() - t0
        self._build_hist.observe(dt)
        return out._replace(build_seconds=dt)

    def prefetch(self, day: int) -> None:
        """Start building ``day`` in the background (no-op when
        synchronous or already pending)."""
        if self._pool is None or day in self._pending:
            return
        self._pending[day] = self._pool.submit(self._timed, day)

    def get(self, day: int) -> PreparedWindow:
        """The prepared window for ``day`` — joins the background build if
        one is pending, else builds synchronously right here. A window
        whose batch was copied to a card is ordered after its copies on
        the caller's current stream."""
        fut = self._pending.pop(day, None)
        t0 = time.perf_counter()
        prefetched = fut is not None
        if fut is None:
            out = self._timed(day)
            wait = out.build_seconds  # fully exposed
        else:
            with obs.get_tracer().span("stream/wait", day=day):
                out = fut.result()
            wait = time.perf_counter() - t0
            self._pre_build_s.inc(out.build_seconds)
            self._pre_wait_s.inc(min(wait, out.build_seconds))
        if out.ready is not None:
            consumer = torch.cuda.current_stream()
            consumer.wait_event(out.ready)
            for t in _tensors(out.batch):
                t.record_stream(consumer)
        self._windows.inc(1.0)
        self._build_s.inc(out.build_seconds)
        self._wait_s.inc(wait)
        return out._replace(wait_seconds=wait, prefetched=prefetched)

    @property
    def stats(self) -> PlannerStats:
        """The familiar tuple, read back out of the registry counters."""
        return PlannerStats(
            windows=int(self._windows.value),
            build_seconds=self._build_s.value,
            wait_seconds=self._wait_s.value,
            prefetched_build_seconds=self._pre_build_s.value,
            prefetched_wait_seconds=self._pre_wait_s.value)

    def close(self) -> None:
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "WindowPlanner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
