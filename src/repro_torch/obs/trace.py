"""Context-manager span tracing with Chrome-trace/Perfetto export.

A :class:`Tracer` records host-side spans — nested, thread-safe (the
serving queue's pump thread and the caller's thread interleave into one
timeline, separated by their ``tid``) — and exports the Chrome trace
event format that ``chrome://tracing`` and https://ui.perfetto.dev load
directly: one ``"ph": "X"`` complete event per span with microsecond
``ts``/``dur`` relative to the tracer's epoch, plus one ``"M"`` metadata
event naming each thread.

When ``annotate=True`` every span also enters a
``torch.profiler.record_function`` range (seen by an active
``torch.profiler`` trace) and, on a machine with a card, a
``torch.cuda.nvtx`` range, so the host spans line up with the kernels
on the device timeline. Annotation is off by default.

Disabled fast path: ``Tracer(enabled=False)`` (and the module's default
tracer until a launch driver configures ``--trace-out``) hands out one
shared no-op context manager — a span in cold code costs a method call
and nothing else.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_ann", "_nvtx")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0
        self._ann = None
        self._nvtx = False

    def __enter__(self) -> "_Span":
        if self._tracer.annotate:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self.name, self._t0, t1, self.args)


class Tracer:
    """Span recorder; see the module docstring."""

    def __init__(self, *, enabled: bool = True, annotate: bool = False):
        self.enabled = enabled
        self.annotate = annotate
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        self._named_tids: set[int] = set()

    def span(self, name: str, **args):
        """``with tracer.span("serve/dispatch", g=4): ...`` — records one
        complete event on exit. No-op (shared null span) when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def step_span(self, name: str, step: int, **args):
        """A span for one optimizer step (``step`` recorded in its args);
        no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, {"step": step, **args})

    def _record(self, name: str, t0_ns: int, t1_ns: int, args: dict) -> None:
        tid = threading.get_ident()
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,  # us
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": self._pid,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        with self._lock:
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            self._events.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> dict:
        """The Chrome trace event JSON document (Perfetto-loadable)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Atomic (temp + ``os.replace``): a crash mid-export leaves the
        previous trace intact, never a truncated JSON document."""
        from repro_torch.obs.fileio import atomic_write

        with atomic_write(path) as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")
        return path


NULL_TRACER = Tracer(enabled=False)
_DEFAULT = NULL_TRACER


def get_tracer() -> Tracer:
    """The process default tracer — disabled until a driver configures
    ``--trace-out`` (see ``repro_torch.obs.configure``)."""
    return _DEFAULT


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process default tracer; returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, tracer
    return prev
