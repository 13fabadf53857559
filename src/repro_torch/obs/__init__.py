"""Observability for the port: metrics registry, span tracing, run ledger.

The port's copy of ``repro.obs`` (``obs/__init__.py:150-252``), without
the health monitor, drift detectors and report renderer, which arrive
with their own queue item. Everything is DISABLED by default (null
tracer, null ledger, an idle registry); drivers call :func:`configure`
with their ``--metrics-out``/``--trace-out``/``--ledger-out`` flags and
close the returned session when done.
"""
from __future__ import annotations

from .fileio import atomic_write  # noqa: F401
from .ledger import (  # noqa: F401
    NULL_LEDGER,
    NullLedger,
    RunLedger,
    SCHEMA,
    get_ledger,
    log,
    read_jsonl,
    set_ledger,
    validate_event,
    validate_events,
    validate_file,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    next_instance,
    set_registry,
)
from .trace import (  # noqa: F401
    NULL_SPAN,
    NULL_TRACER,
    Tracer,
    get_tracer,
    set_tracer,
)


class ObsSession:
    """A configured observability scope: owns the enabled tracer/ledger
    it installed as process defaults and knows where to write snapshots.
    ``close()`` writes the metrics/trace files (if requested), closes the
    ledger file and restores the previous defaults — idempotent."""

    def __init__(self, *, metrics_out=None, trace_out=None, registry=None,
                 tracer=None, ledger=None, prev_tracer=None,
                 prev_ledger=None):
        self.metrics_out = metrics_out
        self.trace_out = trace_out
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.ledger = ledger if ledger is not None else get_ledger()
        self._prev_tracer = prev_tracer
        self._prev_ledger = prev_ledger
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.metrics_out:
            self.registry.write(self.metrics_out)
        if self.trace_out:
            self.tracer.write(self.trace_out)
        self.ledger.close()
        if self._prev_tracer is not None:
            set_tracer(self._prev_tracer)
        if self._prev_ledger is not None:
            set_ledger(self._prev_ledger)

    def __enter__(self) -> "ObsSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def configure(*, metrics_out: str | None = None, trace_out: str | None = None,
              ledger_out: str | None = None, trace_annotate: bool = False,
              meta: dict | None = None) -> ObsSession:
    """Install enabled process defaults for whichever outputs the driver
    asked for and return the owning :class:`ObsSession`. A tracer is
    enabled only when ``trace_out`` is given, a file-backed ledger only
    when ``ledger_out`` is; ``meta`` becomes the ledger's leading
    ``run_meta`` record. With no arguments this is a no-op session."""
    prev_tracer = prev_ledger = None
    tracer = get_tracer()
    ledger = get_ledger()
    if trace_out:
        tracer = Tracer(enabled=True, annotate=trace_annotate)
        prev_tracer = set_tracer(tracer)
    if ledger_out:
        ledger = RunLedger(ledger_out)
        prev_ledger = set_ledger(ledger)
        if meta:
            ledger.emit("run_meta", **meta)
    return ObsSession(metrics_out=metrics_out, trace_out=trace_out,
                      registry=get_registry(), tracer=tracer, ledger=ledger,
                      prev_tracer=prev_tracer, prev_ledger=prev_ledger)


def add_flags(parser) -> None:
    """The launch drivers' shared observability flags."""
    parser.add_argument("--metrics-out", default=None, metavar="PATH",
                        help="write a metrics-registry snapshot on exit "
                             "(.jsonl = one series per line, else JSON)")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="record spans and write Chrome-trace JSON on "
                             "exit (open in chrome://tracing or Perfetto)")
    parser.add_argument("--ledger-out", default=None, metavar="PATH",
                        help="append typed run-ledger records (JSONL), one "
                             "per dispatch")
    parser.add_argument("--trace-annotate", action="store_true",
                        help="with --trace-out: mirror spans into "
                             "torch.profiler / NVTX ranges so a profiler "
                             "trace shows them on the device timeline")


def configure_from_args(args, *, driver: str, device,
                        argv: list[str]) -> ObsSession:
    """:func:`configure` from parsed :func:`add_flags` arguments, with a
    ``run_meta`` record carrying the driver's ``argv`` and the device
    context (``device`` is the resolved ``torch.device`` it runs on)."""
    import torch

    meta: dict = {"driver": driver, "backend": device.type,
                  "argv": list(argv)}
    if device.type == "cuda":
        meta["device_count"] = torch.cuda.device_count()
        meta["device_name"] = torch.cuda.get_device_name(device)
    else:
        meta["device_count"] = 1
    return configure(metrics_out=args.metrics_out, trace_out=args.trace_out,
                     ledger_out=args.ledger_out,
                     trace_annotate=args.trace_annotate, meta=meta)
