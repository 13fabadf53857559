"""Observability for the port: metrics registry, span tracing, run ledger,
health monitor, drift references and run reports.

The port's copy of ``repro.obs``. Everything is DISABLED by default (null
tracer, null ledger, null monitor, an idle registry); drivers call
:func:`configure` with their ``--metrics-out``/``--trace-out``/
``--ledger-out``/``--report-out``/``--monitor`` flags and close the
returned session when done.
"""
from __future__ import annotations

from .drift import (  # noqa: F401
    CalibrationTracker,
    DriftReference,
    IdTrafficTracker,
    ScoreDriftTracker,
    capture_reference,
    kl,
    load_drift_reference,
    psi,
    save_drift_reference,
)
from .fileio import atomic_write  # noqa: F401
from .ledger import (  # noqa: F401
    NULL_LEDGER,
    NullLedger,
    RunLedger,
    SCHEMA,
    get_ledger,
    log,
    read_jsonl,
    render_stream_day,
    render_train_iter,
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
from .monitor import (  # noqa: F401
    NULL_MONITOR,
    HealthMonitor,
    NullMonitor,
    RollingWindow,
    SLORule,
    default_rules,
    get_monitor,
    parse_rule,
    set_monitor,
)
from .trace import (  # noqa: F401
    NULL_SPAN,
    NULL_TRACER,
    Tracer,
    get_tracer,
    set_tracer,
)


class ObsSession:
    """A configured observability scope: owns the enabled tracer, ledger
    and monitor it installed as process defaults and knows where to write
    snapshots. ``close()`` settles the monitor, writes the metrics/trace
    files and the report (if requested), closes the ledger file and
    restores the previous defaults — idempotent, safe in a ``finally``."""

    def __init__(self, *, metrics_out=None, trace_out=None,
                 report_out=None, registry=None, tracer=None, ledger=None,
                 monitor=None, prev_tracer=None, prev_ledger=None,
                 prev_monitor=None):
        self.metrics_out = metrics_out
        self.trace_out = trace_out
        self.report_out = report_out
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.ledger = ledger if ledger is not None else get_ledger()
        self.monitor = monitor if monitor is not None else get_monitor()
        self._prev_tracer = prev_tracer
        self._prev_ledger = prev_ledger
        self._prev_monitor = prev_monitor
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.monitor.enabled:
            # settle any partial hysteresis window before the snapshot
            self.monitor.evaluate()
            self.monitor.detach()
        if self.metrics_out:
            self.registry.write(self.metrics_out)
        if self.trace_out:
            self.tracer.write(self.trace_out)
        if self.report_out:
            from . import report as _report

            rep = _report.build_report(self.ledger.events())
            text = (_report.render_html(rep)
                    if self.report_out.endswith((".html", ".htm"))
                    else _report.render_md(rep))
            with atomic_write(self.report_out) as f:
                f.write(text + "\n")
        self.ledger.close()
        if self._prev_tracer is not None:
            set_tracer(self._prev_tracer)
        if self._prev_ledger is not None:
            set_ledger(self._prev_ledger)
        if self._prev_monitor is not None:
            set_monitor(self._prev_monitor)

    def __enter__(self) -> "ObsSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def configure(*, metrics_out: str | None = None, trace_out: str | None = None,
              ledger_out: str | None = None, report_out: str | None = None,
              monitor: bool = False, monitor_rules: list | None = None,
              trace_annotate: bool = False,
              meta: dict | None = None) -> ObsSession:
    """Install enabled process defaults for whichever outputs the driver
    asked for and return the owning :class:`ObsSession`.

    A tracer is enabled only when ``trace_out`` is given, a file-backed
    ledger only when ``ledger_out`` is. ``monitor=True`` installs a
    :class:`HealthMonitor` (default or ``monitor_rules``) attached to the
    run ledger; ``report_out`` renders the ledger into a run report on
    close (md, or html by extension). Both need ledger records, so either
    implies an in-memory ledger when ``ledger_out`` was not given.
    ``meta`` becomes the ledger's leading ``run_meta`` record. With no
    arguments this is a no-op session."""
    prev_tracer = prev_ledger = prev_monitor = None
    tracer = get_tracer()
    ledger = get_ledger()
    mon = get_monitor()
    if trace_out:
        tracer = Tracer(enabled=True, annotate=trace_annotate)
        prev_tracer = set_tracer(tracer)
    if ledger_out or monitor or report_out:
        ledger = RunLedger(ledger_out)  # path=None -> in-memory only
        prev_ledger = set_ledger(ledger)
        if meta:
            ledger.emit("run_meta", **meta)
    if monitor:
        mon = HealthMonitor(monitor_rules).attach(ledger)
        prev_monitor = set_monitor(mon)
    return ObsSession(metrics_out=metrics_out, trace_out=trace_out,
                      report_out=report_out, registry=get_registry(),
                      tracer=tracer, ledger=ledger, monitor=mon,
                      prev_tracer=prev_tracer, prev_ledger=prev_ledger,
                      prev_monitor=prev_monitor)


def add_flags(parser) -> None:
    """The launch drivers' shared observability flags."""
    parser.add_argument("--metrics-out", default=None, metavar="PATH",
                        help="write a metrics-registry snapshot on exit "
                             "(.jsonl = one series per line, else JSON)")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="record spans and write Chrome-trace JSON on "
                             "exit (open in chrome://tracing or Perfetto)")
    parser.add_argument("--ledger-out", default=None, metavar="PATH",
                        help="append typed run-ledger records (JSONL): "
                             "per-iteration, per-window, per-dispatch")
    parser.add_argument("--trace-annotate", action="store_true",
                        help="with --trace-out: mirror spans into "
                             "torch.profiler / NVTX ranges so a profiler "
                             "trace shows them on the device timeline")
    parser.add_argument("--monitor", action="store_true",
                        help="run the health monitor (obs.monitor): "
                             "rolling SLO rules over dispatch/eval records "
                             "with hysteresis, emitting typed 'alert' "
                             "ledger records")
    parser.add_argument("--monitor-rule", action="append", default=None,
                        metavar="RULE", dest="monitor_rules",
                        help="replace the default SLO rule set "
                             "(repeatable): '[name:] signal <=|>= "
                             "threshold [for B/C]', e.g. "
                             "'drift.id_psi <= 0.25 for 2/2'")
    parser.add_argument("--drift-ref", default=None, metavar="PATH",
                        help="drift-reference snapshot (.npz): training "
                             "drivers CAPTURE one here from held-out "
                             "eval; serving drivers LOAD it to arm the "
                             "monitor's drift/calibration detectors")
    parser.add_argument("--report-out", default=None, metavar="PATH",
                        help="render the run ledger into one analytics "
                             "report on exit (.html for HTML, else "
                             "markdown; same renderer as "
                             "python -m repro_torch.obs.report)")


def configure_from_args(args, *, driver: str, device, argv: list[str],
                        mode: str | None = None) -> ObsSession:
    """:func:`configure` from parsed :func:`add_flags` arguments, with a
    ``run_meta`` record carrying the driver's ``argv``, its ``mode`` (if
    any) and the device context (``device`` is the resolved
    ``torch.device`` it runs on)."""
    import torch

    meta: dict = {"driver": driver, "backend": device.type,
                  "argv": list(argv)}
    if mode is not None:
        meta["mode"] = mode
    if device.type == "cuda":
        meta["device_count"] = torch.cuda.device_count()
        meta["device_name"] = torch.cuda.get_device_name(device)
    else:
        meta["device_count"] = 1
    rules = None
    if args.monitor_rules:
        rules = [parse_rule(r) for r in args.monitor_rules]
    return configure(metrics_out=args.metrics_out, trace_out=args.trace_out,
                     ledger_out=args.ledger_out, report_out=args.report_out,
                     monitor=args.monitor, monitor_rules=rules,
                     trace_annotate=args.trace_annotate, meta=meta)
