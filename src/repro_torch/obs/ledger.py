"""Append-only structured run ledger: typed JSONL event records.

The port's copy of ``repro/obs/ledger.py``. Records use the reference's
schema unchanged, so a port ledger passes ``python -m repro.obs.ledger
--check`` as well as this module's own ``python -m repro_torch.obs.ledger
--check``:

  * ``train_iter``     one OWLQN+ iteration: objective before/after,
                       accepted step, line-search trials, direction norm
                       (the Eq. 4 optimality measure), non-zero count,
                       wall and (every few iterations) test AUC;
  * ``stream_window``  one streaming window: plan/compile/total build
                       walls, exposed wait, prefetched flag, device step
                       wall, carry policy -- the planner's overlap ratio
                       reconstructs from these records exactly;
  * ``stream_summary`` the planner's end-of-run overlap accounting;
  * ``serve_dispatch`` one engine dispatch: envelope key, group size,
                       occupancy, queue delay, measured wall, flush
                       reason;
  * ``alert``          one health-monitor state change (firing or
                       cleared): the rule, the signal value that crossed
                       it and the hysteresis shape (``obs.monitor``);
  * ``run_meta`` / ``stream_eval`` / ``log``  driver context (device name
                       and count), held-out per-day quality and free-text
                       lines that keep their human-readable rendering.

OBSERVERS: ``add_observer(fn)`` subscribes a callable to every record the
ledger accepts (the health monitor's live feed). Observers run on the
emitting thread AFTER the ledger lock is released, so an observer may
itself emit (the monitor's alert records) without deadlocking.

Records validate against :data:`SCHEMA` on emit and again offline.
Unknown EXTRA fields are allowed (forward compatibility); unknown KINDS,
missing required fields and type mismatches are errors.

Disabled fast path: the module default is :data:`NULL_LEDGER`
(``enabled=False``, ``emit`` returns immediately); instrumented code
guards record construction behind ``ledger.enabled``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Iterator

_NUM = (int, float)

# kind -> {"required": {field: type(s)}, "optional": {field: type(s)}}.
# "text" (str) is implicitly optional on every kind.
SCHEMA: dict[str, dict[str, dict[str, Any]]] = {
    "run_meta": {
        "required": {"driver": str},
        "optional": {"mode": str, "backend": str, "device_count": int,
                     "argv": list},
    },
    "log": {
        "required": {"text": str},
        "optional": {},
    },
    "train_iter": {
        "required": {"step": int, "f": _NUM, "f_new": _NUM, "alpha": _NUM,
                     "grad_norm": _NUM, "nnz": int},
        "optional": {"ls_iters": int, "wall_s": _NUM, "day": int,
                     "window_iter": int, "test_auc": _NUM},
    },
    "stream_window": {
        "required": {"day": int, "days_in_window": int, "plan_s": _NUM,
                     "compile_s": _NUM, "build_s": _NUM, "wait_s": _NUM,
                     "prefetched": bool, "step_s": _NUM, "carry": str,
                     "alpha": _NUM, "nnz": int, "fs": list},
        "optional": {},
    },
    "stream_summary": {
        "required": {"windows": int, "build_seconds": _NUM,
                     "wait_seconds": _NUM, "prefetched_build_seconds": _NUM,
                     "prefetched_wait_seconds": _NUM, "overlap_ratio": _NUM},
        "optional": {},
    },
    "stream_eval": {
        "required": {"day": int},
        "optional": {"next_day_nll": _NUM, "next_day_auc": _NUM},
    },
    "serve_dispatch": {
        "required": {"envelope": list, "g": int, "requests": int,
                     "candidates": int, "occupancy": _NUM, "wall_s": _NUM,
                     "flush_reason": str, "queue_delay_us": _NUM},
        "optional": {},
    },
    "alert": {
        "required": {"rule": str, "state": str, "signal": str,
                     "value": _NUM, "threshold": _NUM},
        "optional": {"op": str, "breach_n": int, "clear_n": int, "day": int},
    },
}


def validate_event(event: Any) -> str | None:
    """One record's schema error string, or None when it validates."""
    if not isinstance(event, dict):
        return f"record is not an object: {event!r}"
    kind = event.get("kind")
    if kind not in SCHEMA:
        return f"unknown kind {kind!r} (known: {sorted(SCHEMA)})"
    spec = SCHEMA[kind]
    for field, typ in spec["required"].items():
        if field not in event:
            return f"{kind}: missing required field {field!r}"
        if not _type_ok(event[field], typ):
            return (f"{kind}.{field}: expected {_type_name(typ)}, "
                    f"got {type(event[field]).__name__}")
    for field, typ in spec["optional"].items():
        if field in event and not _type_ok(event[field], typ):
            return (f"{kind}.{field}: expected {_type_name(typ)}, "
                    f"got {type(event[field]).__name__}")
    if "text" in event and not isinstance(event["text"], str):
        return f"{kind}.text: expected str, got {type(event['text']).__name__}"
    if "t" in event and not isinstance(event["t"], float):
        return f"{kind}.t: expected float timestamp"
    return None


def _type_ok(value: Any, typ: Any) -> bool:
    if typ is bool:
        return isinstance(value, bool)
    if isinstance(value, bool):  # bool is an int subclass; keep kinds apart
        return False
    return isinstance(value, typ)


def _type_name(typ: Any) -> str:
    if isinstance(typ, tuple):
        return "/".join(t.__name__ for t in typ)
    return typ.__name__


class RunLedger:
    """Append-only event sink: in-memory list + optional JSONL file.

    ``emit`` validates (raise on schema violation), stamps ``t`` (unix
    seconds) and ``kind``, appends, and — when ``path`` is given — writes
    one JSON line immediately (line-buffered, so a crashed run still
    leaves a readable prefix). Thread-safe: the stream planner's thread
    and the main thread may emit concurrently.
    """

    enabled = True

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._observers: list = []
        self._fh = None
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "w", buffering=1)

    def emit(self, kind: str, **fields) -> dict:
        event = {"kind": kind, "t": time.time(), **fields}
        err = validate_event(event)
        if err is not None:
            raise ValueError(f"invalid ledger record: {err}")
        with self._lock:
            self._events.append(event)
            if self._fh is not None:
                self._fh.write(json.dumps(event, sort_keys=True) + "\n")
        # outside the lock: an observer may emit back into this ledger
        # (the monitor's alert records) without deadlocking
        for fn in list(self._observers):
            fn(event)
        return event

    def add_observer(self, fn) -> None:
        """Subscribe ``fn(event)`` to every accepted record (called on the
        emitting thread, after the record is stored/written)."""
        if fn not in self._observers:
            self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        if fn in self._observers:
            self._observers.remove(fn)

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.get("kind") == kind]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class NullLedger:
    """The disabled default: ``emit`` is one early return."""

    enabled = False
    path = None

    def emit(self, kind: str, **fields) -> None:
        return None

    def events(self, kind: str | None = None) -> list[dict]:
        return []

    def add_observer(self, fn) -> None:
        return None

    def remove_observer(self, fn) -> None:
        return None

    def close(self) -> None:
        return None


NULL_LEDGER = NullLedger()
_DEFAULT: RunLedger | NullLedger = NULL_LEDGER


def get_ledger() -> RunLedger | NullLedger:
    """The process default ledger — :data:`NULL_LEDGER` until a driver
    configures ``--ledger-out`` (see ``repro_torch.obs.configure``)."""
    return _DEFAULT


def set_ledger(ledger: RunLedger | NullLedger) -> RunLedger | NullLedger:
    """Swap the process default ledger; returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, ledger
    return prev


def log(text: str, *, kind: str = "log", ledger=None,
        printer: Callable[[str], None] = print, **fields) -> None:
    """Structured logging: emit ``kind`` (with the rendered ``text`` and
    any structured ``fields``) to the run ledger AND print the exact
    same human line."""
    led = ledger if ledger is not None else _DEFAULT
    if led.enabled:
        led.emit(kind, text=text, **fields)
    printer(text)


def render_train_iter(rec: dict, *, nnz_width: int = 8) -> str:
    """The training driver's per-iteration line, rendered from a
    ``train_iter`` record (``test_auc``/``wall_s`` included if present)."""
    out = (f"iter {rec['step']:3d}  f={rec['f_new']:12.2f} "
           f"alpha={rec['alpha']:.3g} nnz={rec['nnz']:{nnz_width}d}")
    if "test_auc" in rec:
        out += f" test_auc={rec['test_auc']:.4f} "
    if "wall_s" in rec:
        out += f" ({rec['wall_s'] * 1e3:.0f} ms/iter)"
    return out


def render_stream_day(rec: dict) -> str:
    """``launch/train --stream``'s per-day line from a ``stream_window``
    record (the held-out next-day suffix is the driver's own
    ``stream_eval`` record)."""
    return (f"day {rec['day']:3d}  window={rec['days_in_window']}d "
            f"f={rec['fs'][-1]:12.2f} alpha={rec['alpha']:.3g} "
            f"nnz={rec['nnz']:8d} plan={rec['build_s'] * 1e3:6.0f}ms "
            f"step={rec['step_s'] * 1e3:6.0f}ms")


# ----------------------------------------------------- offline validation
def read_jsonl(path: str) -> list[dict]:
    """Parse a ledger file back into records (raises on malformed JSON)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
    return out


def validate_events(events: Iterator[dict]) -> list[str]:
    """Schema errors over a record stream (empty list == valid)."""
    errors = []
    for i, ev in enumerate(events):
        err = validate_event(ev)
        if err is not None:
            errors.append(f"record {i}: {err}")
    return errors


def validate_file(path: str) -> list[str]:
    try:
        events = read_jsonl(path)
    except (OSError, ValueError) as e:
        return [str(e)]
    errs = validate_events(events)
    if not events:
        errs.append(f"{path}: empty ledger (no records)")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate run-ledger JSONL files against the typed "
                    "event schema")
    ap.add_argument("paths", nargs="+", help="ledger .jsonl file(s)")
    ap.add_argument("--check", action="store_true",
                    help="accepted for symmetry; validation is the only "
                         "mode")
    args = ap.parse_args(argv)
    rc = 0
    for path in args.paths:
        errors = validate_file(path)
        if errors:
            rc = 1
            for err in errors[:20]:
                print(f"FAIL {path}: {err}", file=sys.stderr)
        else:
            print(f"ledger OK: {path} ({len(read_jsonl(path))} records)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
