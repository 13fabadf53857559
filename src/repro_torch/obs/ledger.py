"""Append-only structured run ledger: typed JSONL event records.

The port's copy of ``repro/obs/ledger.py``, cut to the record kinds the
ported drivers emit. Records use the reference's schema unchanged, so a
port ledger passes ``python -m repro.obs.ledger --check`` as well as
this module's own ``python -m repro_torch.obs.ledger --check``:

  * ``serve_dispatch`` one engine dispatch: envelope key, group size,
                       occupancy, queue delay, measured wall, flush
                       reason;
  * ``run_meta`` / ``log``  driver context (device name and count) and
                       free-text lines that keep their human-readable
                       rendering.

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
    "serve_dispatch": {
        "required": {"envelope": list, "g": int, "requests": int,
                     "candidates": int, "occupancy": _NUM, "wall_s": _NUM,
                     "flush_reason": str, "queue_delay_us": _NUM},
        "optional": {},
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
    leaves a readable prefix). Thread-safe.
    """

    enabled = True

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._events: list[dict] = []
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
        return event

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
