"""Offline run analytics: one report from one ledger, no recomputation.

The port's copy of ``repro/obs/report.py``: for the same ledger file both
packages render byte-identical reports.

``python -m repro_torch.obs.report run.jsonl --format md|html [--out PATH]``
folds a run ledger's typed records (``repro_torch.obs.ledger``) into a
single human-readable report:

  * run metadata (driver, mode, backend, argv);
  * the per-iteration convergence/nnz curve from ``train_iter``
    records, formatted with the EXACT format strings the drivers print
    (``render_train_iter``) — the report's numbers are bit-identical to
    the console lines of the run that wrote the ledger;
  * the next-day decay table from ``stream_eval`` records (the Fig. 7
    analogue), again with the drivers' own ``{:.4f}`` formatting;
  * streaming window/planner accounting from ``stream_window`` /
    ``stream_summary``;
  * serving latency percentiles, occupancy and the flush-reason mix
    from ``serve_dispatch`` records;
  * every ``alert`` state change the health monitor emitted.

Everything derives from ledger records alone — the report never touches
data, models or clocks, so it reproduces byte-for-byte from an archived
ledger (the CI observability job renders and archives it next to the
raw JSONL). Output is atomic (``repro_torch.obs.fileio.atomic_write``): a
crash mid-render never leaves a truncated artifact.
"""
from __future__ import annotations

import argparse
import html
import sys

import numpy as np

from repro_torch.obs.fileio import atomic_write
from repro_torch.obs.ledger import read_jsonl, render_train_iter, validate_events


def build_report(events: list[dict]) -> dict:
    """Fold ledger records into the report's section dict (pure data —
    the renderers below turn it into md/html)."""
    by_kind: dict[str, list[dict]] = {}
    for e in events:
        by_kind.setdefault(e.get("kind", "?"), []).append(e)

    report: dict = {"records": len(events),
                    "kinds": {k: len(v) for k, v in sorted(by_kind.items())}}

    metas = by_kind.get("run_meta", [])
    if metas:
        m = metas[0]
        report["meta"] = {k: m[k] for k in
                          ("driver", "mode", "backend", "device_count",
                           "argv") if k in m}

    iters = by_kind.get("train_iter", [])
    if iters:
        report["convergence"] = {
            "iters": len(iters),
            "rows": [{"step": r["step"], "f_new": r["f_new"],
                      "nnz": r["nnz"], "alpha": r["alpha"],
                      **({"test_auc": r["test_auc"]} if "test_auc" in r
                         else {}),
                      "line": render_train_iter(r)} for r in iters],
            "f_first": iters[0]["f_new"], "f_last": iters[-1]["f_new"],
            "nnz_last": iters[-1]["nnz"],
        }

    evals = [r for r in by_kind.get("stream_eval", [])
             if "next_day_nll" in r]
    if evals:
        report["decay"] = [{"day": r["day"],
                            "next_day_nll": r["next_day_nll"],
                            "next_day_auc": r.get("next_day_auc")}
                           for r in evals]

    wins = by_kind.get("stream_window", [])
    if wins:
        report["windows"] = {
            "count": len(wins),
            "plan_s": sum(w["build_s"] for w in wins),
            "step_s": sum(w["step_s"] for w in wins),
            "prefetched": sum(1 for w in wins if w["prefetched"]),
        }
        summaries = by_kind.get("stream_summary", [])
        if summaries:
            report["windows"]["overlap_ratio"] = \
                summaries[-1]["overlap_ratio"]

    disp = by_kind.get("serve_dispatch", [])
    if disp:
        walls_us = np.array([d["wall_s"] for d in disp]) * 1e6
        delays_us = np.array([d["queue_delay_us"] for d in disp])
        mix: dict[str, dict] = {}
        for d in disp:
            row = mix.setdefault(d["flush_reason"],
                                 {"dispatches": 0, "requests": 0,
                                  "candidates": 0})
            row["dispatches"] += 1
            row["requests"] += d["requests"]
            row["candidates"] += d["candidates"]
        report["serving"] = {
            "dispatches": len(disp),
            "requests": sum(d["requests"] for d in disp),
            "candidates": sum(d["candidates"] for d in disp),
            "occupancy_mean":
                float(np.mean([d["occupancy"] for d in disp])),
            "wall_p50_us": float(np.percentile(walls_us, 50)),
            "wall_p99_us": float(np.percentile(walls_us, 99)),
            "queue_delay_p99_us": float(np.percentile(delays_us, 99)),
            "flush_mix": mix,
        }

    alerts = by_kind.get("alert", [])
    if alerts:
        report["alerts"] = [{k: a[k] for k in
                             ("rule", "state", "signal", "value",
                              "threshold", "op") if k in a}
                            for a in alerts]
    return report


# ------------------------------------------------------------- rendering
def _md_table(headers: list[str], rows: list[list[str]]) -> list[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "---|" * len(headers)]
    out += ["| " + " | ".join(r) + " |" for r in rows]
    return out


def _sections(report: dict) -> list[tuple[str, list[str], list[list[str]]]]:
    """(title, headers, rows) per tabular section, shared by both
    renderers so md and html always agree on the numbers."""
    secs = []
    if "convergence" in report:
        conv = report["convergence"]
        secs.append(("Convergence", ["iter", "f", "alpha", "nnz", "test_auc"],
                     [[str(r["step"]), f"{r['f_new']:.2f}",
                       f"{r['alpha']:.3g}", str(r["nnz"]),
                       (f"{r['test_auc']:.4f}" if "test_auc" in r else "")]
                      for r in conv["rows"]]))
    if "decay" in report:
        secs.append(("Next-day decay", ["day", "next-day nll",
                                        "next-day auc"],
                     [[str(r["day"]), f"{r['next_day_nll']:.4f}",
                       (f"{r['next_day_auc']:.4f}"
                        if r["next_day_auc"] is not None else "")]
                      for r in report["decay"]]))
    if "serving" in report:
        s = report["serving"]
        secs.append(("Serving", ["metric", "value"], [
            ["dispatches", str(s["dispatches"])],
            ["requests", str(s["requests"])],
            ["candidates", str(s["candidates"])],
            ["occupancy (mean)", f"{s['occupancy_mean']:.3f}"],
            ["dispatch wall p50", f"{s['wall_p50_us']:,.0f} us"],
            ["dispatch wall p99", f"{s['wall_p99_us']:,.0f} us"],
            ["queue delay p99", f"{s['queue_delay_p99_us']:,.0f} us"],
        ]))
        secs.append(("Flush mix", ["reason", "dispatches", "requests",
                                   "candidates"],
                     [[reason, str(row["dispatches"]), str(row["requests"]),
                       str(row["candidates"])]
                      for reason, row in sorted(s["flush_mix"].items())]))
    if "windows" in report:
        w = report["windows"]
        rows = [["windows", str(w["count"])],
                ["host plan wall", f"{w['plan_s']:.2f} s"],
                ["device step wall", f"{w['step_s']:.2f} s"],
                ["prefetched windows", str(w["prefetched"])]]
        if "overlap_ratio" in w:
            rows.append(["overlap ratio", f"{w['overlap_ratio']:.2f}"])
        secs.append(("Streaming windows", ["metric", "value"], rows))
    if "alerts" in report:
        secs.append(("Alerts", ["rule", "state", "signal", "value",
                                "threshold"],
                     [[a["rule"], a["state"], a["signal"],
                       f"{a['value']:.6g}",
                       f"{a['op']} {a['threshold']:.6g}"]
                      for a in report["alerts"]]))
    else:
        secs.append(("Alerts", ["rule", "state", "signal", "value",
                                "threshold"], []))
    return secs


def render_md(report: dict) -> str:
    out = ["# Run report", ""]
    if "meta" in report:
        m = report["meta"]
        out.append("- driver: `%s`" % m.get("driver", "?"))
        for k in ("mode", "backend", "device_count"):
            if k in m:
                out.append(f"- {k}: `{m[k]}`")
        if m.get("argv"):
            out.append("- argv: `%s`" % " ".join(m["argv"]))
    out.append(f"- records: {report['records']} "
               f"({', '.join(f'{k}={v}' for k, v in report['kinds'].items())})")
    out.append("")
    for title, headers, rows in _sections(report):
        out.append(f"## {title}")
        out.append("")
        if rows:
            out += _md_table(headers, rows)
        else:
            out.append("_none_")
        out.append("")
    if "convergence" in report:
        out.append("## Console lines (reconstructed)")
        out.append("")
        out.append("```")
        out += [r["line"] for r in report["convergence"]["rows"]]
        out.append("```")
        out.append("")
    return "\n".join(out)


def render_html(report: dict) -> str:
    esc = html.escape
    out = ["<!doctype html><html><head><meta charset='utf-8'>",
           "<title>Run report</title>",
           "<style>body{font-family:sans-serif;margin:2em}"
           "table{border-collapse:collapse}"
           "td,th{border:1px solid #999;padding:4px 8px;"
           "font-variant-numeric:tabular-nums}"
           "th{background:#eee}</style></head><body>",
           "<h1>Run report</h1>"]
    if "meta" in report:
        m = report["meta"]
        items = "".join(
            f"<li>{esc(str(k))}: <code>{esc(str(m[k]))}</code></li>"
            for k in ("driver", "mode", "backend", "device_count", "argv")
            if k in m)
        out.append(f"<ul>{items}</ul>")
    out.append(f"<p>{report['records']} records</p>")
    for title, headers, rows in _sections(report):
        out.append(f"<h2>{esc(title)}</h2>")
        if not rows:
            out.append("<p><em>none</em></p>")
            continue
        head = "".join(f"<th>{esc(h)}</th>" for h in headers)
        body = "".join(
            "<tr>" + "".join(f"<td>{esc(c)}</td>" for c in row) + "</tr>"
            for row in rows)
        out.append(f"<table><tr>{head}</tr>{body}</table>")
    if "convergence" in report:
        lines = "\n".join(esc(r["line"])
                          for r in report["convergence"]["rows"])
        out.append(f"<h2>Console lines (reconstructed)</h2>"
                   f"<pre>{lines}</pre>")
    out.append("</body></html>")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="render one analytics report from a run-ledger JSONL "
                    "file (no recomputation: every number comes from the "
                    "ledger records)")
    ap.add_argument("ledger", help="run ledger (.jsonl) to analyse")
    ap.add_argument("--format", choices=("md", "html"), default="md")
    ap.add_argument("--out", default=None,
                    help="write here (atomic); default: stdout")
    args = ap.parse_args(argv)

    try:
        events = read_jsonl(args.ledger)
    except (OSError, ValueError) as e:
        print(f"FAIL {args.ledger}: {e}", file=sys.stderr)
        return 1
    errors = validate_events(events)
    if errors:
        for err in errors[:10]:
            print(f"FAIL {args.ledger}: {err}", file=sys.stderr)
        return 1
    if not events:
        print(f"FAIL {args.ledger}: empty ledger", file=sys.stderr)
        return 1

    report = build_report(events)
    text = render_md(report) if args.format == "md" else render_html(report)
    if args.out:
        with atomic_write(args.out) as f:
            f.write(text + "\n")
        print(f"report -> {args.out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
