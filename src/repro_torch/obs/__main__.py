"""CLI: render / diff repro_torch.obs artifacts.

    python -m repro_torch.obs render metrics.json [--format text|prom|json]
    python -m repro_torch.obs diff old.json new.json
    python -m repro_torch.obs trace trace.json

``render`` pretty-prints a metrics snapshot (written by
``launch/serve.py --metrics`` or ``obs.metrics.snapshot()``); ``diff``
shows the series that changed between two snapshots; ``trace``
summarizes a Chrome trace-event file (span counts/durations by name).
Exit 0 on success, 1 when ``diff`` found differences, 2 on bad input.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from .metrics import diff_snapshots, load_snapshot


def _fmt_value(kind: str, value) -> str:
    if kind == "histogram" and isinstance(value, dict):
        n = value.get("count", 0)
        if not n:
            return "count=0"
        mean = value["sum"] / n
        return f"count={n} sum={value['sum']:.6g} mean={mean:.6g}"
    return f"{value}"


def render(snap: dict, fmt: str) -> str:
    if fmt == "json":
        return json.dumps(snap, indent=2, sort_keys=True)
    if fmt == "prom":
        reg = _registry_from_snapshot(snap)
        return reg.prometheus_text()
    lines = []
    for name in sorted(snap):
        fam = snap[name]
        kind = fam.get("type", "?")
        for label, value in sorted(fam.get("values", {}).items()):
            series = f"{name}{{{label}}}" if label else name
            lines.append(f"{series:58s} {kind:9s} "
                         f"{_fmt_value(kind, value)}")
    return "\n".join(lines)


def _registry_from_snapshot(snap: dict):
    """Rehydrate a registry from a snapshot (for prom re-exposition)."""
    from .metrics import MetricsRegistry
    reg = MetricsRegistry()
    for name, fam in snap.items():
        kind, help_ = fam.get("type"), fam.get("help", "")
        for label, value in fam.get("values", {}).items():
            kv = dict(p.split("=", 1) for p in label.split(",")) \
                if label else {}
            if kind == "counter":
                reg.counter(name, help_).labels(**kv).inc(value)
            elif kind == "gauge":
                reg.gauge(name, help_).labels(**kv).set(value)
            elif kind == "histogram" and isinstance(value, dict):
                h = reg.histogram(name, value["edges"],
                                  help_).labels(**kv)
                h.counts = list(value["counts"])
                h.total = value["sum"]
                h.count = value["count"]
    return reg


def summarize_trace(doc: dict) -> str:
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    spans = [e for e in events if e.get("ph") == "X"]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in spans:
        agg = by_name[e.get("name", "?")]
        agg[0] += 1
        agg[1] += float(e.get("dur", 0.0))
    lines = [f"{len(events)} events, {len(spans)} spans"]
    for name, (n, dur) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][1]):
        lines.append(f"  {name:42s} n={n:<6d} total={dur / 1e3:.3f} ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="render / diff repro_torch.obs metric snapshots and "
                    "traces")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_render = sub.add_parser("render", help="pretty-print a snapshot")
    p_render.add_argument("snapshot")
    p_render.add_argument("--format", choices=("text", "prom", "json"),
                          default="text")
    p_diff = sub.add_parser("diff", help="diff two snapshots")
    p_diff.add_argument("old")
    p_diff.add_argument("new")
    p_trace = sub.add_parser("trace", help="summarize a trace JSON")
    p_trace.add_argument("trace")
    args = ap.parse_args(argv)
    try:
        if args.cmd == "render":
            print(render(load_snapshot(args.snapshot), args.format))
            return 0
        if args.cmd == "diff":
            d = diff_snapshots(load_snapshot(args.old),
                               load_snapshot(args.new))
            print(json.dumps(d, indent=2, sort_keys=True))
            return 1 if d else 0
        with open(args.trace) as fh:
            print(summarize_trace(json.load(fh)))
        return 0
    except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
