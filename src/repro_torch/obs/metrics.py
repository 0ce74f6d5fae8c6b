"""Typed metrics: Counter / Gauge / Histogram families with labels.

The registry replaces the ad-hoc counters that used to live scattered
across the stack (plan-cache hits buried in ``ops._PlanCache``, autotune
cache misses visible only as warnings, scheduler rejections as a bare
list) with named, typed series that snapshot to JSON and expose in
Prometheus text format.

Determinism contract: histograms use *fixed bucket edges*, so a
virtual-time serving run — whose observed values are simulated seconds —
produces a bit-identical snapshot on every host.  Nothing in a snapshot
reads a wall clock.

The default registry is pre-populated with the full metric glossary
(``GLOSSARY``; documented in the README), so a snapshot always contains
every standard series even when its value is still zero — consumers can
rely on the keys being present.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily",
           "MetricsRegistry", "GLOSSARY", "get_registry", "reset_metrics",
           "snapshot", "prometheus_text", "diff_snapshots",
           "load_snapshot"]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _prom_labels(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonic count.  ``inc`` only; negative increments are rejected."""
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n

    def snapshot(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-edge histogram: ``counts[i]`` counts values <= edges[i]
    (first bucket) / in (edges[i-1], edges[i]]; the last bucket is the
    +Inf overflow.  Fixed edges keep snapshots deterministic."""
    __slots__ = ("_lock", "edges", "counts", "total", "count")

    def __init__(self, lock: threading.Lock, edges: Sequence[float]):
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram edges must be sorted and "
                             f"non-empty, got {edges!r}")
        self._lock = lock
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for edge in self.edges:
            if v <= edge:
                break
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.total += v
            self.count += 1

    def snapshot(self):
        return {"edges": list(self.edges), "counts": list(self.counts),
                "sum": self.total, "count": self.count}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric plus its labeled children.  Calling ``inc`` /
    ``set`` / ``observe`` on the family hits the unlabeled child."""

    def __init__(self, name: str, kind: str, help: str = "",
                 edges: Optional[Sequence[float]] = None,
                 lock: Optional[threading.Lock] = None):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        if kind == "histogram" and edges is None:
            raise ValueError(f"histogram {name!r} needs bucket edges")
        self.name = name
        self.kind = kind
        self.help = help
        self.edges = tuple(edges) if edges is not None else None
        self._lock = lock if lock is not None else threading.Lock()
        self._children: Dict[LabelKey, object] = {}

    def labels(self, **labels):
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    cls = _KINDS[self.kind]
                    child = (cls(self._lock, self.edges)
                             if self.kind == "histogram"
                             else cls(self._lock))
                    self._children[key] = child
        return child

    # unlabeled conveniences
    def inc(self, n: float = 1) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value

    def snapshot(self) -> dict:
        values = {_label_str(k): c.snapshot()
                  for k, c in sorted(self._children.items())}
        if not values:        # registered but never touched: still present
            values = {"": self.labels().snapshot()}
        return {"type": self.kind, "help": self.help, "values": values}

    def reset(self) -> None:
        self._children.clear()


class MetricsRegistry:
    """Named metric families; create-or-get semantics per name."""

    def __init__(self, preset: bool = False):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}
        if preset:
            self.install(GLOSSARY)

    def _family(self, name: str, kind: str, help: str,
                edges=None) -> MetricFamily:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = MetricFamily(name, kind, help, edges)
                    self._families[name] = fam
        if fam.kind != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{fam.kind}, requested {kind}")
        return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, edges: Sequence[float],
                  help: str = "") -> MetricFamily:
        return self._family(name, "histogram", help, edges)

    def install(self, glossary: dict) -> None:
        """Pre-register every metric in a ``GLOSSARY``-shaped dict."""
        for name, meta in glossary.items():
            self._family(name, meta["type"], meta.get("help", ""),
                         meta.get("edges"))

    def names(self) -> List[str]:
        return sorted(self._families)

    def snapshot(self) -> dict:
        return {name: fam.snapshot()
                for name, fam in sorted(self._families.items())}

    def prometheus_text(self) -> str:
        lines = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            children = sorted(fam._children.items()) \
                or [((), fam.labels())]
            for key, child in children:
                lab = _prom_labels(key)
                if fam.kind == "histogram":
                    cum = 0
                    inner = lab[1:-1] + "," if key else ""
                    for edge, c in zip(list(child.edges) + ["+Inf"],
                                       child.counts):
                        cum += c
                        lines.append(f'{name}_bucket{{{inner}le="{edge}"'
                                     f'}} {cum}')
                    lines.append(f"{name}_sum{lab} {child.total}")
                    lines.append(f"{name}_count{lab} {child.count}")
                else:
                    lines.append(f"{name}{lab} {child.snapshot()}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every family (children dropped; names kept)."""
        for fam in self._families.values():
            fam.reset()


# latency-style edges (seconds): span virtual-time scales (~1e-5 s steps
# under step_time_scale) through realtime interpret-mode scales (~1 s)
_TIME_EDGES = (1e-5, 1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
               1.0, 5.0, 10.0, 60.0)
_DENSITY_EDGES = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
_DEPTH_EDGES = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
_OCC_EDGES = (0.0, 0.25, 0.5, 0.75, 1.0)

#: The standard metric names (the README glossary is generated from the
#: help strings here).  Every entry is pre-registered on the default
#: registry so snapshots always carry the full key set.
GLOSSARY = {
    "repro_plan_cache_hits_total": {
        "type": "counter",
        "help": "Plan-cache hits in kernels.ops (reused PlannedOperand)."},
    "repro_plan_cache_misses_total": {
        "type": "counter",
        "help": "Plan-cache misses (a fresh digit-plane plan was built)."},
    "repro_autotune_cache_hits_total": {
        "type": "counter",
        "help": "Autotune cache lookups that found a tuned config."},
    "repro_autotune_cache_misses_total": {
        "type": "counter",
        "help": "Autotune cache lookups that fell back to heuristics."},
    "repro_autotune_miss_warnings_total": {
        "type": "counter",
        "help": "AutotuneCacheMissWarning emissions (strict-mode misses)."},
    "repro_autotune_vmem_rejected_total": {
        "type": "counter",
        "help": "Autotune candidate configs rejected by the VMEM budget."},
    "repro_schedule_b_dma_elided_total": {
        "type": "counter",
        "help": "B-block DMAs elided by k-major schedule reuse."},
    "repro_schedule_density": {
        "type": "histogram", "edges": _DENSITY_EDGES,
        "help": "Plane-block density of built schedules (1.0 = dense)."},
    "repro_collective_bytes_total": {
        "type": "counter",
        "help": "Per-device collective bytes moved by sharded applies."},
    "repro_gemm_dispatch_total": {
        "type": "counter",
        "help": "planned_dense_apply dispatches by resolved route "
                "(label route=); recorded only while obs is enabled."},
    "repro_serve_admitted_total": {
        "type": "counter",
        "help": "Requests admitted by the scheduler."},
    "repro_serve_rejected_total": {
        "type": "counter",
        "help": "Requests rejected at admission."},
    "repro_serve_completed_total": {
        "type": "counter",
        "help": "Requests that reached DONE."},
    "repro_serve_generated_tokens_total": {
        "type": "counter",
        "help": "Decode tokens generated across completed requests."},
    "repro_serve_engine_steps_total": {
        "type": "counter",
        "help": "Engine decode steps; recorded only while obs is "
                "enabled (hot path)."},
    "repro_serve_queue_depth": {
        "type": "histogram", "edges": _DEPTH_EDGES,
        "help": "Admission queue depth sampled per scheduling round."},
    "repro_serve_slot_occupancy": {
        "type": "histogram", "edges": _OCC_EDGES,
        "help": "Decode-slot occupancy per tier (label tier=)."},
    "repro_serve_ttft_seconds": {
        "type": "histogram", "edges": _TIME_EDGES,
        "help": "Time to first token (serving clock)."},
    "repro_serve_tpot_seconds": {
        "type": "histogram", "edges": _TIME_EDGES,
        "help": "Time per output token (serving clock)."},
    "repro_serve_latency_seconds": {
        "type": "histogram", "edges": _TIME_EDGES,
        "help": "Request completion latency (serving clock)."},
    "repro_cost_drift_ratio": {
        "type": "gauge",
        "help": "CostCalibrator measured/predicted drift per impl "
                "(label impl=); 1.0 = perfectly calibrated."},
    "repro_chaos_faults_injected_total": {
        "type": "counter",
        "help": "Chaos faults fired by the installed FaultPlan "
                "(label kind=); zero unless REPRO_CHAOS is enabled."},
    "repro_serve_worker_deaths_total": {
        "type": "counter",
        "help": "Tier workers declared DEAD (label tier=): injected "
                "kills, engine failures, or watchdog timeouts."},
    "repro_serve_retries_total": {
        "type": "counter",
        "help": "Request restarts after a worker death (bounded by the "
                "server's retry budget)."},
    "repro_serve_migrations_total": {
        "type": "counter",
        "help": "Requests re-routed away from a dead tier."},
    "repro_serve_requests_lost_total": {
        "type": "counter",
        "help": "Requests REJECTED because their retry budget was "
                "exhausted or no live tier remained."},
    "repro_serve_snapshots_total": {
        "type": "counter",
        "help": "Decode-state snapshots taken from dying workers' slots "
                "(restore-mode failover drain)."},
    "repro_serve_restores_total": {
        "type": "counter",
        "help": "Migrated requests re-admitted with their tokens (label "
                "mode=same_spec for a bit-exact slot restore, "
                "mode=cross_spec for a token-preserving re-prefill)."},
    "repro_serve_tokens_recovered_total": {
        "type": "counter",
        "help": "Committed tokens preserved across a migration or resume "
                "instead of being regenerated."},
    "repro_serve_journal_records_total": {
        "type": "counter",
        "help": "Write-ahead request-journal records appended "
                "(label kind=admit|tok|done|rst|drop|death|hdr)."},
    "repro_serve_journal_replayed_total": {
        "type": "counter",
        "help": "Journal records successfully replayed on --resume."},
    "repro_serve_journal_truncated_total": {
        "type": "counter",
        "help": "Trailing journal lines dropped as torn/corrupt by the "
                "truncating replay."},
    "repro_serve_brownout_transitions_total": {
        "type": "counter",
        "help": "Brownout level changes (label direction=down|up)."},
    "repro_serve_brownout_level": {
        "type": "gauge",
        "help": "Current brownout degradation level (0 = healthy)."},
    "repro_autotune_cache_load_errors_total": {
        "type": "counter",
        "help": "Autotune cache files that failed to parse and fell "
                "back to the static block-size table."},
}

_default = MetricsRegistry(preset=True)


def get_registry() -> MetricsRegistry:
    return _default


def reset_metrics() -> None:
    """Zero the default registry (glossary families stay registered)."""
    _default.reset()


def snapshot() -> dict:
    return _default.snapshot()


def prometheus_text() -> str:
    return _default.prometheus_text()


def diff_snapshots(a: dict, b: dict) -> dict:
    """Series-level diff of two ``snapshot()`` dicts (b relative to a).

    Returns ``{name: {label: {"a": ..., "b": ...}}}`` for every series
    whose value changed, plus ``{"only_in_a"|"only_in_b": [...]}`` keys
    when the name sets differ.
    """
    out: dict = {}
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    if only_a:
        out["only_in_a"] = only_a
    if only_b:
        out["only_in_b"] = only_b
    for name in sorted(set(a) & set(b)):
        va, vb = a[name].get("values", {}), b[name].get("values", {})
        changed = {}
        for lab in sorted(set(va) | set(vb)):
            if va.get(lab) != vb.get(lab):
                changed[lab] = {"a": va.get(lab), "b": vb.get(lab)}
        if changed:
            out[name] = changed
    return out


def load_snapshot(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
