"""Serving metrics: per-request TTFT/TPOT, queue depth, slot occupancy,
tier assignment histogram.

Timing metrics are derived from the timestamps the lifecycle transitions
stamped on each request (``ServeRequest.ttft`` / ``.tpot`` / ``.latency``),
so the collector works identically on the realtime clock and the
virtual-time simulation clock.  ``validate_summary`` pins the summary-dict
shape — the CI serve-smoke lane and the benchmark artifact both assert it.

The collector is backed by the typed ``repro_torch.obs.metrics`` registry: every
observation lands in the glossary's ``repro_serve_*`` counter/histogram
series (fixed bucket edges — deterministic snapshots in virtual-time
mode), and the summary dict is kept as the validated *view* the CI
lane pins (exact percentiles come from the raw per-request stamps; the
registry histograms carry the bucketized exposition).

``emit_request_trace`` converts one finished request's lifecycle stamps
into Chrome-trace spans on the serving-clock timeline (QUEUED / PREFILL
/ DECODE phases, tid = request id) — post-hoc emission works identically
for the virtual and realtime clocks because both stamp the same fields.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .request import DONE, REJECTED, ServeRequest

__all__ = ["dist", "ServerMetrics", "SUMMARY_KEYS", "DIST_KEYS",
           "validate_summary", "emit_request_trace"]

DIST_KEYS = ("mean", "p50", "p95", "max")


def dist(values: Iterable[float], ndigits: int = 4) -> Optional[dict]:
    """mean/p50/p95/max summary of a sample list (None when empty)."""
    vals = np.asarray([v for v in values if v is not None], np.float64)
    if vals.size == 0:
        return None
    return {"mean": round(float(vals.mean()), ndigits),
            "p50": round(float(np.percentile(vals, 50)), ndigits),
            "p95": round(float(np.percentile(vals, 95)), ndigits),
            "max": round(float(vals.max()), ndigits)}


SUMMARY_KEYS = ("requests", "completed", "rejected", "generated_tokens",
                "engine_steps", "wall_s", "sim_s", "req_per_s", "tok_per_s",
                "ttft", "tpot", "latency", "queue_depth", "slot_occupancy",
                "tier_requests", "tier_tokens", "deadlines", "failover",
                "brownout")


def emit_request_trace(req: ServeRequest) -> None:
    """Trace the request's lifecycle phases on the serving clock.

    One span per phase it passed through — QUEUED (arrival ->
    admission), PREFILL (admission -> first token; its duration *is*
    the TTFT tail), DECODE (first token -> done) — with the request id
    as the track (tid) and ttft/tpot in the span args.  No-op unless
    tracing is enabled.
    """
    if not obs_trace.enabled():
        return
    tid = int(req.rid)
    args = {"tier": req.tier, "tokens": len(req.out)}
    if req.admitted_at is not None:
        obs_trace.complete_event("QUEUED", req.arrival, req.admitted_at,
                                 tid=tid, args=args)
    if req.admitted_at is not None and req.first_token_at is not None:
        obs_trace.complete_event(
            "PREFILL", req.admitted_at, req.first_token_at, tid=tid,
            args=dict(args, ttft=req.ttft))
    if req.first_token_at is not None and req.finished_at is not None:
        obs_trace.complete_event(
            "DECODE", req.first_token_at, req.finished_at, tid=tid,
            args=dict(args, tpot=req.tpot, latency=req.latency))


class ServerMetrics:
    """Aggregates time-series samples; the final summary combines them with
    the per-request timing the lifecycle stamps carry.

    registry: a ``repro_torch.obs.metrics.MetricsRegistry`` the typed series
    land in (default: the process-wide registry).  The raw sample lists
    are kept alongside for the summary view's exact percentiles.
    """

    def __init__(self, registry: Optional[object] = None):
        self.registry = registry if registry is not None \
            else obs_metrics.get_registry()
        g = obs_metrics.GLOSSARY
        self._h_depth = self.registry.histogram(
            "repro_serve_queue_depth",
            g["repro_serve_queue_depth"]["edges"])
        self._h_occ = self.registry.histogram(
            "repro_serve_slot_occupancy",
            g["repro_serve_slot_occupancy"]["edges"])
        self._queue_depth: List[int] = []
        self._occupancy: Dict[str, List[float]] = {}
        self.engine_steps = 0

    def sample(self, queue_depth: int, occupancy: Dict[str, float]) -> None:
        """One observation of server state (taken per scheduling round)."""
        self._queue_depth.append(int(queue_depth))
        self._h_depth.observe(queue_depth)
        for tier, occ in occupancy.items():
            self._occupancy.setdefault(tier, []).append(float(occ))
            self._h_occ.labels(tier=tier).observe(occ)

    def _record_run(self, done: List[ServeRequest],
                    rejected_n: int, gen: int) -> None:
        """Fold one run's terminal totals into the typed registry."""
        reg = self.registry
        reg.counter("repro_serve_completed_total").inc(len(done))
        reg.counter("repro_serve_generated_tokens_total").inc(gen)
        g = obs_metrics.GLOSSARY
        series = (("repro_serve_ttft_seconds", "ttft"),
                  ("repro_serve_tpot_seconds", "tpot"),
                  ("repro_serve_latency_seconds", "latency"))
        for name, attr in series:
            h = reg.histogram(name, g[name]["edges"])
            for r in done:
                v = getattr(r, attr)
                if v is not None:
                    h.observe(v)

    def summary(self, requests: List[ServeRequest], wall_s: float,
                sim_s: Optional[float] = None) -> dict:
        done = [r for r in requests if r.state == DONE]
        rejected = [r for r in requests if r.state == REJECTED]
        gen = sum(len(r.out) for r in done)
        self._record_run(done, len(rejected), gen)
        tier_reqs = Counter(r.tier for r in done if r.tier is not None)
        tier_toks: Counter = Counter()
        for r in done:
            if r.tier is not None:
                tier_toks[r.tier] += len(r.out)
        with_deadline = [r for r in done if r.deadline is not None]
        met = sum(1 for r in with_deadline if r.deadline_met)
        # throughput is measured on the serving clock: simulated seconds in
        # virtual-time mode (deterministic; host wall time there is
        # host overhead), wall seconds in realtime mode
        served_s = sim_s if sim_s is not None else wall_s
        return {
            "requests": len(requests),
            "completed": len(done),
            "rejected": len(rejected),
            "generated_tokens": gen,
            "engine_steps": self.engine_steps,
            "wall_s": round(wall_s, 4),
            "sim_s": round(sim_s, 6) if sim_s is not None else None,
            "req_per_s": round(len(done) / max(served_s, 1e-9), 2),
            "tok_per_s": round(gen / max(served_s, 1e-9), 1),
            "ttft": dist(r.ttft for r in done),
            "tpot": dist(r.tpot for r in done),
            "latency": dist(r.latency for r in done),
            "queue_depth": dist(self._queue_depth, 2),
            "slot_occupancy": {t: dist(v, 3)
                               for t, v in sorted(self._occupancy.items())},
            "tier_requests": dict(sorted(tier_reqs.items())),
            "tier_tokens": dict(sorted(tier_toks.items())),
            "deadlines": {"with_deadline": len(with_deadline), "met": met,
                          "missed": len(with_deadline) - met},
            # the AsyncServer overwrites these with its failover /
            # brownout tallies; the defaults keep the summary shape
            # stable for collectors that never see a fault
            "failover": {"worker_deaths": 0, "retries": 0,
                         "migrations": 0, "lost": 0, "snapshots": 0,
                         "restored": 0, "reprefilled": 0,
                         "tokens_recovered": 0, "tokens_reprefilled": 0,
                         "mode": "restore"},
            "brownout": {"transitions": 0, "max_level": 0},
        }


def validate_summary(stats: dict) -> dict:
    """Assert the metrics-dict shape (CI serve-smoke lane contract).

    Returns ``stats`` so it composes in expressions; raises ``ValueError``
    listing everything wrong otherwise.
    """
    problems = []
    for key in SUMMARY_KEYS:
        if key not in stats:
            problems.append(f"missing key {key!r}")
    for key in ("ttft", "tpot", "latency", "queue_depth"):
        d = stats.get(key)
        if d is not None and set(d) != set(DIST_KEYS):
            problems.append(f"{key!r} must have keys {DIST_KEYS}, got "
                            f"{tuple(d)}")
    counts = ("requests", "completed", "rejected", "generated_tokens",
              "engine_steps")
    for key in counts:
        v = stats.get(key)
        if key in stats and not isinstance(v, int):
            problems.append(f"{key!r} must be an int, got {type(v).__name__}")
    if not problems and \
            stats["completed"] + stats["rejected"] > stats["requests"]:
        problems.append("completed + rejected exceeds requests")
    tr = stats.get("tier_requests")
    if isinstance(tr, dict) and isinstance(stats.get("completed"), int):
        if sum(tr.values()) != stats["completed"]:
            problems.append("tier_requests histogram does not sum to "
                            "completed")
    fo = stats.get("failover")
    if isinstance(fo, dict):
        for key in ("worker_deaths", "retries", "migrations", "lost",
                    "snapshots", "restored", "reprefilled",
                    "tokens_recovered", "tokens_reprefilled"):
            if not isinstance(fo.get(key), int):
                problems.append(f"failover[{key!r}] must be an int")
    if problems:
        raise ValueError("bad serving metrics summary: "
                         + "; ".join(problems))
    return stats
