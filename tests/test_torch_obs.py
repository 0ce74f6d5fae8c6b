"""The port's observability (``repro_torch.obs``) against the reference's
``repro.obs``: metrics snapshots and Prometheus text, Chrome traces, the
snapshot CLI, the calibrator's drift check, the zero-cost off switch, and
the counters the served smoke lane moves.

Both packages' ``obs`` modules are standard-library code with the same
metric names, so every comparison here is exact; only clock values
(``ts``/``dur`` of runtime spans, thread ids) are left out of the trace
comparison.
"""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.registry import get_config as jget_config
from repro.engine import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.obs import __main__ as jcli
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.request import ServeRequest as JRequest
from repro_torch import obs as tobs
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.kernels import ops as tops
from repro_torch.obs import __main__ as tcli
from repro_torch.serving.engine import ServeEngine as TEngine
from repro_torch.serving.request import ServeRequest as TRequest

torch.set_num_threads(1)

SPEC = "planes=3,encoding=ent,impl=pallas_fused,act_quant=per_token"


def _drive(obs):
    """One sequence of counter, gauge and histogram updates on a fresh
    preset registry of ``obs``."""
    reg = obs.MetricsRegistry(preset=True)
    reg.counter("repro_serve_admitted_total").inc()
    reg.counter("repro_serve_admitted_total").inc(4)
    reg.counter("repro_gemm_dispatch_total").labels(route="dense").inc(3)
    reg.counter("repro_gemm_dispatch_total").labels(route="sparse").inc()
    reg.gauge("repro_serve_brownout_level").set(2.0)
    reg.gauge("repro_cost_drift_ratio").labels(impl="pallas").set(1.25)
    reg.gauge("repro_cost_drift_ratio").labels(impl="pallas").inc(0.5)
    h = reg.histogram("repro_serve_ttft_seconds",
                      obs.GLOSSARY["repro_serve_ttft_seconds"]["edges"])
    for v in (1e-6, 3e-4, 0.02, 0.5, 7.0, 100.0):
        h.observe(v)
    d = reg.histogram("repro_schedule_density",
                      obs.GLOSSARY["repro_schedule_density"]["edges"])
    for v in (0.05, 0.5, 0.75, 1.0):
        d.labels(tier="fast").observe(v)
    reg.counter("repro_port_extra_total", "a family outside the glossary"
                ).labels(a="x", b="y").inc(2)
    return reg


def test_glossary_and_env_names_match_reference():
    assert tobs.GLOSSARY == jobs.GLOSSARY
    assert tobs.ENV_TRACE == jobs.ENV_TRACE == "REPRO_TRACE"
    from repro import chaos as jchaos
    from repro_torch import chaos as tchaos
    assert tchaos.ENV_CHAOS == jchaos.ENV_CHAOS == "REPRO_CHAOS"
    assert tchaos.FAULT_SITES == jchaos.FAULT_SITES


def test_metrics_snapshot_and_prometheus_match_reference():
    j, t = _drive(jobs), _drive(tobs)
    assert t.snapshot() == j.snapshot()
    assert t.prometheus_text() == j.prometheus_text()
    assert t.names() == j.names()
    t.reset()
    j.reset()
    assert t.snapshot() == j.snapshot()


def test_diff_and_load_snapshot_match_reference(tmp_path):
    a = _drive(tobs).snapshot()
    reg = _drive(tobs)
    reg.counter("repro_serve_admitted_total").inc()
    b = reg.snapshot()
    assert tobs.diff_snapshots(a, b) == jobs.diff_snapshots(a, b)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(b))
    assert tobs.load_snapshot(str(path)) == jobs.load_snapshot(str(path))


def _trace_sequence(obs):
    obs.enable(clear_events=True)
    try:
        with obs.span("plan.build_schedule", order="m_major", blocks=12):
            with obs.span("ops.planned_dense_apply", cat="kernel",
                          route="dense", m=40, k=64, n=2) as sp:
                sp.set(extra=1)
        obs.instant("serve.snapshot", cat="serve", rid=3, pos=5)
        obs.trace.complete_event("QUEUED", 0.25, 0.5, tid=3,
                                 args={"tier": "fast"})
        obs.trace.complete_event("DECODE", 1.0, 0.75, tid=4)
        doc = obs.trace.to_chrome()
    finally:
        obs.disable()
        obs.clear_trace()
    return doc


def _clockless(doc):
    out = []
    for ev in doc["traceEvents"]:
        ev = dict(ev)
        if ev.get("pid") == jobs.PID_RUNTIME and ev.get("ph") != "M":
            ev.pop("ts", None)
            ev.pop("dur", None)
            ev.pop("tid", None)
        out.append(ev)
    return out


def test_chrome_trace_matches_reference_clocks_aside():
    j, t = _trace_sequence(jobs), _trace_sequence(tobs)
    assert t["displayTimeUnit"] == j["displayTimeUnit"]
    assert _clockless(t) == _clockless(j)
    # explicit-timestamp events carry their (serving-clock) times exactly
    serve = [e for e in t["traceEvents"] if e.get("pid") == tobs.PID_SERVER
             and e.get("ph") == "X"]
    assert [(e["ts"], e["dur"]) for e in serve] == [(250000.0, 250000.0),
                                                    (1000000.0, 0.0)]


def test_tracing_off_returns_null_span_and_records_nothing():
    tobs.disable()
    tobs.clear_trace()
    assert not tobs.enabled()
    sp = tobs.span("x", a=1)
    assert sp is tobs.NULL_SPAN
    with sp as inner:
        inner.set(b=2)
    tobs.instant("y")
    tobs.trace.complete_event("QUEUED", 0.0, 1.0)
    assert tobs.trace_events() == []
    tobs.enable(clear_events=True)
    try:
        assert tobs.span("x") is not tobs.NULL_SPAN
    finally:
        tobs.disable()
        tobs.clear_trace()


@pytest.mark.parametrize("argv", [["render", "{snap}"],
                                  ["render", "{snap}", "--format", "prom"],
                                  ["render", "{snap}", "--format", "json"],
                                  ["diff", "{snap0}", "{snap}"],
                                  ["diff", "{snap}", "{snap}"],
                                  ["trace", "{trace}"],
                                  ["render", "{missing}"]])
def test_cli_prints_what_the_reference_prints(argv, tmp_path, capsys):
    paths = {"snap0": tmp_path / "a.json", "snap": tmp_path / "b.json",
             "trace": tmp_path / "t.json",
             "missing": tmp_path / "nope.json"}
    paths["snap0"].write_text(json.dumps(
        tobs.MetricsRegistry(preset=True).snapshot()))
    paths["snap"].write_text(json.dumps(_drive(tobs).snapshot()))
    paths["trace"].write_text(json.dumps(_trace_sequence(tobs)))
    args = [a.format(**{k: str(v) for k, v in paths.items()})
            for a in argv]
    rc_j = jcli.main(args)
    out_j = capsys.readouterr()
    rc_t = tcli.main(args)
    out_t = capsys.readouterr()
    assert rc_t == rc_j
    assert out_t.out == out_j.out
    assert out_t.err == out_j.err


def _calibrator_samples(obs):
    cal = obs.CostCalibrator(drift_threshold=3.0, min_samples=2)
    rng = np.random.default_rng(5)
    for i in range(6):
        for impl, scale in (("pallas", 1.0), ("pallas_fused", 1.3),
                            ("pallas_sparse", 9.0)):
            pred = float(rng.uniform(1e-4, 1e-3))
            cal.record(impl, pred, pred * scale * (1 + 0.01 * i),
                       shape=(4, 64, 64), source="realtime")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bad = cal.check()
    return (bad, cal.report(), cal.corrections(),
            [(w.category.__name__, str(w.message)) for w in caught])


def test_calibrator_drift_warning_fires_on_the_same_samples():
    jres, tres = _calibrator_samples(jobs), _calibrator_samples(tobs)
    assert tres[:3] == jres[:3]
    assert [m for _, m in tres[3]] == [m for _, m in jres[3]]
    assert [c for c, _ in tres[3]] == ["CostModelDriftWarning"]
    assert list(tres[0]) == ["pallas_sparse"]
    assert tobs.COST_MODEL_MISCALIBRATED == jobs.COST_MODEL_MISCALIBRATED


def test_predict_gemm_seconds_matches_reference():
    from repro.engine import QuantSpec as JS
    for impl in ("pallas_fused", "pallas_sparse", "planes"):
        js, ts = JS.parse(SPEC).replace(impl=impl), \
            TSpec.parse(SPEC).replace(impl=impl)
        assert tobs.predict_gemm_seconds(impl, 4, 2304, 5760, ts,
                                         density=0.5) == \
            jobs.predict_gemm_seconds(impl, 4, 2304, 5760, js, density=0.5)


def _lane(obs, ops, make_engine, make_request, vocab):
    obs.reset_metrics()
    ops.plan_cache_clear()          # its counts are process-wide
    obs.enable(clear_events=True)
    try:
        eng = make_engine()
        rng = np.random.default_rng(0)
        reqs = [make_request(i, rng.integers(0, vocab, 6).tolist(), 5)
                for i in range(3)]
        stats = eng.run(reqs)
        snap = obs.snapshot()
        names = sorted({e["name"] for e in obs.trace_events()})
    finally:
        obs.disable()
        obs.clear_trace()
        obs.reset_metrics()
    return eng, reqs, stats, snap, names


def test_smoke_lane_counters_match_reference():
    """The served smoke lane with tracing on: the plan-time counters
    (cache, schedule density, B copies elided) and the serving counters
    equal the reference's.  The dispatch counter counts calls in the
    port (7 per layer per step) where the reference counts its jit
    traces, so only its route labels are compared."""
    jcfg = jget_config("minicpm-2b", smoke=True)
    tcfg = tget_config("minicpm-2b", smoke=True)
    jeng, jreqs, jstats, jsnap, jnames = _lane(
        jobs, jops, lambda: JEngine(jcfg, 2, 16, quant=JSpec.parse(SPEC)),
        JRequest, jcfg.vocab_size)
    tree = jax.tree.map(np.asarray, jeng.params)
    teng, treqs, tstats, tsnap, tnames = _lane(
        tobs, tops, lambda: TEngine(tcfg, 2, 16, quant=TSpec.parse(SPEC),
                              params=params_from_numpy(tree, tcfg,
                                                       device="cpu"),
                              device="cpu"),
        TRequest, tcfg.vocab_size)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert set(tsnap) == set(jsnap)
    for name in ("repro_plan_cache_hits_total",
                 "repro_plan_cache_misses_total", "repro_schedule_density",
                 "repro_schedule_b_dma_elided_total",
                 "repro_serve_engine_steps_total",
                 "repro_serve_admitted_total", "repro_serve_rejected_total",
                 "repro_serve_snapshots_total", "repro_serve_restores_total"):
        assert tsnap[name] == jsnap[name], name
    hist = tsnap["repro_schedule_density"]["values"][""]
    assert hist["count"] == 7 * tcfg.n_layers
    disp = tsnap["repro_gemm_dispatch_total"]["values"]
    assert set(disp) == set(jsnap["repro_gemm_dispatch_total"]["values"]) \
        == {"route=dense"}
    assert disp["route=dense"] == 7 * tcfg.n_layers * teng.steps
    # the same spans and instants are emitted
    assert {"serve.decode_step", "ops.planned_dense_apply",
            "plan.build_schedule", "QUEUED", "PREFILL",
            "DECODE"} <= set(tnames)
    assert set(tnames) <= set(jnames) | {"ops.planned_dense_apply"}
    # the summary compares key for key
    assert set(tstats) == set(jstats)
    assert tstats["plan_cache"] == jstats["plan_cache"]
    assert tstats["quant_planes"] == jstats["quant_planes"] == 3
    assert set(teng.plan_stats) == set(jeng.quant.plan_stats)
    assert teng.plan_stats["schedules_verified"] == \
        jeng.quant.plan_stats["schedules_verified"]
