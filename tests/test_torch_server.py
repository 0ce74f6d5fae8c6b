"""The port's serving stack (tiers, router, brownout, AsyncServer and its
failover) against the reference's ``AsyncServer`` on the smoke config.

The reference serves each scenario in a subprocess with XLA's excess
precision off (``--xla_allow_excess_precision=false``), as
test_torch_sparse.py's planes=2 lane does: with it on, XLA keeps fused
bf16 chains in float32, and on this config the fast tier's (planes=2)
greedy tokens flip (ROADMAP queue C3).  The subprocess also writes the
params its workers drew; the port's server takes that tree
(``convert.params_from_numpy``) and hands it to every worker, on the CPU.
In virtual mode the clock advances by the cost model's step times, which
are the reference's numbers (test_torch_cost.py), so a load routes the
same way in both packages: every request's tier, tokens and clock stamps
must be equal, and the virtual-clock summary within 1e-9 (the host's
``wall_s`` aside).
"""
import copy
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.serving import (DONE, ROUTER_POLICIES, AsyncServer,
                                 BrownoutPolicy, ServeEngine, ServeRequest,
                                 Tier, WorkerDied, default_tiers, loadgen,
                                 validate_summary)
from repro_torch.serving.engine import state_leaves
from repro_torch.serving.metrics import SUMMARY_KEYS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BATCH = 2
MAX_LEN = 16
SCALE = 5e4
HOST_KEYS = ("wall_s",)
STAMPS = ("admitted_at", "first_token_at", "finished_at")

# name -> (tiers, router, load seed, n, pattern, brownout, chaos, failover)
SCENARIOS = {}
for _r in ROUTER_POLICIES:
    SCENARIOS[f"two-{_r}"] = (2, _r, 0, 10, "poisson", None, None,
                              "restore")
    SCENARIOS[f"three-{_r}"] = (3, _r, 1, 12, "poisson", None, None,
                                "restore")
SCENARIOS["two-brownout"] = (2, "quality", 0, 12, "burst", (6.0, 2.0),
                             None, "restore")
for _m in ("restart", "restore"):
    SCENARIOS[f"two-kill-{_m}"] = (2, "slo", 3, 12, "poisson", None,
                                   "kill:fast@s3", _m)

_REFERENCE_SERVER = """
import pickle, sys
import jax, numpy as np
from repro.configs.registry import get_config
from repro.serving import AsyncServer, BrownoutPolicy, default_tiers, loadgen
SCENARIOS = %r
cfg = get_config("minicpm-2b", smoke=True)
servers, out = {}, {"runs": {}}
for name, (n_tiers, router, seed, n, pattern, brown, chaos,
           failover) in SCENARIOS.items():
    srv = servers.get(n_tiers)
    if srv is None:
        srv = servers[n_tiers] = AsyncServer(
            cfg, tiers=default_tiers(n_tiers, batch=%d), max_len=%d,
            seed=0, router="slo", step_time_scale=%r, retry_budget=4)
    srv.router.policy, srv.router._rr = router, 0
    srv.router.brownout = BrownoutPolicy(*brown) if brown else None
    srv.chaos, srv.failover = chaos, failover
    reqs = loadgen.synthesize(cfg.vocab_size, n, prompt_len=(3, 6),
                              max_tokens=(3, 6), pattern=pattern, rate=50,
                              deadline_slack=(0.1, 1.5), seed=seed)
    stats = srv.run(reqs)
    out["runs"][name] = ([dict(rid=r.rid, state=r.state, tier=r.tier,
                               out=list(r.out), retries=r.retries,
                               migrations=r.migrations,
                               **{s: getattr(r, s) for s in %r})
                          for r in reqs], stats)
w = next(iter(servers[2].workers.values()))
out["params"] = jax.tree.map(np.asarray, w.engine.params)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (SCENARIOS, BATCH, MAX_LEN, SCALE, STAMPS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every scenario served by the reference, excess precision off."""
    path = tmp_path_factory.mktemp("ref") / "runs.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, "-c", _REFERENCE_SERVER,
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(ref):
    cfg = tget_config("minicpm-2b", smoke=True)
    params = params_from_numpy(ref["params"], cfg, device="cpu")
    servers = {n: AsyncServer(cfg, tiers=default_tiers(n, batch=BATCH),
                              max_len=MAX_LEN, seed=0, router="slo",
                              step_time_scale=SCALE, retry_budget=4,
                              params=params, device="cpu")
               for n in (2, 3)}
    return {"cfg": cfg, "params": params, "servers": servers}


def _load(cfg, n=10, seed=0, pattern="poisson"):
    return loadgen.synthesize(cfg.vocab_size, n, prompt_len=(3, 6),
                              max_tokens=(3, 6), pattern=pattern, rate=50,
                              deadline_slack=(0.1, 1.5), seed=seed)


def _serve(port, name):
    n_tiers, router, seed, n, pattern, brown, chaos, failover = \
        SCENARIOS[name]
    srv = port["servers"][n_tiers]
    srv.router.policy, srv.router._rr = router, 0
    srv.router.brownout = BrownoutPolicy(*brown) if brown else None
    srv.chaos, srv.failover = chaos, failover
    try:
        reqs = _load(port["cfg"], n, seed, pattern)
        return reqs, srv.run(reqs)
    finally:
        srv.router.policy, srv.router.brownout = "slo", None
        srv.chaos, srv.failover = None, "restore"


def _close(a, b, path=""):
    """Equal structure; floats within 1e-9."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert a is not None and b is not None, (path, a, b)
        assert abs(a - b) <= 1e-9, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _assert_same_run(ref, port, name):
    jreqs, jstats = ref["runs"][name]
    treqs, tstats = _serve(port, name)
    validate_summary(tstats)
    assert set(SUMMARY_KEYS) <= set(tstats)
    got = [dict(rid=r.rid, state=r.state, tier=r.tier, out=list(r.out),
                retries=r.retries, migrations=r.migrations,
                **{s: getattr(r, s) for s in STAMPS}) for r in treqs]
    _close({str(i): g for i, g in enumerate(got)},
           {str(i): j for i, j in enumerate(jreqs)})
    _close({k: v for k, v in tstats.items() if k not in HOST_KEYS},
           {k: v for k, v in jstats.items() if k not in HOST_KEYS})
    return treqs, tstats


@pytest.mark.parametrize("router", ROUTER_POLICIES)
def test_two_tier_virtual_run_matches_reference(ref, port, router):
    treqs, tstats = _assert_same_run(ref, port, f"two-{router}")
    assert tstats["completed"] == 10
    if router in ("round_robin", "slo"):
        assert set(tstats["tier_requests"]) == {"fast", "quality"}


@pytest.mark.parametrize("router", ROUTER_POLICIES)
def test_three_tier_virtual_run_matches_reference(ref, port, router):
    treqs, tstats = _assert_same_run(ref, port, f"three-{router}")
    assert tstats["completed"] == 12
    if router == "round_robin":
        assert set(tstats["tier_requests"]) == {"fast", "balanced",
                                                "quality"}


def test_tier_tokens_equal_standalone_engines(port):
    """Every request's tokens are a standalone engine's on its tier's
    spec (the port's own invariant, on the shared params)."""
    treqs, tstats = _serve(port, "two-slo")
    assert tstats["completed"] == 10
    for tier in port["servers"][2].tiers:
        mine = [r for r in treqs if r.tier == tier.name]
        clones = [ServeRequest(r.rid, list(r.prompt), r.max_tokens)
                  for r in mine]
        ServeEngine(port["cfg"], tier.batch, MAX_LEN, quant=tier.spec,
                    params=port["params"], device="cpu").run(clones)
        assert mine and [c.out for c in clones] == [r.out for r in mine]


def test_brownout_transitions_match_reference(ref, port):
    """A burst over a tiny slot pool degrades and recovers at the same
    clock values in both packages."""
    _, tstats = _assert_same_run(ref, port, "two-brownout")
    assert tstats["brownout"]["transitions"] >= 2
    assert tstats["brownout"]["max_level"] >= 1
    assert len(tstats["tier_requests"]) == 2


@pytest.mark.parametrize("mode", ["restart", "restore"])
def test_kill_fast_at_step_3_matches_reference(ref, port, mode):
    treqs, tstats = _assert_same_run(ref, port, f"two-kill-{mode}")
    fo = tstats["failover"]
    assert fo["worker_deaths"] == 1 and fo["lost"] == 0
    assert fo["migrations"] >= 1 and fo["mode"] == mode
    assert tstats["chaos"]["fired"] == 1
    assert all(r.state == DONE for r in treqs)
    if mode == "restore":
        assert fo["tokens_recovered"] >= 1


def test_engine_bug_surfaces_as_worker_died(port):
    """An exception inside a worker's engine (not an injected fault) is
    re-raised from run() as WorkerDied."""
    srv = port["servers"][2]
    worker = srv.workers["quality"]

    def boom(now=None):
        raise RuntimeError("engine bug")

    worker.engine.step = boom
    try:
        with pytest.raises(WorkerDied, match="engine bug"):
            srv.run(_load(port["cfg"], 4))
        assert not worker.alive
    finally:
        del worker.engine.step
    stats = srv.run(_load(port["cfg"], 4))
    assert stats["completed"] == 4      # the next run revives the tier


def test_realtime_single_tier_matches_virtual(port):
    """Threaded wall-clock mode on one tier gives virtual mode's tokens.
    The watchdog's miss limit is set far above any machine-load stall,
    so only a real fault could declare the worker dead."""
    tier = (Tier("only", default_tiers(1)[0].spec, BATCH),)
    srv = AsyncServer(port["cfg"], tiers=tier, max_len=MAX_LEN,
                      router="fastest", step_time_scale=SCALE,
                      watchdog_miss_limit=10 ** 6, params=port["params"],
                      device="cpu")
    virt = _load(port["cfg"], 6, seed=4)
    real = _load(port["cfg"], 6, seed=4)
    v_stats = validate_summary(srv.run(virt))
    r_stats = validate_summary(srv.run(real, realtime=True,
                                       time_scale=0.01))
    assert v_stats["completed"] == r_stats["completed"] == 6
    assert (v_stats["mode"], r_stats["mode"]) == ("virtual", "realtime")
    assert [r.out for r in real] == [r.out for r in virt]
    assert r_stats["failover"]["worker_deaths"] == 0
    assert threading.active_count() < 10          # worker threads joined


def test_server_shares_one_params_tree(port):
    """Every worker serves from the one tree it was given, unmutated."""
    params, srv = port["params"], port["servers"][2]
    before = copy.deepcopy(params)
    for w in srv.workers.values():
        assert w.engine.params["embed"]["table"] is \
            params["embed"]["table"]
        assert w.engine.params["blocks"][0]["attn"]["wq"]["w"] is \
            params["blocks"][0]["attn"]["wq"]["w"]
    srv.run(_load(port["cfg"], 4))
    assert all(torch.equal(a, b) for a, b in
               zip(state_leaves(params), state_leaves(before)))
    assert all("w_plan" not in layer["attn"]["wq"]
               for layer in params["blocks"])


def test_launcher_serves_two_tiers_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--tiers", "2", "--smoke", "--device", "cpu",
                     "--requests", "4", "--max-tokens", "4",
                     "--arrival", "poisson", "--json"])
    assert rc == 0
    assert '"completed": 4' in capsys.readouterr().out


@pytest.mark.parametrize("smoke, flags, scale", [
    (False, [], 1.0), (True, [], 5e4),
    (False, ["--step-time-scale", "3"], 3.0)])
def test_launcher_step_time_scale_follows_the_width(monkeypatch, smoke,
                                                    flags, scale):
    """Virtual mode prices a full-width step at the cost model's estimate
    and stretches it 5e4-fold only at smoke size (the reference launcher's
    scale, whose models are always smoke-sized), unless
    --step-time-scale says otherwise.  The workers are stubbed so that no
    full-width engine is built; the server's own pricing runs."""
    from types import SimpleNamespace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serving import (default_tiers, estimate_step_time,
                                     server as server_mod)

    class Built(Exception):
        pass

    class Worker:
        def __init__(self, tier, *args, **kwargs):
            self.tier = tier
            self.engine = SimpleNamespace(plan_density=None)

    built = []
    real = serve.AsyncServer

    def capture(*args, **kwargs):
        built.append(real(*args, **kwargs))
        raise Built

    monkeypatch.setattr(server_mod, "TierWorker", Worker)
    monkeypatch.setattr(api, "get_api",
                        lambda cfg: SimpleNamespace(init=lambda *a: {}))
    monkeypatch.setattr(serve, "AsyncServer", capture)
    with pytest.raises(Built):
        serve.main(["--tiers", "2", "--device", "cpu", "--batch", "4"]
                   + (["--smoke"] if smoke else []) + flags)
    cfg = get_config("minicpm-2b", smoke=smoke)
    assert built[0].router.per_step == {
        t.name: estimate_step_time(cfg, 4, t.spec) * scale
        for t in default_tiers(2, batch=4)}


def test_launcher_mesh_names_the_multi_device_queue():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="A9"):
        serve.main(["--tiers", "2", "--smoke", "--device", "cpu",
                    "--mesh", "2x2"])


def test_kernel_dispatch_chaos_site_raises(port):
    """REPRO_CHAOS's kernel.dispatch site is in planned_dense_apply: an
    armed kernel_raise fault for the call's route raises there once."""
    from repro_torch import chaos
    from repro_torch.kernels import ops
    layer = port["servers"][2].workers["quality"].engine.params["blocks"][0]
    rec = layer["attn"]["wq"]
    x = torch.ones((2, rec["w"].shape[0]))
    spec = port["servers"][2].tiers[-1].spec
    plan = chaos.install("kernel_raise:sparse;kernel_raise:dense")
    try:
        with pytest.raises(chaos.InjectedFault, match="kernel_raise"):
            ops.planned_dense_apply(rec["w_plan"], x, spec,
                                    rec["w"].shape[1])
        assert plan.summary()["fired"] == 1
        ops.planned_dense_apply(rec["w_plan"], x, spec, rec["w"].shape[1])
    finally:
        chaos.uninstall()
    assert not chaos.enabled()
