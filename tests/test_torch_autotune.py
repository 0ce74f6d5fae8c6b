"""The port's measured autotuner (``repro_torch.kernels.autotune``) and the
seams it feeds, against the reference's (``repro.kernels.autotune``) on
the same inputs: keys, buckets and candidates; every lookup of the
reference's checked-in cache; ``_resolve_dispatch``'s order-transfer
rules over every (dispatch, order, cached winner); block sizes and plan
arrays at the CI shapes; the cache file's contract (round trip, bad and
untagged entries, the strict warning, the chaos-corrupted load); and a
CPU sweep.  Plans are compared bit for bit.
"""
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import QuantSpec as JSpec
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro_torch import chaos
from repro_torch.engine import QuantSpec
from repro_torch.kernels import autotune, ops
from repro_torch.obs import metrics as obs_metrics

torch.set_num_threads(1)

SPECS = (None, 1, 2, 3, 4)          # None: the default plan grid
# (d_in, d_out) of the two CI shapes (kernel rows M = d_out, K = d_in)
CI_WEIGHTS = ((256, 192), (256, 256))


def _specs(planes):
    if planes is None:
        return None, None
    return JSpec(planes=planes), QuantSpec(planes=planes)


@pytest.fixture
def fresh_cache():
    """Isolate both packages' process-wide caches."""
    yield
    autotune.reset_cache()
    jautotune.reset_cache()


def _counter(name):
    snap = obs_metrics.get_registry().counter(name).snapshot()
    return sum(snap["values"].values())


# ---------------------------------------------------------------------------
# keys, buckets, candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planes", SPECS)
def test_cache_keys_equal_the_reference(planes):
    jspec, tspec = _specs(planes)
    for m, k, n in ((256, 256, 128), (2304, 5760, 4), (7, 9, 1)):
        for density in (None, 0.0, 0.1, 0.25, 0.3, 0.5, 0.5001, 0.75, 1.0):
            assert autotune.cache_key(m, k, n, tspec, density) == \
                jautotune.cache_key(m, k, n, jspec, density)
    spec = QuantSpec.parse("planes=2,block_m=256,block_k=128")
    assert autotune.cache_key(64, 64, 4, spec) == jautotune.cache_key(
        64, 64, 4, JSpec.parse("planes=2,block_m=256,block_k=128"))
    assert autotune.current_backend() == autotune.current_backend("cpu") \
        == jautotune.current_backend() == "interpret"


def test_card_backend_tag_is_queried_once_a_card(monkeypatch):
    """The 'auto' seam asks for the tag on every call: the card's name is
    read once per device index, and an unindexed device is the current
    one."""
    calls = []

    def name(index):
        calls.append(index)
        return f"card{index}"

    autotune._card_name.cache_clear()
    monkeypatch.setattr(torch.cuda, "get_device_name", name)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    try:
        for _ in range(3):
            assert autotune.current_backend("cuda:0") == "card0"
            assert autotune.current_backend(torch.device("cuda")) == "card1"
            assert autotune.current_backend(torch.device("cpu")) == \
                "interpret"
        assert calls == [0, 1]
    finally:
        autotune._card_name.cache_clear()


def test_density_buckets_equal_the_reference():
    for d in np.linspace(0.0, 1.2, 61):
        assert autotune.density_bucket(d) == jautotune.density_bucket(d)


@pytest.mark.parametrize("mkn", [(256, 256, 128), (192, 256, 128),
                                 (2304, 2304, 4), (5760, 2304, 4),
                                 (2304, 5760, 4), (100, 700, 300)])
def test_candidate_configs_equal_the_reference(mkn):
    got = autotune.candidate_configs(*mkn)
    assert got == jautotune.candidate_configs(*mkn)
    if mkn[2] == 4:
        assert len(got) == 24           # a decode sweep: 6 blocks x 4 routes
    assert autotune.ROUTE_CANDIDATES == jautotune.ROUTE_CANDIDATES
    assert autotune.CI_SHAPES == jautotune.CI_SHAPES


# ---------------------------------------------------------------------------
# the reference's checked-in cache
# ---------------------------------------------------------------------------

def test_checked_in_cache_is_the_reference_s():
    with open(autotune.DEFAULT_CACHE_PATH) as f:
        ours = json.load(f)
    with open(jautotune.DEFAULT_CACHE_PATH) as f:
        theirs = json.load(f)
    assert ours == theirs and len(ours["entries"]) == 20
    assert autotune.validate(autotune.DEFAULT_CACHE_PATH) == []
    cache = autotune.AutotuneCache.load(autotune.DEFAULT_CACHE_PATH)
    assert cache.coverage(autotune.CI_SHAPES) == []


@pytest.mark.parametrize("planes", SPECS)
def test_lookups_equal_the_reference_on_its_cache(planes):
    jspec, tspec = _specs(planes)
    tcache = autotune.AutotuneCache.load(jautotune.DEFAULT_CACHE_PATH)
    jcache = jautotune.AutotuneCache.load(jautotune.DEFAULT_CACHE_PATH)
    for m, k, n in autotune.CI_SHAPES + ((256, 256, 4), (512, 256, 128)):
        for density in (None, 0.2, 0.25, 0.5, 0.6, 0.75, 1.0):
            assert tcache.lookup(m, k, n, tspec, density) == \
                jcache.lookup(m, k, n, jspec, density)
    assert tcache.stats() == jcache.stats()
    # a card's lookups see none of the CPU's entries
    on_card = autotune.AutotuneCache("mem")
    on_card.entries = dict(tcache.entries)
    key = autotune.cache_key(256, 256, 128, tspec, backend="NVIDIA H100")
    assert key.endswith("|NVIDIA H100")
    assert on_card.coverage(autotune.CI_SHAPES, tspec,
                            backend="NVIDIA H100") == \
        list(autotune.CI_SHAPES)


# ---------------------------------------------------------------------------
# _resolve_dispatch's order-transfer rules
# ---------------------------------------------------------------------------

WINNERS = [None,
           {"dispatch": "dense", "order": "m_major"},
           {"dispatch": "sparse", "order": "m_major"},
           {"dispatch": "sparse", "order": "k_major"},
           {"dispatch": "pipelined", "order": "m_major"},
           {"dispatch": "pipelined", "order": "k_major"},
           {"dispatch": "sparse"},
           {"dispatch": "pipelined"},
           {"dispatch": "dense"}]


@pytest.mark.parametrize("winner", WINNERS,
                         ids=lambda w: "miss" if w is None else
                         f"{w['dispatch']}-{w.get('order', 'any')}")
def test_resolve_dispatch_equals_the_reference_for_every_winner(
        winner, fresh_cache):
    text = "planes=2,encoding=ent,act_quant=per_token"
    jspec, tspec = JSpec.parse(text), QuantSpec.parse(text)
    for steps in (17, 18, 19, 36):                   # mask of 36 blocks
        jplan = {"mask": np.zeros((4, 3, 3), bool),
                 "schedule": np.zeros((steps, 9), np.int32)}
        tplan = {"mask": torch.zeros(4, 3, 3, dtype=torch.bool),
                 "schedule": torch.zeros(steps, 9, dtype=torch.int32)}
        density = steps / 36
        for pkg, spec in ((autotune, tspec), (jautotune, jspec)):
            cache = pkg.AutotuneCache("mem")
            if winner is not None:
                cache.record(520, 300, 3, spec,
                             dict(winner, block_m=128, block_k=128,
                                  block_n=128), density=density)
            pkg.set_cache(cache)
        for dispatch in ops.DISPATCHES:
            for order in ops.SCHEDULE_ORDERS:
                args = (520, 300, 3, order)
                try:
                    want = jops._resolve_dispatch(dispatch, jplan, jspec,
                                                  *args)
                except ValueError:
                    with pytest.raises(ValueError):
                        ops._resolve_dispatch(dispatch, tplan, tspec, *args)
                    continue
                got = ops._resolve_dispatch(dispatch, tplan, tspec, *args)
                assert got == want, (dispatch, order, steps, winner)


def test_auto_dispatch_follows_the_cache_and_keeps_the_math(fresh_cache):
    """A cached 'dense' winner moves a low-density plan off the sparse
    route; both routes give the same numbers."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, size=(4, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.05, size=(96, 64))
                         .astype(np.float32))
    spec = QuantSpec(planes=2, impl="pallas_sparse")
    plan = ops.plan_dense_weight(w, spec)
    density = plan["schedule"].shape[0] / plan["mask"].numel()
    assert ops._resolve_dispatch("auto", plan, spec, 64, 96, 4,
                                 "m_major") == "sparse"
    cache = autotune.AutotuneCache("mem")
    cache.record(64, 96, 4, spec, {"block_m": 128, "block_k": 128,
                                   "block_n": 128, "dispatch": "dense"},
                 density=density)
    autotune.set_cache(cache)
    assert ops._resolve_dispatch("auto", plan, spec, 64, 96, 4,
                                 "m_major") == "dense"
    forced = ops.planned_dense_apply(plan, x, spec, 64, dispatch="auto")
    autotune.reset_cache()
    free = ops.planned_dense_apply(plan, x, spec, 64, dispatch="auto")
    assert torch.equal(forced, free)
    assert cache.hits == 2


# ---------------------------------------------------------------------------
# block sizes and plans at the CI shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planes", SPECS)
@pytest.mark.parametrize("d_in,d_out", CI_WEIGHTS)
def test_block_sizes_and_plans_equal_the_reference_at_ci_shapes(
        planes, d_in, d_out, fresh_cache):
    jspec, tspec = _specs(planes)
    got = ops.select_block_sizes(d_out, d_in, 128, tspec)
    want = jops.select_block_sizes(d_out, d_in, 128, jspec)
    assert got == want
    hit = autotune.get_cache().lookup(d_out, d_in, 128, tspec)
    assert got == (hit["block_m"], hit["block_k"], hit["block_n"])
    if planes is None:
        return
    rng = np.random.default_rng(d_out + planes)
    w = (rng.standard_t(4, size=(d_in, d_out)) * 0.02).astype(np.float32)
    for order in ops.SCHEDULE_ORDERS:
        jrec = jops.plan_dense_weight(jnp.asarray(w), jspec, use_cache=False,
                                      order=order, verify=False)
        trec = ops.plan_dense_weight(torch.from_numpy(w), tspec,
                                     use_cache=False, order=order)
        assert set(trec) == set(jrec)
        for key in jrec:
            np.testing.assert_array_equal(trec[key].numpy(),
                                          np.asarray(jrec[key]),
                                          err_msg=f"{order} {key}")


# ---------------------------------------------------------------------------
# the cache file's contract
# ---------------------------------------------------------------------------

def test_cache_roundtrip(tmp_path, fresh_cache):
    path = str(tmp_path / "cache.json")
    cache = autotune.AutotuneCache(path)
    spec = QuantSpec(planes=3)
    cfg = {"block_m": 256, "block_k": 128, "block_n": 128,
           "dispatch": "sparse"}
    cache.record(256, 512, 128, spec, cfg, density=0.3)
    cache.save()
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    loaded = autotune.AutotuneCache.load(path)
    hit = loaded.lookup(256, 512, 128, spec, density=0.28)
    assert hit["dispatch"] == "sparse" and hit["block_m"] == 256
    assert hit["backend"] == "interpret"
    assert loaded.lookup(256, 512, 128, spec) is not None
    assert loaded.lookup(999, 512, 128, spec) is None
    # the reference reads the port's file and answers the same
    jloaded = jautotune.AutotuneCache.load(path)
    assert jloaded.lookup(256, 512, 128, JSpec(planes=3),
                          density=0.28) == hit


def test_cache_rejects_bad_and_untagged_entries(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({
        "version": autotune.CACHE_FORMAT_VERSION,
        "entries": {"8x8x8|default|interpret": {
            "block_m": 100, "block_k": 128, "block_n": 128,
            "backend": "interpret"}}}))
    with pytest.raises(ValueError, match="multiple of 128"):
        autotune.AutotuneCache.load(str(path))
    path.write_text(json.dumps({"version": 99, "entries": {}}))
    with pytest.raises(ValueError, match="format version"):
        autotune.AutotuneCache.load(str(path))
    path.write_text(json.dumps({
        "version": autotune.CACHE_FORMAT_VERSION,
        "entries": {"128x128x128|default|interpret": {
            "block_m": 128, "block_k": 128, "block_n": 128,
            "dispatch": "sparse"}}}))          # no "backend" field
    with pytest.raises(ValueError, match="backend tag"):
        autotune.AutotuneCache.load(str(path))
    problems = autotune.validate(str(path))
    assert problems and "backend" in problems[0]
    assert jautotune.validate(str(path))


def test_strict_cache_warns_once_per_key(fresh_cache):
    cache = autotune.AutotuneCache("explicit.json", strict=True)
    cache.entries["1x1x1|default"] = {"block_m": 128, "block_k": 128,
                                      "block_n": 128}
    autotune.set_cache(cache)
    before = _counter("repro_autotune_miss_warnings_total")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sel = ops.select_block_sizes(4096, 4096, 512)
        ops.select_block_sizes(4096, 4096, 512)      # same key: no re-warn
        ops.select_block_sizes(4096, 2048, 512)      # another key: warns
    assert sel == (256, 512, 256)                    # static table fallback
    hits = [w for w in rec
            if issubclass(w.category, autotune.AutotuneCacheMissWarning)]
    assert len(hits) == 2
    assert "falling back to the static block table" in str(hits[0].message)
    assert _counter("repro_autotune_miss_warnings_total") == before + 2


def test_env_var_selects_a_strict_cache(tmp_path, monkeypatch, fresh_cache):
    path = tmp_path / "env_cache.json"
    cache = autotune.AutotuneCache(str(path))
    cache.record(320, 320, 128, None,
                 {"block_m": 128, "block_k": 256, "block_n": 128,
                  "dispatch": "dense"})
    cache.save()
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.reset_cache()
    got = autotune.get_cache()
    assert got.strict is True
    assert ops.select_block_sizes(320, 320, 128) == (128, 256, 128)


def test_chaos_corrupt_cache_falls_back_once(tmp_path, fresh_cache):
    path = tmp_path / "cache.json"
    good = autotune.AutotuneCache(str(path))
    good.record(256, 256, 128, None,
                {"block_m": 128, "block_k": 128, "block_n": 128,
                 "dispatch": "dense", "order": "m_major"})
    good.save()
    before = _counter("repro_autotune_cache_load_errors_total")
    try:
        chaos.install("corrupt_cache")      # polled at autotune.load
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            cache = autotune.AutotuneCache.load(str(path),
                                                on_error="fallback")
            again = autotune.AutotuneCache.load(str(path),
                                                on_error="fallback")
    finally:
        chaos.uninstall()
    assert cache.entries == {}
    assert cache.lookup(256, 256, 128) is None       # static fallback
    assert again.entries                             # fired once
    assert len([w for w in rec if issubclass(
        w.category, autotune.AutotuneCacheMissWarning)]) == 1
    assert _counter("repro_autotune_cache_load_errors_total") == before + 1
    with pytest.raises(ValueError):                  # raise by default
        (tmp_path / "torn.json").write_text('{"version": 2, "entr')
        autotune.AutotuneCache.load(str(tmp_path / "torn.json"))


# ---------------------------------------------------------------------------
# the measured sweep, on the CPU
# ---------------------------------------------------------------------------

def test_cpu_sweep_records_a_winner(tmp_path, fresh_cache):
    cache = autotune.AutotuneCache(str(tmp_path / "t.json"))
    autotune.set_cache(cache)
    spec = QuantSpec(planes=2)
    seen = []
    before = _counter("repro_autotune_vmem_rejected_total")
    win = autotune.autotune_gemm(128, 256, 4, spec, cache=cache, iters=1,
                                 device="cpu",
                                 on_measure=lambda c, s: seen.append((c, s)))
    configs = autotune.candidate_configs(128, 256, 4)
    assert win["candidates"] == len(seen) == len(configs) == 8
    assert win["vmem_rejected"] == 0
    assert _counter("repro_autotune_vmem_rejected_total") == before
    assert win["backend"] == "interpret"
    assert win["dispatch"] in ("sparse", "dense", "pipelined")
    best = min(seen, key=lambda cs: cs[1])
    assert win["us"] == round(best[1] * 1e6)
    assert 0.0 < win["density"] <= 1.0
    hit = cache.lookup(128, 256, 4, spec, density=win["density"])
    assert hit == win
    assert ops.select_block_sizes(128, 256, 4, spec) == \
        (win["block_m"], win["block_k"], win["block_n"])
    cache.save()
    assert autotune.AutotuneCache.load(cache.path).entries == cache.entries


def test_cli_validate_and_sweep(tmp_path, capsys, fresh_cache):
    assert autotune.main(["--validate"]) == 0
    assert "parses and covers" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text("{torn")
    assert autotune.main(["--validate", "--cache", str(bad)]) == 1
    assert autotune.main([]) == 2
