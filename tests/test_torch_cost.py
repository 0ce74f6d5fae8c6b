"""The port's cost model, hardware model, spec flags and plan cache
against the reference package.

``GemmEngine.cost`` / ``predict_seconds`` are pure arithmetic over shapes,
the spec, a density and (optionally) a plan's block grid and schedule, so
every number must be equal: the dicts compare with ``==``, the seconds
too.  Plans are built by each package from the same numpy weight (the
reference's with ``use_cache=False``), so a plan-derived density or
schedule count is the same input on both sides.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import hwmodel as jhw
from repro.engine import QuantSpec as JSpec
from repro.engine import get_engine as jget_engine
from repro.engine import spec_from_flags as jspec_from_flags
from repro.kernels import ops as jops
from repro.serving import tiers as jtiers
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.core import hwmodel as thw
from repro_torch.engine import IMPLS
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.engine import get_engine as tget_engine
from repro_torch.engine import spec_from_flags as tspec_from_flags
from repro_torch.kernels import ops as tops
from repro_torch.serving import tiers as ttiers

torch.set_num_threads(1)

PLANES = (2, 3, 4)


def _spec_text(impl, planes):
    return f"planes={planes},encoding=ent,impl={impl},act_quant=per_token"


def _gemms(smoke):
    """The distinct (m, k, n) of one decode step at batch 4."""
    cfg = jget_config("minicpm-2b", smoke=smoke)
    return sorted(set(jtiers.decode_step_gemms(cfg, 4)))


def _weight(k, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_cost_and_predict_seconds_match_reference(impl, smoke):
    """Every engine, planes 2/3/4, every GEMM of a decode step, density
    None and given, and with a shard grid: equal dicts and seconds."""
    for (m, k, n), planes in itertools.product(_gemms(smoke), PLANES):
        js = JSpec.parse(_spec_text(impl, planes))
        ts = TSpec.parse(_spec_text(impl, planes))
        for kw in ({}, {"density": 0.3125}, {"shards": (2, 2)},
                   {"density": 0.5, "shards": (4, 1)}):
            want = jget_engine(impl).cost(m, k, n, js, **kw)
            got = tget_engine(impl).cost(m, k, n, ts, **kw)
            assert got == want, (impl, m, k, n, planes, kw)
            for design in ("tpu", "opt4c"):
                assert tget_engine(impl).predict_seconds(
                    m, k, n, ts, design=design, **kw) == \
                    jget_engine(impl).predict_seconds(
                        m, k, n, js, design=design, **kw)


@pytest.mark.parametrize("impl", IMPLS)
def test_cost_from_a_plan_matches_reference(impl):
    """With a plan record in hand the kernel engines read its block grid,
    density and schedule: the smoke widths' weights at planes 2/3/4, and
    one full-width projection at planes 2, planned by each package."""
    cases = [(k, n, p) for (_, k, n) in _gemms(True) if n <= 256
             for p in PLANES] + [(2304, 2304, 2)]
    order = "k_major" if impl == "pallas_pipelined" else "m_major"
    for i, (k, n, planes) in enumerate(cases):
        w = _weight(k, n, i)
        js = JSpec.parse(_spec_text(impl, planes))
        ts = TSpec.parse(_spec_text(impl, planes))
        jplan = jops.plan_dense_weight(jnp.asarray(w), js, use_cache=False,
                                       order=order, verify=False)
        tplan = tops.plan_dense_weight(torch.from_numpy(w), ts,
                                       use_cache=False, order=order)
        for m in (1, 4):
            want = jget_engine(impl).cost(m, k, n, js, plan=jplan)
            got = tget_engine(impl).cost(m, k, n, ts, plan=tplan)
            assert got == want, (impl, m, k, n, planes)
            assert tget_engine(impl).predict_seconds(
                m, k, n, ts, plan=tplan) == jget_engine(
                    impl).predict_seconds(m, k, n, js, plan=jplan)


def test_hwmodel_tables_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in thw.TABLE7.items()} == \
        {k: dataclasses.asdict(v) for k, v in jhw.TABLE7.items()}
    assert thw.efficiency_ratios() == jhw.efficiency_ratios()
    assert thw.table7_report() == jhw.table7_report()
    for name in thw.TABLE7:
        assert thw.peak_tops(thw.TABLE7[name]) == \
            jhw.peak_tops(jhw.TABLE7[name])


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_step_cost_and_estimate_match_reference(smoke):
    jcfg = jget_config("minicpm-2b", smoke=smoke)
    tcfg = tget_config("minicpm-2b", smoke=smoke)
    for impl, planes, density, shards, batch in itertools.product(
            ("pallas_fused", "pallas_sparse", "pallas_pipelined", "planes"),
            PLANES, (None, 0.4), (None, (2, 2)), (1, 4)):
        js = JSpec.parse(_spec_text(impl, planes))
        ts = TSpec.parse(_spec_text(impl, planes))
        assert ttiers.step_cost(tcfg, batch, ts, density, shards) == \
            jtiers.step_cost(jcfg, batch, js, density, shards)
        for design in ("tpu", "opt1_tpu"):
            assert ttiers.estimate_step_time(
                tcfg, batch, ts, design, density, shards, 1.5) == \
                jtiers.estimate_step_time(jcfg, batch, js, design, density,
                                          shards, 1.5)
    # the unquantized tier prices one bf16 pass
    assert ttiers.step_cost(tcfg, 4, None, shards=(2, 1)) == \
        jtiers.step_cost(jcfg, 4, None, shards=(2, 1))
    assert ttiers.estimate_step_time(tcfg, 4, None) == \
        jtiers.estimate_step_time(jcfg, 4, None)


def test_spec_from_flags_matches_reference():
    grid = itertools.product(
        (None, "", "planes=2", "impl=pallas,block_m=256",
         "planes=3,encoding=mbe,act_quant=per_token"),
        (0, 2, 4), ("pallas", "pallas_fused", "planes", "int8"),
        ("ent", "bitserial"), (8, 6))
    for flags in grid:
        try:
            want = jspec_from_flags(*flags)
        except ValueError as e:
            with pytest.raises(ValueError, match="."):
                tspec_from_flags(*flags)
            assert str(e)
            continue
        got = tspec_from_flags(*flags)
        assert (str(got) if got else None) == (str(want) if want else None)
        if want is not None:
            assert got.block_overrides() == want.block_overrides()
            assert str(got.replace(planes=1)) == str(want.replace(planes=1))


def test_plan_cache_counts_match_reference():
    """The same sequence of plan_for calls gives the same entries, hits
    and misses: numpy weights by content, tensors (arrays in the
    reference) by identity, one entry per spec and order."""
    jops.plan_cache_clear()
    tops.plan_cache_clear()
    w1, w2 = _weight(64, 40, 1), _weight(64, 40, 2)
    s2, s3 = "planes=2,impl=pallas_fused", "planes=3,impl=pallas_fused"
    seq = [(w1, s2, "m_major"), (w1, s2, "m_major"), (w1.copy(), s2,
           "m_major"), (w2, s2, "m_major"), (w1, s3, "m_major"),
           (w1, s2, "k_major"), (w2, s2, "m_major")]
    for w, text, order in seq:
        jops.plan_for(w, JSpec.parse(text), order=order, verify=False)
        tops.plan_for(w, TSpec.parse(text), order=order)
        assert tops.plan_cache_stats() == jops.plan_cache_stats()
    jw, tw = jnp.asarray(w1), torch.from_numpy(w1.copy())
    for _ in range(3):
        jops.plan_for(jw, JSpec.parse(s2), verify=False)
        tops.plan_for(tw, TSpec.parse(s2))
    assert tops.plan_cache_stats() == jops.plan_cache_stats()
    assert tops.plan_cache_stats()["hits"] == 5
    jops.plan_cache_clear()
    tops.plan_cache_clear()
    assert tops.plan_cache_stats() == {"entries": 0, "hits": 0,
                                       "misses": 0}


def test_plan_cache_misses_after_in_place_update():
    """A tensor updated in place is a new weight: its plan is rebuilt,
    and the rebuilt plan is the plan of the new values."""
    tops.plan_cache_clear()
    spec = TSpec.parse("planes=3,impl=pallas_fused")
    w = torch.from_numpy(_weight(64, 40, 3))
    first, _ = tops.plan_for(w, spec)
    again, _ = tops.plan_for(w, spec)
    assert again is first
    assert tops.plan_cache_stats()["hits"] == 1
    w.add_(1.0)
    fresh, _ = tops.plan_for(w, spec)
    assert fresh is not first
    assert tops.plan_cache_stats()["misses"] == 2
    want, _ = tops.plan_for(w.clone(), spec)
    assert torch.equal(fresh.digits, want.digits)
    del w, first, again, fresh, want
    assert tops.plan_cache_stats()["entries"] == 0   # weakref eviction
    tops.plan_cache_clear()


def test_plan_dense_weight_cache_flag():
    """use_cache=True goes through plan_for's cache, False does not; both
    give the same record."""
    tops.plan_cache_clear()
    spec = TSpec.parse(_spec_text("pallas_fused", 3))
    w = torch.from_numpy(_weight(128, 64, 4))
    a = tops.plan_dense_weight(w, spec, use_cache=False)
    assert tops.plan_cache_stats()["misses"] == 0
    b = tops.plan_dense_weight(w, spec)
    c = tops.plan_dense_weight(w, spec)
    assert tops.plan_cache_stats() == {"entries": 1, "hits": 1,
                                       "misses": 1}
    for key in a:
        assert torch.equal(a[key], b[key]) and torch.equal(b[key], c[key])
    tops.plan_cache_clear()
