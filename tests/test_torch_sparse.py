"""The port's block schedules, sparse and pipelined kernels (their plain
versions), dispatch and the planes=2 serving routes against the reference
package on the same numpy inputs.  The reference's Pallas kernels run in
interpret mode, as its own tests run them on the CPU; the port's wrappers
take their plain versions for CPU tensors.

Tolerances, as in ``test_torch_ops.py``: schedules, int32 accumulators
and dequantized outputs without bias or activation are compared bit for
bit.  With a bias they agree within rtol 1e-6, atol 1e-6 (about an ulp):
XLA on the CPU contracts ``acc * s + bias`` into one fused multiply-add,
which the port does not.  With an activation they agree within rtol 1e-5,
atol 1e-6 (XLA's and torch's exp differ by a few ulps).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.engine import QuantSpec as JSpec
from repro.kernels import bw_gemm as jbw
from repro.kernels import ops as jops
from repro.models.api import get_api as jget_api
from repro.parallel.sharding import unbox
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.request import ServeRequest as JRequest
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.engine import engine_names
from repro_torch.engine.spec import IMPLS
from repro_torch.kernels import bw_gemm as tbw
from repro_torch.kernels import ops as tops
from repro_torch.serving.engine import ServeEngine as TEngine
from repro_torch.serving.request import ServeRequest as TRequest

# One torch thread: these tensors are small, and the suite runs in parallel
# workers beside timing-sensitive tests (the realtime server's heartbeat
# watchdog) that an oversubscribed CPU would fail.
torch.set_num_threads(1)

ACT_TOL = dict(rtol=1e-5, atol=1e-6)
BIAS_TOL = dict(rtol=1e-6, atol=1e-6)
ORDERS = ("m_major", "k_major")
FAST_SPEC = "planes=2,encoding=ent,act_quant=per_token,impl="
BM, BK = 128, 256


def _mask(kind, seed=0, shape=(4, 5, 4)):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape) < 0.45
    if kind == "empty_rows":              # rows 1 and 3 have no live block
        mask = rng.random(shape) < 0.6
        mask[:, [1, 3], :] = False
        return mask
    if kind == "high_planes":             # only planes 2 and 3 are live
        mask = np.zeros(shape, bool)
        mask[2:] = rng.random((shape[0] - 2,) + shape[1:]) < 0.5
        return mask
    return np.zeros(shape, bool)          # all False: sentinels only


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", ["random", "empty_rows", "high_planes",
                                  "all_false"])
def test_build_schedule_matches_reference(kind, order):
    mask = _mask(kind)
    want = jops.build_schedule(mask, 4, order)
    got = tops.build_schedule(mask, 4, order)
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tops.build_schedule(torch.from_numpy(mask), 4, order), want)
    if kind == "empty_rows" and order == "k_major":
        assert list(got[:2, 1]) == [1, 3] and not got[:2, 3].any()
    for length in (got.shape[0], got.shape[0] + 3):
        padded = tops.pad_schedule(got, length)
        np.testing.assert_array_equal(padded,
                                      jops.pad_schedule(want, length))
        assert tops.schedule_stats(padded, mask) == \
            jops.schedule_stats(jops.pad_schedule(want, length), mask)
    assert tops.schedule_stats(torch.from_numpy(got),
                               torch.from_numpy(mask)) == \
        jops.schedule_stats(want, mask)
    with pytest.raises(ValueError, match="cannot pad"):
        tops.pad_schedule(got, got.shape[0] - 1)
    with pytest.raises(ValueError, match="order"):
        tops.build_schedule(mask, 4, "n_major")


def _sparse_case(planes, seed, n=3):
    """Digits [4, 384, 768] live on planes < ``planes``, a False block
    over non-zero digits, an all-empty row block (a sentinel), int8
    activations, and the epilogue vectors."""
    rng = np.random.default_rng(seed)
    m, k = 3 * BM, 3 * BK
    digits = rng.integers(-2, 3, size=(4, m, k)).astype(np.int8)
    digits[planes:] = 0
    digits[:, BM:2 * BM] = 0                       # row block 1: a sentinel
    mask = np.array(jops.plane_block_mask(jnp.asarray(digits), BM, BK))
    assert digits[0, :BM, :BK].any()
    mask[0, 0, 0] = False                          # live digits, skipped
    b = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
    b_pad = np.zeros((k, 128), np.int8)
    b_pad[:, :n] = b.T
    scale = rng.uniform(1e-4, 1e-2, (m, 1)).astype(np.float32)
    bias = rng.standard_normal((m, 1)).astype(np.float32)
    scale_n = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    scale_n_pad = np.ones((1, 128), np.float32)
    scale_n_pad[:, :n] = scale_n
    return digits, mask, b, b_pad, scale, bias, scale_n, scale_n_pad


@pytest.mark.parametrize("family", ["sparse", "pipelined"])
@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_sparse_kernels_plain_match_reference(planes, family):
    digits, mask, b, b_pad, scale, bias, scale_n, scale_n_pad = \
        _sparse_case(planes, 10 + planes)
    n = b.shape[0]
    t, j = torch.from_numpy, jnp.asarray
    blocks = dict(block_m=BM, block_k=BK)
    jblocks = dict(block_m=BM, block_n=128, block_k=BK, interpret=True)
    orders = ORDERS if family == "pipelined" else ("m_major",)
    dense = tbw.bw_gemm_plain(t(digits), t(b), t(mask), **blocks)
    assert not dense[BM:2 * BM].any()
    for order in orders:
        sched = jops.build_schedule(mask, 4, order)
        if family == "sparse":
            j_i32, j_fused = jbw.bw_gemm_sparse, jbw.bw_gemm_sparse_fused
            t_i32, t_fused = tbw.bw_gemm_sparse, tbw.bw_gemm_sparse_fused
        else:
            j_i32 = jbw.bw_gemm_sparse_pipelined
            j_fused = jbw.bw_gemm_sparse_fused_pipelined
            t_i32 = tbw.bw_gemm_sparse_pipelined
            t_fused = tbw.bw_gemm_sparse_fused_pipelined
        want = np.asarray(j_i32(j(digits), j(b_pad), j(sched),
                                **jblocks))[:, :n]
        got = t_i32(t(digits), t(b), t(sched), **blocks)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), dense.numpy())
        for use_bias, act in ((False, None), (True, None), (True, "silu")):
            jb = j(bias) if use_bias else None
            want = np.asarray(j_fused(
                j(digits), j(b_pad), j(sched), j(scale), jb,
                j(scale_n_pad), activation=act, **jblocks))[:, :n]
            got = t_fused(t(digits), t(b), t(sched), t(scale),
                          t(bias) if use_bias else None, t(scale_n),
                          activation=act, **blocks).numpy()
            if act is not None:
                np.testing.assert_allclose(got, want, **ACT_TOL)
            elif use_bias:
                np.testing.assert_allclose(got, want, **BIAS_TOL)
            else:
                np.testing.assert_array_equal(got, want)


def _weight(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])
    w[:, 0] *= 30.0                        # an outlier channel
    return w


def _both_plans(w, text, order):
    jspec, tspec = JSpec.parse(text), TSpec.parse(text)
    jplan = jops.plan_dense_weight(jnp.asarray(w), jspec, use_cache=False,
                                   order=order, verify=False)
    tplan = tops.plan_dense_weight(torch.from_numpy(w), tspec, order=order)
    return jplan, tplan, jspec, tspec


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dispatch", ["dense", "sparse", "pipelined",
                                      "auto"])
def test_planned_dense_apply_routes_match_reference(dispatch, fused, order):
    text = "planes=2,encoding=ent,act_quant=per_token"
    w = _weight((300, 520), 20)
    jplan, tplan, jspec, tspec = _both_plans(w, text, order)
    np.testing.assert_array_equal(tplan["schedule"].numpy(),
                                  np.asarray(jplan["schedule"]))
    x = np.random.default_rng(21).standard_normal((2, 3, 300)).astype(
        np.float32)
    kw = dict(fused=fused, dispatch=dispatch, order=order)
    if dispatch == "sparse" and order == "k_major":
        with pytest.raises(ValueError, match="m_major"):
            jops.planned_dense_apply(jplan, jnp.asarray(x), jspec, 520,
                                     interpret=True, **kw)
        with pytest.raises(ValueError, match="m_major"):
            tops.planned_dense_apply(tplan, torch.from_numpy(x), tspec, 520,
                                     **kw)
        return
    want = np.asarray(jops.planned_dense_apply(
        jplan, jnp.asarray(x), jspec, 520, interpret=True, **kw))
    got = tops.planned_dense_apply(tplan, torch.from_numpy(x), tspec, 520,
                                   **kw).numpy()
    assert got.shape == want.shape == (2, 3, 520)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", ORDERS)
def test_planned_operand_wrappers_match_reference(order):
    rng = np.random.default_rng(30)
    a = rng.integers(-10, 11, size=(200, 300)).astype(np.int8)
    b = rng.integers(-127, 128, size=(300, 3)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, 200).astype(np.float32)
    jp = jops.plan_operand(jnp.asarray(a), "ent", 128, 256, order=order)
    tp = tops.plan_operand(torch.from_numpy(a), "ent", 128, 256, order=order)
    assert tp.order == order and tp.schedule.dtype == torch.int32
    np.testing.assert_array_equal(tp.schedule.numpy(), jp.schedule)
    assert tp.density() == jp.density()
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    pairs = [("bw_gemm_sparse_pipelined", ()),
             ("bw_gemm_sparse_fused_pipelined", (scale,))]
    if order == "m_major":
        pairs += [("bw_gemm_sparse", ()), ("bw_gemm_sparse_fused", (scale,))]
    for name, extra in pairs:
        want = np.asarray(getattr(jops, name)(
            jp, jb, *map(jnp.asarray, extra), interpret=True))
        got = getattr(tops, name)(tp, tb,
                                  *map(torch.from_numpy, extra)).numpy()
        assert got.shape == want.shape == (200, 3)
        np.testing.assert_array_equal(got, want)
        if not extra:
            np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("order", ORDERS + ("n_major",))
@pytest.mark.parametrize("dispatch", ["dense", "sparse", "pipelined", "auto",
                                      "bogus"])
def test_resolve_dispatch_matches_reference(dispatch, order):
    spec = "planes=2,encoding=ent,act_quant=per_token"
    for steps in (None, 0, 17, 18, 19, 36):       # mask of 36 blocks
        jplan = {"mask": np.zeros((4, 3, 3), bool),
                 "schedule": None if steps is None
                 else np.zeros((steps, 9), np.int32)}
        tplan = {"mask": torch.zeros(4, 3, 3, dtype=torch.bool),
                 "schedule": None if steps is None
                 else torch.zeros(steps, 9, dtype=torch.int32)}
        args = (JSpec.parse(spec), 520, 300, 3, order)
        try:
            want = jops._resolve_dispatch(dispatch, jplan, *args)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tops._resolve_dispatch(dispatch, tplan, TSpec.parse(spec),
                                       *args[1:])
            assert str(got.value).split()[0] == str(e).split()[0]
            continue
        assert tops._resolve_dispatch(dispatch, tplan, TSpec.parse(spec),
                                      *args[1:]) == want


@pytest.mark.parametrize("impl", ["pallas_sparse", "pallas_pipelined"])
def test_plan_params_records_match_reference_stacked(impl):
    """Per-layer records of a list of layers equal the reference's
    layer-stacked records sliced at each layer, schedule padding
    included."""
    rng = np.random.default_rng(40)
    w = rng.standard_normal((3, 300, 200)).astype(np.float32) / 17.0
    w[1, :, 100:] = 0.0          # layer 1 has empty rows: a shorter walk
    w[2] *= 4.0
    jtree = {"blocks": {"mlp": {"up": {"w": jnp.asarray(w)}}},
             "head": {"w": jnp.asarray(w[0])}}
    ttree = {"blocks": [{"mlp": {"up": {"w": torch.from_numpy(w[i])}}}
                        for i in range(3)],
             "head": {"w": torch.from_numpy(w[0])}}
    text = FAST_SPEC + impl
    jplanned, jcount = jops.plan_params(jtree, JSpec.parse(text))
    tplanned, tcount = tops.plan_params(ttree, TSpec.parse(text))
    assert jcount == tcount == 4
    stacked = jplanned["blocks"]["mlp"]["up"]["w_plan"]
    lengths = set()
    for i in range(3):
        rec = tplanned["blocks"][i]["mlp"]["up"]["w_plan"]
        assert set(rec) == set(stacked)
        for key in stacked:
            np.testing.assert_array_equal(rec[key].numpy(),
                                          np.asarray(stacked[key][i]),
                                          err_msg=f"layer {i} {key}")
        lengths.add(int((rec["schedule"][:, 3] != 0).sum()))
    assert len(lengths) > 1                 # padding was exercised
    for key, val in jplanned["head"]["w_plan"].items():
        np.testing.assert_array_equal(
            tplanned["head"]["w_plan"][key].numpy(), np.asarray(val))


@pytest.mark.parametrize("planes,routes", [
    (2, {"pallas_sparse": "sparse", "pallas_pipelined": "pipelined"}),
    (3, {"pallas_sparse": "dense", "pallas_pipelined": "dense"})])
def test_fast_tier_routes_match_reference(planes, routes):
    """planes=2 (the fast tier) takes the sparse routes, planes=3 the
    dense kernel, in both packages."""
    w = _weight((512, 640), 50)
    for impl, route in routes.items():
        text = f"planes={planes},encoding=ent,act_quant=per_token,impl={impl}"
        order = "k_major" if impl == "pallas_pipelined" else "m_major"
        jplan, tplan, jspec, tspec = _both_plans(w, text, order)
        want = jops._resolve_dispatch("auto", jplan, jspec, 640, 512, 4,
                                      order)
        got = tops._resolve_dispatch("auto", tplan, tspec, 640, 512, 4,
                                     order)
        assert got == want == route


def test_engines_registered_in_reference_order():
    assert engine_names() == IMPLS


def _smoke_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 6).tolist() for _ in range(3)]


def _serve_port(jeng, text):
    tcfg = tget_config("minicpm-2b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               device="cpu")
    teng = TEngine(tcfg, 2, 16, quant=TSpec.parse(text), params=params,
                   device="cpu")
    reqs = [TRequest(i, list(p), 5)
            for i, p in enumerate(_smoke_prompts(tcfg.vocab_size))]
    teng.run(reqs)
    return [r.out for r in reqs], teng


# Logit tolerance of the planes=2 path: test_torch_serve.py's 1.0 for the
# 3-plane grid (qmax 42), scaled by the ratio of the grid steps (42 / 10,
# the 2-plane grid's qmax): a one-ulp bf16 difference upstream moves a
# quantized activation by a whole step of the grid.
FAST_LOGIT_ATOL = 4.0


def _lockstep(jeng, teng, forced):
    """Decode ``forced`` through both packages' decode steps in lock step
    (in both batch rows of fresh states) and return the largest logit
    difference, the reference's top-2 margin at the last step, and both
    packages' greedy tokens there."""
    api = jget_api(jeng.cfg)
    jstep = jax.jit(lambda p, t, pos, s: api.decode_step(p, t, pos, s,
                                                         jeng.cfg))
    jstate = unbox(api.init_decode(jeng.cfg, 2, 16))
    tstate = teng.api.init_decode(teng.cfg, 2, 16, teng.device)
    worst = 0.0
    for step, token in enumerate(forced):
        tok = np.full((2, 1), token, np.int32)
        pos = np.full((2,), step, np.int32)
        jlogits, jstate = jstep(jeng.params, jnp.asarray(tok),
                                jnp.asarray(pos), jstate)
        tlogits, tstate = teng.api.decode_step(
            teng.params, torch.from_numpy(tok), torch.from_numpy(pos),
            tstate, teng.cfg)
        want = np.asarray(jlogits.astype(jnp.float32))[0, -1]
        got = tlogits.to(torch.float32).numpy()[0, -1]
        worst = max(worst, float(np.abs(got - want).max()))
    top2 = np.sort(want)[-2:]
    return worst, float(top2[1] - top2[0]), int(want.argmax()), \
        int(got.argmax())


@pytest.mark.parametrize("impl,kernel", [
    ("pallas_sparse", "bw_gemm_sparse_fused"),
    ("pallas_pipelined", "bw_gemm_sparse_fused_pipelined")])
def test_fast_tier_smoke_lane_tokens_match_reference(impl, kernel,
                                                     monkeypatch):
    """The smoke lane (3 prompts, batch 2, max_len 16, 5 new tokens) at
    planes=2 through both new impls, every projection on the new route:
    the port's tokens equal its pallas_fused and plain planes tokens, and
    the reference's, except where a request's first differing token is
    a near tie of the reference's logits (top-2 margin within
    FAST_LOGIT_ATOL, the logits agreeing within it in lock step).  That
    flip is XLA's excess precision in the jitted reference (ROADMAP queue
    C2): with it off, the reference emits the port's tokens on the whole
    lane (the test below)."""
    jcfg = jget_config("minicpm-2b", smoke=True)
    jeng = JEngine(jcfg, 2, 16, quant=JSpec.parse(FAST_SPEC + impl))
    prompts = _smoke_prompts(jcfg.vocab_size)
    jreqs = [JRequest(i, list(p), 5) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    calls = []
    plain = getattr(tbw, kernel)
    monkeypatch.setattr(tbw, kernel,
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tokens, teng = _serve_port(jeng, FAST_SPEC + impl)
    assert len(calls) == 7 * jcfg.n_layers * teng.steps
    monkeypatch.undo()
    for other in ("pallas_fused", "planes"):
        assert _serve_port(jeng, FAST_SPEC + other)[0] == tokens, other
    for prompt, want, got in zip(prompts, [r.out for r in jreqs], tokens):
        assert len(got) == len(want) == 5
        if got == want:
            continue
        g = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
        worst, margin, jtop, ttop = _lockstep(jeng, teng,
                                              prompt + want[:g])
        assert (jtop, ttop) == (want[g], got[g])
        assert worst <= FAST_LOGIT_ATOL and margin <= FAST_LOGIT_ATOL, \
            (worst, margin)


_REFERENCE_LANE = textwrap.dedent("""
    import json
    import numpy as np
    from repro.configs.registry import get_config
    from repro.engine import QuantSpec
    from repro.serving.engine import ServeEngine
    from repro.serving.request import ServeRequest
    cfg = get_config("minicpm-2b", smoke=True)
    eng = ServeEngine(cfg, 2, 16, quant=QuantSpec.parse(%r))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6).tolist() for _ in range(3)]
    reqs = [ServeRequest(i, list(p), 5) for i, p in enumerate(prompts)]
    eng.run(reqs)
    print(json.dumps([r.out for r in reqs]))
""")


@pytest.mark.parametrize("impl", ["pallas_sparse", "pallas_pipelined"])
def test_fast_tier_smoke_lane_matches_reference_without_excess_precision(
        impl):
    """The whole planes=2 smoke lane (3 requests x 5 tokens): the reference
    served in a process with XLA's excess precision off emits, token for
    token, what the port serves on the same route (_smoke_prompts)."""
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE_LANE % (FAST_SPEC + impl)],
        env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    jcfg = jget_config("minicpm-2b", smoke=True)
    jeng = JEngine(jcfg, 2, 16, quant=JSpec.parse(FAST_SPEC + impl))
    tokens, _ = _serve_port(jeng, FAST_SPEC + impl)
    assert len(want) == 3 and all(len(t) == 5 for t in want)
    assert tokens == want


@pytest.mark.parametrize("kernel", ["bw_gemm_sparse", "bw_gemm_sparse_fused",
                                    "bw_gemm_sparse_pipelined",
                                    "bw_gemm_sparse_fused_pipelined"])
def test_sparse_wrappers_reject_malformed_operands(kernel):
    digits, mask, b, _, scale, _, scale_n, _ = _sparse_case(2, 60, n=2)
    sched = tops.build_schedule(mask, 4, "m_major")
    fn = getattr(tbw, kernel)
    extra = (torch.from_numpy(scale),) if "fused" in kernel else ()
    t = torch.from_numpy

    def call(d=t(digits), bb=t(b), s=t(sched), *vectors):
        return fn(d, bb, s, *(vectors or extra), block_m=BM, block_k=BK)

    with pytest.raises(ValueError, match="columns"):
        call(s=t(sched[:, :5].copy()))
    if "pipelined" in kernel:
        with pytest.raises(ValueError, match="exactly 9"):
            call(s=t(sched[:, :6].copy()))
    else:
        assert call(s=t(sched[:, :6].copy())).shape == (digits.shape[1], 2)
    with pytest.raises(TypeError, match="int32"):
        call(s=t(sched.astype(np.int64)))
    with pytest.raises(ValueError, match="must be on"):
        call(bb=torch.empty(b.shape, dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError, match="must be on"):
        call(s=torch.empty(sched.shape, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="K="):
        call(bb=t(b[:, :-16].copy()))
    if extra:
        with pytest.raises(ValueError, match="must be on"):
            call(t(digits), t(b), t(sched),
                 torch.empty(scale.shape, device="meta"))
        with pytest.raises(ValueError, match="scale_n"):
            fn(t(digits), t(b), t(sched), t(scale), None,
               t(scale_n[:, :1].copy()), block_m=BM, block_k=BK)


def test_sparse_entry_points_refuse_k_major_plans():
    rng = np.random.default_rng(70)
    a = torch.from_numpy(rng.integers(-10, 11, (200, 300)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-9, 10, (300, 2)).astype(np.int8))
    planned = tops.plan_operand(a, "ent", 128, 256, order="k_major")
    with pytest.raises(ValueError, match="m_major"):
        tops.bw_gemm_sparse(planned, b)
    with pytest.raises(ValueError, match="m_major"):
        tops.bw_gemm_sparse_fused(planned, b, torch.ones(200))
    with pytest.raises(ValueError, match="K="):
        tops.bw_gemm_sparse_pipelined(planned, b[:-1])
    spec = TSpec.parse("planes=2,encoding=ent,act_quant=per_token")
    plan = tops.plan_dense_weight(torch.from_numpy(_weight((64, 40), 71)),
                                  spec, order="k_major")
    with pytest.raises(ValueError, match="m_major"):
        tops.planned_dense_apply(plan, torch.zeros(1, 64), spec, 40,
                                 dispatch="sparse", order="k_major")
    with pytest.raises(ValueError, match="has no schedule"):
        tops.bw_gemm_sparse_pipelined(
            tops.PlannedOperand(**dict(vars(planned), schedule=None)), b)
