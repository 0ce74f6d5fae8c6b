"""The port's hybrid family (``models/ssm.py``, ``models/hymba.py``,
hymba-1.5b) against the reference's, on the smoke config (2 layers,
d_model 64, 4 heads x 16, 2 kv heads, d_ff 128, vocab 512, ssm_state 4).

The reference sets the fusion's ``beta_attn`` / ``beta_ssm`` and the
SSM's ``d_skip`` to ones, under which a swapped beta or a dropped skip
would move nothing.  Every case here replaces them by seeded U(0.5, 1.5)
draws of the same shapes (``draw_constant_leaves``; chip_smoke.py draws
the same on the card).

The jitted reference runs once, in a subprocess with XLA's excess
precision off (test_torch_forward.py's ``run_reference``): its param
tree, inputs and outputs come back in one pickle and the port takes the
same params (``convert.params_from_numpy``) and inputs on the CPU, where
its kernel wrappers run their plain versions.

Where the two differ, and the tolerances that follow (ROADMAP C11):

* ``jax.nn.softplus`` is ``logaddexp(x, 0)`` with XLA's own float32
  ``exp`` and ``log1p``; the port computes the same formula with
  torch's, up to ``SOFTPLUS_ULPS`` float32 ulps apart.  XLA on the CPU
  also fuses the scan's float32 multiply-adds (``da * h + dbx``) and
  sums ``h . c`` its own way, where the port rounds each op: the scan's
  outputs and state within ``F32_RTOL`` of their largest values.
* The float32 projections (``x_to_dt``, ``dt_proj``, ``x_to_bc``) sum
  in another order, and XLA and torch have their own float32 ``exp``
  in the softmax: a bf16 value lands a ulp apart where a float32
  difference crosses a rounding boundary (``BF16_RTOL``, relative to the
  largest value).
* Through the quantized routes such a one-ulp input can quantize one
  step apart, and the ROADMAP C2 scale rounding adds its own step:
  outputs and states within two steps (``QUANT_RTOL``), logits within
  test_torch_forward.py's LOGIT_ATOL of 1.0; greedy tokens may differ
  only where the reference's top-2 margin is within the tolerance.
* Decode through ``ServeEngine`` takes the activation scale as the
  compiled reference rounds it (``compiled_scale``, C2): then the served
  greedy tokens equal the reference's.
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget_config
from repro.models import hymba as JH
from repro.parallel.sharding import unbox
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec
from repro_torch.kernels import bw_gemm as bwk
from repro_torch.kernels import ops as tops
from repro_torch.models import hymba as H
from repro_torch.models import ssm as S
from repro_torch.models.api import get_api, loss_fn
from repro_torch.serving import engine as tengine
from repro_torch.serving.ckpt import DecodeSnapshot
from repro_torch.serving.engine import ServeEngine, state_leaves
from repro_torch.serving.request import ServeRequest

from test_torch_forward import (assert_tokens, compiled_scale,
                                run_reference, spec_text)

torch.set_num_threads(1)

ARCH = "hymba-1.5b"
IMPLS = (None, "planes", "pallas_fused")
SERVE_IMPLS = ("planes", "pallas_fused")
BATCH, SEQ = 2, 12
SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS = 2, 16, 6
W = 2048
# decode positions, a row each, step by step from the initial caches: the
# ring's slot 2 overwritten at W + 2 (row 0), the window's expiry at
# W + 2 and W + 5
DECODE_POS = ((0, 0), (1, 1), (2, 2), (W + 2, 3), (W + 5, W + 5))
# (b, t, h, d, window, chunk, dtype) for _windowed / _windowed_chunked:
# tests/test_attention.py:38's float32 case, and the model's bf16
WINDOW_CASES = ((1, 32, 2, 8, 8, 4, "float32"),
                (2, 32, 4, 16, 16, 8, "bfloat16"))
# the forward with meta on the chunked walk: 128 + 12 = 140 positions
# over chunks of 28 (the window, 2,048, covers them all)
CHUNK = 28
# planned a layer: wq, wk, wv, wo, in_proj, out_proj, gate, up, down; and
# the head
PLANNED_PER_LAYER = 9

# jax.nn.softplus against the port's: float32 ulps of the result
SOFTPLUS_ULPS = 2
# float32 values of the scan and its state: XLA's fused multiply-adds and
# sum order against torch's separate roundings, a few float32 ulps of the
# largest value (2^-23 each), kept well under a bf16 ulp (2^-8)
F32_RTOL = 2.0 ** -18
# the windowed attention alone against the reference's: float32 within
# test_attention.py's 2e-5; bf16 within 2^-8, under a bf16 ulp of the
# largest value (the libraries' float32 exp and sums)
WINDOW_ATOL = {"float32": 2e-5, "bfloat16": 2.0 ** -8}
# the chunked walk against the plain one, in the port as in the
# reference: float32 within 2e-5; in bf16 the plain walk rounds the
# normalised probabilities and the chunked one the unnormalised weights,
# so outputs sit a bf16 ulp apart (2^-7 of the largest value bounds one
# ulp of any value)
WALKS_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
# the forward's logits on the two walks: each layer's attention a bf16
# ulp apart, through two layers and the head, within 2^-5 of the largest
# logit (four bf16 ulps of the top binade); the reference's own two walks
# part as far (0.058 of 3.8 on these inputs)
WALKS_LOGIT_RTOL = 2.0 ** -5
# the bf16 route, relative to an output's largest value: one bf16 ulp
# (2^-8) where a float32 difference crosses a bf16 rounding boundary (a
# module's output, the SSM state after the bf16 conv); two on the logits,
# after two layers and the head
BF16_RTOL = {"module": 2.0 ** -8, "logits": 2.0 ** -7}
# the quantized routes, relative to an output's or a state's largest
# value: two steps of the planes=3 grid (qmax 42, per token), one from an
# input a bf16 ulp off and one from C2's scale rounding
QUANT_RTOL = 2.0 / 42
# the logits on the quantized routes: test_torch_forward.py's LOGIT_ATOL
QUANT_LOGIT_ATOL = 1.0
# the mean next-token NLL: the logit gaps above at a few positions
LOSS_ATOL = {None: 0.02, "planes": 0.05, "pallas_fused": 0.05}
# the port's forward without meta against its own token-by-token decode:
# the reference's test_rwkv_scan_decode_consistency tolerance
DECODE_CONSISTENCY_TOL = 0.05


def draw_constant_leaves(blocks, rng):
    """Replace the leaves hymba_lm_init sets to ones, in a layer-stacked
    numpy tree, by seeded U(0.5, 1.5) draws of the same shapes: the
    fusion's beta_attn and beta_ssm and the SSM's d_skip.  The
    reference's subprocess runs this same function (its source is put
    into the script)."""
    for tree, key in ((blocks, "beta_attn"), (blocks, "beta_ssm"),
                      (blocks["ssm"], "d_skip")):
        tree[key] = rng.uniform(0.5, 1.5, np.shape(tree[key])).astype(
            np.float32)


_REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.engine import QuantSpec
from repro.kernels import ops
from repro.models import hymba as H, ssm as S
from repro.models.api import get_api, loss_fn
from repro.parallel.sharding import unbox
from repro.serving.engine import ServeEngine
from repro.serving.request import ServeRequest
%s
ARCH, IMPLS, SERVE_IMPLS = %r, %r, %r
BATCH, SEQ, CHUNK = %d, %d, %d
SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS = %d, %d, %d
DECODE_POS, WINDOW_CASES = %r, %r


def spec(impl):
    return None if impl is None else QuantSpec.parse(
        "planes=3,encoding=ent,impl=%%s,act_quant=per_token" %% impl)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def tree32(t):
    return jax.tree.map(lambda a: np.asarray(a) if a.dtype == jnp.int32
                        else f32(a), t)


def planned(p, cfg):
    if cfg.quant is not None and cfg.quant.impl == "pallas_fused":
        p, _ = ops.plan_params(p, cfg.quant)
    return p


base = get_config(ARCH, smoke=True)
params = jax.tree.map(np.asarray, jax.jit(
    lambda key: unbox(H.hymba_lm_init(key, base)))(jax.random.PRNGKey(0)))
draw_constant_leaves(params["blocks"], np.random.default_rng(7))
layer = jax.tree.map(lambda a: a[0], params["blocks"])
d, di, n, kc = (base.d_model, base.ssm_expand * base.d_model,
                base.ssm_state, base.ssm_conv)

rng = np.random.default_rng(1)
inputs = dict(
    x=rng.standard_normal((BATCH, SEQ, d)).astype(np.float32),
    conv=rng.standard_normal((BATCH, kc - 1, di)).astype(np.float32),
    h=rng.standard_normal((BATCH, di, n)).astype(np.float32),
    xc=rng.standard_normal((BATCH, SEQ, di)).astype(np.float32),
    xs=rng.standard_normal((BATCH, SEQ, di)).astype(np.float32),
    dt=rng.uniform(0.01, 1.0, (BATCH, SEQ, di)).astype(np.float32),
    bmat=rng.standard_normal((BATCH, SEQ, n)).astype(np.float32),
    cmat=rng.standard_normal((BATCH, SEQ, n)).astype(np.float32),
    softplus=(8 * rng.standard_normal(1 << 16)).astype(np.float32),
    tokens=rng.integers(0, base.vocab_size, (BATCH, SEQ)).astype(np.int32))
labels = np.concatenate([inputs["tokens"][:, 1:],
                         np.full((BATCH, 1), -1, np.int32)], axis=1)
labels[0, :2] = -1
inputs["labels"] = labels
inputs["window"] = [
    tuple(rng.standard_normal((b, t, h, dd)).astype(np.float32)
          for _ in range(3)) for b, t, h, dd, _, _, _ in WINDOW_CASES]
bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
x, conv, h0 = bf(inputs["x"]), bf(inputs["conv"]), jnp.asarray(inputs["h"])
positions = jnp.broadcast_to(jnp.arange(SEQ)[None], (BATCH, SEQ))

out = {"params": params, "inputs": inputs, "modules": {}, "forward": {},
       "decode": {}, "serve": {}, "window": []}
w = bf(layer["ssm"]["conv_w"])
out["conv"] = {str(carried): tree32(jax.jit(S._causal_conv)(
    bf(inputs["xc"]), w, conv if carried else None))
    for carried in (False, True)}
a = -jnp.exp(jnp.asarray(layer["ssm"]["a_log"]))
out["scan"] = tree32(jax.jit(S._selective_scan)(
    *(jnp.asarray(inputs[k]) for k in ("xs", "dt", "bmat", "cmat")), a, h0))
out["softplus"] = f32(jax.jit(jax.nn.softplus)(inputs["softplus"]))
for (b, t, hh, dd, win, chunk, dtype), qkv in zip(WINDOW_CASES,
                                                  inputs["window"]):
    q, k, v = (jnp.asarray(z).astype(dtype) for z in qkv)
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    out["window"].append((
        f32(jax.jit(H._windowed, static_argnums=3)(q, k, v, win, pos)),
        f32(jax.jit(H._windowed_chunked, static_argnums=(3, 4))(
            q, k, v, win, chunk))))

for impl in IMPLS:
    cfg = base.replace(quant=spec(impl))
    api = get_api(cfg)
    toks = inputs["tokens"]

    def run(lp, p, x, conv, h0, t, l):
        st = {"h": h0, "conv": conv}
        ssm_zero = S.ssm_apply(lp["ssm"], x, cfg)
        ssm_st = S.ssm_apply(lp["ssm"], x, cfg, st)
        blk = H.block_apply(lp, x, cfg, positions, st)
        logits, aux = api.forward(p, {"tokens": t}, cfg)
        bare, _ = H.hymba_lm_apply(p, t, cfg, with_meta=False)
        loss, metrics = loss_fn(p, {"tokens": t, "labels": l}, cfg)
        return ssm_zero, ssm_st, blk, logits, aux, bare, loss, metrics
    pp = planned(params, cfg)
    ssm_zero, ssm_st, blk, logits, aux, bare, loss, metrics = jax.jit(run)(
        jax.tree.map(lambda a: a[0], pp["blocks"]), pp, x, conv, h0, toks,
        labels)
    out["modules"][impl] = dict(ssm_zero=tree32(ssm_zero),
                                ssm_state=tree32(ssm_st), block=tree32(blk))
    out["forward"][impl] = dict(
        logits=f32(logits), aux=float(aux), bare=f32(bare),
        loss=float(loss), metrics={k: float(v) for k, v in metrics.items()})
    if impl == "pallas_fused":
        out["planned"] = jax.tree.map(np.asarray, pp)
    if impl is None:
        chunked = cfg.replace(attn_chunk=CHUNK)
        out["chunked"] = f32(jax.jit(lambda p, t: get_api(chunked).forward(
            p, {"tokens": t}, chunked)[0])(pp, toks))

    step = jax.jit(lambda p, t, i, st: api.decode_step(p, t, i, st, cfg))
    state = unbox(api.init_decode(cfg, BATCH, SEQ))
    steps = []
    for i, pos in enumerate(DECODE_POS):
        lg, state = step(pp, toks[:, i:i + 1], jnp.asarray(pos, jnp.int32),
                         state)
        steps.append((f32(lg), tree32(state)))
    out["decode"][impl] = steps

rng = np.random.default_rng(0)
prompts = [rng.integers(0, base.vocab_size, int(rng.integers(3, 8)))
           .tolist() for _ in range(3)]
out["prompts"] = prompts
for impl in SERVE_IMPLS:
    eng = ServeEngine(base, SERVE_BATCH, SERVE_MAX_LEN, quant=spec(impl))
    eng.params = planned(params, eng.cfg)
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    out["serve"][impl] = dict(tokens=[list(r.out) for r in reqs],
                              steps=eng.steps)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (inspect.getsource(draw_constant_leaves), ARCH, IMPLS, SERVE_IMPLS,
       BATCH, SEQ, CHUNK, SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS,
       DECODE_POS, WINDOW_CASES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's params (betas and d_skip drawn), inputs and every
    case's outputs, jitted with excess precision off."""
    return run_reference(_REFERENCE,
                         tmp_path_factory.mktemp("ref") / "hymba.pkl")


def port_config(impl=None):
    cfg = get_config(ARCH, smoke=True)
    return cfg.replace(quant=None if impl is None
                       else QuantSpec.parse(spec_text(impl)))


def planned(params, cfg):
    """The params as cfg's route runs them: planned on pallas_fused."""
    if cfg.quant is not None and cfg.quant.impl == "pallas_fused":
        params, _ = tops.plan_params(params, cfg.quant)
    return params


def port_params(ref, cfg):
    return planned(params_from_numpy(ref["params"], cfg, device="cpu"), cfg)


def bf16(a):
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16)


def f32(t):
    return t.float().numpy()


def assert_close(got, want, atol, what):
    np.testing.assert_allclose(f32(got) if isinstance(got, torch.Tensor)
                               else got, want, rtol=0, atol=atol,
                               err_msg=what)


def rel_atol(impl, want, what="module"):
    """An output's or a state's tolerance on a route, from its largest
    value: BF16_RTOL on the bf16 route, QUANT_RTOL on the others (the
    logits there: QUANT_LOGIT_ATOL)."""
    if impl is not None and what == "logits":
        return QUANT_LOGIT_ATOL
    rtol = BF16_RTOL[what] if impl is None else QUANT_RTOL
    return rtol * float(np.abs(want).max())


def assert_ssm_state(got, want, impl, what):
    """A returned SSM state: h float32 [.., B, di, n], conv bf16
    [.., B, K-1, di], each within ``rel_atol``."""
    for key, dtype in (("h", torch.float32), ("conv", torch.bfloat16)):
        assert got[key].dtype == dtype, key
        assert tuple(got[key].shape) == want[key].shape, key
        assert_close(got[key], want[key], rel_atol(impl, want[key]),
                     f"{what} {key}")


# --- config and init --------------------------------------------------------

def test_get_api_takes_the_hybrid_family():
    """``get_api(get_config("hymba-1.5b"))`` is the hybrid family, with
    hymba_lm_init, the forward and hymba_lm_decode_step; its init_decode
    ignores max_len and holds the five leaves in three dtypes.  (The
    config's fields and counts are held against the reference's by
    test_torch_dense_configs.py.)"""
    cfg = get_config(ARCH)
    api = get_api(cfg)
    assert (api.family, cfg.family, cfg.ssm_state, cfg.ssm_expand,
            cfg.ssm_conv, cfg.subquadratic) == ("hybrid", "hybrid", 16, 2,
                                                4, True)
    assert api.init is H.hymba_lm_init
    assert api.decode_step is H.hymba_lm_decode_step
    small = get_config(ARCH, smoke=True)
    for max_len in (1, 1 << 19):
        state = api.init_decode(small, 3, max_len, "cpu")
        shapes = {k: {kk: (tuple(v.shape), v.dtype) for kk, v in sub.items()}
                  for k, sub in state.items()}
        assert shapes == {
            "kv": {"k": ((2, 3, W, 2, 16), torch.bfloat16),
                   "v": ((2, 3, W, 2, 16), torch.bfloat16),
                   "pos": ((2, 3, W), torch.int32)},
            "ssm": {"h": ((2, 3, 128, 4), torch.float32),
                    "conv": ((2, 3, 3, 128), torch.bfloat16)}}
        assert bool((state["kv"]["pos"] == -1).all())
        assert not any(bool(x.any()) for x in (
            state["kv"]["k"], state["kv"]["v"], state["ssm"]["h"],
            state["ssm"]["conv"]))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_init_tree_matches_reference():
    """hymba_lm_init's tree has the reference's keys, shapes and dtypes
    (float32), the blocks unstacked into per-layer dicts, the top-level
    meta [128, d] included; a_log, d_skip and the betas take the
    reference's values, and dt_proj's bias is zeros."""
    cfg = get_config(ARCH, smoke=True)
    ours = H.hymba_lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    jcfg = jget_config(ARCH, smoke=True)
    theirs = jax.tree.map(np.asarray, jax.jit(
        lambda key: unbox(JH.hymba_lm_init(key, jcfg)))(jax.random.PRNGKey(0)))
    layered = jax.tree.map(lambda a: a[0], theirs["blocks"])
    assert len(ours["blocks"]) == cfg.n_layers
    for blk in ours["blocks"]:
        assert _shapes(blk) == _shapes(layered)
    rest = {k: v for k, v in ours.items() if k != "blocks"}
    assert _shapes(rest) == _shapes({k: v for k, v in theirs.items()
                                     if k != "blocks"})
    assert ours["meta"].shape == (H.N_META, cfg.d_model)
    for blk in ours["blocks"]:
        for tree, key in ((blk["ssm"], "a_log"), (blk["ssm"], "d_skip"),
                          (blk, "beta_attn"), (blk, "beta_ssm")):
            want = layered["ssm"][key] if tree is blk["ssm"] else \
                layered[key]
            np.testing.assert_array_equal(tree[key].numpy(), want,
                                          err_msg=key)
        assert not blk["ssm"]["dt_proj"]["b"].any()


def test_params_from_numpy_carries_the_tree(ref):
    """params_from_numpy slices every layer-stacked leaf -- the 3-D
    a_log [L, di, n] and conv_w [L, K, di], dt_proj's bias [L, di], the
    drawn betas and d_skip -- bit for bit, and carries the top-level meta
    [128, d], the embedding, the final norm and the head as they are."""
    cfg = port_config()
    tree = ref["params"]
    ours = params_from_numpy(tree, cfg, device="cpu")
    ssm = ours["blocks"][0]["ssm"]
    assert ssm["a_log"].shape == (128, 4) and ssm["conv_w"].shape == (4, 128)
    assert ssm["dt_proj"]["b"].shape == (128,)
    for i, blk in enumerate(ours["blocks"]):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: a[i], tree["blocks"]))[0]
        for path, want in flat:
            got = blk
            for key in path:
                got = got[key.key]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ours["meta"].numpy(), tree["meta"])
    for key in ("embed", "final_norm", "lm_head"):
        for name, want in tree[key].items():
            np.testing.assert_array_equal(ours[key][name].numpy(), want)


# --- the SSM ----------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "carried"])
def test_causal_conv_matches_reference(ref, carried):
    """_causal_conv in bf16 (its K=4 products summed in order from 0),
    from zeros and from a carried state: the output and the returned
    state, the last K-1 inputs, bit for bit."""
    inp = ref["inputs"]
    w = bf16(ref["params"]["blocks"]["ssm"]["conv_w"][0])
    got = S._causal_conv(bf16(inp["xc"]), w,
                         bf16(inp["conv"]) if carried else None)
    for g, want in zip(got, ref["conv"][str(carried)]):
        assert g.dtype == torch.bfloat16 and g.shape == want.shape
        np.testing.assert_array_equal(f32(g), want)
    np.testing.assert_array_equal(f32(got[1]), f32(bf16(inp["xc"])[:, -3:]))


def test_selective_scan_matches_reference(ref):
    """_selective_scan over 12 positions from a seeded state: y and the
    final state within F32_RTOL of their largest values (XLA's fused
    multiply-adds; ROADMAP C11)."""
    inp = ref["inputs"]
    a = -torch.exp(torch.from_numpy(
        np.array(ref["params"]["blocks"]["ssm"]["a_log"][0])))
    y, state = S._selective_scan(*(torch.from_numpy(inp[k]) for k in (
        "xs", "dt", "bmat", "cmat")), a, torch.from_numpy(inp["h"]))
    for got, want in zip((y, state), ref["scan"]):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert_close(got, want, F32_RTOL * float(np.abs(want).max()), "scan")


def test_softplus_within_two_ulps_of_reference(ref):
    """The port's softplus (max(x, 0) + log1p(exp(-|x|)), the reference's
    logaddexp(x, 0)) on 2^16 values of N(0, 64): within SOFTPLUS_ULPS
    float32 ulps of jax.nn.softplus; equal on most."""
    x = ref["inputs"]["softplus"]
    got = S._softplus(torch.from_numpy(x)).numpy()
    want = ref["softplus"]
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= SOFTPLUS_ULPS, ulps.max()
    assert np.mean(got == want) > 0.5


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@pytest.mark.parametrize("carried", [False, True], ids=["zeros", "carried"])
@torch.no_grad()
def test_ssm_apply_matches_reference(ref, impl, carried):
    """ssm_apply on a seeded bf16 input, from zeros and from a seeded
    state: the output and the returned state (h float32, conv bf16 --
    the last K-1 inputs of the conv, bit for bit) within ``rel_atol``."""
    cfg = port_config(impl)
    inp = ref["inputs"]
    want = ref["modules"][impl]["ssm_state" if carried else "ssm_zero"]
    state = {"h": torch.from_numpy(inp["h"]),
             "conv": bf16(inp["conv"])} if carried else None
    out, got = S.ssm_apply(port_params(ref, cfg)["blocks"][0]["ssm"],
                           bf16(inp["x"]), cfg, state)
    assert out.dtype == torch.bfloat16 and out.shape == want[0].shape
    assert_close(out, want[0], rel_atol(impl, want[0]), "out")
    assert_ssm_state(got, want[1], impl, "ssm")


@pytest.mark.parametrize("case", range(len(WINDOW_CASES)),
                         ids=[c[-1] for c in WINDOW_CASES])
def test_windowed_attention_matches_reference(ref, case):
    """_windowed (scores / sqrt(d)) and _windowed_chunked (scores x
    1/sqrt(d), kv chunks within the window, online softmax) against the
    reference's within WINDOW_ATOL, and against each other within
    WALKS_TOL, as the reference's two walks are (tests/test_attention.py:38's
    case in float32, and the model's bf16)."""
    b, t, h, d, win, chunk, dtype = WINDOW_CASES[case]
    q, k, v = (torch.from_numpy(z).to(getattr(torch, dtype))
               for z in ref["inputs"]["window"][case])
    pos = torch.arange(t)[None].expand(b, t)
    plain = H._windowed(q, k, v, win, pos)
    chunked = H._windowed_chunked(q, k, v, win, chunk)
    atol = WINDOW_ATOL[dtype]
    for got, want, what in ((plain, ref["window"][case][0], "plain"),
                            (chunked, ref["window"][case][1], "chunked")):
        assert got.dtype == q.dtype and got.shape == (b, t, h, d)
        assert_close(got, want, atol, what)
    walks = WALKS_TOL[dtype] * (1.0 if dtype == "float32"
                                else float(np.abs(ref["window"][case][0]).max()))
    assert_close(chunked, f32(plain), walks, "chunked against plain")
    assert_close(ref["window"][case][1], ref["window"][case][0], walks,
                 "the reference's chunked against its plain")


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_block_apply_matches_reference(ref, impl):
    """One whole block from a seeded SSM state: the output and the SSM
    state it returns, within ``rel_atol``."""
    cfg = port_config(impl)
    inp = ref["inputs"]
    want, want_state = ref["modules"][impl]["block"]
    state = {"h": torch.from_numpy(inp["h"]), "conv": bf16(inp["conv"])}
    pos = torch.arange(SEQ)[None].expand(BATCH, SEQ)
    out, got = H.block_apply(port_params(ref, cfg)["blocks"][0],
                             bf16(inp["x"]), cfg, pos, state)
    assert out.dtype == torch.bfloat16
    assert_close(out, want, rel_atol(impl, want), "out")
    assert_ssm_state(got, want_state, impl, "block")


# --- the LM -----------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_forward_and_loss_match_reference(ref, impl):
    """api.forward (hymba_lm_apply with the 128 meta tokens), the forward
    without them, and loss_fn on seeded tokens: logits within tolerance,
    greedy tokens equal but at near-ties, the loss within LOSS_ATOL, the
    token count exact; the loss is the masked mean NLL of the port's own
    logits, and the aux a float32 zero."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    inp, want = ref["inputs"], ref["forward"][impl]
    tokens = torch.from_numpy(inp["tokens"])
    labels = torch.from_numpy(inp["labels"])
    logits, aux = get_api(cfg).forward(params, {"tokens": tokens}, cfg,
                                       device="cpu")
    bare, _ = H.hymba_lm_apply(params, tokens, cfg, "cpu", with_meta=False)
    loss, metrics = loss_fn(params, {"tokens": tokens, "labels": labels},
                            cfg, device="cpu")
    for got, key in ((logits, "logits"), (bare, "bare")):
        assert got.shape == (BATCH, SEQ, cfg.padded_vocab)
        atol = rel_atol(impl, want[key], "logits")
        assert_close(got, want[key], atol, key)
        assert_tokens(f32(got), want[key], atol)
    assert aux.dtype == torch.float32 and float(aux) == want["aux"] == 0.0
    assert abs(float(loss) - want["loss"]) <= LOSS_ATOL[impl]
    assert float(metrics["tokens"]) == want["metrics"]["tokens"] == \
        BATCH * (SEQ - 1) - 2
    lf, lab = logits.float(), labels.long()
    mask = lab >= 0
    nll = torch.logsumexp(lf, -1) - torch.take_along_dim(
        lf, lab.clamp_min(0)[..., None], dim=-1)[..., 0]
    np.testing.assert_allclose(float(loss),
                               float((nll * mask).sum() / mask.sum()),
                               rtol=1e-6)
    # the meta tokens move the logits
    assert not torch.equal(logits, bare)


@torch.no_grad()
def test_forward_on_the_chunked_walk_matches_reference(ref):
    """With attn_chunk 28 the forward's 140 positions (128 meta + 12)
    take the chunked walk in every layer (bf16 route): logits within
    tolerance of the reference's on the same walk, and within
    WALKS_LOGIT_RTOL of the port's plain walk, as the reference's two
    walks are."""
    cfg = port_config()
    params = port_params(ref, cfg)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    chunked = cfg.replace(attn_chunk=CHUNK)
    assert (SEQ + H.N_META) % CHUNK == 0 and SEQ + H.N_META > CHUNK
    logits, _ = get_api(chunked).forward(params, {"tokens": tokens},
                                         chunked, device="cpu")
    atol = rel_atol(None, ref["chunked"], "logits")
    assert_close(logits, ref["chunked"], atol, "chunked")
    assert_tokens(f32(logits), ref["chunked"], atol)
    plain, _ = get_api(cfg).forward(params, {"tokens": tokens}, cfg,
                                    device="cpu")
    want = ref["forward"][None]["logits"]
    walks = WALKS_LOGIT_RTOL * float(np.abs(want).max())
    assert_close(logits, f32(plain), walks, "the port's two walks")
    assert_close(ref["chunked"], want, walks, "the reference's two walks")


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_decode_steps_match_reference(ref, impl):
    """hymba_lm_decode_step from init_decode's caches, a row each at
    positions 0, 1, 2, W+2 / 3 and W+5: the logits and all five state
    leaves after each step (the ring's slot 2 overwritten at W+2, the
    window expired at W+2 and W+5; pos int32 exact)."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    api = get_api(cfg)
    state = api.init_decode(cfg, BATCH, SEQ, "cpu")
    for i, (pos, (want, want_state)) in enumerate(zip(
            DECODE_POS, ref["decode"][impl])):
        logits, state = api.decode_step(
            params, tokens[:, i:i + 1], torch.tensor(pos, dtype=torch.int32),
            state, cfg)
        atol = rel_atol(impl, want, "logits")
        assert_close(logits, want, atol, f"step {i}")
        assert_tokens(f32(logits), want, atol)
        kv = state["kv"]
        np.testing.assert_array_equal(kv["pos"].numpy(),
                                      want_state["kv"]["pos"])
        for key in ("k", "v"):
            assert kv[key].dtype == torch.bfloat16
            assert_close(kv[key], want_state["kv"][key],
                         rel_atol(impl, want_state["kv"][key]),
                         f"step {i} {key}")
        assert_ssm_state(state["ssm"], want_state["ssm"], impl, f"step {i}")
    # row 0's slot 2 holds position W + 2, and the window dropped 0-2
    assert state["kv"]["pos"][:, 0, :6].tolist() == \
        [[0, 1, W + 2, -1, -1, W + 5]] * cfg.n_layers


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_forward_without_meta_continues_by_decode(ref, impl):
    """The port's forward without meta against its own token-by-token
    decode from the initial caches, at positions 0..11 (within
    DECODE_CONSISTENCY_TOL; on the CPU bit for bit at this size).  With
    meta the forward is not decode's continuation: the meta tokens move
    every logit."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    bare, _ = H.hymba_lm_apply(params, tokens, cfg, "cpu", with_meta=False)
    state = H.init_hymba_caches(cfg, BATCH, device="cpu")
    steps = []
    for i in range(SEQ):
        lg, state = H.hymba_lm_decode_step(params, tokens[:, i:i + 1],
                                           torch.full((BATCH,), i), state,
                                           cfg)
        steps.append(lg)
    np.testing.assert_allclose(f32(torch.cat(steps, 1)), f32(bare),
                               rtol=DECODE_CONSISTENCY_TOL,
                               atol=DECODE_CONSISTENCY_TOL)
    assert torch.equal(torch.cat(steps, 1), bare)


# --- plans and launches -----------------------------------------------------

def test_plans_match_reference(ref):
    """The port plans what the reference plans on a hybrid tree, as many
    (9 a layer and the head: 19): every record equals the reference's
    layer-stacked record (planned in its subprocess) sliced at its layer;
    x_to_dt, dt_proj and x_to_bc stay unplanned, as do conv_w, a_log,
    d_skip, the betas, meta and the embedding."""
    cfg = port_config("pallas_fused")
    jplanned = ref["planned"]
    planned, count = tops.plan_params(
        params_from_numpy(ref["params"], cfg, device="cpu"), cfg.quant)

    def records(tree):
        if isinstance(tree, dict):
            return ("w_plan" in tree) + sum(records(v) for k, v in
                                            tree.items() if k != "w_plan")
        return 0
    assert count == PLANNED_PER_LAYER * cfg.n_layers + 1 == 19
    assert records(jplanned) == PLANNED_PER_LAYER + 1    # stacked layers
    for i, blk in enumerate(planned["blocks"]):
        for mod, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("ssm", ("in_proj", "out_proj")),
                           ("mlp", ("gate", "up", "down"))):
            for name in names:
                ours = blk[mod][name]["w_plan"]
                theirs = jplanned["blocks"][mod][name]["w_plan"]
                assert set(ours) == set(theirs)
                for key, want in theirs.items():
                    np.testing.assert_array_equal(
                        ours[key].numpy(), want[i],
                        err_msg=f"layer {i} {mod}.{name}.{key}")
        for name in ("x_to_dt", "dt_proj", "x_to_bc"):
            assert "w_plan" not in blk["ssm"][name]
            assert "w_plan" not in jplanned["blocks"]["ssm"][name]
    for key, want in jplanned["lm_head"]["w_plan"].items():
        np.testing.assert_array_equal(
            planned["lm_head"]["w_plan"][key].numpy(), want, err_msg=key)


def test_b1_launches_per_forward_and_step(ref, monkeypatch):
    """On pallas_fused a forward and a decode step call B1 once a planned
    weight: 9 x layers + 1 = 19 times, never for the SSM's float32
    projections."""
    cfg = port_config("pallas_fused")
    params = port_params(ref, cfg)
    calls = []
    fused = bwk.bw_gemm_fused

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fused(*args, **kw)
    monkeypatch.setattr(bwk, "bw_gemm_fused", counted)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    with torch.no_grad():
        H.hymba_lm_apply(params, tokens, cfg, "cpu")
        assert len(calls) == 19
        H.hymba_lm_decode_step(params, tokens[:, :1], torch.zeros(BATCH),
                               H.init_hymba_caches(cfg, BATCH, device="cpu"),
                               cfg)
    assert len(calls) == 38


# --- serving ----------------------------------------------------------------

def engine(ref, impl, batch=SERVE_BATCH):
    cfg = get_config(ARCH, smoke=True)
    return ServeEngine(cfg, batch, SERVE_MAX_LEN,
                       quant=QuantSpec.parse(spec_text(impl)),
                       params=params_from_numpy(ref["params"], cfg,
                                                device="cpu"), device="cpu")


def serve(ref, impl, batch=SERVE_BATCH, prompts=None, eng=None):
    eng = eng or engine(ref, impl, batch)
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts or ref["prompts"])]
    stats = eng.run(reqs)
    return eng, [r.out for r in reqs], stats


def test_engine_constructs_on_the_hybrid_family(ref):
    """A ServeEngine on the hybrid family keeps a copy of the whole
    nested initial state (``_state0``, the reference's
    ``jax.tree.map(jnp.copy, ...)``): the same five leaves, equal, none
    shared with the live state; warm() leaves the state as it was."""
    eng = engine(ref, "pallas_fused")
    assert eng.api.family == "hybrid" and \
        "hybrid" in tengine.RESET_STATE_FAMILIES
    live, first = state_leaves(eng.state), state_leaves(eng._state0)
    assert len(live) == len(first) == 5
    assert [x.dtype for x in live] == [torch.bfloat16, torch.int32,
                                       torch.bfloat16, torch.bfloat16,
                                       torch.float32]     # k pos v conv h
    for a, b in zip(live, first):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    eng.warm()
    for a, b in zip(state_leaves(eng.state), first):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", SERVE_IMPLS)
def test_served_tokens_match_reference(ref, impl, monkeypatch):
    """The port's ServeEngine on the reference's params (batch 2, 3
    requests: the third reuses a slot, whose state rows are reset) emits
    the reference engine's greedy tokens step for step through the
    oracle and B1, the activation scale as the compiled reference rounds
    it; 19 weights planned on pallas_fused."""
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    eng, tokens, stats = serve(ref, impl)
    want = ref["serve"][impl]
    assert tokens == want["tokens"]
    assert stats["engine_steps"] == want["steps"]
    assert stats["generated_tokens"] == 3 * NEW_TOKENS
    if impl == "pallas_fused":
        assert eng.plan_stats["planned_weights"] == 19


def test_served_tokens_equal_on_both_routes(ref):
    """B1 and the oracle serve the same greedy tokens (no activation is
    folded into B1's epilogue, so the routes are bit-identical)."""
    assert serve(ref, "planes")[1] == serve(ref, "pallas_fused")[1]


def reuse_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, 4).tolist() for _ in range(2)]


@pytest.mark.parametrize("impl", SERVE_IMPLS)
def test_slot_reuse_resets_state(ref, impl):
    """At batch 1 the second request rebinds slot 0 and must emit the
    tokens it emits alone on a fresh engine."""
    prompts = reuse_prompts()
    _, tokens, _ = serve(ref, impl, batch=1, prompts=prompts)
    _, alone, _ = serve(ref, impl, batch=1, prompts=prompts[1:])
    assert tokens[1] == alone[0]


@pytest.mark.parametrize("kept", ["ssm", "kv"])
def test_slot_reuse_without_reset(ref, kept, monkeypatch):
    """The check above has teeth.  With the ``ssm`` rows (h and conv)
    left as the first request left them, the second request's tokens
    differ from its run alone.  With only the ring's rows left, they do
    not: max_len < W, so a stale entry's position is above the new
    request's until that request overwrites its slot, and the mask
    hides it."""
    reset = tengine._reset_state_row

    def reset_all_but_kept(state, state0, slot):
        keys = [k for k in state if k != kept]
        reset({k: state[k] for k in keys}, {k: state0[k] for k in keys},
              slot)
    monkeypatch.setattr(tengine, "_reset_state_row", reset_all_but_kept)
    prompts = reuse_prompts()
    _, tokens, _ = serve(ref, "pallas_fused", batch=1, prompts=prompts)
    _, alone, _ = serve(ref, "pallas_fused", batch=1, prompts=prompts[1:])
    assert (tokens[1] != alone[0]) == (kept == "ssm")


def test_snapshot_round_trips_hybrid_rows(ref):
    """A mid-decode hybrid slot's DecodeSnapshot: its rows are the five
    leaves' [L, 1, ...] slices in sorted-key order (k, pos, v, conv, h:
    bf16, int32, bf16, bf16, float32), its bytes read back bit for bit
    (the reference cannot read its own bf16 rows, ROADMAP C4, so bytes
    are compared, not a reference restore), and restored into a fresh
    engine's other slot the request goes on to the same tokens."""
    from repro_torch.serving.scheduler import Scheduler
    eng = engine(ref, "pallas_fused")
    sched = Scheduler("fcfs", max_len=SERVE_MAX_LEN)
    prompt = ref["prompts"][0]
    req = ServeRequest(0, list(prompt), NEW_TOKENS)
    sched.submit(req, now=0.0)
    eng.admit_from(sched)
    while len(req.out) < 2:
        eng.step()
    snap = eng.snapshot_slot(0)
    assert [tuple(r.shape) for r in snap.rows] == [
        (2, 1, W, 2, 16), (2, 1, W), (2, 1, W, 2, 16), (2, 1, 3, 128),
        (2, 1, 128, 4)]
    assert [r.dtype for r in snap.rows] == [
        torch.bfloat16, torch.int32, torch.bfloat16, torch.bfloat16,
        torch.float32]
    assert snap.rows[1][0, 0, :len(prompt) + 1].tolist() == \
        list(range(len(prompt) + 1))
    for row, leaf in zip(snap.rows, state_leaves(eng.state)):
        assert torch.equal(row, leaf[:, :1].cpu())
    data = snap.to_bytes()
    back = DecodeSnapshot.from_bytes(data)
    assert back.to_bytes() == data
    for a, b in zip(back.rows, snap.rows):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)
    while not req.done:
        eng.step()
    fresh = engine(ref, "pallas_fused")
    assert fresh.restorable(back) is None
    moved = ServeRequest(0, list(prompt), NEW_TOKENS, out=list(back.out))
    fresh.restore_slot(1, moved, back)
    while not moved.done:
        fresh.step()
    assert moved.out == req.out


def test_launcher_serves_hymba(capsys):
    """``launch/serve.py --arch hymba-1.5b`` serves through the registry
    with no flag of its own, through B1: 19 weights planned."""
    from repro_torch.launch import serve as launcher
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
            "3", "--batch", "2", "--prompt-len", "4", "--max-tokens", "3",
            "--quant-spec", spec_text("pallas_fused"), "--json"]
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert '"generated_tokens": 9' in out
    assert '"planned_weights": 19' in out
