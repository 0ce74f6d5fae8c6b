"""The port's RWKV-6 family (``models/rwkv6.py``, rwkv6-3b) against the
reference's, on the smoke config (2 layers, d_model 64, 4 heads x 16,
d_ff 128, vocab 512).

The reference initialises seven leaves to constants (``mu_x``,
``mu_base``, ``u``, ``w0``, ``ln_x_bias``, ``mu_k``, ``mu_r``: zeros,
-0.5 and 0.5), under which the token shift, the bonus and the decay's
offset would move nothing.  Every case here replaces them by seeded
draws of the same shapes (``draw_constant_leaves``; chip_smoke.py draws
the same on the card), so every parameter moves the logits.

The jitted reference runs once, in a subprocess with XLA's excess
precision off (test_torch_forward.py's ``run_reference``): its param
tree, inputs and outputs come back in one pickle and the port takes the
same params (``convert.params_from_numpy``) and inputs on the CPU, where
its kernel wrappers run their plain versions.

Where the two differ, and the tolerances that follow (ROADMAP C10):

* XLA on the CPU contracts a float32 multiply and add into one fused
  multiply-add (the ddlerp's ``x + sx * mu``, the scan's ``w * s + kv``
  and ``s + u * kv``, the group norm's affine) and sums the scan's
  ``r . (...)`` as a chain of them; torch rounds each op.  Its float32
  ``tanh`` and ``exp`` are its own approximations.  Each leaves float32
  values a few ulps apart (``F32_RTOL`` on the scan alone) and, where one
  lands on a bf16 rounding boundary, a bf16 value one ulp apart
  (``BF16_RTOL``, relative to the largest value).
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

from repro.configs.registry import get_config as jget_config
from repro.models import rwkv6 as JR
from repro.parallel.sharding import unbox
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec
from repro_torch.kernels import bw_gemm as bwk
from repro_torch.kernels import ops as tops
from repro_torch.models import rwkv6 as R
from repro_torch.models.api import get_api, loss_fn
from repro_torch.serving import engine as tengine
from repro_torch.serving.ckpt import DecodeSnapshot
from repro_torch.serving.engine import ServeEngine, state_leaves
from repro_torch.serving.request import ServeRequest

from test_torch_forward import (assert_tokens, compiled_scale,
                                run_reference, spec_text)

torch.set_num_threads(1)

ARCH = "rwkv6-3b"
IMPLS = (None, "planes", "pallas_fused")
SERVE_IMPLS = ("planes", "pallas_fused")
BATCH, SEQ, DECODE_STEPS = 2, 12, 8
SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS = 2, 16, 6
# planned a layer: timemix wr/wk/wv/wg/wo, chanmix wk/wv/wr; and the head
PLANNED_PER_LAYER = 8

# float32 values of the scan and its state: XLA's fused multiply-adds
# against torch's separate roundings, a few float32 ulps of the largest
# value (2^-23 each), kept well under a bf16 ulp (2^-8)
F32_RTOL = 2.0 ** -18
# the bf16 route, relative to an output's largest value: one bf16 ulp
# (2^-8) where a float32 difference crosses a bf16 rounding boundary (a
# module's output, the wkv state after bf16 k and v, a shift row after a
# layer); two on the logits, after two layers and the head
BF16_RTOL = {"module": 2.0 ** -8, "logits": 2.0 ** -7}
# the quantized routes, relative to an output's or a state's largest
# value: two steps of the planes=3 grid (qmax 42, per token), one from an
# input a bf16 ulp off and one from C2's scale rounding
QUANT_RTOL = 2.0 / 42
# the logits on the quantized routes: test_torch_forward.py's LOGIT_ATOL
QUANT_LOGIT_ATOL = 1.0
# the mean next-token NLL: the logit gaps above at a few positions
LOSS_ATOL = {None: 0.02, "planes": 0.05, "pallas_fused": 0.05}
# the port's forward against its own token-by-token decode: the
# reference's test_rwkv_scan_decode_consistency tolerance
DECODE_CONSISTENCY_TOL = 0.05


def draw_constant_leaves(blocks, rng):
    """Replace the leaves rwkv_lm_init sets to constants, in a
    layer-stacked numpy tree, by seeded draws of the same shapes: the
    mixing coefficients mu_* ~ U(0, 1), the bonus u ~ U(-0.5, 1), the
    decay offset w0 ~ U(-6, -1) (about the span of RWKV-6's own init),
    ln_x_bias ~ U(-0.5, 0.5).  The reference's subprocess runs this same
    function (its source is put into the script)."""
    tm, cm = blocks["tm"], blocks["cm"]
    for tree, key, lo, hi in ((tm, "mu_x", 0.0, 1.0),
                              (tm, "mu_base", 0.0, 1.0),
                              (tm, "u", -0.5, 1.0), (tm, "w0", -6.0, -1.0),
                              (tm, "ln_x_bias", -0.5, 0.5),
                              (cm, "mu_k", 0.0, 1.0),
                              (cm, "mu_r", 0.0, 1.0)):
        tree[key] = rng.uniform(lo, hi, np.shape(tree[key])).astype(
            np.float32)


_REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.engine import QuantSpec
from repro.kernels import ops
from repro.models import rwkv6 as R
from repro.models.api import get_api, loss_fn
from repro.parallel.sharding import unbox
from repro.serving.engine import ServeEngine
from repro.serving.request import ServeRequest
%s
ARCH, IMPLS, SERVE_IMPLS = %r, %r, %r
BATCH, SEQ, DECODE_STEPS = %d, %d, %d
SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS = %d, %d, %d


def spec(impl):
    return None if impl is None else QuantSpec.parse(
        "planes=3,encoding=ent,impl=%%s,act_quant=per_token" %% impl)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def tree32(t):
    return jax.tree.map(f32, t)


def planned(p, cfg):
    if cfg.quant is not None and cfg.quant.impl == "pallas_fused":
        p, _ = ops.plan_params(p, cfg.quant)
    return p


base = get_config(ARCH, smoke=True)
params = jax.tree.map(np.asarray, jax.jit(
    lambda key: unbox(R.rwkv_lm_init(key, base)))(jax.random.PRNGKey(0)))
draw_constant_leaves(params["blocks"], np.random.default_rng(7))
layer = jax.tree.map(lambda a: a[0], params["blocks"])
d, h, hs = base.d_model, base.n_heads, base.rwkv_head_size

rng = np.random.default_rng(1)
inputs = dict(
    x=rng.standard_normal((BATCH, SEQ, d)).astype(np.float32),
    shift_tm=rng.standard_normal((BATCH, d)).astype(np.float32),
    shift_cm=rng.standard_normal((BATCH, d)).astype(np.float32),
    wkv=rng.standard_normal((BATCH, h, hs, hs)).astype(np.float32),
    r=rng.standard_normal((BATCH, SEQ, h, hs)).astype(np.float32),
    k=rng.standard_normal((BATCH, SEQ, h, hs)).astype(np.float32),
    v=rng.standard_normal((BATCH, SEQ, h, hs)).astype(np.float32),
    w=rng.uniform(0.5, 0.999, (BATCH, SEQ, h, hs)).astype(np.float32),
    tokens=rng.integers(0, base.vocab_size, (BATCH, SEQ)).astype(np.int32))
labels = np.concatenate([inputs["tokens"][:, 1:],
                         np.full((BATCH, 1), -1, np.int32)], axis=1)
labels[0, :2] = -1
inputs["labels"] = labels
bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
x, stm, scm = bf(inputs["x"]), bf(inputs["shift_tm"]), bf(inputs["shift_cm"])
wkv = jnp.asarray(inputs["wkv"])

out = {"params": params, "inputs": inputs, "modules": {}, "forward": {},
       "decode": {}, "serve": {}}
y, s = jax.jit(R._wkv_scan)(inputs["r"], inputs["k"], inputs["v"],
                            inputs["w"], layer["tm"]["u"], wkv)
out["scan"] = dict(y=f32(y), state=f32(s))

for impl in IMPLS:
    cfg = base.replace(quant=spec(impl))
    api = get_api(cfg)
    toks = inputs["tokens"]

    def run(lp, p, x, stm, scm, wkv, t, l):
        tm = R.timemix_apply(lp["tm"], x, cfg, stm, wkv)
        cm = R.chanmix_apply(lp["cm"], x, cfg, scm)
        blk = R.rwkv_apply(lp, x, cfg, {"shift_tm": stm, "shift_cm": scm,
                                        "wkv": wkv})
        logits, aux = api.forward(p, {"tokens": t}, cfg)
        loss, metrics = loss_fn(p, {"tokens": t, "labels": l}, cfg)
        return tm, cm, blk, logits, aux, loss, metrics
    pp = planned(params, cfg)
    tm, cm, blk, logits, aux, loss, metrics = jax.jit(run)(
        planned(layer, cfg), pp, x, stm, scm, wkv, toks, labels)
    out["modules"][impl] = dict(
        timemix=tree32(tm), chanmix=tree32(cm),
        block=(f32(blk[0]), tree32(blk[1])))
    out["forward"][impl] = dict(
        logits=f32(logits), aux=float(aux), loss=float(loss),
        metrics={k: float(v) for k, v in metrics.items()})
    if impl == "pallas_fused":
        out["planned"] = jax.tree.map(np.asarray, pp)

    step = jax.jit(lambda p, t, i, st: api.decode_step(p, t, i, st, cfg))
    state = unbox(api.init_decode(cfg, BATCH, SEQ))
    steps = []
    for i in range(DECODE_STEPS):
        lg, state = step(pp, toks[:, i:i + 1], jnp.full((BATCH,), i), state)
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
       BATCH, SEQ, DECODE_STEPS, SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's params (constant leaves drawn), inputs and every
    case's outputs, jitted with excess precision off."""
    return run_reference(_REFERENCE,
                         tmp_path_factory.mktemp("ref") / "rwkv.pkl")


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


def assert_state(got, want, impl, what):
    """A returned [.., B, ...] state: the shifts bf16, wkv float32, each
    within ``rel_atol``."""
    for key in ("shift_tm", "shift_cm", "wkv"):
        assert got[key].dtype == (torch.float32 if key == "wkv"
                                  else torch.bfloat16), key
        assert tuple(got[key].shape) == want[key].shape, key
        assert_close(got[key], want[key], rel_atol(impl, want[key]),
                     f"{what} {key}")


# --- config and init --------------------------------------------------------

def test_get_api_takes_the_rwkv_family():
    """``get_api(get_config("rwkv6-3b"))`` is the rwkv family, with
    rwkv_lm_init, the forward and rwkv_lm_decode_step; its init_decode
    ignores max_len.  (The config's fields and counts are held against
    the reference's by test_torch_dense_configs.py.)"""
    cfg = get_config(ARCH)
    api = get_api(cfg)
    assert (api.family, cfg.family, cfg.rwkv_head_size,
            cfg.subquadratic) == ("rwkv", "rwkv", 64, True)
    assert api.init is R.rwkv_lm_init
    assert api.decode_step is R.rwkv_lm_decode_step
    small = get_config(ARCH, smoke=True)
    for max_len in (1, 4096):
        state = api.init_decode(small, 3, max_len, "cpu")
        assert {k: tuple(v.shape) for k, v in state.items()} == {
            "shift_tm": (2, 3, 64), "shift_cm": (2, 3, 64),
            "wkv": (2, 3, 4, 16, 16)}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_init_tree_matches_reference():
    """rwkv_lm_init's tree has the reference's keys, shapes and dtypes
    (float32), the blocks unstacked into per-layer dicts; the constant
    leaves take the reference's values."""
    cfg = get_config(ARCH, smoke=True)
    ours = R.rwkv_lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    jcfg = jget_config(ARCH, smoke=True)
    theirs = jax.tree.map(np.asarray, jax.jit(
        lambda key: unbox(JR.rwkv_lm_init(key, jcfg)))(jax.random.PRNGKey(0)))
    layered = jax.tree.map(lambda a: a[0], theirs["blocks"])
    assert len(ours["blocks"]) == cfg.n_layers
    for blk in ours["blocks"]:
        assert _shapes(blk) == _shapes(layered)
    rest = {k: v for k, v in ours.items() if k != "blocks"}
    assert _shapes(rest) == _shapes({k: v for k, v in theirs.items()
                                     if k != "blocks"})
    for blk in ours["blocks"]:
        for tree, key in (("tm", "mu_x"), ("tm", "mu_base"), ("tm", "u"),
                          ("tm", "w0"), ("tm", "ln_x_scale"),
                          ("tm", "ln_x_bias"), ("cm", "mu_k"),
                          ("cm", "mu_r")):
            np.testing.assert_array_equal(blk[tree][key].numpy(),
                                          layered[tree][key], err_msg=key)


def test_params_from_numpy_carries_the_tree(ref):
    """params_from_numpy slices every layer-stacked leaf, the bare
    [L, 5, 32, d] mix_w2 and the [L, H, hs] bonus included, bit for bit;
    the embedding, norms and head are carried as they are."""
    cfg = port_config()
    tree = ref["params"]
    ours = params_from_numpy(tree, cfg, device="cpu")
    assert ours["blocks"][0]["tm"]["mix_w2"].shape == (5, 32, cfg.d_model)
    for i, blk in enumerate(ours["blocks"]):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: a[i], tree["blocks"]))[0]
        for path, want in flat:
            got = blk
            for key in path:
                got = got[key.key]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    for key in ("embed", "ln_in", "ln_out", "head"):
        for name, want in tree[key].items():
            np.testing.assert_array_equal(ours[key][name].numpy(), want)


# --- the modules ------------------------------------------------------------

def test_wkv_scan_matches_reference(ref):
    """_wkv_scan over 12 positions from a seeded state: y and the final
    state within F32_RTOL of their largest values (XLA's fused
    multiply-adds; ROADMAP C10)."""
    inp = ref["inputs"]
    u = torch.from_numpy(np.array(ref["params"]["blocks"]["tm"]["u"][0]))
    y, state = R._wkv_scan(*(torch.from_numpy(inp[k])
                             for k in ("r", "k", "v", "w")), u,
                           torch.from_numpy(inp["wkv"]))
    for got, want in ((y, ref["scan"]["y"]), (state, ref["scan"]["state"])):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert_close(got, want, F32_RTOL * float(np.abs(want).max()),
                     "scan")


def _layer(ref, cfg):
    params = port_params(ref, cfg)
    return params["blocks"][0]


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_timemix_matches_reference(ref, impl):
    """timemix_apply on a seeded bf16 input, shift and wkv state: the
    output and the wkv state within ``rel_atol``, the returned shift the
    input's last row bit for bit."""
    cfg = port_config(impl)
    inp, want = ref["inputs"], ref["modules"][impl]["timemix"]
    out, shift, wkv = R.timemix_apply(
        _layer(ref, cfg)["tm"], bf16(inp["x"]), cfg, bf16(inp["shift_tm"]),
        torch.from_numpy(inp["wkv"]))
    assert out.dtype == torch.bfloat16 and out.shape == want[0].shape
    assert_close(out, want[0], rel_atol(impl, want[0]), "out")
    np.testing.assert_array_equal(f32(shift), want[1])
    assert wkv.dtype == torch.float32
    assert_close(wkv, want[2], rel_atol(impl, want[2]), "wkv")


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_chanmix_matches_reference(ref, impl):
    """chanmix_apply in bf16: squared ReLU after an un-fused projection,
    gated by sigmoid(wr) (XLA's op-by-op 1 / (1 + exp(-x))); the output
    within ``rel_atol``, the shift the last row bit for bit."""
    cfg = port_config(impl)
    inp, want = ref["inputs"], ref["modules"][impl]["chanmix"]
    out, shift = R.chanmix_apply(_layer(ref, cfg)["cm"], bf16(inp["x"]),
                                 cfg, bf16(inp["shift_cm"]))
    assert out.dtype == torch.bfloat16
    assert_close(out, want[0], rel_atol(impl, want[0]), "out")
    np.testing.assert_array_equal(f32(shift), want[1])


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_rwkv_apply_matches_reference(ref, impl):
    """One whole block from a seeded state: the output and the state it
    returns."""
    cfg = port_config(impl)
    inp, (want, want_state) = ref["inputs"], ref["modules"][impl]["block"]
    state = {"shift_tm": bf16(inp["shift_tm"]),
             "shift_cm": bf16(inp["shift_cm"]),
             "wkv": torch.from_numpy(inp["wkv"])}
    out, got_state = R.rwkv_apply(_layer(ref, cfg), bf16(inp["x"]), cfg,
                                  state)
    assert out.dtype == torch.bfloat16
    assert_close(out, want, rel_atol(impl, want), "out")
    assert_state(got_state, want_state, impl, "block")
    # the time mix's shift is ln1's last row, before any projection
    np.testing.assert_array_equal(f32(got_state["shift_tm"]),
                                  want_state["shift_tm"])


# --- the LM -----------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_forward_and_loss_match_reference(ref, impl):
    """api.forward (rwkv_lm_apply from a zero state) and loss_fn on
    seeded tokens: logits within tolerance, greedy tokens equal but at
    near-ties, the loss within LOSS_ATOL, the token count exact; the
    loss is the masked mean NLL of the port's own logits."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    inp, want = ref["inputs"], ref["forward"][impl]
    tokens = torch.from_numpy(inp["tokens"])
    labels = torch.from_numpy(inp["labels"])
    logits, aux = get_api(cfg).forward(params, {"tokens": tokens}, cfg,
                                       device="cpu")
    loss, metrics = loss_fn(params, {"tokens": tokens, "labels": labels},
                            cfg, device="cpu")
    assert logits.shape == (BATCH, SEQ, cfg.padded_vocab)
    atol = rel_atol(impl, want["logits"], "logits")
    assert_close(logits, want["logits"], atol, "logits")
    assert_tokens(f32(logits), want["logits"], atol)
    assert float(aux) == want["aux"] == 0.0
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


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_decode_steps_match_reference(ref, impl):
    """rwkv_lm_decode_step from init_decode's zero state, teacher-forced
    on the seeded tokens: the logits and the state after each of 8 steps
    (the shifts bf16, wkv float32, all [L, B, ...]); pos is not read."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    api = get_api(cfg)
    state = api.init_decode(cfg, BATCH, 10 ** 6, "cpu")   # max_len unused
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        "shift_tm": ((2, BATCH, 64), torch.bfloat16),
        "shift_cm": ((2, BATCH, 64), torch.bfloat16),
        "wkv": ((2, BATCH, 4, 16, 16), torch.float32)}
    for i, (want, want_state) in enumerate(ref["decode"][impl]):
        logits, state = api.decode_step(params, tokens[:, i:i + 1],
                                        torch.full((BATCH,), 99), state,
                                        cfg)
        atol = rel_atol(impl, want, "logits")
        assert_close(logits, want, atol, f"step {i}")
        assert_tokens(f32(logits), want, atol)
        assert_state(state, want_state, impl, f"step {i}")


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_forward_state_and_decode_continue_the_forward(ref, impl):
    """The reference's test_rwkv_scan_decode_consistency on the port
    (rtol = atol = 0.05, its tolerance): token-by-token decode from the
    zero state gives the forward's logits; so does the forward over a
    prefix with ``return_state`` followed by decode of the rest.  On the
    CPU both are the forward's bit for bit at this size."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    full, _ = R.rwkv_lm_apply(params, tokens, cfg, device="cpu")
    state = R.stacked_rwkv_state(cfg, BATCH, "cpu")
    steps = []
    for i in range(SEQ):
        lg, state = R.rwkv_lm_decode_step(params, tokens[:, i:i + 1], None,
                                          state, cfg)
        steps.append(lg)
    np.testing.assert_allclose(f32(torch.cat(steps, 1)), f32(full),
                               rtol=DECODE_CONSISTENCY_TOL,
                               atol=DECODE_CONSISTENCY_TOL)
    assert torch.equal(torch.cat(steps, 1), full)
    prefix, state = R.rwkv_lm_apply(params, tokens[:, :5], cfg,
                                    return_state=True, device="cpu")
    assert torch.equal(prefix, full[:, :5])
    rest = []
    for i in range(5, SEQ):
        lg, state = R.rwkv_lm_decode_step(params, tokens[:, i:i + 1], None,
                                          state, cfg)
        rest.append(lg)
    assert torch.equal(torch.cat(rest, 1), full[:, 5:])


# --- plans and launches -----------------------------------------------------

def test_plans_match_reference(ref):
    """The port plans what the reference plans on an RWKV tree, as many
    (8 a layer and the head: 17): every record equals the reference's
    layer-stacked record (planned in its subprocess) sliced at its layer;
    mix_w1, w_lora1 and w_lora2 stay unplanned, mix_w2 a bare tensor."""
    cfg = port_config("pallas_fused")
    jplanned = ref["planned"]
    planned, count = tops.plan_params(
        params_from_numpy(ref["params"], cfg, device="cpu"), cfg.quant)

    def records(tree):
        if isinstance(tree, dict):
            return ("w_plan" in tree) + sum(records(v) for k, v in
                                            tree.items() if k != "w_plan")
        return 0
    assert count == PLANNED_PER_LAYER * cfg.n_layers + 1 == 17
    assert records(jplanned) == PLANNED_PER_LAYER + 1    # stacked layers
    for i, blk in enumerate(planned["blocks"]):
        for mix, names in (("tm", ("wr", "wk", "wv", "wg", "wo")),
                           ("cm", ("wk", "wv", "wr"))):
            for name in names:
                ours = blk[mix][name]["w_plan"]
                theirs = jplanned["blocks"][mix][name]["w_plan"]
                assert set(ours) == set(theirs)
                for key, want in theirs.items():
                    np.testing.assert_array_equal(
                        ours[key].numpy(), want[i],
                        err_msg=f"layer {i} {mix}.{name}.{key}")
        for name in ("mix_w1", "w_lora1", "w_lora2"):
            assert set(blk["tm"][name]) == {"w"}
            assert set(jplanned["blocks"]["tm"][name]) == {"w"}
        assert isinstance(blk["tm"]["mix_w2"], torch.Tensor)
    for key, want in jplanned["head"]["w_plan"].items():
        np.testing.assert_array_equal(planned["head"]["w_plan"][key].numpy(),
                                      want, err_msg=key)


def test_b1_launches_per_forward_and_step(ref, monkeypatch):
    """On pallas_fused a forward and a decode step call B1 once a planned
    weight: 8 x layers + 1 = 17 times, never for the LoRAs."""
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
        R.rwkv_lm_apply(params, tokens, cfg, device="cpu")
        assert len(calls) == 17
        R.rwkv_lm_decode_step(params, tokens[:, :1], None,
                              R.stacked_rwkv_state(cfg, BATCH, "cpu"), cfg)
    assert len(calls) == 34


# --- serving ----------------------------------------------------------------

def serve(ref, impl, batch=SERVE_BATCH, prompts=None, engine=None):
    cfg = get_config(ARCH, smoke=True)
    eng = engine or ServeEngine(
        cfg, batch, SERVE_MAX_LEN, quant=QuantSpec.parse(spec_text(impl)),
        params=params_from_numpy(ref["params"], cfg, device="cpu"),
        device="cpu")
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts or ref["prompts"])]
    stats = eng.run(reqs)
    return eng, [r.out for r in reqs], stats


@pytest.mark.parametrize("impl", SERVE_IMPLS)
def test_served_tokens_match_reference(ref, impl, monkeypatch):
    """The port's ServeEngine on the reference's params (batch 2, 3
    requests: the third reuses a slot, whose recurrent row is reset)
    emits the reference engine's greedy tokens step for step through the
    oracle and B1, the activation scale as the compiled reference rounds
    it; 17 weights planned on pallas_fused."""
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    eng, tokens, stats = serve(ref, impl)
    want = ref["serve"][impl]
    assert tokens == want["tokens"]
    assert stats["engine_steps"] == want["steps"]
    assert stats["generated_tokens"] == 3 * NEW_TOKENS
    if impl == "pallas_fused":
        assert eng.plan_stats["planned_weights"] == 17


def test_served_tokens_equal_on_both_routes(ref):
    """B1 and the oracle serve the same greedy tokens (no activation is
    folded into B1's epilogue, so the routes are bit-identical)."""
    assert serve(ref, "planes")[1] == serve(ref, "pallas_fused")[1]


@pytest.mark.parametrize("impl", SERVE_IMPLS)
def test_slot_reuse_resets_recurrent_state(ref, impl):
    """The reference's test_rwkv_slot_reuse_resets_recurrent_state on the
    port: at batch 1 the second request rebinds slot 0 and must emit the
    tokens it emits alone on a fresh engine."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, 4).tolist() for _ in range(2)]
    _, tokens, _ = serve(ref, impl, batch=1, prompts=prompts)
    _, alone, _ = serve(ref, impl, batch=1, prompts=prompts[1:])
    assert tokens[1] == alone[0]


@pytest.mark.parametrize("impl", SERVE_IMPLS)
def test_slot_reuse_without_reset_leaks_state(ref, impl):
    """The check above has teeth: with no initial state to reset from
    (``_state0`` None, as a position-masked family has), the second
    request starts from the first one's recurrent state and its tokens
    differ from its run alone."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, 4).tolist() for _ in range(2)]
    cfg = get_config(ARCH, smoke=True)
    eng = ServeEngine(cfg, 1, SERVE_MAX_LEN,
                      quant=QuantSpec.parse(spec_text(impl)),
                      params=params_from_numpy(ref["params"], cfg,
                                               device="cpu"), device="cpu")
    assert eng._state0 is not None and "rwkv" in tengine.RESET_STATE_FAMILIES
    eng._state0 = None
    _, tokens, _ = serve(ref, impl, prompts=prompts, engine=eng)
    _, alone, _ = serve(ref, impl, batch=1, prompts=prompts[1:])
    assert tokens[1] != alone[0]


def test_snapshot_round_trips_rwkv_rows(ref):
    """A mid-decode RWKV slot's DecodeSnapshot: its rows are the state's
    [L, 1, ...] slices (two bf16 shift rows, one float32 wkv row), its
    bytes read back bit for bit (the reference cannot read its own bf16
    rows, ROADMAP C4, so bytes are compared, not a reference restore),
    and restored into a fresh engine's other slot the request goes on to
    the same tokens."""
    cfg = get_config(ARCH, smoke=True)
    spec = QuantSpec.parse(spec_text("pallas_fused"))

    def engine():
        return ServeEngine(cfg, SERVE_BATCH, SERVE_MAX_LEN, quant=spec,
                           params=params_from_numpy(ref["params"], cfg,
                                                    device="cpu"),
                           device="cpu")
    from repro_torch.serving.scheduler import Scheduler
    eng = engine()
    sched = Scheduler("fcfs", max_len=SERVE_MAX_LEN)
    prompt = ref["prompts"][0]
    req = ServeRequest(0, list(prompt), NEW_TOKENS)
    sched.submit(req, now=0.0)
    eng.admit_from(sched)
    while len(req.out) < 2:
        eng.step()
    snap = eng.snapshot_slot(0)
    assert [tuple(r.shape) for r in snap.rows] == [
        (2, 1, 64), (2, 1, 64), (2, 1, 4, 16, 16)]      # sorted keys
    assert [r.dtype for r in snap.rows] == [torch.bfloat16, torch.bfloat16,
                                            torch.float32]
    for row, leaf in zip(snap.rows, state_leaves(eng.state)):
        assert torch.equal(row, leaf[:, :1].cpu())
    data = snap.to_bytes()
    back = DecodeSnapshot.from_bytes(data)
    assert back.to_bytes() == data
    for a, b in zip(back.rows, snap.rows):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    while not req.done:
        eng.step()
    fresh = engine()
    assert fresh.restorable(back) is None
    moved = ServeRequest(0, list(prompt), NEW_TOKENS, out=list(back.out))
    fresh.restore_slot(1, moved, back)
    while not moved.done:
        fresh.step()
    assert moved.out == req.out


def test_launcher_serves_rwkv(capsys):
    """``launch/serve.py --arch rwkv6-3b`` serves through the registry
    with no flag of its own, through B1: 17 weights planned."""
    from repro_torch.launch import serve as launcher
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
            "3", "--batch", "2", "--prompt-len", "4", "--max-tokens", "3",
            "--quant-spec", spec_text("pallas_fused"), "--json"]
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert '"generated_tokens": 9' in out
    assert '"planned_weights": 17' in out
