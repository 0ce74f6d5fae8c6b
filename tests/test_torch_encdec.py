"""The port's encoder-decoder family (``models/encdec.py``,
seamless-m4t-medium) against the reference's, on the smoke config (2
encoder + 2 decoder layers, d_model 64, 4 heads x 16, d_ff 128, vocab
512, 8 frames; LayerNorm, an un-gated gelu MLP, an untied head).

The jitted reference runs once, in a subprocess with XLA's excess
precision off (test_torch_forward.py's ``run_reference``): its param
tree, seeded numpy inputs and outputs come back in one pickle, and the
port takes the same params (``convert.params_from_numpy``) and inputs on
the CPU, where its kernel wrappers run their plain versions.

Where the two differ, and the tolerances that follow (ROADMAP C12):

* The bf16 route: attention and the norms sum in float32 in both, but
  the libraries' float32 ``exp`` and sum orders differ, so a bf16 value
  lands one ulp apart where a float32 difference crosses a rounding
  boundary (``BF16_RTOL``, relative to an output's largest value).
* The quantized routes: such a one-ulp input can quantize one step
  apart, and the ROADMAP C2 scale rounding adds its own step: outputs
  within two steps of the planes=3 grid (``QUANT_RTOL``), logits within
  test_torch_forward.py's LOGIT_ATOL of 1.0; greedy tokens may differ
  only where the reference's top-2 margin is within the tolerance.  With
  the activation scale as the compiled reference rounds it
  (``compiled_scale``, C2) the quantized routes' modules, forward
  logits, decode logits and caches equal the reference's bit for bit,
  and the served greedy tokens too.
* The gelu folded into the up projection's epilogue (tanh form) is
  XLA's float32 ``tanh`` in the reference and torch's in the port; on
  these inputs they round alike (the bit-for-bit cases above hold it).
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs.registry import get_config as jget_config
from repro.models import encdec as JE
from repro.parallel.sharding import unbox
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec
from repro_torch.kernels import bw_gemm as bwk
from repro_torch.kernels import ops as tops
from repro_torch.models import encdec as E
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_api, loss_fn
from repro_torch.serving import engine as tengine
from repro_torch.serving.ckpt import DecodeSnapshot
from repro_torch.serving.engine import ServeEngine, state_leaves
from repro_torch.serving.request import ServeRequest

from test_torch_forward import (assert_tokens, compiled_scale,
                                run_reference, spec_text)

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
IMPLS = (None, "planes", "pallas_fused")
BATCH, SEQ = 2, 12
SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS = 2, 16, 6
# decode positions, a row each, from the unprimed caches (what serving
# decodes against): the rows apart from the second step on
ZERO_DECODE_POS = ((0, 0), (1, 3), (2, 7))
# planned: an encoder layer's wq, wk, wv, wo, up, down; a decoder layer's
# self wq, wk, wv, wo, cross wq, wk, wv, wo, up, down; and the head
ENC_PLANNED, DEC_PLANNED = 6, 10
# B1 launches a decode step: a decoder layer's self 4, cross wq and wo,
# up and down; and the head (the cross wk / wv run only when priming)
DEC_STEP_LAUNCHES = 8

# the bf16 route, relative to an output's largest value: one bf16 ulp of
# any value (2^-7 of the largest bounds it) where a float32 difference
# crosses a bf16 rounding boundary (a decode step's K / V, the logits)
BF16_RTOL = 2.0 ** -7
# the quantized routes, relative to an output's largest value: two steps
# of the planes=3 grid (qmax 42, per token), one from an input a bf16 ulp
# off and one from C2's scale rounding
QUANT_RTOL = 2.0 / 42
# the logits on the quantized routes: test_torch_forward.py's LOGIT_ATOL
QUANT_LOGIT_ATOL = 1.0
# the mean next-token NLL: the logit gaps above at a few positions
LOSS_ATOL = {None: 0.02, "planes": 0.05, "pallas_fused": 0.05}
# prime + teacher-forced decode against the forward: the reference's own
# test_decode_matches_forward_teacher_forced tolerance
DECODE_CONSISTENCY_TOL = 0.05


_REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.engine import QuantSpec
from repro.kernels import ops
from repro.models import encdec as E
from repro.models.api import get_api, loss_fn
from repro.parallel.sharding import unbox
from repro.serving.engine import ServeEngine
from repro.serving.request import ServeRequest
ARCH, IMPLS, SERVE_IMPLS = %r, %r, %r
BATCH, SEQ = %d, %d
SERVE_BATCH, SERVE_MAX_LEN, NEW_TOKENS = %d, %d, %d
ZERO_DECODE_POS = %r


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
    lambda key: unbox(E.encdec_init(key, base)))(jax.random.PRNGKey(0)))
d, f, kv, hd = base.d_model, base.frontend_tokens, base.n_kv_heads, \\
    base.head_dim
rng = np.random.default_rng(1)
inputs = dict(
    x_enc=rng.standard_normal((BATCH, f, d)).astype(np.float32),
    x_dec=rng.standard_normal((BATCH, SEQ, d)).astype(np.float32),
    mem=rng.standard_normal((BATCH, f, d)).astype(np.float32),
    mk=rng.standard_normal((BATCH, f, kv, hd)).astype(np.float32),
    mv=rng.standard_normal((BATCH, f, kv, hd)).astype(np.float32),
    frames=rng.standard_normal((BATCH, f, d)).astype(np.float32),
    tokens=rng.integers(0, base.vocab_size, (BATCH, SEQ)).astype(np.int32))
labels = np.concatenate([inputs["tokens"][:, 1:],
                         np.full((BATCH, 1), -1, np.int32)], axis=1)
labels[0, :2] = -1
inputs["labels"] = labels
bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
frames2 = inputs["frames"].copy()
frames2[:, -1] += 1.0

out = {"params": params, "inputs": inputs, "modules": {}, "forward": {},
       "decode": {}, "zero_decode": {}, "serve": {}}
for impl in IMPLS:
    cfg = base.replace(quant=spec(impl))
    api = get_api(cfg)
    pp = planned(params, cfg)

    def run(pp, x_enc, x_dec, mem, mk, mv, frames, frames2, toks, labels):
        dt = jnp.bfloat16
        enc = jax.tree.map(lambda a: a[0], pp["enc_blocks"])
        dec = jax.tree.map(lambda a: a[0], pp["dec_blocks"])
        pe = jnp.broadcast_to(jnp.arange(f)[None], (BATCH, f))
        pd = jnp.broadcast_to(jnp.arange(SEQ)[None], (BATCH, SEQ))
        batch = {"tokens": toks, "labels": labels, "frontend": frames}
        return dict(
            bidir=E._bidir_attn(enc["attn"], x_enc, cfg, pe, dt),
            cross_kv=E.cross_kv(dec["cross"], mem, cfg, dt),
            cross=E.cross_apply(dec["cross"], x_dec, mk, mv, cfg, dt),
            enc_block=E.enc_block_apply(enc, x_enc, cfg, pe, dt),
            dec_block=E.dec_block_apply(dec, x_dec, cfg, pd, mk, mv, dt),
            memory=E.encdec_encode(pp, frames, cfg),
            memory2=E.encdec_encode(pp, frames2, cfg),
            prime=E.encdec_prime_cross(pp, frames, cfg),
            forward=api.forward(pp, batch, cfg),
            loss=loss_fn(pp, batch, cfg))
    res = jax.jit(run)(pp, bf(inputs["x_enc"]), bf(inputs["x_dec"]),
                       bf(inputs["mem"]), bf(inputs["mk"]),
                       bf(inputs["mv"]), inputs["frames"], frames2,
                       inputs["tokens"], labels)
    logits, aux = res.pop("forward")
    loss, metrics = res.pop("loss")
    out["modules"][impl] = tree32(res)
    out["forward"][impl] = dict(
        logits=f32(logits), aux=float(aux), loss=float(loss),
        metrics={k: float(v) for k, v in metrics.items()})
    if impl == "pallas_fused":
        out["planned"] = jax.tree.map(np.asarray, pp)

    step = jax.jit(lambda p, t, i, st: api.decode_step(p, t, i, st, cfg))
    state = unbox(api.init_decode(cfg, BATCH, SEQ))
    state["xk"], state["xv"] = res["prime"]["xk"], res["prime"]["xv"]
    steps = []
    for i in range(SEQ):
        lg, state = step(pp, inputs["tokens"][:, i:i + 1],
                         jnp.full((BATCH,), i, jnp.int32), state)
        steps.append((f32(lg), tree32(state)))
    out["decode"][impl] = steps
    state = unbox(api.init_decode(cfg, BATCH, SEQ))
    steps = []
    for i, pos in enumerate(ZERO_DECODE_POS):
        lg, state = step(pp, inputs["tokens"][:, i:i + 1],
                         jnp.asarray(pos, jnp.int32), state)
        steps.append((f32(lg), tree32(state)))
    out["zero_decode"][impl] = steps

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
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
""" % (ARCH, IMPLS, ("planes", "pallas_fused"), BATCH, SEQ, SERVE_BATCH,
       SERVE_MAX_LEN, NEW_TOKENS, ZERO_DECODE_POS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's params, inputs and every case's outputs, jitted
    with excess precision off."""
    return run_reference(_REFERENCE,
                         tmp_path_factory.mktemp("ref") / "encdec.pkl")


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


def rel_atol(impl, want, what="module"):
    """An output's tolerance on a route, from its largest value:
    BF16_RTOL on the bf16 route, QUANT_RTOL on the others (the logits
    there: QUANT_LOGIT_ATOL)."""
    if impl is not None and what == "logits":
        return QUANT_LOGIT_ATOL
    rtol = BF16_RTOL if impl is None else QUANT_RTOL
    return rtol * float(np.abs(want).max())


def assert_close(got, want, atol, what):
    np.testing.assert_allclose(f32(got) if isinstance(got, torch.Tensor)
                               else got, want, rtol=0, atol=atol,
                               err_msg=what)


def port_modules(ref, impl):
    """The port's outputs of the reference's ``run`` on the same params
    and inputs: the attention variants, the blocks (layer 0 of each
    stack), the encoder on the frames and on the frames with the last
    one moved, and the primed cross K/V."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    inp = ref["inputs"]
    enc, dec = params["enc_blocks"][0], params["dec_blocks"][0]
    f = cfg.frontend_tokens
    pe = torch.arange(f)[None].expand(BATCH, f)
    pd = torch.arange(SEQ)[None].expand(BATCH, SEQ)
    x_enc, x_dec, mem, mk, mv = (bf16(inp[k]) for k in (
        "x_enc", "x_dec", "mem", "mk", "mv"))
    frames = torch.from_numpy(inp["frames"])
    frames2 = frames.clone()
    frames2[:, -1] += 1.0
    with torch.no_grad():
        return dict(
            bidir=E._bidir_attn(enc["attn"], x_enc, cfg, pe),
            cross_kv=E.cross_kv(dec["cross"], mem, cfg),
            cross=E.cross_apply(dec["cross"], x_dec, mk, mv, cfg),
            enc_block=E.enc_block_apply(enc, x_enc, cfg, pe),
            dec_block=E.dec_block_apply(dec, x_dec, cfg, pd, mk, mv),
            memory=E.encdec_encode(params, frames, cfg, "cpu"),
            memory2=E.encdec_encode(params, frames2, cfg, "cpu"),
            prime=E.encdec_prime_cross(params, frames, cfg, "cpu"))


def flat_outputs(got, want, name=""):
    """(name, port tensor, reference array) over nested dicts / tuples."""
    if isinstance(got, dict):
        return [x for k in got for x in flat_outputs(got[k], want[k],
                                                     f"{name}{k}.")]
    if isinstance(got, tuple):
        return [x for i, (g, w) in enumerate(zip(got, want))
                for x in flat_outputs(g, w, f"{name}{i}.")]
    return [(name.rstrip("."), got, want)]


def batch_of(ref, cfg=None):
    inp = ref["inputs"]
    return {"tokens": torch.from_numpy(inp["tokens"]),
            "labels": torch.from_numpy(inp["labels"]),
            "frontend": torch.from_numpy(inp["frames"])}


def decode_teacher_forced(params, cfg, batch, cross):
    """encdec_decode_step over batch's tokens at positions 0..T-1 from
    init_decode's caches with ``cross`` ({"xk", "xv"}, or None: the
    zeros serving decodes against): the logits [B, T, V] and the state
    after each step."""
    state = get_api(cfg).init_decode(cfg, BATCH, SEQ, "cpu")
    if cross is not None:
        state["xk"], state["xv"] = cross["xk"], cross["xv"]
    steps, states = [], []
    with torch.no_grad():
        for i in range(SEQ):
            lg, state = E.encdec_decode_step(
                params, batch["tokens"][:, i:i + 1],
                torch.full((BATCH,), i, dtype=torch.int32), state, cfg)
            steps.append(lg)
            states.append({k: v.clone() for k, v in state.items()})
    return torch.cat(steps, dim=1), states


# --- config and init --------------------------------------------------------

def test_get_api_takes_the_encdec_family():
    """``get_api(get_config("seamless-m4t-medium"))`` is the
    encoder-decoder family, with encdec_init and encdec_decode_step; its
    init_decode holds bf16 zeros: the self cache [L, B, max_len, kv, hd]
    and the cross K/V [L, B, F, kv, hd] over the config's frames."""
    cfg = get_config(ARCH)
    api = get_api(cfg)
    assert (api.family, cfg.n_layers, cfg.n_encoder_layers, cfg.act,
            cfg.gated_mlp, cfg.norm, cfg.frontend_tokens,
            cfg.padded_vocab) == ("encdec", 12, 12, "gelu", False, "layer",
                                  512, 256256)
    assert api.init is E.encdec_init
    assert api.decode_step is E.encdec_decode_step
    small = get_config(ARCH, smoke=True)
    for max_len in (1, 24):
        state = api.init_decode(small, 3, max_len, "cpu")
        assert list(state) == ["k", "v", "xk", "xv"]
        assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
            "k": ((2, 3, max_len, 4, 16), torch.bfloat16),
            "v": ((2, 3, max_len, 4, 16), torch.bfloat16),
            "xk": ((2, 3, 8, 4, 16), torch.bfloat16),
            "xv": ((2, 3, 8, 4, 16), torch.bfloat16)}
        assert not any(bool(x.any()) for x in state.values())
    got = E.init_encdec_caches(small, 2, 5, 3, torch.float32, "cpu")
    assert got["xk"].shape == (2, 2, 3, 4, 16) and \
        got["k"].dtype == torch.float32


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_init_tree_matches_reference():
    """encdec_init's tree has the reference's keys, shapes and dtypes
    (float32), both stacks unstacked into per-layer dicts: an encoder
    layer ln1 / attn / ln2 / mlp (up, down: un-gated), a decoder layer
    also ln_x and cross (wq, wk, wv, wo, no bias); LayerNorm scale ones
    and bias zeros."""
    cfg = get_config(ARCH, smoke=True)
    ours = E.encdec_init(torch.Generator().manual_seed(0), cfg, "cpu")
    jcfg = jget_config(ARCH, smoke=True)
    theirs = jax.tree.map(np.asarray, jax.jit(
        lambda key: unbox(JE.encdec_init(key, jcfg)))(jax.random.PRNGKey(0)))
    for key, depth in (("enc_blocks", 2), ("dec_blocks", 2)):
        layered = jax.tree.map(lambda a: a[0], theirs[key])
        assert len(ours[key]) == depth
        for blk in ours[key]:
            assert _shapes(blk) == _shapes(layered)
            assert torch.equal(blk["ln1"]["scale"], torch.ones(64))
            assert not blk["ln2"]["bias"].any()
    rest = {k: v for k, v in ours.items() if not k.endswith("blocks")}
    assert _shapes(rest) == _shapes({k: v for k, v in theirs.items()
                                     if not k.endswith("blocks")})
    assert set(ours["dec_blocks"][0]) == {"ln1", "attn", "ln_x", "cross",
                                          "ln2", "mlp"}


def test_params_from_numpy_splits_both_stacks(ref):
    """params_from_numpy slices enc_blocks by n_encoder_layers and
    dec_blocks by n_layers, bit for bit, and carries frontend_proj, the
    norms, the embedding and the head as they are."""
    cfg = port_config()
    tree = ref["params"]
    ours = params_from_numpy(tree, cfg, device="cpu")
    assert "blocks" not in ours
    for key, depth in (("enc_blocks", cfg.n_encoder_layers),
                       ("dec_blocks", cfg.n_layers)):
        assert len(ours[key]) == depth == 2
        for i, blk in enumerate(ours[key]):
            flat = jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda a: a[i], tree[key]))[0]
            for path, want in flat:
                got = blk
                for k in path:
                    got = got[k.key]
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
    for key in ("frontend_proj", "enc_norm", "embed", "final_norm",
                "lm_head"):
        for name, want in tree[key].items():
            np.testing.assert_array_equal(ours[key][name].numpy(), want)


# --- the modules ------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS, ids=str)
def test_modules_match_reference(ref, impl):
    """_bidir_attn, cross_kv, cross_apply, enc_block_apply and
    dec_block_apply (layer 0, seeded bf16 inputs), encdec_encode and
    encdec_prime_cross on seeded float32 frames, the port as it is: bf16
    outputs of the reference's shapes within ``rel_atol``; on the bf16
    route bit for bit."""
    want = ref["modules"][impl]
    for name, got, w in flat_outputs(port_modules(ref, impl), want):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape, name
        if impl is None:
            np.testing.assert_array_equal(f32(got), w, err_msg=name)
        else:
            assert_close(got, w, rel_atol(impl, w), name)


@pytest.mark.parametrize("impl", ("planes", "pallas_fused"))
def test_modules_bit_for_bit_with_compiled_scale(ref, impl, monkeypatch):
    """With the activation scale as the compiled reference rounds it (C2)
    every module output above equals the reference's bit for bit on the
    quantized routes, the gelu folded into B1's epilogue included."""
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    for name, got, w in flat_outputs(port_modules(ref, impl),
                                     ref["modules"][impl]):
        np.testing.assert_array_equal(f32(got), w, err_msg=name)


def test_encoder_is_bidirectional(ref):
    """Moving the LAST frame moves the memory at position 0 (a causal
    encoder could not), as tests/test_encdec.py:50 checks the reference;
    the moved frames' memory equals the reference's (bf16 route)."""
    got = port_modules(ref, None)
    early = (got["memory"][:, 0].float() - got["memory2"][:, 0].float())
    assert float(early.abs().max()) > 1e-6
    np.testing.assert_array_equal(f32(got["memory2"]),
                                  ref["modules"][None]["memory2"])


@pytest.mark.parametrize("impl", IMPLS, ids=str)
def test_cross_attention_over_zero_kv_is_zero(ref, impl):
    """Against the zero cross K/V of init_encdec_caches (what serving
    decodes against) the softmax is uniform over zeros: cross_apply gives
    exact zeros on every route (per-token quantization of a zero row is
    safe: its scale is clamped)."""
    cfg = port_config(impl)
    cross = port_params(ref, cfg)["dec_blocks"][0]["cross"]
    zeros = torch.zeros((BATCH, cfg.frontend_tokens, cfg.n_kv_heads,
                         cfg.head_dim), dtype=torch.bfloat16)
    with torch.no_grad():
        out = E.cross_apply(cross, bf16(ref["inputs"]["x_dec"]), zeros,
                            zeros, cfg)
    assert out.shape == (BATCH, SEQ, cfg.d_model) and not out.any()


# --- the model --------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_forward_and_loss_match_reference(ref, impl):
    """api.forward (encdec_apply over the frames) and loss_fn on seeded
    tokens: logits within tolerance, greedy tokens equal but at
    near-ties, the loss within LOSS_ATOL, the token count exact (no
    prefix masked: 2 x 11 - 2 labels >= 0); the loss is the masked mean
    NLL of the port's own logits, and the aux a float32 zero."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    want = ref["forward"][impl]
    batch = batch_of(ref)
    logits, aux = get_api(cfg).forward(params, batch, cfg, device="cpu")
    loss, metrics = loss_fn(params, batch, cfg, device="cpu")
    assert logits.dtype == torch.bfloat16
    assert logits.shape == (BATCH, SEQ, cfg.padded_vocab)
    atol = rel_atol(impl, want["logits"], "logits")
    assert_close(logits, want["logits"], atol, "logits")
    assert_tokens(f32(logits), want["logits"], atol)
    assert aux.dtype == torch.float32 and float(aux) == want["aux"] == 0.0
    assert abs(float(loss) - want["loss"]) <= LOSS_ATOL[impl]
    assert float(metrics["tokens"]) == want["metrics"]["tokens"] == \
        BATCH * (SEQ - 1) - 2
    lf, lab = logits.float(), batch["labels"].long()
    mask = lab >= 0
    nll = torch.logsumexp(lf, -1) - torch.take_along_dim(
        lf, lab.clamp_min(0)[..., None], dim=-1)[..., 0]
    np.testing.assert_allclose(float(loss),
                               float((nll * mask).sum() / mask.sum()),
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ("planes", "pallas_fused"))
@torch.no_grad()
def test_forward_bit_for_bit_with_compiled_scale(ref, impl, monkeypatch):
    """With the compiled scale (C2) the quantized routes' forward logits
    equal the reference's bit for bit, and the loss within float32
    summation order (rtol 1e-6)."""
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    logits, _ = get_api(cfg).forward(params, batch_of(ref), cfg, "cpu")
    loss, _ = loss_fn(params, batch_of(ref), cfg, device="cpu")
    np.testing.assert_array_equal(f32(logits), ref["forward"][impl]["logits"])
    np.testing.assert_allclose(float(loss), ref["forward"][impl]["loss"],
                               rtol=1e-6)


@pytest.mark.parametrize("impl", IMPLS, ids=str)
def test_primed_decode_steps_match_reference(ref, impl, monkeypatch):
    """encdec_prime_cross, then encdec_decode_step on each token from
    init_decode's caches, against the reference's, step by step, with the
    compiled scale (C2): on the quantized routes the logits, the self
    cache (written at each position) and the cross K/V (read only, the
    primed values after every step) bit for bit; on the bf16 route the
    primed cross K/V bit for bit and the rest within ``rel_atol`` (a
    bf16 matmul at N=1 sums in its own order in each library)."""
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    batch = batch_of(ref)
    with torch.no_grad():
        cross = E.encdec_prime_cross(params, batch["frontend"], cfg, "cpu")
    for key in ("xk", "xv"):
        assert cross[key].shape == (2, BATCH, 8, 4, 16)
        np.testing.assert_array_equal(f32(cross[key]),
                                      ref["modules"][impl]["prime"][key])
    logits, states = decode_teacher_forced(params, cfg, batch, cross)
    for i, (state, (want, want_state)) in enumerate(zip(
            states, ref["decode"][impl])):
        got = logits[:, i:i + 1]
        if impl is None:
            assert_close(got, want, rel_atol(None, want, "logits"),
                         f"step {i}")
        else:
            np.testing.assert_array_equal(f32(got), want, err_msg=f"step {i}")
        for key in ("k", "v", "xk", "xv"):
            assert state[key].dtype == torch.bfloat16
            if impl is None and key in ("k", "v"):
                assert_close(state[key], want_state[key],
                             rel_atol(None, want_state[key]),
                             f"step {i} {key}")
            else:
                np.testing.assert_array_equal(
                    f32(state[key]), want_state[key],
                    err_msg=f"step {i} {key}")


@pytest.mark.parametrize("impl", IMPLS, ids=str)
def test_primed_decode_continues_the_forward(ref, impl):
    """Prime + teacher-forced decode against the forward over the same
    frames and tokens (the reference's
    test_decode_matches_forward_teacher_forced): the port's decode equals
    its own forward bit for bit on the CPU (within the reference test's
    DECODE_CONSISTENCY_TOL), and the reference's forward within the
    route's logit tolerance, as the reference's own decode does."""
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    batch = batch_of(ref)
    with torch.no_grad():
        forward, _ = get_api(cfg).forward(params, batch, cfg, "cpu")
        cross = E.encdec_prime_cross(params, batch["frontend"], cfg, "cpu")
    logits, _ = decode_teacher_forced(params, cfg, batch, cross)
    np.testing.assert_allclose(f32(logits), f32(forward),
                               rtol=DECODE_CONSISTENCY_TOL,
                               atol=DECODE_CONSISTENCY_TOL)
    assert torch.equal(logits, forward)
    want = ref["forward"][impl]["logits"]
    atol = rel_atol(impl, want, "logits")
    assert_close(logits, want, atol, "against the reference's forward")
    ref_decode = np.concatenate([s[0] for s in ref["decode"][impl]], axis=1)
    np.testing.assert_array_equal(ref_decode, want)


@pytest.mark.parametrize("impl", IMPLS, ids=str)
@torch.no_grad()
def test_unprimed_decode_matches_reference(ref, impl, monkeypatch):
    """Decode against the zero cross K/V, as serving decodes, with the
    rows at different positions (ZERO_DECODE_POS), against the
    reference's with the compiled scale (C2): the logits and the self
    cache after each step bit for bit on the quantized routes, within
    ``rel_atol`` on the bf16 route; xk / xv stay zeros."""
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    cfg = port_config(impl)
    params = port_params(ref, cfg)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    api = get_api(cfg)
    state = api.init_decode(cfg, BATCH, SEQ, "cpu")
    for i, (pos, (want, want_state)) in enumerate(zip(
            ZERO_DECODE_POS, ref["zero_decode"][impl])):
        logits, state = api.decode_step(
            params, tokens[:, i:i + 1], torch.tensor(pos, dtype=torch.int32),
            state, cfg)
        if impl is None:
            assert_close(logits, want, rel_atol(None, want, "logits"),
                         f"step {i}")
        else:
            np.testing.assert_array_equal(f32(logits), want,
                                          err_msg=f"step {i}")
        for key in ("k", "v"):
            if impl is None:
                assert_close(state[key], want_state[key],
                             rel_atol(None, want_state[key]),
                             f"step {i} {key}")
            else:
                np.testing.assert_array_equal(
                    f32(state[key]), want_state[key],
                    err_msg=f"step {i} {key}")
        assert not state["xk"].any() and not state["xv"].any()


def test_frontend_errors(ref):
    """Where the reference crashes (no frames: a KeyError on
    batch["frontend"]; frames of another width, rank or batch than the
    tokens': a shape error) the port raises a ValueError that names the
    key or the shape, on the forward, loss_fn, encdec_encode and
    encdec_prime_cross.  Another number of frames is no error, as in the
    reference: the encoder takes any S."""
    cfg = port_config()
    params = port_params(ref, cfg)
    batch = batch_of(ref)
    f, d = cfg.frontend_tokens, cfg.d_model
    calls = {
        "forward": lambda e: get_api(cfg).forward(
            params, dict(batch, frontend=e), cfg, device="cpu"),
        "loss": lambda e: loss_fn(params, dict(batch, frontend=e), cfg,
                                  device="cpu"),
        "encode": lambda e: E.encdec_encode(params, e, cfg, "cpu"),
        "prime": lambda e: E.encdec_prime_cross(params, e, cfg, "cpu"),
    }
    with pytest.raises(ValueError, match=r"batch\['frontend'\]"):
        get_api(cfg).forward(params, {"tokens": batch["tokens"]}, cfg, "cpu")
    for name, call in calls.items():
        with pytest.raises(ValueError, match=r"batch\['frontend'\]"):
            call(None)
        shapes = [(BATCH, f, d + 1), (f, d)]
        if name in ("forward", "loss"):
            shapes.append((BATCH + 1, f, d))
        for shape in shapes:
            with pytest.raises(ValueError, match=r"frontend_embeds of shape "
                               + rf"\[{', '.join(map(str, shape))}\], "
                               rf"expected \[.*, S, {d}\]"):
                call(torch.zeros(shape))
    with torch.no_grad():
        logits, _ = calls["forward"](batch["frontend"][:, :f - 3])
    assert logits.shape == (BATCH, SEQ, cfg.padded_vocab)


# --- plans and launches -----------------------------------------------------

def test_plans_match_reference(ref):
    """The port plans what the reference plans on an encoder-decoder
    tree, as many (6 an encoder layer, 10 a decoder layer and the head:
    2 x 6 + 2 x 10 + 1 = 33): every record equals the reference's
    layer-stacked record sliced at its layer, in both stacks, which pad
    their schedules apart (the paths differ); frontend_proj stays
    unplanned, as do the norms and the embedding."""
    cfg = port_config("pallas_fused")
    jplanned = ref["planned"]
    planned_tree, count = tops.plan_params(
        params_from_numpy(ref["params"], cfg, device="cpu"), cfg.quant)

    def records(tree):
        if isinstance(tree, list):
            return sum(records(v) for v in tree)
        if isinstance(tree, dict):
            return ("w_plan" in tree) + sum(records(v) for k, v in
                                            tree.items() if k != "w_plan")
        return 0
    assert count == records(planned_tree) == \
        ENC_PLANNED * 2 + DEC_PLANNED * 2 + 1 == 33
    assert records(jplanned) == ENC_PLANNED + DEC_PLANNED + 1  # stacked
    mods = {"enc_blocks": (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("up", "down"))),
            "dec_blocks": (("attn", ("wq", "wk", "wv", "wo")),
                           ("cross", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("up", "down")))}
    for stack, names in mods.items():
        for i, blk in enumerate(planned_tree[stack]):
            for mod, ws in names:
                for name in ws:
                    ours = blk[mod][name]["w_plan"]
                    theirs = jplanned[stack][mod][name]["w_plan"]
                    assert set(ours) == set(theirs)
                    for key, want in theirs.items():
                        np.testing.assert_array_equal(
                            ours[key].numpy(), want[i],
                            err_msg=f"{stack} {i} {mod}.{name}.{key}")
    assert "w_plan" not in planned_tree["frontend_proj"]
    assert "w_plan" not in jplanned["frontend_proj"]
    for key, want in jplanned["lm_head"]["w_plan"].items():
        np.testing.assert_array_equal(
            planned_tree["lm_head"]["w_plan"][key].numpy(), want,
            err_msg=key)


def test_b1_launches_per_forward_prime_and_step(ref, monkeypatch):
    """On pallas_fused B1 is called once a planned weight: 33 times a
    forward, 2 x 6 + 2 x 2 = 16 a prime (the encoder and the cross wk /
    wv), 2 x 8 + 1 = 17 a decode step (self 4, cross wq and wo, the
    MLP's 2, the head); never for frontend_proj."""
    cfg = port_config("pallas_fused")
    params = port_params(ref, cfg)
    calls = []
    fused = bwk.bw_gemm_fused

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fused(*args, **kw)
    monkeypatch.setattr(bwk, "bw_gemm_fused", counted)
    batch = batch_of(ref)
    with torch.no_grad():
        get_api(cfg).forward(params, batch, cfg, "cpu")
        assert len(calls) == 33
        cross = E.encdec_prime_cross(params, batch["frontend"], cfg, "cpu")
        assert len(calls) == 33 + 16
        state = dict(get_api(cfg).init_decode(cfg, BATCH, SEQ, "cpu"),
                     **cross)
        E.encdec_decode_step(params, batch["tokens"][:, :1],
                             torch.zeros(BATCH), state, cfg)
    assert len(calls) == 33 + 16 + DEC_STEP_LAUNCHES * 2 + 1


# --- serving ----------------------------------------------------------------

def engine(ref, impl, batch=SERVE_BATCH):
    cfg = get_config(ARCH, smoke=True)
    return ServeEngine(cfg, batch, SERVE_MAX_LEN,
                       quant=QuantSpec.parse(spec_text(impl)),
                       params=params_from_numpy(ref["params"], cfg,
                                                device="cpu"), device="cpu")


def serve(ref, impl, batch=SERVE_BATCH, prompts=None):
    eng = engine(ref, impl, batch)
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts or ref["prompts"])]
    stats = eng.run(reqs)
    return eng, [r.out for r in reqs], stats


def test_engine_on_the_encdec_family(ref):
    """A ServeEngine on the encoder-decoder family keeps no initial state
    (``encdec`` is not in RESET_STATE_FAMILIES, as in the reference: the
    self cache is masked by position, the cross K/V are zeros it never
    writes); its four leaves, in sorted-key order, are k, v, xk, xv."""
    eng = engine(ref, "pallas_fused")
    assert eng.api.family == "encdec"
    assert "encdec" not in tengine.RESET_STATE_FAMILIES
    assert eng._state0 is None
    leaves = state_leaves(eng.state)
    assert [tuple(x.shape) for x in leaves] == [
        (2, 2, SERVE_MAX_LEN, 4, 16)] * 2 + [(2, 2, 8, 4, 16)] * 2
    assert leaves[2] is eng.state["xk"] and leaves[3] is eng.state["xv"]


@pytest.mark.parametrize("impl", ("planes", "pallas_fused"))
def test_served_tokens_match_reference(ref, impl, monkeypatch):
    """The port's ServeEngine on the reference's params (batch 2, 3
    requests: the third reuses a slot) emits the reference engine's
    greedy tokens step for step through the oracle and B1, against the
    zero cross K/V, the activation scale as the compiled reference rounds
    it; 33 weights planned on pallas_fused.  The two routes part where
    the reference's do: the oracle rounds the up projection to bf16
    before the gelu, B1 does not (C7)."""
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    eng, tokens, stats = serve(ref, impl)
    want = ref["serve"][impl]
    assert tokens == want["tokens"]
    assert stats["engine_steps"] == want["steps"]
    assert stats["generated_tokens"] == 3 * NEW_TOKENS
    if impl == "pallas_fused":
        assert eng.plan_stats["planned_weights"] == 33
    assert not eng.state["xk"].any() and not eng.state["xv"].any()


def test_b2_serves_b1s_tokens(ref):
    """B2 (``pallas``: the unfused kernel, its gelu in the float32 plain
    epilogue) serves B1's tokens: the gelu is the same function of the
    same float32 product on both."""
    assert serve(ref, "pallas")[1] == serve(ref, "pallas_fused")[1]


def reuse_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, 4).tolist() for _ in range(2)]


@pytest.mark.parametrize("impl", ("planes", "pallas_fused"))
def test_reused_slot_matches_fresh_engine(ref, impl):
    """At batch 1 the second request rebinds slot 0 over the first's self
    cache rows, not reset, and must emit the tokens it emits alone on a
    fresh engine: the position mask hides the stale rows."""
    prompts = reuse_prompts()
    _, tokens, _ = serve(ref, impl, batch=1, prompts=prompts)
    _, alone, _ = serve(ref, impl, batch=1, prompts=prompts[1:])
    assert tokens[1] == alone[0]


def test_snapshot_round_trips_encdec_rows(ref):
    """A mid-decode encdec slot's DecodeSnapshot: its rows are the four
    leaves' [L, 1, ...] slices in sorted-key order (k, v [L, 1, max_len,
    kv, hd]; xk, xv [L, 1, F, kv, hd]), all bf16; its bytes read back bit
    for bit (the reference cannot read its own bf16 rows, ROADMAP C4);
    restored into a fresh engine's other slot the request goes on to the
    same tokens.  An engine over another number of frames refuses it on
    the cross rows' geometry."""
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
        (2, 1, SERVE_MAX_LEN, 4, 16)] * 2 + [(2, 1, 8, 4, 16)] * 2
    assert all(r.dtype == torch.bfloat16 for r in snap.rows)
    n = len(prompt) + 1
    assert snap.rows[0][:, :, :n].any() and not snap.rows[0][:, :, n:].any()
    for row, leaf in zip(snap.rows, state_leaves(eng.state)):
        assert torch.equal(row, leaf[:, :1].cpu())
    data = snap.to_bytes()
    back = DecodeSnapshot.from_bytes(data)
    assert back.to_bytes() == data
    for a, b in zip(back.rows, snap.rows):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    while not req.done:
        eng.step()
    fresh = engine(ref, "pallas_fused")
    assert fresh.restorable(back) is None
    moved = ServeRequest(0, list(prompt), NEW_TOKENS, out=list(back.out))
    fresh.restore_slot(1, moved, back)
    while not moved.done:
        fresh.step()
    assert moved.out == req.out
    cfg = get_config(ARCH, smoke=True).replace(frontend_tokens=6)
    other = ServeEngine(cfg, SERVE_BATCH, SERVE_MAX_LEN,
                        quant=QuantSpec.parse(spec_text("pallas_fused")),
                        device="cpu")
    why = other.restorable(back)
    assert why is not None and why.startswith("state leaf 2 mismatch") and \
        "(2, 1, 6, 4, 16)" in why


def test_lm_init_still_refuses_the_encdec_family():
    """transformer.lm_init builds the decoder-only families only: the
    encoder-decoder family has its own init (``encdec_init``)."""
    with pytest.raises(ValueError, match="has its own init"):
        TT.lm_init(torch.Generator().manual_seed(0),
                   get_config(ARCH, smoke=True), "cpu")


def test_launcher_serves_seamless(capsys):
    """``launch/serve.py --arch seamless-m4t-medium`` serves through the
    registry with no flag of its own (text prompts against the zero cross
    K/V), through B1: 33 weights planned."""
    from repro_torch.launch import serve as launcher
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
            "3", "--batch", "2", "--prompt-len", "4", "--max-tokens", "3",
            "--quant-spec", spec_text("pallas_fused"), "--json"]
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert '"generated_tokens": 9' in out
    assert '"planned_weights": 33' in out
