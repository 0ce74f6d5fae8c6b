"""The port's MoE family (``models/moe.py``, olmoe-1b-7b and grok-1-314b)
against the reference's, on the two configs' smoke sizes.

``moe_apply`` runs the reference as its own tests do (eagerly, in this
process) on seeded numpy inputs: the port's output equals it in bf16, bit
for bit, with picks dropped by capacity, with two dispatch groups and on
equal router probabilities.  The forward, the loss and decode run the
reference in a subprocess with XLA's excess precision off, as
test_torch_forward.py does (``run_reference``); the port's decode takes
the activation scale as the compiled reference rounds it
(``compiled_scale``, ROADMAP C2), and then its greedy tokens equal the
reference's exactly.

An MoE decode step is not its forward's continuation: the capacity of a
call is set by the call's own token count, so a decode step of a few
tokens drops picks that a forward over the same tokens keeps.  The tests
force drops through ``capacity_factor``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget_config
from repro.engine import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.parallel.sharding import unbox
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_api
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import ServeRequest

from test_torch_dense_configs import prompts
# port_forward plans, runs and prefills at these BATCH, SEQ, PREFILL and
# MAX_LEN, which the reference below shares
from test_torch_forward import (BATCH, LOGIT_ATOL, LOSS_ATOL, MAX_LEN,
                                PREFILL, SEQ, assert_tokens, compiled_scale,
                                port_forward, run_reference, spec_text)

torch.set_num_threads(1)

MOE_ARCHS = ("olmoe-1b-7b", "grok-1-314b")
NEW_TOKENS = 6
AUX_ATOL = 1e-6
# the forward's aux, the layers' router losses, as the port is: C2's
# rounding moves each layer's hidden state, and with it the router's
# probabilities, by a quantization step (measured: up to 6.9e-6 on these
# cases, 1e-6 or less with the compiled scale)
FORWARD_AUX_ATOL = {None: AUX_ATOL, "planes": 2e-5, "pallas_fused": 2e-5}
# grok's soft-capped head: torch's and XLA's float32 tanh differ by up to
# 4 ulps on the CPU
SOFTCAP_RTOL, SOFTCAP_ATOL = 2.0 ** -21, 2.0 ** -22
# (arch, impl, capacity_factor): both configs at the default factor on
# every route, and olmoe at 0.5, where a forward drops picks
FORWARD_CASES = [(arch, impl, 1.25) for arch in MOE_ARCHS
                 for impl in (None, "planes", "pallas_fused")]
FORWARD_CASES += [("olmoe-1b-7b", impl, 0.5)
                  for impl in ("planes", "pallas_fused")]
# (arch, impl, capacity_factor) served: at 0.5 a decode step of batch 2
# has one slot an expert, and picks are dropped
DECODE_CASES = [(arch, impl, 1.25) for arch in MOE_ARCHS
                for impl in ("planes", "pallas_fused")]
DECODE_CASES += [("olmoe-1b-7b", impl, 0.5)
                 for impl in ("planes", "pallas_fused")]


_REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.engine import QuantSpec
from repro.kernels import ops
from repro.models import transformer as T
from repro.models.api import get_api, loss_fn
from repro.parallel.sharding import unbox
from repro.serving.engine import ServeEngine
from repro.serving.request import ServeRequest

FORWARD, DECODE = %r, %r
BATCH, SEQ, PREFILL, MAX_LEN, NEW_TOKENS = %d, %d, %d, %d, %d


def spec(impl):
    return None if impl is None else QuantSpec.parse(
        "planes=3,encoding=ent,impl=%%s,act_quant=per_token" %% impl)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


out = {"forward": {}, "decode": {}}
for arch, impl, cf in FORWARD:
    cfg = get_config(arch, smoke=True).replace(quant=spec(impl),
                                               capacity_factor=cf)
    params = unbox(T.lm_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(SEQ)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((BATCH, 1), -1,
                                                    np.int32)], axis=1)
    labels[0, :2] = -1
    api = get_api(cfg)

    def run(p, t, l):
        logits, aux = api.forward(p, {"tokens": t}, cfg)
        loss, metrics = loss_fn(p, {"tokens": t, "labels": l}, cfg)
        pl, caches = T.lm_prefill(p, t[:, :PREFILL], cfg, MAX_LEN)
        return logits, aux, loss, metrics, pl, caches

    planned = params
    if impl == "pallas_fused":
        planned, _ = ops.plan_params(params, cfg.quant)
    logits, aux, loss, metrics, pl, caches = jax.jit(run)(
        planned, tokens, labels)
    out["forward"][arch, impl, cf] = dict(
        params=jax.tree.map(np.asarray, params), tokens=tokens,
        labels=labels, logits=f32(logits), aux=float(aux),
        loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
        prefill=f32(pl), k=f32(caches["k"]), v=f32(caches["v"]))

for arch, impl, cf in DECODE:
    cfg = get_config(arch, smoke=True).replace(capacity_factor=cf)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))
               .tolist() for _ in range(3)]
    eng = ServeEngine(cfg, BATCH, MAX_LEN, quant=spec(impl))
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    out["decode"][arch, impl, cf] = dict(
        tokens=[list(r.out) for r in reqs], steps=eng.steps,
        params=jax.tree.map(np.asarray, eng.params))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (FORWARD_CASES, DECODE_CASES, BATCH, SEQ, PREFILL, MAX_LEN, NEW_TOKENS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every forward and decode case run by the reference, excess
    precision off."""
    return run_reference(_REFERENCE,
                         tmp_path_factory.mktemp("ref") / "moe.pkl")


def torch_tree(tree):
    """A numpy tree as torch tensors (private copies)."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def moe_case(arch, cf, groups, seed=2):
    """(reference cfg, port cfg, numpy params, bf16 x as numpy float32)
    for one moe_apply case: the reference's init, seeded inputs."""
    jcfg = jget_config(arch, smoke=True).replace(
        capacity_factor=cf, moe_dispatch_groups=groups)
    tcfg = get_config(arch, smoke=True).replace(
        capacity_factor=cf, moe_dispatch_groups=groups)
    params = jax.tree.map(np.array,
                          unbox(JM.moe_init(jax.random.PRNGKey(0), jcfg)))
    x = np.random.default_rng(seed).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return jcfg, tcfg, params, x


def both_moe(jcfg, tcfg, params, x):
    """(reference y, aux), (port y, aux), as float32 numpy / float."""
    jy, jaux = JM.moe_apply(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    with torch.no_grad():
        ty, taux = TM.moe_apply(torch_tree(params),
                                torch.from_numpy(x).to(torch.bfloat16), tcfg)
    return ((np.asarray(jy.astype(jnp.float32)), float(jaux)),
            (ty.float().numpy(), float(taux)))


def dropped_picks(tcfg, params, x):
    """Picks the port's dispatch drops for x (over its groups)."""
    g = tcfg.moe_dispatch_groups
    xf = torch.from_numpy(x.reshape(-1, x.shape[-1])).to(torch.bfloat16)
    e, k = tcfg.n_experts, tcfg.experts_per_token
    tg = xf.shape[0] // g
    cap = int(np.ceil(tg * k / e * tcfg.capacity_factor))
    _, gate, eidx = TM._route(xf, torch.from_numpy(params["router"]["w"]), k)
    dropped = 0
    for i in range(g):
        rows = slice(i * tg, (i + 1) * tg)
        _, dest, _ = TM._dispatch(xf[rows], eidx[rows], gate[rows], e, k,
                                  cap, torch.bfloat16)
        dropped += int((dest == e * cap).sum())
    return dropped


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, cf, groups):
    """y equal in bf16 and aux within AUX_ATOL; the port's dispatch
    destinations equal the reference's, picks dropped at capacity 0.5."""
    jcfg, tcfg, params, x = moe_case(arch, cf, groups)
    (jy, jaux), (ty, taux) = both_moe(jcfg, tcfg, params, x)
    assert ty.shape == jy.shape == x.shape
    np.testing.assert_array_equal(ty, jy)
    assert abs(taux - jaux) <= AUX_ATOL
    if cf < 1.0:
        assert dropped_picks(tcfg, params, x) > 0
    # the destinations themselves, on the whole batch as one group
    xf = x.reshape(-1, x.shape[-1])
    k, e = jcfg.experts_per_token, jcfg.n_experts
    cap = int(np.ceil(xf.shape[0] * k / e * cf))
    probs = jax.nn.softmax(jnp.asarray(xf).astype(jnp.bfloat16).astype(
        jnp.float32) @ jnp.asarray(params["router"]["w"]), axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    _, jdest, jwgt = JM._dispatch(jnp.asarray(xf).astype(jnp.bfloat16), eidx,
                                  gate, e, k, cap, jnp.bfloat16)
    _, tgate, teidx = TM._route(torch.from_numpy(xf).to(torch.bfloat16),
                                torch.from_numpy(params["router"]["w"]), k)
    _, tdest, twgt = TM._dispatch(torch.from_numpy(xf).to(torch.bfloat16),
                                  teidx, tgate, e, k, cap, torch.bfloat16)
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(eidx))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(twgt.float().numpy(),
                                  np.asarray(jwgt.astype(jnp.float32)))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_top_k_ties_keep_the_reference_order(cf):
    """Zero rows give a uniform softmax: every expert ties, and the port
    picks the reference's (lower index first; ``torch.topk`` would take
    others), so y matches too, with and without drops."""
    jcfg, tcfg, params, x = moe_case("olmoe-1b-7b", cf, 1)
    x[0, ::2] = 0.0
    x[1, :5] = 0.0
    xf = x.reshape(-1, x.shape[-1])
    k = jcfg.experts_per_token
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(params["router"]["w"]),
                           axis=-1)
    _, jidx = jax.lax.top_k(probs, k)
    tprobs, _, tidx = TM._route(torch.from_numpy(xf).to(torch.bfloat16),
                                torch.from_numpy(params["router"]["w"]), k)
    zero = ~xf.any(-1)
    assert zero.sum() == 13
    assert bool((tprobs[torch.from_numpy(zero)] == 1 / jcfg.n_experts).all())
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (np.asarray(jidx)[zero] == np.arange(k)).all()
    (jy, jaux), (ty, taux) = both_moe(jcfg, tcfg, params, x)
    np.testing.assert_array_equal(ty, jy)
    assert abs(taux - jaux) <= AUX_ATOL


def test_combine_adds_in_slot_order():
    """The combine is k sequential bf16 adds from zeros in slot order, as
    the reference's scatter-add rounds; one float32 sum rounded once
    differs from it on these inputs."""
    rng = np.random.default_rng(5)
    e, cap, d, n_tok, k = 8, 16, 64, 16, 8
    out = rng.standard_normal((e, cap, d)).astype(np.float32)
    dest = rng.permutation(e * cap)[:n_tok * k].astype(np.int32)
    dest[::7] = e * cap                                   # dropped picks
    wgt = rng.random(n_tok * k).astype(np.float32)
    wgt[::7] = 0.0
    jout = jnp.asarray(out).astype(jnp.bfloat16)
    jw = jnp.asarray(wgt).astype(jnp.bfloat16)
    want = np.asarray(JM._combine(jout, jnp.asarray(dest), jw, n_tok, k,
                                  jnp.bfloat16).astype(jnp.float32))
    tout = torch.from_numpy(out).to(torch.bfloat16)
    tw = torch.from_numpy(wgt).to(torch.bfloat16)
    got = TM._combine(tout, torch.from_numpy(dest).long(), tw, n_tok, k,
                      torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
    vals = tout.reshape(e * cap, d)[torch.from_numpy(dest).long().clamp_max(
        e * cap - 1)] * tw[:, None]
    once = vals.float().reshape(n_tok, k, d).sum(1).to(torch.bfloat16)
    assert (once.float().numpy() != want).any()


def test_init_tree_matches_reference():
    """lm_init of an MoE config: the reference's tree, a layer at a time
    (keys, shapes, dtypes), the router [d, e] and experts [e, d, f]."""
    for arch in MOE_ARCHS:
        cfg = get_config(arch, smoke=True)
        ours = TT.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
        theirs = jax.tree.map(np.asarray, unbox(JT.lm_init(
            jax.random.PRNGKey(0), jget_config(arch, smoke=True))))

        def shapes(tree, layered=False):
            if isinstance(tree, dict):
                return {k: shapes(v, layered) for k, v in tree.items()}
            return tuple(tree.shape[1:] if layered else tree.shape)
        for i, layer in enumerate(ours["blocks"]):
            assert shapes(layer) == shapes(theirs["blocks"], True), i
        rest = {k: v for k, v in ours.items() if k != "blocks"}
        assert shapes(rest) == shapes({k: v for k, v in theirs.items()
                                       if k != "blocks"})
        moe = ours["blocks"][0]["moe"]
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert moe["router"]["w"].shape == (d, e)
        assert moe["w_up"].shape == (e, d, f)
        assert ("w_gate" in moe) == cfg.gated_mlp
        # the experts are divided by sqrt(d) beyond fan-in scaling
        assert float(moe["w_up"].abs().max()) <= 2 / np.sqrt(e * d) + 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS + ("minicpm-2b",))
def test_plan_params_plans_the_reference_paths(arch):
    """The port plans the paths the reference plans, with its count: the
    attention projections and the untied head, never the router (whose
    dict has no ``w_plan``) nor the experts; a dense tree as before."""
    spec = QuantSpec.parse(spec_text("pallas_fused"))
    jcfg = jget_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jparams = unbox(JT.lm_init(jax.random.PRNGKey(0), jcfg))
    jplanned, jcount = jops.plan_params(jparams, JSpec.parse(
        spec_text("pallas_fused")))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    planned, count = tops.plan_params(params, spec)

    def paths(tree, path=()):
        if isinstance(tree, list):
            return set().union(*(paths(v, path) for v in tree))
        if not isinstance(tree, dict):
            return set()
        own = {path} if "w_plan" in tree else set()
        return own.union(*(paths(v, path + (k,)) for k, v in tree.items()
                           if k != "w_plan"))
    assert paths(planned) == paths(jplanned)
    assert count == jcount
    if cfg.n_experts:
        assert count == 4 * cfg.n_layers + 1
        for layer in planned["blocks"]:
            assert set(layer["moe"]["router"]) == {"w"}
            assert "w_plan" not in layer["moe"]
    else:
        assert count == 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)


def test_params_from_numpy_slices_moe_layers():
    """A reference MoE tree ([L, e, d, f] experts, [L, d, e] router) as
    the port's list of layers, every leaf equal to its slice."""
    for arch in MOE_ARCHS:
        cfg = get_config(arch, smoke=True)
        tree = jax.tree.map(np.asarray, unbox(JT.lm_init(
            jax.random.PRNGKey(3), jget_config(arch, smoke=True))))
        params = params_from_numpy(tree, cfg, device="cpu")
        assert len(params["blocks"]) == cfg.n_layers
        for i, layer in enumerate(params["blocks"]):
            for name in ("w_up", "w_down") + (("w_gate",) if cfg.gated_mlp
                                             else ()):
                assert layer["moe"][name].dtype == torch.float32
                np.testing.assert_array_equal(
                    layer["moe"][name].numpy(),
                    tree["blocks"]["moe"][name][i])
            np.testing.assert_array_equal(
                layer["moe"]["router"]["w"].numpy(),
                tree["blocks"]["moe"]["router"]["w"][i])
            np.testing.assert_array_equal(
                layer["attn"]["wq"]["w"].numpy(),
                tree["blocks"]["attn"]["wq"]["w"][i])
        np.testing.assert_array_equal(params["lm_head"]["w"].numpy(),
                                      tree["lm_head"]["w"])


def port_config(arch, impl, cf):
    cfg = get_config(arch, smoke=True).replace(capacity_factor=cf)
    return cfg.replace(quant=None if impl is None
                       else QuantSpec.parse(spec_text(impl)))


def case_id(case):
    arch, impl, cf = case
    return f"{arch}-{impl}-cf{cf}"


@pytest.mark.parametrize("case", FORWARD_CASES, ids=case_id)
def test_forward_and_loss_within_tolerance(ref, case):
    """lm_apply, loss_fn (its aux the layers' summed router losses) and
    lm_prefill against the reference, within test_torch_forward.py's
    tolerances; the aux within AUX_ATOL."""
    arch, impl, cf = case
    want = ref["forward"][case]
    got = port_forward(want, port_config(arch, impl, cf))
    atol = LOGIT_ATOL[impl]
    assert got["logits"].shape == want["logits"].shape
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=atol)
    assert_tokens(got["logits"], want["logits"], atol)
    np.testing.assert_allclose(got["prefill"], want["prefill"], rtol=0,
                               atol=atol)
    assert want["aux"] > 0.0
    assert abs(got["aux"] - want["aux"]) <= FORWARD_AUX_ATOL[impl]
    assert abs(got["metrics"]["aux_loss"] - want["metrics"]["aux_loss"]) \
        <= FORWARD_AUX_ATOL[impl]
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL[impl]
    assert got["metrics"]["tokens"] == want["metrics"]["tokens"]


@pytest.mark.parametrize(
    "case", [c for c in FORWARD_CASES if c[1] is not None], ids=case_id)
def test_forward_equal_with_compiled_scale(ref, case, monkeypatch):
    """With the activation scale as the compiled reference computes it,
    the quantized MoE forward is the reference's bit for bit (its heads
    are untied: no bf16 matmul sums apart), and so are the prefill
    logits and caches, but for grok's soft cap (a float32 tanh) within
    SOFTCAP_RTOL / SOFTCAP_ATOL; greedy tokens equal."""
    arch, impl, cf = case
    want = ref["forward"][case]
    cfg = port_config(arch, impl, cf)
    got = port_forward(want, cfg, monkeypatch)
    np.testing.assert_array_equal(got["k"], want["k"])
    rtol, atol = (SOFTCAP_RTOL, SOFTCAP_ATOL) if cfg.logit_softcap \
        else (0, 0)
    for key in ("logits", "prefill"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=key)
    np.testing.assert_array_equal(got["logits"].argmax(-1),
                                  want["logits"].argmax(-1))
    assert abs(got["aux"] - want["aux"]) <= AUX_ATOL
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


@pytest.mark.parametrize("case", DECODE_CASES, ids=case_id)
def test_decode_tokens_match_reference(ref, case, monkeypatch):
    """The port's ServeEngine on the reference's params emits the
    reference's greedy tokens step for step through the oracle and B1
    (four planned projections a layer and the head), the activation scale
    as the compiled reference rounds it; at capacity 0.5 decode drops
    picks."""
    arch, impl, cf = case
    want = ref["decode"][case]
    cfg = get_config(arch, smoke=True).replace(capacity_factor=cf)
    params = params_from_numpy(want["params"], cfg, device="cpu")
    eng = ServeEngine(cfg, BATCH, MAX_LEN,
                      quant=QuantSpec.parse(spec_text(impl)), params=params,
                      device="cpu")
    if impl == "pallas_fused":
        assert eng.plan_stats["planned_weights"] == 4 * cfg.n_layers + 1
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    drops = []
    dispatch = TM._dispatch

    def counted(xf, eidx, gate, e, k, cap, dtype):
        buf, dest, wgt = dispatch(xf, eidx, gate, e, k, cap, dtype)
        drops.append(int((dest == e * cap).sum()))
        return buf, dest, wgt
    monkeypatch.setattr(TM, "_dispatch", counted)
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts(cfg.vocab_size))]
    stats = eng.run(reqs)
    assert [r.out for r in reqs] == want["tokens"]
    assert stats["engine_steps"] == want["steps"]
    assert stats["generated_tokens"] == 3 * NEW_TOKENS
    assert (sum(drops) > 0) == (cf < 1.0), sum(drops)


@pytest.mark.parametrize("cf,equal", [(2.0, True), (0.5, False)])
def test_decode_continues_the_forward_only_without_drops(cf, equal):
    """With a capacity that keeps every pick (capacity_factor e / k: each
    expert has a slot for every token), prefill then teacher-forced
    decode gives lm_apply's logits bit for bit; at 0.5 a decode step of
    two tokens drops picks the forward keeps, and the two differ, by
    the reference's own semantics."""
    cfg = get_config("olmoe-1b-7b", smoke=True).replace(capacity_factor=cf)
    params = TT.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (BATCH, SEQ)))
    with torch.no_grad():
        full, _ = TT.lm_apply(params, tokens, cfg, device="cpu")
        logits, caches = TT.lm_prefill(params, tokens[:, :PREFILL], cfg, SEQ,
                                       device="cpu")
        steps = [logits]
        for i in range(PREFILL, SEQ):
            logits, caches = TT.lm_decode_step(
                params, tokens[:, i:i + 1], torch.full((BATCH,), i), caches,
                cfg)
            steps.append(logits)
    assert torch.equal(torch.cat(steps, dim=1), full[:, PREFILL - 1:]) == \
        equal


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_serves_each_moe_arch(arch, capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "2", "--batch", "2", "--prompt-len",
                     "4", "--max-tokens", "2", "--quant-spec",
                     spec_text("pallas_fused"), "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"generated_tokens": 4' in out
    assert f'"planned_weights": {4 * 2 + 1}' in out


def test_other_families_still_refused():
    """get_api takes every family: the dense, MoE, VLM, RWKV, hybrid and
    encoder-decoder ones; the transformer's lm_init builds the first
    three, and refuses the others, which have their own inits
    (``models/rwkv6.py``, ``models/hymba.py``, ``models/encdec.py``)."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    assert get_api(cfg).family == "moe"
    for family in ("vlm", "rwkv", "hybrid", "encdec"):
        assert get_api(cfg.replace(family=family)).family == family
    with pytest.raises(ValueError, match="unknown model family"):
        get_api(cfg.replace(family="conv"))
    for family in ("rwkv", "hybrid", "encdec"):
        with pytest.raises(ValueError, match="has its own init"):
            TT.lm_init(torch.Generator().manual_seed(0),
                       cfg.replace(family=family), "cpu")
