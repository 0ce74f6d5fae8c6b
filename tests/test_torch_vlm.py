"""The port's VLM family (phi-3-vision-4.2b with its frontend stub)
against the reference's, on the smoke config.

The frontend stub: ``frontend_proj`` projects the caller's precomputed
patch embeddings [B, F, d] as a bf16 matmul (never quantized, never
planned) and the result overwrites positions [0, F) of the token
embeddings in ``lm_apply`` and ``lm_prefill``; ``loss_fn`` masks those F
positions on a ``vlm`` config only; decode and serving take text tokens.

The forward, loss, prefill + decode and the served decode run the
reference in a subprocess with XLA's excess precision off, as
test_torch_forward.py does (``run_reference``), on seeded numpy tokens
and frontends; the port takes the same params
(``convert.params_from_numpy``) on the CPU, where its kernel wrappers
run their plain versions, and is held within test_torch_forward.py's
tolerances.  Served decode takes the activation scale as the compiled
reference rounds it (``compiled_scale``, ROADMAP C2); then its greedy
tokens equal the reference's.  The init tree, plans and RoPE at head_dim
96 run the reference in this process.
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget_config
from repro.engine import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel.sharding import unbox
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec
from repro_torch.kernels import bw_gemm as bwk
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.api import frontend_len, get_api, loss_fn
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import ServeRequest

from test_torch_dense_configs import prompts
from test_torch_forward import (BATCH, CACHE_ATOL, LOGIT_ATOL, LOSS_ATOL,
                                MAX_LEN, PREFILL, SEQ, assert_tokens,
                                compiled_scale, run_reference, spec_text)

torch.set_num_threads(1)

ARCH = "phi-3-vision-4.2b"
NEW_TOKENS = 6
# (family, impl): the VLM on every route, and the same config relabelled
# "dense", whose loss the reference does not mask (its forward still
# applies the frontend: lm_apply reads cfg.frontend, loss_fn cfg.family)
FORWARD_CASES = [("vlm", impl) for impl in (None, "planes", "pallas_fused")]
FORWARD_CASES.append(("dense", None))
DECODE_IMPLS = ("planes", "pallas_fused")


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

ARCH, FORWARD, DECODE = %r, %r, %r
BATCH, SEQ, PREFILL, MAX_LEN, NEW_TOKENS = %d, %d, %d, %d, %d


def spec(impl):
    return None if impl is None else QuantSpec.parse(
        "planes=3,encoding=ent,impl=%%s,act_quant=per_token" %% impl)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


out = {"forward": {}, "decode": {}}
for family, impl in FORWARD:
    cfg = get_config(ARCH, smoke=True).replace(family=family,
                                               quant=spec(impl))
    params = unbox(T.lm_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(SEQ)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    frontend = rng.standard_normal(
        (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    labels = np.concatenate([tokens[:, 1:], np.full((BATCH, 1), -1,
                                                    np.int32)], axis=1)
    labels[0, :2] = -1
    api = get_api(cfg)

    def run(p, t, l, fe):
        logits, aux = api.forward(p, {"tokens": t, "frontend": fe}, cfg)
        shifted, _ = api.forward(p, {"tokens": t, "frontend": fe + 1.0}, cfg)
        loss, metrics = loss_fn(p, {"tokens": t, "labels": l,
                                    "frontend": fe}, cfg)
        pl, caches = T.lm_prefill(p, t[:, :PREFILL], cfg, MAX_LEN,
                                  frontend_embeds=fe)
        steps, state = [pl], caches
        for i in range(PREFILL, SEQ):
            step, state = T.lm_decode_step(p, t[:, i:i + 1],
                                           jnp.full((BATCH,), i), state, cfg)
            steps.append(step)
        return (logits, shifted, aux, loss, metrics, pl, caches,
                jnp.concatenate(steps, axis=1))

    planned = params
    if impl == "pallas_fused":
        planned, _ = ops.plan_params(params, cfg.quant)
    logits, shifted, aux, loss, metrics, pl, caches, decoded = jax.jit(run)(
        planned, tokens, labels, frontend)
    out["forward"][family, impl] = dict(
        params=jax.tree.map(np.asarray, params), tokens=tokens,
        frontend=frontend, labels=labels, logits=f32(logits),
        shifted=f32(shifted), aux=float(aux), loss=float(loss),
        metrics={k: float(v) for k, v in metrics.items()}, prefill=f32(pl),
        k=f32(caches["k"]), v=f32(caches["v"]), decoded=f32(decoded))

for impl in DECODE:
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))
               .tolist() for _ in range(3)]
    eng = ServeEngine(cfg, BATCH, MAX_LEN, quant=spec(impl))
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    out["decode"][impl] = dict(
        tokens=[list(r.out) for r in reqs], steps=eng.steps,
        params=jax.tree.map(np.asarray, eng.params))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (ARCH, FORWARD_CASES, DECODE_IMPLS, BATCH, SEQ, PREFILL, MAX_LEN,
       NEW_TOKENS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every forward and decode case run by the reference, excess
    precision off."""
    return run_reference(_REFERENCE,
                         tmp_path_factory.mktemp("ref") / "vlm.pkl")


def port_config(family="vlm", impl=None):
    cfg = get_config(ARCH, smoke=True).replace(family=family)
    return cfg.replace(quant=None if impl is None
                       else QuantSpec.parse(spec_text(impl)))


def planned(params, cfg):
    """The params as cfg's route runs them: planned on pallas_fused."""
    if cfg.quant is not None and cfg.quant.impl == "pallas_fused":
        params, _ = tops.plan_params(params, cfg.quant)
    return params


def seeded_params(cfg):
    return TT.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")


def seeded_inputs(cfg):
    """Seeded tokens [BATCH, SEQ] and a float32 frontend [BATCH, F, d]."""
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ)))
    frontend = torch.from_numpy(rng.standard_normal(
        (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return tokens, frontend


@torch.no_grad()
def port_run(case, cfg):
    """The port's forward (and with the frontend + 1.0), loss, prefill
    and teacher-forced decode of one reference case."""
    params = planned(params_from_numpy(case["params"], cfg, device="cpu"),
                     cfg)
    tokens = torch.from_numpy(case["tokens"])
    fe = torch.from_numpy(case["frontend"])
    api = get_api(cfg)
    logits, aux = api.forward(params, {"tokens": tokens, "frontend": fe},
                              cfg, device="cpu")
    shifted, _ = api.forward(params, {"tokens": tokens, "frontend": fe + 1.0},
                             cfg, device="cpu")
    loss, metrics = loss_fn(params, {"tokens": tokens, "frontend": fe,
                                     "labels": torch.from_numpy(
                                         case["labels"])}, cfg, device="cpu")
    pl, caches = TT.lm_prefill(params, tokens[:, :PREFILL], cfg, MAX_LEN,
                               device="cpu", frontend_embeds=fe)
    steps, state = [pl], {k: v.clone() for k, v in caches.items()}
    for i in range(PREFILL, SEQ):
        step, state = TT.lm_decode_step(params, tokens[:, i:i + 1],
                                        torch.full((BATCH,), i), state, cfg)
        steps.append(step)
    return dict(logits=logits, shifted=shifted.float().numpy(),
                aux=float(aux), loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                prefill=pl.float().numpy(), k=caches["k"].float().numpy(),
                v=caches["v"].float().numpy(),
                decoded=torch.cat(steps, dim=1))


def case_id(case):
    family, impl = case
    return f"{family}-{impl}"


@pytest.mark.parametrize("case", FORWARD_CASES, ids=case_id)
def test_forward_loss_prefill_within_tolerance(ref, case):
    """api.forward with a frontend, the same with the frontend + 1.0,
    loss_fn, lm_prefill with the frontend and the caches it fills, and
    decode after it, against the reference within test_torch_forward.py's
    tolerances; the port's decode continues its own forward bit for bit
    on the CPU."""
    family, impl = case
    want = ref["forward"][case]
    cfg = port_config(family, impl)
    got = port_run(want, cfg)
    atol = LOGIT_ATOL[impl]
    logits = got["logits"].float().numpy()
    assert logits.shape == want["logits"].shape == \
        (BATCH, SEQ, cfg.padded_vocab)
    for key, value in (("logits", logits), ("shifted", got["shifted"]),
                       ("prefill", got["prefill"]),
                       ("decoded", got["decoded"].float().numpy())):
        np.testing.assert_allclose(value, want[key], rtol=0, atol=atol,
                                   err_msg=key)
    assert_tokens(logits, want["logits"], atol)
    assert got["aux"] == want["aux"] == 0.0
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL[impl]
    for key in ("k", "v"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=CACHE_ATOL[impl], err_msg=key)
        assert not got[key][:, :, PREFILL:].any()        # the padding
    assert torch.equal(got["decoded"], got["logits"][:, PREFILL - 1:])


@pytest.mark.parametrize(
    "case", [c for c in FORWARD_CASES if c[1] is not None], ids=case_id)
def test_forward_equal_with_compiled_scale(ref, case, monkeypatch):
    """With the activation scale as the compiled reference computes it,
    the quantized multimodal forward (and with the frontend + 1.0),
    prefill, its caches and decode after it are the reference's bit for
    bit: frontend_proj's bf16 product and the prefix overwrite add no
    gap of their own (the head is untied); losses equal but for float32
    summation order (rtol 1e-6)."""
    family, impl = case
    want = ref["forward"][case]
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    got = port_run(want, port_config(family, impl))
    for key in ("logits", "shifted", "prefill", "decoded", "k", "v"):
        value = got[key]
        if isinstance(value, torch.Tensor):
            value = value.float().numpy()
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


@pytest.mark.parametrize("case", FORWARD_CASES, ids=case_id)
def test_loss_masks_the_prefix_on_vlm_only(ref, case):
    """loss_fn's denominator equals the reference's exactly: labels >= 0
    at positions >= F on a vlm config (2 x (12 - 4) - 2), every label
    >= 0 on the same config relabelled dense (2 x 11 - 2); and the loss
    is the masked mean of the port's own forward logits."""
    family, impl = case
    want = ref["forward"][case]
    cfg = port_config(family, impl)
    got = port_run(want, cfg)
    f = frontend_len(cfg)
    prefix = f if family == "vlm" else 0
    assert got["metrics"]["tokens"] == want["metrics"]["tokens"] == \
        BATCH * (SEQ - 1) - 2 - (BATCH * f - 2 if prefix else 0)
    labels = torch.from_numpy(want["labels"]).long()
    mask = (labels >= 0) & (torch.arange(SEQ) >= prefix)[None, :]
    logits = got["logits"].float()
    nll = torch.logsumexp(logits, -1) - torch.take_along_dim(
        logits, labels.clamp_min(0)[..., None], dim=-1)[..., 0]
    np.testing.assert_allclose(got["loss"], float((nll * mask).sum()
                                                  / mask.sum()), rtol=1e-6)


def test_frontend_changes_prefix_logits_only_causally():
    """The reference's test_vlm_frontend_changes_prefix_logits_only_causally
    on the port: the frontend + 1.0 changes the logits (the stub is
    wired in), on every route."""
    for impl in (None, "planes", "pallas_fused"):
        cfg = port_config(impl=impl)
        params = planned(seeded_params(cfg), cfg)
        tokens, fe = seeded_inputs(cfg)
        api = get_api(cfg)
        with torch.no_grad():
            l1, _ = api.forward(params, {"tokens": tokens, "frontend": fe},
                                cfg, device="cpu")
            l2, _ = api.forward(params, {"tokens": tokens,
                                         "frontend": fe + 1.0}, cfg,
                                device="cpu")
        assert not torch.allclose(l1.float(), l2.float()), impl


def test_frontend_overwrites_the_prefix():
    """Positions [0, F) take frontend_proj's bf16 product of the
    frontend (never quantized: the same on the planes route); the tokens
    there are not read, and positions stay 0..T-1."""
    cfg = port_config()
    params = seeded_params(cfg)
    tokens, fe = seeded_inputs(cfg)
    f = cfg.frontend_tokens
    for spec in (None, QuantSpec.parse(spec_text("planes"))):
        x, positions, dtype = TT._embed_inputs(params, tokens,
                                               cfg.replace(quant=spec),
                                               "cpu", fe)
        want = fe.to(torch.bfloat16) @ \
            params["frontend_proj"]["w"].to(torch.bfloat16)
        assert x.dtype == dtype == torch.bfloat16
        assert torch.equal(x[:, :f], want)
        assert torch.equal(x[:, f:], TL.embed_apply(params["embed"],
                                                    tokens)[:, f:])
        assert torch.equal(positions, torch.arange(SEQ).expand(BATCH, SEQ))
    other = tokens.clone()
    other[:, :f] = (other[:, :f] + 1) % cfg.vocab_size
    with torch.no_grad():
        a, _ = TT.lm_apply(params, tokens, cfg, "cpu", frontend_embeds=fe)
        b, _ = TT.lm_apply(params, other, cfg, "cpu", frontend_embeds=fe)
    assert torch.equal(a, b)


def test_frontend_errors():
    """Where the reference crashes (no frontend: ``None.astype``; a
    prompt shorter than F: dynamic_update_slice's shape check) and on a
    frontend of the wrong shape, the port raises a ValueError that says
    what is wrong, on every entry point that takes a frontend."""
    cfg = port_config()
    params = seeded_params(cfg)
    tokens, fe = seeded_inputs(cfg)
    f, d = cfg.frontend_tokens, cfg.d_model
    labels = tokens
    calls = {
        "forward": lambda t, e: get_api(cfg).forward(
            params, {"tokens": t, "frontend": e}, cfg, device="cpu"),
        "loss": lambda t, e: loss_fn(
            params, {"tokens": t, "labels": labels[:, :t.shape[1]],
                     "frontend": e}, cfg, device="cpu"),
        "prefill": lambda t, e: TT.lm_prefill(params, t, cfg, MAX_LEN, "cpu",
                                              frontend_embeds=e),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match=r"batch\['frontend'\]"):
            call(tokens, None)
        with pytest.raises(ValueError, match=f"3 tokens .* {f} positions"):
            call(tokens[:, :3], fe)
        for shape in ((BATCH, f - 1, d), (BATCH, f, d + 1),
                      (BATCH + 1, f, d)):
            with pytest.raises(ValueError, match=rf"expected \[{BATCH}, "
                               rf"{f}, {d}\]"):
                call(tokens, torch.zeros(shape))
    with torch.no_grad():
        logits, _ = calls["forward"](tokens[:, :f], fe)   # T == F: all image
    assert logits.shape == (BATCH, f, cfg.padded_vocab)


@pytest.mark.parametrize("impl", DECODE_IMPLS)
def test_decode_tokens_match_reference(ref, impl, monkeypatch):
    """The port's ServeEngine on the reference's params (frontend_proj
    carried, unused: decode takes text) emits the reference's greedy
    tokens step for step through the oracle and B1, the activation scale
    as the compiled reference rounds it; 7 x layers + 1 planned weights,
    frontend_proj not among them."""
    want = ref["decode"][impl]
    cfg = get_config(ARCH, smoke=True)
    params = params_from_numpy(want["params"], cfg, device="cpu")
    eng = ServeEngine(cfg, BATCH, MAX_LEN,
                      quant=QuantSpec.parse(spec_text(impl)), params=params,
                      device="cpu")
    assert torch.equal(eng.params["frontend_proj"]["w"],
                       torch.from_numpy(want["params"]["frontend_proj"]["w"]))
    if impl == "pallas_fused":
        assert eng.plan_stats["planned_weights"] == 7 * cfg.n_layers + 1
        assert "w_plan" not in eng.params["frontend_proj"]
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts(cfg.vocab_size))]
    stats = eng.run(reqs)
    assert [r.out for r in reqs] == want["tokens"]
    assert stats["engine_steps"] == want["steps"]
    assert stats["generated_tokens"] == 3 * NEW_TOKENS


def test_b1_launches_skip_the_frontend(monkeypatch):
    """On pallas_fused a forward and a decode step call B1 once a planned
    projection and once for the untied head, 7 x layers + 1 times, never
    for frontend_proj, which plan_params leaves unplanned."""
    cfg = port_config(impl="pallas_fused")
    params, count = tops.plan_params(seeded_params(cfg), cfg.quant)
    assert count == 7 * cfg.n_layers + 1
    assert set(params["frontend_proj"]) == {"w"}
    calls = []
    fused = bwk.bw_gemm_fused

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fused(*args, **kw)
    monkeypatch.setattr(bwk, "bw_gemm_fused", counted)
    tokens, fe = seeded_inputs(cfg)
    with torch.no_grad():
        TT.lm_apply(params, tokens, cfg, "cpu", frontend_embeds=fe)
        assert len(calls) == 7 * cfg.n_layers + 1
        caches = TT.init_caches(cfg, BATCH, MAX_LEN, device="cpu")
        TT.lm_decode_step(params, tokens[:, :1], torch.zeros(BATCH,
                                                             dtype=torch.long),
                          caches, cfg)
    assert len(calls) == 2 * (7 * cfg.n_layers + 1)


def test_config_and_init_tree_match_reference():
    """The full and smoke configs' fields and parameter counts are the
    reference's (param_count counts no frontend_proj, as there); lm_init's
    tree has the reference's keys and shapes, frontend_proj [d, d]
    included, and params_from_numpy carries it as it is."""
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH,
                                                               smoke=smoke)
        assert (cfg.family, cfg.frontend) == (jcfg.family, jcfg.frontend) \
            == ("vlm", "vision")
        assert cfg.frontend_tokens == jcfg.frontend_tokens == \
            (4 if smoke else 576)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim == \
            (16 if smoke else 96)
        assert cfg.padded_vocab == jcfg.padded_vocab == \
            (512 if smoke else 32128)
    cfg = get_config(ARCH, smoke=True)
    ours = seeded_params(cfg)
    theirs = jax.tree.map(np.asarray, unbox(JT.lm_init(
        jax.random.PRNGKey(0), jget_config(ARCH, smoke=True))))

    def shapes(tree, layered=False):
        if isinstance(tree, dict):
            return {k: shapes(v, layered) for k, v in tree.items()}
        return tuple(tree.shape[1:] if layered else tree.shape)
    for layer in ours["blocks"]:
        assert shapes(layer) == shapes(theirs["blocks"], True)
    rest = {k: v for k, v in ours.items() if k != "blocks"}
    assert shapes(rest) == shapes({k: v for k, v in theirs.items()
                                   if k != "blocks"})
    assert shapes(rest["frontend_proj"]) == {"w": (cfg.d_model,
                                                   cfg.d_model)}

    def matrices(tree):
        if isinstance(tree, list):
            return sum(map(matrices, tree))
        if isinstance(tree, dict):
            return sum(map(matrices, tree.values()))
        return tree.numel() if tree.dim() == 2 else 0
    assert cfg.param_count() == matrices(ours) - cfg.d_model ** 2
    converted = params_from_numpy(theirs, cfg, device="cpu")
    np.testing.assert_array_equal(converted["frontend_proj"]["w"].numpy(),
                                  theirs["frontend_proj"]["w"])


def test_plan_params_plans_the_reference_paths():
    """The port plans what the reference plans on a VLM tree, as many:
    the seven projections a layer and the untied head, not
    frontend_proj."""
    spec = spec_text("pallas_fused")
    jparams = unbox(JT.lm_init(jax.random.PRNGKey(0),
                               jget_config(ARCH, smoke=True)))
    jplanned, jcount = jops.plan_params(jparams, JSpec.parse(spec))
    cfg = get_config(ARCH, smoke=True)
    planned, count = tops.plan_params(
        params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                          device="cpu"), QuantSpec.parse(spec))
    assert count == jcount == 7 * cfg.n_layers + 1
    assert "w_plan" not in jplanned["frontend_proj"]
    assert "w_plan" not in planned["frontend_proj"]
    assert "w_plan" in planned["lm_head"]


def test_rope_at_head_dim_96():
    """RoPE at phi-3's head_dim 96 (48 frequencies, halves of 48) against
    the reference's at positions to 1,100: float32 q / k within 1e-6 (the
    two libraries' float32 sin and cos differ by an ulp at some angles),
    bf16 q / k within one bf16 ulp (rtol 2^-7: that ulp rounds one value
    in about 4 x 10^5 apart)."""
    rng = np.random.default_rng(96)
    q, k = (rng.standard_normal((2, 1100, 2, 96)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(1100)[None], (2, 1100))
    for jdtype, tdtype, rtol, atol in ((jnp.float32, torch.float32, 0, 1e-6),
                                       (jnp.bfloat16, torch.bfloat16,
                                        2.0 ** -7, 0)):
        jq, jk = JL.rope(jnp.asarray(q).astype(jdtype),
                         jnp.asarray(k).astype(jdtype), jnp.asarray(pos), 96)
        tq, tk = TL.rope(torch.from_numpy(q).to(tdtype),
                         torch.from_numpy(k).to(tdtype),
                         torch.from_numpy(pos.copy()), 96)
        for got, want in ((tq, jq), (tk, jk)):
            assert got.dtype == tdtype
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                rtol=rtol, atol=atol)


def test_launcher_serves_phi3_vision_on_text(capsys):
    """``launch/serve.py --arch phi-3-vision-4.2b`` serves text prompts
    through B1; as in the reference, the launcher, the engine, the server
    and snapshots take no frontend."""
    from repro_torch.launch import serve
    from repro_torch.serving import AsyncServer
    from repro_torch.serving.ckpt import DecodeSnapshot
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
            "2", "--batch", "2", "--prompt-len", "4", "--max-tokens", "2",
            "--quant-spec", spec_text("pallas_fused"), "--json"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert '"generated_tokens": 4' in out
    assert f'"planned_weights": {7 * 2 + 1}' in out
    with pytest.raises(SystemExit):
        serve.main(argv + ["--frontend", "patches.npy"])
    for fn in (ServeEngine.__init__, ServeEngine.run, AsyncServer.__init__,
               DecodeSnapshot.__init__):
        assert not any("frontend" in name
                       for name in inspect.signature(fn).parameters), fn
