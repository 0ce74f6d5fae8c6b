"""The port's dense configs (granite-34b, nemotron-4-15b, qwen1.5-110b
beside minicpm-2b) against the reference's: their fields, parameter
counts, registry order and input-shape cells (the MoE, VLM, RWKV,
hybrid and encoder-decoder configs' fields and counts too), and decode
through the port's ``ServeEngine`` against the reference's on each new
config's smoke size.

Decode runs the reference in a subprocess with XLA's excess precision
off (test_torch_forward.py's ``run_reference``), and the port with its
activation scale computed as the compiled reference computes it
(``compiled_scale``, ROADMAP C2): then the greedy tokens are equal
exactly.  The port's own rounding of that scale flips near-tie tokens on
these configs, within the logit tolerance test_torch_forward.py holds the
same forward to.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_config as jget_config
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import ServeRequest

from test_torch_forward import compiled_scale, run_reference, spec_text

torch.set_num_threads(1)

NEW_ARCHS = ("nemotron-4-15b", "qwen1.5-110b", "granite-34b")
IMPLS = ("planes", "pallas_fused")
BATCH, MAX_LEN, NEW_TOKENS = 2, 16, 6


def prompts(vocab):
    """3 seeded prompts of 3-7 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.integers(3, 8))).tolist()
            for _ in range(3)]


_REFERENCE_DECODE = """
import pickle, sys
import jax, numpy as np
from repro.configs.registry import get_config
from repro.engine import QuantSpec
from repro.serving.engine import ServeEngine
from repro.serving.request import ServeRequest

ARCHS, IMPLS = %r, %r
BATCH, MAX_LEN, NEW_TOKENS = %d, %d, %d
out = {"tokens": {}, "params": {}, "steps": {}}
for arch in ARCHS:
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))
               .tolist() for _ in range(3)]
    for impl in IMPLS:
        eng = ServeEngine(cfg, BATCH, MAX_LEN, quant=QuantSpec.parse(
            "planes=3,encoding=ent,impl=%%s,act_quant=per_token" %% impl))
        reqs = [ServeRequest(i, list(p), NEW_TOKENS)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        out["tokens"][arch, impl] = [list(r.out) for r in reqs]
        out["steps"][arch, impl] = eng.steps
    out["params"][arch] = jax.tree.map(np.asarray, eng.params)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (NEW_ARCHS, IMPLS, BATCH, MAX_LEN, NEW_TOKENS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Each new config served by the reference's ServeEngine on both
    impls, excess precision off."""
    return run_reference(_REFERENCE_DECODE,
                         tmp_path_factory.mktemp("ref") / "decode.pkl")


def shared_fields(cfg):
    return {f.name for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    """Every field the port's config has equals the reference's, and so
    do the parameter counts; a field the port lacks is one neither the
    dense, the MoE, the VLM, the RWKV, the hybrid nor the
    encoder-decoder forward reads."""
    tcfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch,
                                                            smoke=smoke)
    names = shared_fields(tcfg)
    assert names <= shared_fields(jcfg)
    for name in names - {"quant"}:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.quant is None and jcfg.quant is None
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    assert tcfg.padded_vocab == jcfg.padded_vocab
    lacking = shared_fields(jcfg) - names
    assert not lacking & {"attn_chunk", "frontend", "frontend_tokens",
                          "qkv_bias", "gated_mlp", "act", "norm",
                          "rope_theta", "tie_embeddings", "logit_softcap",
                          "n_experts", "experts_per_token",
                          "capacity_factor", "moe_shard",
                          "moe_dispatch_groups", "router_aux_coef",
                          "rwkv_head_size", "ssm_state", "ssm_expand",
                          "ssm_conv", "subquadratic", "n_encoder_layers"}


def test_registry_follows_reference_order():
    assert ARCHS == [a for a in JARCHS if a in ARCHS]
    assert set(NEW_ARCHS) | {"minicpm-2b", "olmoe-1b-7b", "grok-1-314b",
                             "phi-3-vision-4.2b", "rwkv6-3b", "hymba-1.5b",
                             "seamless-m4t-medium"} == set(ARCHS) == \
        set(JARCHS)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("seamless-m4t-large")
    assert get_config("qwen1.5-110b", smoke=True, n_layers=3).n_layers == 3


def test_shapes_match_reference():
    assert tbase.SHAPES.keys() == jbase.SHAPES.keys()
    for name, shape in tbase.SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(jbase.SHAPES[name])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_tokens_match_reference(ref, arch, impl, monkeypatch):
    """The port's ServeEngine on the reference's params emits the
    reference's greedy tokens, step for step, with the weights planned by
    the port and the activation scale as the compiled reference rounds it
    (relu2 in B1's epilogue on nemotron, the qkv bias on qwen, MQA on
    granite, each config's untied head)."""
    cfg = get_config(arch, smoke=True)
    params = params_from_numpy(ref["params"][arch], cfg, device="cpu")
    eng = ServeEngine(cfg, BATCH, MAX_LEN,
                      quant=QuantSpec.parse(spec_text(impl)), params=params,
                      device="cpu")
    if impl == "pallas_fused":
        assert eng.plan_stats["planned_weights"] == \
            (6 if arch == "nemotron-4-15b" else 7) * cfg.n_layers + 1
    monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    reqs = [ServeRequest(i, list(p), NEW_TOKENS)
            for i, p in enumerate(prompts(cfg.vocab_size))]
    stats = eng.run(reqs)
    assert [r.out for r in reqs] == ref["tokens"][arch, impl]
    assert stats["engine_steps"] == ref["steps"][arch, impl]
    assert stats["generated_tokens"] == 3 * NEW_TOKENS


@pytest.mark.parametrize("impl", ["pallas_fused", "pallas"])
def test_kernel_operands_are_contiguous(impl, monkeypatch):
    """nemotron's MLP folds relu2 into the up projection's epilogue, whose
    output comes back transposed; the down projection must still hand
    its kernel contiguous token rows (the card's wrappers refuse any
    other), also where d_ff needs no padding to the k-blocks."""
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.models import transformer as TT
    cfg = get_config("nemotron-4-15b", smoke=True)
    cfg = cfg.replace(quant=QuantSpec.parse(spec_text(impl)))
    params = TT.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    mlp, _ = tops.plan_params(params["blocks"][0]["mlp"], cfg.quant)
    assert mlp["down"]["w_plan"]["digits"].shape[2] == cfg.d_ff
    seen = []
    for name in ("bw_gemm_fused", "bw_gemm"):
        def check(*args, _fn=getattr(bwk, name), **kw):
            seen.append(all(t.is_contiguous() for t in args
                            if isinstance(t, torch.Tensor)))
            return _fn(*args, **kw)
        monkeypatch.setattr(bwk, name, check)
    x = torch.randn((3, 1, cfg.d_model)).to(torch.bfloat16)
    with torch.no_grad():
        TT.mlp_apply(mlp, x, cfg)
    assert seen == [True, True]


def test_encoding_by_row_blocks_equals_whole(monkeypatch):
    """A tall weight is encoded a block of rows at a time
    (``ref.ENCODE_BLOCK_ELEMS``: the encoder's int32 temporaries of a
    256,000-row head would not fit beside its weights): the planes equal
    the reference's encode of the whole, and the plan built from them the
    plan built in one block."""
    from repro.kernels import ops as jops
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-128, 128, (300, 64), generator=gen,
                      dtype=torch.int8)
    w = torch.randn((64, 300), generator=gen)
    spec = QuantSpec.parse(spec_text("pallas_fused"))
    whole = tops.plan_dense_weight(w, spec, use_cache=False)
    monkeypatch.setattr(tref, "ENCODE_BLOCK_ELEMS", 7 * 64)  # ragged end
    got = tref.encode_planes_ref(a)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.encode_planes(a.numpy())))
    blocks = tops.plan_dense_weight(w, spec, use_cache=False)
    assert whole.keys() == blocks.keys()
    for key, value in whole.items():
        assert torch.equal(value, blocks[key]), key


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launcher_serves_each_dense_arch(arch, capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "2", "--batch", "2", "--prompt-len",
                     "4", "--max-tokens", "2", "--quant-spec",
                     spec_text("pallas_fused"), "--json"])
    assert rc == 0
    assert '"generated_tokens": 4' in capsys.readouterr().out
