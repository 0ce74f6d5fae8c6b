"""The port's full-sequence forward (``attn_apply``, ``lm_apply``,
``lm_prefill``, ``api.forward`` and ``loss_fn``) against the reference's,
on the smoke configs of the four dense architectures.

The reference runs in a subprocess with XLA's excess precision off
(``--xla_allow_excess_precision=false``, ROADMAP queue C3): with it on,
XLA keeps fused bf16 chains in float32 and the bf16 path's logits move by
a few ulps.  The subprocess draws each case's params (``jax.random`` key
0), runs the reference jitted on seeded numpy tokens (planned with
``ops.plan_params`` first on ``pallas_fused``, whose kernels run in
interpret mode) and writes params and results; the port takes the same
params (``convert.params_from_numpy``) and tokens on the CPU, where its
kernel wrappers run their plain versions.

Two tolerances, two tests:

* The port as it is: logits within ``LOGIT_ATOL`` (test_torch_serve.py's:
  0.125 on the bf16 path; 1.0 on the quantized paths, for ROADMAP C2's
  cause: the compiled reference multiplies by fl(1/qmax) where the port,
  as the reference's source says, divides by qmax, and an activation
  that sits on a rounding boundary then quantizes one step apart).  A
  greedy token may differ only where the reference's top-2 margin is
  within that tolerance.  Losses within ``LOSS_ATOL``, caches within
  ``CACHE_ATOL``.
* With the port's activation scale computed as the compiled reference
  computes it (``compiled_scale``, a test-only patch, as C2's diagnosis
  does): caches bit-identical, logits and prefill logits too but for
  the tied head's bf16 matmul (minicpm-2b: one ulp, where the two
  libraries' float32 sums round apart), tokens equal exactly, losses
  equal but for float32 summation order (rtol 1e-6).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_api, loss_fn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DENSE_ARCHS = ("minicpm-2b", "nemotron-4-15b", "qwen1.5-110b",
               "granite-34b")
LOGIT_ATOL = {None: 0.125, "planes": 1.0, "pallas_fused": 1.0}
# the mean next-token NLL: a logit gap of up to LOGIT_ATOL at a few
# positions moves it by a small part of that
LOSS_ATOL = {None: 0.02, "planes": 0.05, "pallas_fused": 0.05}
# K/V of the last layer: each is a projection of the hidden state, which
# the logit gap's cause (C2) moves by a quantization step or two
CACHE_ATOL = {None: 0.0625, "planes": 0.25, "pallas_fused": 0.25}
BATCH, SEQ, PREFILL, MAX_LEN = 2, 12, 8, 16

# (arch, impl, attn_chunk, seq): the dense path at T=12 on every arch and
# impl, and minicpm's chunked path (T=32 over chunks of 8) on the kernel
# route
FORWARD_CASES = [(arch, impl, 2048, SEQ) for arch in DENSE_ARCHS
                 for impl in (None, "planes", "pallas_fused")]
FORWARD_CASES.append(("minicpm-2b", "pallas_fused", 8, 32))
# (path, impl) for attn_apply alone: attn_chunk 8, T=32 takes the chunked
# path; attn_chunk 2048 the dense one
ATTN_CASES = [(path, impl) for path in ("dense", "chunked")
              for impl in (None, "planes", "pallas_fused")]


def spec_text(impl):
    return f"planes=3,encoding=ent,impl={impl},act_quant=per_token"


def compiled_scale(v, planes=4, axis=None, radix=4, bits=8):
    """``quant.quantize_to_planes`` as the compiled reference computes it:
    ``amax * fl(1/qmax)`` for ``amax / qmax`` (ROADMAP C2)."""
    qmax = tquant.plane_qmax(planes, radix, bits)
    recip = torch.tensor(1.0 / qmax, dtype=torch.float32)
    s = torch.clamp_min(v.abs().amax(dim=axis, keepdim=True), 1e-8) * recip
    return torch.clamp(torch.round(v / s), -qmax, qmax).to(torch.int8), s


def run_reference(script: str, out_path: Path, *args) -> dict:
    """Run ``script`` (which writes a pickle to argv[1]) in a Python with
    XLA's excess precision off; returns what it wrote."""
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, "-c", script, str(out_path),
                          *map(str, args)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out_path, "rb") as f:
        return pickle.load(f)


_REFERENCE_FORWARD = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.engine import QuantSpec
from repro.kernels import ops
from repro.models import attention as A, transformer as T
from repro.models.api import get_api, loss_fn
from repro.parallel.sharding import unbox

FORWARD, ATTN = %r, %r
BATCH, PREFILL, MAX_LEN = %d, %d, %d


def spec(impl):
    return None if impl is None else QuantSpec.parse(
        "planes=3,encoding=ent,impl=%%s,act_quant=per_token" %% impl)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def planned(params, cfg):
    if cfg.quant is not None and cfg.quant.impl == "pallas_fused":
        params, _ = ops.plan_params(params, cfg.quant)
    return params


out = {"forward": {}, "attn": {}}
for arch, impl, chunk, seq in FORWARD:
    cfg = get_config(arch, smoke=True).replace(quant=spec(impl),
                                               attn_chunk=chunk)
    params = unbox(T.lm_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((BATCH, 1), -1,
                                                    np.int32)], axis=1)
    labels[0, :2] = -1
    api = get_api(cfg)

    def run(p, t, l):
        logits, aux = api.forward(p, {"tokens": t}, cfg)
        loss, metrics = loss_fn(p, {"tokens": t, "labels": l}, cfg)
        pl, caches = T.lm_prefill(p, t[:, :PREFILL], cfg, MAX_LEN)
        return logits, aux, loss, metrics, pl, caches

    logits, aux, loss, metrics, pl, caches = jax.jit(run)(
        planned(params, cfg), tokens, labels)
    out["forward"][arch, impl, chunk, seq] = dict(
        params=jax.tree.map(np.asarray, params), tokens=tokens,
        labels=labels, logits=f32(logits), aux=float(aux),
        loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
        prefill=f32(pl), k=f32(caches["k"]), v=f32(caches["v"]))

for path, impl in ATTN:
    cfg = get_config("minicpm-2b", smoke=True).replace(
        quant=spec(impl), attn_chunk=8 if path == "chunked" else 2048)
    params = unbox(A.attn_init(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((BATCH, 32, cfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(32)[None, :], (BATCH, 32))
    y, (k, v) = jax.jit(lambda p, x, pos: A.attn_apply(p, x, cfg, pos))(
        planned(params, cfg), xb, pos)
    out["attn"][path, impl] = dict(
        params=jax.tree.map(np.asarray, params), x=f32(xb), y=f32(y),
        k=f32(k), v=f32(v))

with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (FORWARD_CASES, ATTN_CASES, BATCH, PREFILL, MAX_LEN)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every case run by the reference, excess precision off."""
    return run_reference(_REFERENCE_FORWARD,
                         tmp_path_factory.mktemp("ref") / "forward.pkl")


def port_config(arch, impl, chunk=2048):
    cfg = tget_config(arch, smoke=True).replace(attn_chunk=chunk)
    return cfg.replace(quant=None if impl is None
                       else TSpec.parse(spec_text(impl)))


def port_params(tree, cfg):
    params = params_from_numpy(tree, cfg, device="cpu")
    if cfg.quant is not None and cfg.quant.impl == "pallas_fused":
        params, _ = tops.plan_params(params, cfg.quant)
    return params


@torch.no_grad()
def port_forward(case, cfg, monkeypatch=None):
    """The port's forward, loss and prefill of one reference case (the
    weights planned first, with the port's own scale; then, given
    ``monkeypatch``, every quantization the run makes takes the compiled
    reference's scale)."""
    params = port_params(case["params"], cfg)
    if monkeypatch is not None:
        monkeypatch.setattr(tquant, "quantize_to_planes", compiled_scale)
    tokens = torch.from_numpy(case["tokens"])
    batch = {"tokens": tokens, "labels": torch.from_numpy(case["labels"])}
    logits, aux = get_api(cfg).forward(params, batch, cfg, device="cpu")
    loss, metrics = loss_fn(params, batch, cfg, device="cpu")
    pl, caches = TT.lm_prefill(params, tokens[:, :PREFILL], cfg, MAX_LEN,
                               device="cpu")
    return dict(logits=logits.float().numpy(), aux=float(aux),
                loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                prefill=pl.float().numpy(), k=caches["k"].float().numpy(),
                v=caches["v"].float().numpy())


def assert_tokens(got, want, atol):
    """Greedy tokens equal, but where the reference's top-2 margin is
    within ``atol`` (a near-tie the logit gap may flip)."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    flip = got.argmax(-1) != want.argmax(-1)
    margins = (top2[..., 1] - top2[..., 0])[flip]
    assert np.all(margins <= atol), margins


def case_id(case):
    arch, impl, chunk, seq = case
    return f"{arch}-{impl}" + (f"-chunk{chunk}-t{seq}" if chunk < seq
                               else "")


@pytest.mark.parametrize("case", FORWARD_CASES, ids=case_id)
def test_forward_within_tolerance(ref, case):
    """The port as it is against the reference: forward logits, greedy
    tokens, loss and its metrics, prefill logits and the filled caches."""
    arch, impl, chunk, seq = case
    want = ref["forward"][case]
    got = port_forward(want, port_config(arch, impl, chunk))
    atol = LOGIT_ATOL[impl]
    assert got["logits"].shape == want["logits"].shape == \
        (BATCH, seq, tget_config(arch, smoke=True).padded_vocab)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=atol)
    assert_tokens(got["logits"], want["logits"], atol)
    np.testing.assert_allclose(got["prefill"], want["prefill"], rtol=0,
                               atol=atol)
    assert got["aux"] == want["aux"] == 0.0
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL[impl]
    assert got["metrics"]["tokens"] == want["metrics"]["tokens"] == \
        BATCH * (seq - 1) - 2
    for key in ("k", "v"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=CACHE_ATOL[impl])
        assert not got[key][:, :, PREFILL:].any()        # the padding


@pytest.mark.parametrize(
    "case", [c for c in FORWARD_CASES if c[1] is not None], ids=case_id)
def test_forward_equal_with_compiled_scale(ref, case, monkeypatch):
    """With the activation scale as the compiled reference computes it,
    the quantized forward is the reference's bit for bit: C2's rounding
    is the whole of the gap that test_forward_within_tolerance allows."""
    arch, impl, chunk, seq = case
    want = ref["forward"][case]
    cfg = port_config(arch, impl, chunk)
    got = port_forward(want, cfg, monkeypatch)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # a tied head is a bf16 matmul (embed_logits): torch and XLA sum its
    # float32 products in different orders, which rounds about one logit
    # in 10^4 one bf16 ulp (at most 2^-7 of it) apart, or, where the sum
    # nearly cancels, one float32 ulp of the products' magnitude (< 8)
    rtol, atol = (2.0 ** -7, 2.0 ** -20) if cfg.tie_embeddings else (0, 0)
    for key in ("logits", "prefill"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=key)
    np.testing.assert_array_equal(got["logits"].argmax(-1),
                                  want["logits"].argmax(-1))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


@pytest.mark.parametrize("path,impl", ATTN_CASES)
def test_attn_apply_matches_reference(ref, path, impl):
    """attn_apply alone, on the plain causal path and on the chunked
    online-softmax walk (T=32 over chunks of 8): outputs and head-repeated
    K/V.  The bf16 path within one bf16 ulp at the outputs' magnitudes
    (torch's and XLA's float32 exp may differ in the last bit); the
    quantized paths within a quantization step (C2)."""
    want = ref["attn"][path, impl]
    cfg = port_config("minicpm-2b", impl, 8 if path == "chunked" else 2048)
    params = {name: {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
              for name, p in want["params"].items()}
    if impl == "pallas_fused":
        params, _ = tops.plan_params(params, cfg.quant)
    x = torch.from_numpy(want["x"]).to(torch.bfloat16)
    pos = torch.arange(32)[None, :].expand(BATCH, 32)
    with torch.no_grad():
        y, (k, v) = TA.attn_apply(params, x, cfg, pos)
    assert k.shape == v.shape == (BATCH, 32, cfg.n_heads, cfg.head_dim)
    atol = 0.0078125 if impl is None else 0.125
    for name, got in (("y", y), ("k", k), ("v", v)):
        np.testing.assert_allclose(got.float().numpy(), want[name], rtol=0,
                                   atol=atol, err_msg=name)


def test_chunked_causal_matches_dense_causal():
    """The port's two attention paths agree with each other (the
    reference's test_chunked_causal_matches_dense, on the port), with
    chunks of 8 over T=32 and a chunk as long as the sequence."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 32, 4, 16), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    dense = TA._dense_causal(q, k, v).float()
    for chunk in (8, 32):
        chunked = TA._chunked_causal(q, k, v, chunk, chunk).float()
        torch.testing.assert_close(chunked, dense, rtol=0, atol=0.0625)


@pytest.mark.parametrize(
    "case", [c for c in FORWARD_CASES if c[2] > c[3]], ids=case_id)
def test_prefill_then_decode_continues_the_forward(ref, case):
    """lm_prefill of the first tokens, then lm_decode_step on the rest
    (teacher-forced), gives lm_apply's logits at every later position bit
    for bit on the CPU at this size (the reference's
    test_lm_prefill_matches_decode_for_dense_arch allows rtol and atol
    0.05).  On the card the library orders attention's and the norms'
    float32 sums by shape, so chip_smoke.py phase 8 holds the two within
    a tolerance measured there (ROADMAP C6)."""
    arch, impl, chunk, seq = case
    want = ref["forward"][case]
    cfg = port_config(arch, impl, chunk)
    params = port_params(want["params"], cfg)
    tokens = torch.from_numpy(want["tokens"])
    with torch.no_grad():
        full, _ = TT.lm_apply(params, tokens, cfg, device="cpu")
        logits, caches = TT.lm_prefill(params, tokens[:, :PREFILL], cfg,
                                       seq, device="cpu")
        steps = [logits]
        for i in range(PREFILL, seq):
            logits, caches = TT.lm_decode_step(
                params, tokens[:, i:i + 1], torch.full((BATCH,), i), caches,
                cfg)
            steps.append(logits)
    assert torch.equal(torch.cat(steps, dim=1), full[:, PREFILL - 1:])


def test_forward_refuses_frontend_and_foreign_device():
    """A config with a frontend needs its embeddings (the VLM family's
    stub, tests/test_torch_vlm.py); a short max_len and params on
    another device are refused."""
    cfg = port_config("minicpm-2b", None)
    gen = torch.Generator().manual_seed(0)
    params = TT.lm_init(gen, cfg, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match=r"batch\['frontend'\]"):
        TT.lm_apply(params, tokens, cfg.replace(frontend="vision",
                                                frontend_tokens=2),
                    device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        TT.lm_prefill(params, tokens, cfg, 3, device="cpu")
    with pytest.raises(ValueError, match="params are on cpu"):
        TT.lm_apply(params, tokens, cfg, device="meta")


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = port_config("minicpm-2b", None)
    params = TT.lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    batch = {"tokens": tokens, "labels": tokens}
    for call in (lambda: TT.lm_apply(params, tokens, cfg),
                 lambda: TT.lm_prefill(params, tokens, cfg, 8),
                 lambda: get_api(cfg).forward(params, batch, cfg),
                 lambda: loss_fn(params, batch, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"
