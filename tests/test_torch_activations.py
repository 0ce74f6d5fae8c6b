"""The port's bf16 element-wise activations, and the planes=2 smoke lane's
one flipped request, against the reference (ROADMAP queue C).

* Every finite bfloat16 value goes through the reference's
  ``EPILOGUE_ACTIVATIONS`` (jitted) and the port's.  They are equal
  wherever the reference's result is a normal number.  Where they differ
  the reference gives zero: XLA flushes a subnormal result, or a
  subnormal sigmoid, to zero, and torch keeps it (the port's value there
  is within a few multiples of 2**-126 times max(1, |x|)).
* Request 1 of the planes=2 smoke lane (the prompt of
  ``test_torch_sparse.py``'s lane) decodes to 166 in the port and to 342
  in the reference's served (jitted) step.  The port's logits equal at
  every step those of the reference's own decode step run op by op
  (``jax.disable_jit``), but for a few a bf16 ulp apart (the tied head
  sums in another order), and both pick 166.  The jitted step
  differs because XLA, allowed excess precision, drops the bf16 rounding
  of ``silu(gate) * up`` where the down projection's quantizer converts
  it to float32 at once: the jitted down projection equals the eager one
  fed that product in float32, and with
  ``XLA_FLAGS=--xla_allow_excess_precision=false`` the jitted step picks
  166 too.  No formula of the port's is at fault.
"""
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
from repro.kernels.bw_gemm import EPILOGUE_ACTIVATIONS as JACTS
from repro.models import layers as JL
from repro.models.api import get_api as jget_api
from repro.parallel.sharding import unbox
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.kernels.bw_gemm import EPILOGUE_ACTIVATIONS as TACTS
from repro_torch.models import layers as TL
from repro_torch.serving.engine import ServeEngine as TEngine

# One torch thread, as in the other port tests.
torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny)        # 2**-126
FAST_SPEC = "planes=2,encoding=ent,act_quant=per_token,impl=planes"


def _every_bf16() -> np.ndarray:
    """Every finite bfloat16 value (65,280 of them), as float32."""
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return x[np.isfinite(x)]


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_activation_matches_reference_on_every_bf16(name):
    x = _every_bf16()
    want = np.asarray(jax.jit(JACTS[name])(
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = TACTS[name](torch.from_numpy(x).to(torch.bfloat16)).to(
        torch.float32).numpy()
    normal = np.abs(want) >= TINY
    np.testing.assert_array_equal(got[normal], want[normal])
    differ = got != want
    assert differ.sum() == {"silu": 511, "gelu": 508, "relu2": 511}[name]
    assert (want[differ] == 0).all()
    assert (np.abs(got[differ])
            <= 2 * TINY * np.maximum(1.0, np.abs(x[differ]))).all()


@pytest.fixture(scope="module")
def fast_lane():
    """Both packages' planes=2 smoke engines on the same params, and the
    prompt of the smoke lane's request 1."""
    jcfg = jget_config("minicpm-2b", smoke=True)
    jeng = JEngine(jcfg, 2, 16, quant=JSpec.parse(FAST_SPEC))
    tcfg = tget_config("minicpm-2b", smoke=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               device="cpu")
    teng = TEngine(tcfg, 2, 16, quant=TSpec.parse(FAST_SPEC), params=params,
                   device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 6).tolist() for _ in range(3)]
    return jeng, teng, prompts[1]


def test_fast_lane_request_1_equals_the_reference_op_by_op(fast_lane):
    jeng, teng, prompt = fast_lane
    api = jget_api(jeng.cfg)
    jstep = jax.jit(lambda p, t, pos, s: api.decode_step(p, t, pos, s,
                                                         jeng.cfg))
    jit_state = unbox(api.init_decode(jeng.cfg, 2, 16))
    eager_state = unbox(api.init_decode(jeng.cfg, 2, 16))
    tstate = teng.api.init_decode(teng.cfg, 2, 16, teng.device)
    for step, token in enumerate(prompt):
        tok = np.full((2, 1), token, np.int32)
        pos = np.full((2,), step, np.int32)
        jit_logits, jit_state = jstep(jeng.params, jnp.asarray(tok),
                                      jnp.asarray(pos), jit_state)
        with jax.disable_jit():
            eager_logits, eager_state = api.decode_step(
                jeng.params, jnp.asarray(tok), jnp.asarray(pos),
                eager_state, jeng.cfg)
        tlogits, tstate = teng.api.decode_step(
            teng.params, torch.from_numpy(tok), torch.from_numpy(pos),
            tstate, teng.cfg)
        got = tlogits.to(torch.float32).numpy()
        # equal, but for a few logits one bf16 ulp apart: the tied head's
        # bf16 product sums in another order in torch and XLA
        np.testing.assert_allclose(
            got, np.asarray(eager_logits.astype(jnp.float32)),
            rtol=2.0 ** -7, atol=0)
    served = np.asarray(jit_logits.astype(jnp.float32))[0, -1]
    # the flip of queue C: the port (and the reference op by op) pick 166,
    # the served reference 342 by a top-2 margin of 0.125
    assert int(got[0, -1].argmax()) == 166
    mine = np.sort(got[0, -1])[-2:]
    assert mine[1] - mine[0] == 0.65625
    assert int(served.argmax()) == 342
    top2 = np.sort(served)[-2:]
    assert top2[1] - top2[0] == 0.125
    assert np.abs(got[0, -1] - served).max() == 1.15625


def test_reference_jit_keeps_silu_times_up_in_float32(fast_lane):
    """The first op at which the served reference parts from the port:
    layer 0's down projection at step 0 of request 1."""
    jeng, teng, prompt = fast_lane
    spec = jeng.cfg.quant_spec()
    lp = jax.tree.map(lambda a: a[0], jeng.params["blocks"])
    x = JL.embed_apply(jeng.params["embed"],
                       jnp.full((2, 1), prompt[0], jnp.int32))
    n2 = JL.rmsnorm_apply(lp["ln2"], x)
    up = JL.dense_apply(lp["mlp"]["up"], n2, jnp.bfloat16, spec)
    gate = JL.dense_apply(lp["mlp"]["gate"], n2, jnp.bfloat16, spec)

    def down(h):
        return JL.dense_apply(lp["mlp"]["down"], h, jnp.bfloat16, spec)

    def f32(a):
        return np.asarray(a.astype(jnp.float32))

    served = f32(jax.jit(lambda g, u: down(JACTS["silu"](g) * u))(gate, up))
    eager = f32(down(JACTS["silu"](gate) * up))
    product_in_f32 = f32(down(JACTS["silu"](gate).astype(jnp.float32)
                              * up.astype(jnp.float32)))
    np.testing.assert_array_equal(served, product_in_f32)
    assert (served != eager).sum() == 2
    assert np.abs(served - eager).max() == 0.001953125
    # the port rounds the product to bf16, as the reference's source does
    tl = teng.params["blocks"][0]["mlp"]["down"]

    def t(a):
        return torch.from_numpy(f32(a)).to(torch.bfloat16)

    port = TL.dense_apply(tl, TACTS["silu"](t(gate)) * t(up), torch.bfloat16,
                          teng.cfg.quant_spec())
    np.testing.assert_array_equal(port.to(torch.float32).numpy(), eager)


def test_reference_without_excess_precision_emits_the_port_token():
    """The served reference step, jitted with XLA's excess precision off,
    picks the port's token for request 1 (it picks 342 with it on)."""
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.registry import get_config
        from repro.engine import QuantSpec
        from repro.models.api import get_api
        from repro.parallel.sharding import unbox
        from repro.serving.engine import ServeEngine
        cfg = get_config("minicpm-2b", smoke=True)
        eng = ServeEngine(cfg, 2, 16, quant=QuantSpec.parse(%r))
        rng = np.random.default_rng(0)
        prompt = [rng.integers(0, cfg.vocab_size, 6).tolist()
                  for _ in range(3)][1]
        api = get_api(eng.cfg)
        step = jax.jit(lambda p, t, pos, s: api.decode_step(p, t, pos, s,
                                                            eng.cfg))
        state = unbox(api.init_decode(eng.cfg, 2, 16))
        for i, tok in enumerate(prompt):
            logits, state = step(eng.params, jnp.full((2, 1), tok, jnp.int32),
                                 jnp.full((2,), i, jnp.int32), state)
        print(int(np.asarray(logits.astype(jnp.float32))[0, -1].argmax()))
    """ % FAST_SPEC)
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "166"
