"""The port's serving slice as a whole against the reference, and the
port's boundaries.

The reference's ServeEngine builds the minicpm-2b smoke params; the port
serves the same params (``convert.params_from_numpy``) on the CPU, on the
``e2e.quantized_forward_kernel`` lane of ``benchmarks/run.py``: 3 prompts
of 6 tokens, batch 2, max_len 16, 5 new tokens.  Greedy tokens must be
equal.

Per-step logits (bf16, magnitudes up to about 12) are compared in lock
step.  XLA fuses bf16 element-wise chains and rounds them differently
from torch's op-by-op bf16 (the silu's exp among them), so hidden states
differ by an ulp here and there.  On the bf16 path the logits must agree
within atol 0.125 (two ulps in [4, 8)).  On the quantized path the
3-plane grid (qmax 42, per-token scales) turns such an ulp into a whole
quantization step where it crosses a rounding boundary or moves a row's
max, so the logits must agree within atol 1.0.  A greedy flip is only
accepted where the reference's top-2 margin is within that tolerance.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.engine import QuantSpec as JSpec
from repro.models.api import get_api as jget_api
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.request import ServeRequest as JRequest
from repro_torch import resolve_device
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.serving.engine import ServeEngine as TEngine
from repro_torch.serving.request import ServeRequest as TRequest

# One torch thread: these tensors are small, and the suite runs in parallel
# workers beside timing-sensitive tests (the realtime server's heartbeat
# watchdog) that an oversubscribed CPU would fail.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = {None: 0.125, "pallas_fused": 1.0}


def _spec_text(impl):
    return f"planes=3,encoding=ent,impl={impl},act_quant=per_token"


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 6).tolist() for _ in range(3)]


def _port_engine(jeng, impl):
    tcfg = tget_config("minicpm-2b", smoke=True)
    tree = jax.tree.map(np.asarray, jeng.params)
    params = params_from_numpy(tree, tcfg, device="cpu")
    return TEngine(tcfg, 2, 16, quant=TSpec.parse(_spec_text(impl)),
                   params=params, device="cpu")


@pytest.mark.parametrize("impl", ["pallas_fused", "pallas", "planes"])
def test_smoke_lane_tokens_match_reference(impl):
    jcfg = jget_config("minicpm-2b", smoke=True)
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, 2, 16, quant=JSpec.parse(_spec_text(impl)))
    jreqs = [JRequest(i, list(p), 5) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng = _port_engine(jeng, impl)
    treqs = [TRequest(i, list(p), 5) for i, p in enumerate(prompts)]
    stats = teng.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert stats["requests"] == 3 and stats["generated_tokens"] == 15
    assert stats["engine_steps"] == jeng.steps
    if impl != "planes":
        assert teng.plan_stats["planned_weights"] == 7 * jcfg.n_layers
        assert teng.plan_stats["plane_block_density"] == \
            jeng.plan_density


@pytest.mark.parametrize("impl", [None, "pallas_fused"])
def test_decode_step_logits_match_reference(impl):
    """Lock-step decode on the same forced tokens: the port's logits
    against the reference's at every step, on the bf16 path and on the
    kernel route of the main spec."""
    jcfg = jget_config("minicpm-2b", smoke=True)
    jspec = JSpec.parse(_spec_text(impl)) if impl else None
    jeng = JEngine(jcfg, 2, 16, quant=jspec)
    tcfg = tget_config("minicpm-2b", smoke=True)
    teng = TEngine(tcfg, 2, 16,
                   quant=TSpec.parse(_spec_text(impl)) if impl else None,
                   params=params_from_numpy(
                       jax.tree.map(np.asarray, jeng.params), tcfg,
                       device="cpu"), device="cpu")
    api = jget_api(jeng.cfg)
    jstep = jax.jit(lambda p, t, pos, s: api.decode_step(p, t, pos, s,
                                                         jeng.cfg))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(8, 2)).astype(np.int32)
    jstate, tstate = jeng.state, teng.state
    atol = LOGIT_ATOL[impl]
    flips = []
    for step in range(tokens.shape[0]):
        tok = tokens[step][:, None]
        pos = np.full((2,), step, np.int32)
        jlogits, jstate = jstep(jeng.params, jnp.asarray(tok),
                                jnp.asarray(pos), jstate)
        tlogits, tstate = teng.api.decode_step(
            teng.params, torch.from_numpy(tok), torch.from_numpy(pos),
            tstate, teng.cfg)
        want = np.asarray(jlogits.astype(jnp.float32))[:, -1]
        got = tlogits.to(torch.float32).numpy()[:, -1]
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        for row in range(2):
            if got[row].argmax() != want[row].argmax():
                top2 = np.sort(want[row])[-2:]
                flips.append((step, row, float(top2[1] - top2[0])))
    assert all(margin <= atol for *_, margin in flips), flips


# The planes=3 lock-step gap with XLA's excess precision off in the
# reference: under 0.5 on this lane (0.64 with it on), with the logits
# equal at five or more of the eight steps.  It does not fall to a bf16
# ulp, so what is left is not excess precision; it is held below the
# gap with excess precision on.
LOCKSTEP_NO_EXCESS_ATOL = 0.5

_REFERENCE_LOCKSTEP = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.engine import QuantSpec
from repro.models.api import get_api
from repro.serving.engine import ServeEngine
cfg = get_config("minicpm-2b", smoke=True)
eng = ServeEngine(cfg, 2, 16, quant=QuantSpec.parse(%r))
api = get_api(eng.cfg)
step = jax.jit(lambda p, t, pos, s: api.decode_step(p, t, pos, s, eng.cfg))
tokens = np.random.default_rng(1).integers(
    0, cfg.vocab_size, size=(8, 2)).astype(np.int32)
state, out = eng.state, []
for i in range(tokens.shape[0]):
    logits, state = step(eng.params, jnp.asarray(tokens[i][:, None]),
                         jnp.full((2,), i, jnp.int32), state)
    out.append(np.asarray(logits.astype(jnp.float32))[:, -1])
np.save(sys.argv[1], np.stack(out))
"""


def test_decode_step_logits_without_excess_precision(tmp_path):
    """test_decode_step_logits_match_reference's lock step on the kernel
    route, the reference jitted in a process with XLA's excess precision
    off: the logits agree within LOCKSTEP_NO_EXCESS_ATOL at every step and
    exactly at most."""
    spec = _spec_text("pallas_fused")
    out = tmp_path / "ref.npy"
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE_LOCKSTEP % spec, str(out)],
        env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    want = np.load(out)
    jcfg = jget_config("minicpm-2b", smoke=True)
    jeng = JEngine(jcfg, 2, 16, quant=JSpec.parse(spec))
    teng = _port_engine(jeng, "pallas_fused")
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(8, 2)).astype(np.int32)
    tstate, exact = teng.state, 0
    for step in range(tokens.shape[0]):
        tlogits, tstate = teng.api.decode_step(
            teng.params, torch.from_numpy(tokens[step][:, None]),
            torch.from_numpy(np.full((2,), step, np.int32)), tstate,
            teng.cfg)
        got = tlogits.to(torch.float32).numpy()[:, -1]
        np.testing.assert_allclose(got, want[step], rtol=0,
                                   atol=LOCKSTEP_NO_EXCESS_ATOL)
        exact += bool(np.array_equal(got, want[step]))
    assert exact >= 5


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                     "--batch", "2", "--prompt-len", "5", "--max-tokens",
                     "3", "--quant-spec", _spec_text("pallas_fused"),
                     "--json"])
    assert rc == 0
    assert '"generated_tokens": 9' in capsys.readouterr().out


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tget_config("minicpm-2b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(cfg, 1, 8, quant=TSpec.parse(_spec_text("pallas_fused")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"blocks": {}}, cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1"])


def test_port_imports_neither_jax_nor_reference():
    """A fresh interpreter imports the port's kernels, serving and launch
    modules without loading jax or repro; no port source (nor
    chip_smoke.py) names them in an import."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "repro"), (path, name)


def test_chip_smoke_fails_without_card(tmp_path):
    """chip_smoke.py exits non-zero with no result line when there is no
    card, and alone in a directory without the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        res = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
