"""The port's weight plans, kernel plain versions, planned apply and GEMM
engines against the reference package on the same numpy inputs.  The
reference's Pallas kernels run in interpret mode, as its own tests run
them on the CPU; the port's wrappers take their plain versions for CPU
tensors.

Tolerances: integer results (plans, int32 accumulators) are compared
bit for bit, and so are dequantized outputs without bias or activation
(the same float32 multiplies in the same order).  With a bias they agree
within rtol 1e-6, atol 1e-6: XLA on the CPU contracts ``acc * s + bias``
into one fused multiply-add, which the port (like its CUDA kernel) does
not.  With an activation they agree within rtol 1e-5, atol 1e-6: XLA's
and torch's exp/tanh differ by a few ulps, and the tanh-form gelu loses
relative precision to 1 + tanh cancellation at negative inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import QuantSpec as JSpec
from repro.engine import get_engine as jget_engine
from repro.kernels import bw_gemm as jbw
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.engine import get_engine as tget_engine
from repro_torch.kernels import bw_gemm as tbw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# One torch thread: these tensors are small, and the suite runs in parallel
# workers beside timing-sensitive tests (the realtime server's heartbeat
# watchdog) that an oversubscribed CPU would fail.
torch.set_num_threads(1)

ACT_TOL = dict(rtol=1e-5, atol=1e-6)
BIAS_TOL = dict(rtol=1e-6, atol=1e-6)
MAIN_SPEC = "planes=3,encoding=ent,impl=pallas_fused,act_quant=per_token"

# (d_in, d_out) weight shapes: none a multiple of the plan blocks on both
# axes, and none that the reference's autotune cache holds an entry for
# ((m, k) = (192, 256) and (256, 256)), so both packages plan with the
# static block table.
WEIGHT_SHAPES = [(200, 130), (300, 520), (520, 300), (64, 40)]


def _weight(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])
    w[:, 0] *= 30.0                        # an outlier channel
    return w


def _both_plans(w, text):
    jspec, tspec = JSpec.parse(text), TSpec.parse(text)
    jplan = jops.plan_dense_weight(jnp.asarray(w), jspec, use_cache=False,
                                   verify=False)
    tplan = tops.plan_dense_weight(torch.from_numpy(w), tspec)
    return jplan, tplan, jspec, tspec


@pytest.mark.parametrize("shape,text", [
    *((shape, MAIN_SPEC) for shape in WEIGHT_SHAPES),
    ((300, 520), "planes=4,encoding=mbe"),
    ((200, 130), "planes=8,encoding=bitserial"),
    ((520, 300), "planes=2,encoding=ent,block_m=256")])
def test_plan_arrays_match_reference(shape, text):
    jplan, tplan, _, _ = _both_plans(_weight(shape, 1), text)
    assert set(tplan) == set(jplan)
    for key in ("digits", "mask", "schedule", "row_perm", "inv_perm",
                "sw_rows"):
        want = np.asarray(jplan[key])
        got = tplan[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def _kernel_case(shape, n, seed):
    """A plan from the reference, an extra False block over non-zero
    digits, and int8 activations [N, K_pad] / [K_pad, N_pad]."""
    jplan, _, _, _ = _both_plans(_weight(shape, seed), MAIN_SPEC)
    digits = np.array(jplan["digits"])
    mask = np.array(jplan["mask"])
    bm = digits.shape[1] // mask.shape[1]
    bk = digits.shape[2] // mask.shape[2]
    assert digits[0, :bm, :bk].any()
    mask[0, 0, 0] = False
    rng = np.random.default_rng(seed + 100)
    b = rng.integers(-42, 43, size=(n, digits.shape[2])).astype(np.int8)
    b_pad = np.zeros((digits.shape[2], 128), np.int8)
    b_pad[:, :n] = b.T
    return digits, mask, b, b_pad, bm, bk


@pytest.mark.parametrize("shape,n", [((300, 520), 1), ((520, 300), 3),
                                     ((200, 130), 4)])
def test_bw_gemm_plain_matches_reference(shape, n):
    digits, mask, b, b_pad, bm, bk = _kernel_case(shape, n, 2)
    want = np.asarray(jbw.bw_gemm(
        jnp.asarray(digits), jnp.asarray(b_pad), jnp.asarray(mask),
        block_m=bm, block_n=128, block_k=bk, interpret=True))[:, :n]
    np.testing.assert_array_equal(
        want, np.asarray(jref.bw_gemm_masked_ref(
            jnp.asarray(digits), jnp.asarray(b_pad), jnp.asarray(mask), bm,
            bk))[:, :n])
    got = tbw.bw_gemm(torch.from_numpy(digits), torch.from_numpy(b),
                      torch.from_numpy(mask), block_m=bm, block_k=bk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.bw_gemm_masked_ref(torch.from_numpy(digits),
                                torch.from_numpy(b).t(),
                                torch.from_numpy(mask), bm, bk).numpy(),
        want)


@pytest.mark.parametrize("activation,with_bias", [
    (None, False), (None, True), ("silu", True), ("gelu", True),
    ("relu2", False)])
@pytest.mark.parametrize("axis", ["m", "n"])
def test_bw_gemm_fused_plain_matches_reference(activation, with_bias,
                                               axis):
    n = 3
    digits, mask, b, b_pad, bm, bk = _kernel_case((300, 520), n, 3)
    m = digits.shape[1]
    rng = np.random.default_rng(4)
    if axis == "m":
        scale = rng.uniform(1e-4, 1e-2, (m, 1)).astype(np.float32)
        bias = rng.standard_normal((m, 1)).astype(np.float32)
        scale_n = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
        j_scale, j_bias = scale, bias
        j_scale_n = np.ones((1, 128), np.float32)
        j_scale_n[:, :n] = scale_n
    else:
        scale = rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)
        bias = rng.standard_normal((1, n)).astype(np.float32)
        scale_n = j_scale_n = None
        j_scale = np.ones((1, 128), np.float32)
        j_scale[:, :n] = scale
        j_bias = np.zeros((1, 128), np.float32)
        j_bias[:, :n] = bias
    if not with_bias:
        bias = j_bias = None
    want = np.asarray(jbw.bw_gemm_fused(
        jnp.asarray(digits), jnp.asarray(b_pad), jnp.asarray(mask),
        jnp.asarray(j_scale),
        None if j_bias is None else jnp.asarray(j_bias),
        None if j_scale_n is None else jnp.asarray(j_scale_n),
        block_m=bm, block_n=128, block_k=bk, interpret=True,
        activation=activation, epilogue_axis=axis))[:, :n]
    t = torch.from_numpy
    got = tbw.bw_gemm_fused(
        t(digits), t(b), t(mask), t(scale),
        None if bias is None else t(bias),
        None if scale_n is None else t(scale_n), block_m=bm, block_k=bk,
        activation=activation, epilogue_axis=axis).numpy()
    if activation is not None:
        np.testing.assert_allclose(got, want, **ACT_TOL)
    elif with_bias:
        np.testing.assert_allclose(got, want, **BIAS_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("act_quant", ["per_token", "per_tensor"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_planned_dense_apply_matches_reference(fused, act_quant, epilogue):
    text = f"planes=3,encoding=ent,act_quant={act_quant}"
    w = _weight((300, 520), 5)
    jplan, tplan, jspec, tspec = _both_plans(w, text)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 300)).astype(np.float32)
    bias = rng.standard_normal(520).astype(np.float32) if epilogue else None
    act = "silu" if epilogue else None
    want = np.asarray(jops.planned_dense_apply(
        jplan, jnp.asarray(x), jspec, 520,
        bias=None if bias is None else jnp.asarray(bias), activation=act,
        interpret=True, fused=fused))
    got = tops.planned_dense_apply(
        tplan, torch.from_numpy(x), tspec, 520,
        bias=None if bias is None else torch.from_numpy(bias),
        activation=act, fused=fused).numpy()
    assert got.shape == want.shape == (2, 3, 520)
    if epilogue:
        np.testing.assert_allclose(got, want, **ACT_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["ref", "planes", "int8", "pallas",
                                  "pallas_fused"])
def test_engines_match_reference(impl):
    text = f"planes=3,encoding=ent,act_quant=per_token,impl={impl}"
    w = _weight((200, 130), 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 200)).astype(np.float32)
    want = np.asarray(jget_engine(impl).apply(
        jnp.asarray(w), jnp.asarray(x), JSpec.parse(text),
        out_dtype=jnp.float32))
    got = tget_engine(impl).apply(torch.from_numpy(w), torch.from_numpy(x),
                                  TSpec.parse(text)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantized_dense_and_plan_params():
    spec = TSpec.parse(MAIN_SPEC)
    w = torch.from_numpy(_weight((64, 40), 9))
    x = torch.from_numpy(
        np.random.default_rng(10).standard_normal((5, 64)).astype(
            np.float32))
    got = tops.quantized_dense(x, w, spec)
    want = tget_engine("planes").apply(w, x, spec)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    tree = {"a": {"w": w}, "blocks": [{"b": {"w": w.t().contiguous()}}],
            "norm": {"scale": torch.ones(4)}}
    planned, count = tops.plan_params(tree, spec)
    assert count == 2 and "w_plan" not in tree["a"]
    assert set(planned["a"]["w_plan"]) == {"digits", "mask", "schedule",
                                           "row_perm", "inv_perm",
                                           "sw_rows"}
    masks = [planned["a"]["w_plan"]["mask"],
             planned["blocks"][0]["b"]["w_plan"]["mask"]]
    want_density = sum(int(m.sum()) for m in masks) / \
        sum(m.numel() for m in masks)
    assert tops.plan_tree_density(planned) == want_density
    assert tops.plan_tree_density(tree) is None


def test_wrappers_reject_malformed_operands():
    digits, mask, b, _, bm, bk = _kernel_case((200, 130), 2, 11)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="K="):
        tbw.bw_gemm(t(digits), t(b[:, :-16].copy()), t(mask), block_m=bm,
                    block_k=bk)
    with pytest.raises(ValueError, match="mask shape"):
        tbw.bw_gemm(t(digits), t(b), t(mask[:, :, :1].copy()), block_m=bm,
                    block_k=bk)
    with pytest.raises(ValueError, match="activation"):
        tbw.bw_gemm_fused(t(digits), t(b), t(mask),
                          torch.ones(digits.shape[1], 1), block_m=bm,
                          block_k=bk, activation="tanh")
    with pytest.raises(ValueError, match="scale_n"):
        tbw.bw_gemm_fused(t(digits), t(b), t(mask), torch.ones(1, 2),
                          scale_n=torch.ones(1, 2), block_m=bm, block_k=bk,
                          epilogue_axis="n")
    plan = tops.plan_dense_weight(t(_weight((64, 40), 12)),
                                  TSpec.parse(MAIN_SPEC))
    x = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="digit planes"):
        tops.planned_dense_apply(plan, x, TSpec.parse("planes=3,"
                                                      "encoding=bitserial"),
                                 40)
    with pytest.raises(ValueError, match="dispatch"):
        tops.planned_dense_apply(plan, x, TSpec.parse(MAIN_SPEC), 40,
                                 dispatch="bogus")
    with pytest.raises(TypeError, match="int32"):
        tops.planned_dense_apply(dict(plan, schedule=torch.zeros(1, 9)), x,
                                 TSpec.parse(MAIN_SPEC), 40,
                                 dispatch="sparse")
    assert tops.planned_dense_apply(
        dict(plan, schedule=None), x, TSpec.parse(MAIN_SPEC), 40,
        dispatch="auto").shape == (1, 40)
