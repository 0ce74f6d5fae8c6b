"""The port's kernel-level API -- the EN-T encoder (B7), the parallel-MAC
baseline GEMMs (B9 quant_gemm, B8 quant_gemm_fused) and the
``PlannedOperand`` wrappers of B1/B2 -- against the reference package on
the same numpy inputs.  The reference's Pallas kernels run in interpret
mode, as its own tests run them on the CPU; the port's wrappers take
their plain versions for CPU tensors.

Tolerances: digits, masks, plans and int32 products are compared bit for
bit, and so are dequantized outputs without a bias whose activation is
plain float arithmetic (none, relu2).  With a bias the packages differ by
an ulp (rtol 1e-6, atol 1e-6): XLA on the CPU contracts ``acc * s +
bias`` into one fused multiply-add, which the port does not.  silu and
gelu agree within rtol 1e-5, atol 1e-6 (XLA's and torch's exp/tanh differ
by a few ulps; gelu's 1 + tanh cancels at negative inputs).  A bfloat16
output is the float32 result rounded once, so where the float32 results
differ by an ulp the bfloat16 ones may differ by one bfloat16 ulp
(rtol 2**-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import encode as jenc
from repro.kernels import ops as jops
from repro.kernels import quant_gemm as jqg
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec as TSpec
from repro_torch.kernels import bw_gemm as tbw
from repro_torch.kernels import encode as tenc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_gemm as tqg
from repro_torch.kernels import ref as tref

# One torch thread: these tensors are small, and the suite runs in parallel
# workers beside timing-sensitive tests that an oversubscribed CPU fails.
torch.set_num_threads(1)

ACT_TOL = dict(rtol=1e-5, atol=1e-6)
BIAS_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
ACTIVATIONS = (None, "silu", "gelu", "relu2")


def _int8(rng, shape, lim=128):
    return rng.integers(-lim, lim, size=shape).astype(np.int8)


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _close(got, want, *, exact, bias, activation, bf16=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if exact:
        np.testing.assert_array_equal(got, want)
    elif bf16:
        np.testing.assert_allclose(got, want, **BF16_TOL)
    elif activation in ("silu", "gelu"):
        np.testing.assert_allclose(got, want, **ACT_TOL)
    else:
        assert bias
        np.testing.assert_allclose(got, want, **BIAS_TOL)


def _exact_epilogue(bias, activation) -> bool:
    return bias is None and activation in (None, "relu2")


# ---------------------------------------------------------------------------
# B7 ent_encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,bm,bk", [(128, 128, 128, 128),
                                       (256, 384, 128, 128),
                                       (384, 256, 128, 256)])
def test_ent_encode_matches_reference(m, k, bm, bk):
    x = _int8(np.random.default_rng(m + k), (m, k))
    want_d, want_m = jenc.ent_encode(jnp.asarray(x), block_m=bm, block_k=bk,
                                     interpret=True)
    for fn in (tenc.ent_encode_plain, tenc.ent_encode):
        d, mask = fn(torch.from_numpy(x), block_m=bm, block_k=bk)
        assert d.dtype == torch.int8 and mask.dtype == torch.bool
        np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_m))


def test_ent_encode_every_int8_value():
    """The 256 int8 values tiled into one 128 x 256 block: the reference's
    digits, the reference's decode, and the carry chain's edge cases."""
    x = np.tile(np.arange(-128, 128, dtype=np.int8), 128).reshape(128, 256)
    want_d, want_m = jenc.ent_encode(jnp.asarray(x), block_m=128,
                                     block_k=256, interpret=True)
    d, mask = tenc.ent_encode(torch.from_numpy(x), block_m=128, block_k=256)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_m))
    back = (d.numpy().astype(np.int64)
            * np.asarray([1, 4, 16, 64])[:, None, None]).sum(axis=0)
    np.testing.assert_array_equal(back, x.astype(np.int64))
    assert d[:, 0, 0].tolist() == [0, 0, 0, -2]        # -128
    assert d[:, 0, 255].tolist() == [-1, 0, 0, 2]      # 127
    np.testing.assert_array_equal(
        d.numpy(), tref.encode_planes_ref(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("value,plane", [(1, 0), (-4, 1), (16, 2), (64, 3)])
def test_ent_encode_mask_of_a_single_plane_block(value, plane):
    """A block whose only non-zero digits sit in one plane flags that plane
    alone; the other blocks flag nothing."""
    x = np.zeros((256, 256), np.int8)
    x[130, 7] = value                                   # block (1, 0)
    want_d, want_m = jenc.ent_encode(jnp.asarray(x), block_m=128,
                                     block_k=128, interpret=True)
    d, mask = tenc.ent_encode(torch.from_numpy(x), block_m=128, block_k=128)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_m))
    expect = np.zeros((4, 2, 2), bool)
    expect[plane, 1, 0] = True
    np.testing.assert_array_equal(mask.numpy(), expect)


# ---------------------------------------------------------------------------
# plan_operand(encode_impl=), encode_planes, plane_density
# ---------------------------------------------------------------------------

_PLAN_FIELDS = ("digits", "mask", "schedule", "row_perm", "inv_perm")
_PLAN_SCALARS = ("m", "k", "block_m", "block_k", "encoding", "order")


def _assert_plans_equal(tp, jp):
    for f in _PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in _PLAN_SCALARS:
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_plan_operand_kernel_encode_matches_reference(planes):
    rng = np.random.default_rng(planes)
    w = rng.standard_normal((300, 200)).astype(np.float32)
    w[:, 3] *= 20.0                                     # an outlier row
    q, _ = jquant.quantize_to_planes(jnp.asarray(w), planes, axis=0)
    a = np.asarray(q).T.copy()                          # [200, 300]
    jp = jops.plan_operand(jnp.asarray(a), "ent", 128, 256,
                           encode_impl="kernel")
    tp = tops.plan_operand(torch.from_numpy(a), "ent", 128, 256,
                           encode_impl="kernel")
    _assert_plans_equal(tp, jp)
    _assert_plans_equal(tops.plan_operand(torch.from_numpy(a), "ent", 128,
                                          256, encode_impl="ref"), jp)


@pytest.mark.parametrize("encoding,bits,lim", [("mbe", 8, 128),
                                                ("ent", 4, 8)])
def test_plan_operand_kernel_takes_the_oracle_outside_ent_int8(encoding,
                                                               bits, lim):
    """The reference's contract: only EN-T int8 reaches the kernel; any
    other encoding or width plans with the oracle."""
    a = _int8(np.random.default_rng(bits), (150, 260), lim)
    jp = jops.plan_operand(jnp.asarray(a), encoding, 128, 128,
                           encode_impl="kernel", bits=bits)
    before = tenc.ent_encode.launches
    tp = tops.plan_operand(torch.from_numpy(a), encoding, 128, 128,
                           encode_impl="kernel", bits=bits)
    assert tenc.ent_encode.launches == before     # CPU: never launches
    _assert_plans_equal(tp, jp)
    _assert_plans_equal(tops.plan_operand(torch.from_numpy(a), encoding,
                                          128, 128, bits=bits), jp)


def test_plan_operand_rejects_an_unknown_encode_impl():
    with pytest.raises(ValueError, match="encode_impl"):
        tops.plan_operand(torch.zeros(4, 4, dtype=torch.int8),
                          encode_impl="pallas")


def test_encode_planes_and_plane_density_match_reference():
    a = _int8(np.random.default_rng(5), (256, 512), 42)   # 3 planes
    want = jops.encode_planes(jnp.asarray(a))
    got = tops.encode_planes(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tops.plane_density(got, 128, 256) == jops.plane_density(
        want, 128, 256)
    assert tops.plane_density(got, 128, 256)["plane3"] == 0.0


# ---------------------------------------------------------------------------
# B9 quant_gemm and the ops wrappers
# ---------------------------------------------------------------------------

SHAPES = [(128, 256, 128), (256, 256, 256), (128, 512, 384), (384, 256, 128)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_gemm_matches_reference(m, k, n):
    rng = np.random.default_rng(m * k + n)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    bk = 256 if k % 256 == 0 else 128
    want = np.asarray(jqg.quant_gemm(jnp.asarray(a), jnp.asarray(b),
                                     block_m=128, block_n=128, block_k=bk,
                                     interpret=True))
    for fn in (tqg.quant_gemm_plain, tqg.quant_gemm):
        got = fn(torch.from_numpy(a), torch.from_numpy(b), block_m=128,
                 block_n=128, block_k=bk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.quant_gemm_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        want)


@pytest.mark.parametrize("m,k,n", [(100, 200, 60), (1, 256, 1),
                                   (37, 73, 5)])
def test_ops_quant_gemm_and_bw_gemm_on_unaligned_shapes(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    want = a.astype(np.int64) @ b.astype(np.int64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tops.quant_gemm(ta, tb)
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.quant_gemm(jnp.asarray(a),
                                                jnp.asarray(b))))
    planned = tops.plan_operand(ta, block_m=128, block_k=128)
    got = tops.bw_gemm(planned, tb)
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jplanned = jops.plan_operand(jnp.asarray(a), block_m=128, block_k=128)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.bw_gemm(jplanned, jnp.asarray(b))))


def test_ops_quant_gemm_at_decode_with_an_odd_m():
    """T=4 through the ops wrappers, which pad only K (to 16) where the
    reference pads all three to its 128 x 128 x 256 blocks: B9 with 301
    weight rows against 4 token columns, and B8 with 4 token rows against
    301 output channels, equal to the reference."""
    rng = np.random.default_rng(301)
    w, x = _int8(rng, (301, 200)), _int8(rng, (4, 200))
    got = tops.quant_gemm(torch.from_numpy(w), torch.from_numpy(x.T.copy()))
    assert got.shape == (301, 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.quant_gemm(
        jnp.asarray(w), jnp.asarray(x.T.copy()))))
    scale = (rng.random(301) * 1e-3).astype(np.float32)
    got = tops.quant_gemm_fused(torch.from_numpy(x),
                                torch.from_numpy(w.T.copy()),
                                torch.from_numpy(scale))
    assert got.shape == (4, 301)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.quant_gemm_fused(jnp.asarray(x), jnp.asarray(w.T.copy()),
                              jnp.asarray(scale))))


# ---------------------------------------------------------------------------
# B8 quant_gemm_fused and the ops wrappers of B8 / B1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("axis", ["n", "m"])
def test_quant_gemm_fused_matches_reference(axis, with_bias, activation,
                                            out_dtype):
    m, k, n = 128, 256, 128
    rng = np.random.default_rng(7)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    shape = (1, n) if axis == "n" else (m, 1)
    scale = (rng.random(shape) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(shape).astype(np.float32) if with_bias \
        else None
    want = jqg.quant_gemm_fused(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), interpret=True,
        activation=activation, epilogue_axis=axis,
        out_dtype=getattr(jnp, out_dtype))
    want = np.asarray(want, np.float32)
    t = torch.from_numpy
    for fn in (tqg.quant_gemm_fused_plain, tqg.quant_gemm_fused):
        got = fn(t(a), t(b), t(scale), None if bias is None else t(bias),
                 activation=activation, epilogue_axis=axis,
                 out_dtype=getattr(torch, out_dtype))
        assert got.dtype == getattr(torch, out_dtype)
        _close(_np(got), want, exact=_exact_epilogue(bias, activation),
               bias=with_bias, activation=activation,
               bf16=out_dtype == "bfloat16")


def test_ops_quant_gemm_fused_matches_reference():
    """tests/test_fused_path.py's case: unaligned shapes, a bias, silu."""
    rng = np.random.default_rng(88)
    a = _int8(rng, (100, 200))
    b = _int8(rng, (200, 60))
    scale = (rng.random(60) * 0.01).astype(np.float32)
    bias = rng.normal(0, 1, size=(60,)).astype(np.float32)
    want = np.asarray(jops.quant_gemm_fused(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale),
        jnp.asarray(bias), activation="silu"))
    t = torch.from_numpy
    got = tops.quant_gemm_fused(t(a), t(b), t(scale), t(bias),
                                activation="silu")
    assert got.shape == (100, 60)
    np.testing.assert_allclose(got.numpy(), want, **ACT_TOL)
    acc = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.float32)
    y = acc * scale + bias
    np.testing.assert_allclose(got.numpy(), y / (1 + np.exp(-y)), rtol=1e-5,
                               atol=1e-5)
    got = tops.quant_gemm_fused(t(a), t(b), t(scale), out_dtype=torch.bfloat16)
    want = np.asarray(jops.quant_gemm_fused(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale),
        out_dtype=jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("activation", [None, "silu"])
@pytest.mark.parametrize("planes", [2, 3])
def test_ops_bw_gemm_fused_matches_reference(planes, activation):
    rng = np.random.default_rng(10 + planes)
    w = rng.standard_normal((300, 200)).astype(np.float32)
    q, sw = jquant.quantize_to_planes(jnp.asarray(w), planes, axis=0)
    a = np.asarray(q).T.copy()                          # [200, 300]
    b = _int8(rng, (300, 3), 43)
    scale = np.asarray(sw).reshape(-1) * np.float32(0.02)
    jp = jops.plan_operand(jnp.asarray(a), "ent", 128, 256)
    want = np.asarray(jops.bw_gemm_fused(jp, jnp.asarray(b),
                                         jnp.asarray(scale),
                                         activation=activation))
    tp = tops.plan_operand(torch.from_numpy(a), "ent", 128, 256)
    got = tops.bw_gemm_fused(tp, torch.from_numpy(b),
                             torch.from_numpy(scale), activation=activation)
    assert got.shape == (200, 3) and got.dtype == torch.float32
    _close(got.numpy(), want, exact=activation is None, bias=False,
           activation=activation)
    got = tops.bw_gemm_fused(tp, torch.from_numpy(b), torch.from_numpy(scale),
                             activation=activation, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("planes", [2, 3])
def test_parallel_mac_equals_bit_weight_gemm(planes):
    """The identities the card checks on every weight of the full-width
    model, on a small one: B9 on the planned orientation equals B2 on the
    plan, and B8 on the serving orientation equals B1, bit for bit."""
    spec = TSpec.parse(f"planes={planes},encoding=ent,act_quant=per_token")
    rng = np.random.default_rng(20 + planes)
    w = torch.from_numpy(rng.standard_normal((300, 200)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    qw, sw = tquant.quantize_for_spec(w, spec, axis=0)    # [300, 200]
    bm, bk, _ = tops.select_block_sizes(200, 300, 128, spec)
    planned = tops.plan_operand(qw.t(), spec.encoding, bm, bk,
                                encode_impl="kernel", bits=spec.bits)
    _assert_plans_equal(planned, tops.plan_operand(
        qw.t(), spec.encoding, bm, bk, encode_impl="ref", bits=spec.bits))
    xq, _ = tquant.quantize_for_spec(x, spec, axis=-1)    # [4, 300]
    torch.testing.assert_close(tops.quant_gemm(qw.t(), xq.t()),
                               tops.bw_gemm(planned, xq.t()), rtol=0, atol=0)
    _, sx = tquant.quantize_for_spec(x, spec)              # per tensor
    s = (sw * sx).reshape(-1)
    for act in (None, "silu"):
        torch.testing.assert_close(
            tops.quant_gemm_fused(xq, qw, s, activation=act).t(),
            tops.bw_gemm_fused(planned, xq.t(), s, activation=act),
            rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Malformed operands: every entry point raises, none falls back
# ---------------------------------------------------------------------------

def test_kernel_api_rejects_malformed_operands():
    rng = np.random.default_rng(3)
    t = torch.from_numpy
    x = t(_int8(rng, (256, 256)))
    a, b = t(_int8(rng, (128, 256))), t(_int8(rng, (256, 128)))
    meta_b = torch.empty(b.shape, dtype=torch.int8, device="meta")
    scale_n, scale_m = torch.ones(1, 128), torch.ones(128, 1)

    # shapes that do not divide the blocks (kernel level)
    with pytest.raises(ValueError, match="block_k"):
        tenc.ent_encode(x, block_m=128, block_k=96)
    with pytest.raises(ValueError, match="block_m"):
        tenc.ent_encode(x[:200], block_m=128, block_k=128)
    with pytest.raises(TypeError, match="int8"):
        tenc.ent_encode(x.to(torch.int32))
    with pytest.raises(ValueError, match="block_n"):
        tqg.quant_gemm(a, b[:, :100])
    with pytest.raises(ValueError, match="block_m"):
        tqg.quant_gemm_fused(a[:4], b, scale_n)
    # mismatched K
    with pytest.raises(ValueError, match="K="):
        tqg.quant_gemm(a, b[:128], block_k=128)
    with pytest.raises(ValueError, match="K="):
        tqg.quant_gemm_fused(a, b[:128], scale_n, block_k=128)
    with pytest.raises(ValueError, match="inner-dim"):
        tops.quant_gemm(a, b[:200])
    with pytest.raises(ValueError, match="inner-dim"):
        tops.quant_gemm_fused(a, b[:200], torch.ones(128))
    planned = tops.plan_operand(a, block_m=128, block_k=256)
    with pytest.raises(ValueError, match="K="):
        tops.bw_gemm(planned, b[:200])
    with pytest.raises(ValueError, match="K="):
        tops.bw_gemm_fused(planned, b[:200], torch.ones(128))
    # a wrong scale shape for the epilogue axis
    with pytest.raises(ValueError, match="scale shape"):
        tqg.quant_gemm_fused(a, b, scale_m)                 # axis 'n'
    with pytest.raises(ValueError, match="scale shape"):
        tqg.quant_gemm_fused(a, b, scale_n, epilogue_axis="m")
    with pytest.raises(ValueError, match="bias shape"):
        tqg.quant_gemm_fused(a, b, scale_n, scale_m)
    with pytest.raises(ValueError, match="epilogue_axis"):
        tqg.quant_gemm_fused(a, b, scale_n, epilogue_axis="k")
    with pytest.raises(ValueError, match="scale"):
        tops.quant_gemm_fused(a, b, torch.ones(100))
    with pytest.raises(ValueError, match="bias"):
        tops.quant_gemm_fused(a, b, torch.ones(128), torch.ones(100))
    with pytest.raises(ValueError, match="scale"):
        tops.bw_gemm_fused(planned, b, torch.ones(100))
    # an unknown activation
    with pytest.raises(ValueError, match="activation"):
        tqg.quant_gemm_fused(a, b, scale_n, activation="tanh")
    with pytest.raises(ValueError, match="activation"):
        tops.quant_gemm_fused(a, b, torch.ones(128), activation="tanh")
    with pytest.raises(ValueError, match="activation"):
        tops.bw_gemm_fused(planned, b, torch.ones(128), activation="tanh")
    with pytest.raises(TypeError, match="out_dtype"):
        tqg.quant_gemm_fused(a, b, scale_n, out_dtype=torch.int32)
    # operands on different devices
    with pytest.raises(ValueError, match="must be on"):
        tqg.quant_gemm(a, meta_b)
    with pytest.raises(ValueError, match="must be on"):
        tqg.quant_gemm_fused(a, b, scale_n.to("meta"))
    with pytest.raises(ValueError, match="must be on"):
        tops.quant_gemm(a, meta_b)
    with pytest.raises(ValueError, match="must be on"):
        tops.quant_gemm_fused(a, b, torch.ones(128), torch.ones(128,
                                                               device="meta"))
    with pytest.raises(ValueError, match="must be on"):
        tops.bw_gemm(planned, meta_b)
    with pytest.raises(ValueError, match="must be on"):
        tops.bw_gemm_fused(planned, b, torch.ones(128, device="meta"))
    # none of these reached a kernel
    assert tenc.ent_encode.launches == 0
    assert tqg.quant_gemm.launches == 0
    assert tqg.quant_gemm_fused.launches == 0
    assert tbw.bw_gemm.launches == 0 and tbw.bw_gemm_fused.launches == 0
