"""The port's encodings, quantization grid, exact digit-plane matmul and
QuantSpec against the reference package, on the same numpy inputs.

Everything compared here is integer or exactly rounded, so every check is
bit-for-bit equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bw_ref as jbw_ref
from repro.core import encodings as jenc
from repro.core import quant as jquant
from repro.engine import QuantSpec as JSpec
from repro_torch.core import bw_ref as tbw_ref
from repro_torch.core import encodings as tenc
from repro_torch.core import quant as tquant
from repro_torch.engine import QuantSpec as TSpec

# One torch thread: these tensors are small, and the suite runs in parallel
# workers beside timing-sensitive tests (the realtime server's heartbeat
# watchdog) that an oversubscribed CPU would fail.
torch.set_num_threads(1)

ENCODINGS = ("mbe", "ent", "bitserial", "bitserial_sm")
ALL_INT8 = np.arange(-128, 128, dtype=np.int8)


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("bits", [8, 6])
def test_digits_identical_for_every_int8_value(encoding, bits):
    x = ALL_INT8 if bits == 8 else np.arange(-32, 32, dtype=np.int8)
    want = np.asarray(jenc.encode_jnp(jnp.asarray(x), encoding, bits))
    got = tenc.encode_torch(torch.from_numpy(x), encoding, bits).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tenc.encode_np(x, encoding, bits), want)
    np.testing.assert_array_equal(
        tenc.decode_torch(torch.from_numpy(got), encoding, bits).numpy(),
        x.astype(np.int32))


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_encoding_geometry_matches(encoding):
    for bits in (2, 4, 8):
        assert tenc.num_digits(encoding, bits) == \
            jenc.num_digits(encoding, bits)
        np.testing.assert_array_equal(tenc.digit_weights(encoding, bits),
                                      jenc.digit_weights(encoding, bits))
    assert tenc.radix(encoding) == jenc.radix(encoding)


def _floats(seed, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[3] *= 40.0                         # a row with outliers
    return x


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
@pytest.mark.parametrize("axis", [None, 0, -1])
@pytest.mark.parametrize("radix", [4, 2])
def test_quantize_to_planes_bitidentical(planes, axis, radix):
    x = _floats(planes)
    q_ref, s_ref = jquant.quantize_to_planes(jnp.asarray(x), planes,
                                             axis=axis, radix=radix)
    q, s = tquant.quantize_to_planes(torch.from_numpy(x), planes, axis=axis,
                                     radix=radix)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert tquant.plane_qmax(planes, radix) == jquant.plane_qmax(planes,
                                                                 radix)


@pytest.mark.parametrize("axis", [None, 0])
def test_symmetric_scale_and_quantize_bitidentical(axis):
    x = _floats(7)
    s_ref = jquant.symmetric_scale(jnp.asarray(x), axis=axis)
    s = tquant.symmetric_scale(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(
        tquant.quantize(torch.from_numpy(x), s).numpy(),
        np.asarray(jquant.quantize(jnp.asarray(x), s_ref)))


@pytest.mark.parametrize("text", [
    "planes=3,encoding=ent,impl=pallas_fused,act_quant=per_token",
    "planes=4,encoding=mbe,impl=pallas",
    "planes=8,encoding=bitserial,bits=8,impl=planes",
    "planes=2,encoding=ent,impl=ref,block_m=256,block_k=512",
    "planes=3,impl=int8,act_quant=per_tensor",
])
def test_quant_for_spec_and_spec_strings_agree(text):
    js, ts = JSpec.parse(text), TSpec.parse(text)
    assert str(ts) == str(js)
    assert ts.plan_key() == js.plan_key()
    assert (ts.radix, ts.num_digits, ts.enabled) == \
        (js.radix, js.num_digits, js.enabled)
    assert TSpec.parse(str(ts)) == ts
    x = _floats(11)
    q_ref, s_ref = jquant.quantize_for_spec(jnp.asarray(x), js, axis=0)
    q, s = tquant.quantize_for_spec(torch.from_numpy(x), ts, axis=0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_spec_coerce_and_rejections_agree():
    for value, impl in ((3, None), (4, "pallas"), (2, "pallas_fused"),
                        (0, None), (None, None)):
        want = JSpec.coerce(value, impl=impl)
        got = TSpec.coerce(value, impl=impl)
        assert (None if want is None else str(want)) == \
            (None if got is None else str(got))
    assert TSpec.parse("off") is None and TSpec.parse("") is None
    for bad in ("planes=3,foo=1", "planes", "impl=nope",
                "encoding=ent,planes=5", "act_quant=sometimes"):
        with pytest.raises(ValueError):
            TSpec.parse(bad)
        with pytest.raises(ValueError):
            JSpec.parse(bad)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_bw_matmul_exact(encoding):
    rng = np.random.default_rng(5)
    a = rng.integers(-128, 128, size=(9, 70)).astype(np.int8)
    b = rng.integers(-128, 128, size=(70, 6)).astype(np.int8)
    want = np.asarray(jbw_ref.bw_matmul_jnp(jnp.asarray(a), jnp.asarray(b),
                                            encoding))
    got = tbw_ref.bw_matmul(torch.from_numpy(a), torch.from_numpy(b),
                            encoding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, a.astype(np.int64) @ b.astype(np.int64))
