"""The Hopper redesign of B7 ``ent_encode`` (``csrc/encode.cu``), as a
numpy model of the kernel's work split, held against the reference's
Pallas kernel in interpret mode, on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` phase 3 holds it
bit for bit against its plain version).  Here:

* its lookup table (``encode.ent_table``: byte p of word u is plane p's
  digit of the int8 whose bits are u) equals the reference's EN-T digits
  on all 256 int8 values;
* one CTA a plan block, with as many threads as ``ent_threads`` in the
  source gives it (its constants read from the source), visits every
  16-byte chunk of the block exactly once in its passes of ``kUnroll``
  chunks a thread, and the digits looked up by table and the OR of the
  warps' flags (the ORed table words, byte p for plane p) equal the
  reference's ``ent_encode`` at the served plans' shapes and blocks, at
  24 x 16 and 128 x 128 blocks, and at blocks a CTA takes in several
  passes;
* with one non-zero byte a block, in the chunk the CTA's last warp
  encodes in its last pass, the mask still equals the reference's: the
  flags of every warp reach it.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encodings as jencodings
from repro.kernels import encode as jenc
from repro_torch.kernels import encode as tenc

torch.set_num_threads(1)

PATH_SHAPES = ((2304, 2304), (5760, 2304), (2304, 5888))
CSRC = (Path(tenc.__file__).parent / "csrc" / "encode.cu")


# ---------------------------------------------------------------------------
# B7 ent_encode
# ---------------------------------------------------------------------------

def _table_digits(words):
    """[..., 4] int8 digits of table words (byte p: plane p)."""
    return np.stack([((words >> (8 * p)) & 0xFF).astype(np.uint8)
                     .view(np.int8) for p in range(4)], axis=-1)


def test_ent_table_matches_reference_digits():
    words = tenc.ent_table()
    assert words.dtype == np.uint32 and words.shape == (256,)
    values = np.arange(256, dtype=np.uint8).view(np.int8)
    np.testing.assert_array_equal(_table_digits(words),
                                  jencodings.ent_digits_np(values))


def _constants():
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (k\w+) = (\d+);", CSRC.read_text())}


def cta_threads(block_m, block_k):
    """Threads a CTA, as ``ent_threads`` in csrc/encode.cu computes them."""
    c = _constants()
    chunks = block_m * (block_k // 16)
    return min(32 * _cdiv(_cdiv(chunks, c["kUnroll"]), 32), c["kMaxThreads"])


def _cdiv(a, b):
    return -(-a // b)


def chunk_owner(chunk, threads, unroll):
    """(thread, pass) that encodes a block's 16-byte chunk."""
    return chunk % threads, chunk // (unroll * threads)


def encode_model(x, block_m, block_k):
    """digits and mask as csrc/encode.cu computes them, and the number of
    times each 16-byte chunk of a block is visited."""
    m, k = x.shape
    unroll = _constants()["kUnroll"]
    threads = cta_threads(block_m, block_k)
    assert threads % 32 == 0 and 32 <= threads <= _constants()["kMaxThreads"]
    words = tenc.ent_table()[x.view(np.uint8)]           # [M, K]
    per_row = block_k // 16
    chunks = block_m * per_row
    mblks, kblks = m // block_m, k // block_k
    # [mblks, kblks, chunk, 16 bytes]: a block's chunks, row-major
    blocks = (words.reshape(mblks, block_m, kblks, per_row, 16)
              .transpose(0, 2, 1, 3, 4).reshape(mblks, kblks, chunks, 16))
    chunk_words = np.bitwise_or.reduce(blocks, axis=3)
    flags = np.zeros((mblks, kblks), np.uint32)
    visits = np.zeros(chunks, np.int64)
    for warp in range(threads // 32):
        # thread tid's chunks: pass base, its u-th load base + tid + u * threads
        tid = np.arange(32 * warp, 32 * warp + 32)
        bases = np.arange(0, chunks, unroll * threads)
        c = (bases[:, None, None] + tid[None, :, None]
             + threads * np.arange(unroll)[None, None, :]).ravel()
        c = c[c < chunks]
        np.add.at(visits, c, 1)
        flags |= np.bitwise_or.reduce(chunk_words[:, :, c], axis=2)
    digits = np.moveaxis(_table_digits(words), -1, 0)
    mask = np.stack([(flags >> (8 * p)) & 0xFF != 0 for p in range(4)])
    return digits, mask, visits


def _encode_input(kind, m, k, block, rng):
    if kind == "uniform":
        return rng.integers(-128, 128, (m, k)).astype(np.int8)
    if kind == "sparse":         # about one non-zero a plan block
        x = rng.integers(-128, 128, (m, k)).astype(np.int8)
        return np.where(rng.random((m, k)) < 1.0 / block, x, 0).astype(
            np.int8)
    if kind == "planes3":        # the planes=3 grid: plane 3 empty
        return rng.integers(-42, 43, (m, k)).astype(np.int8)
    return np.tile(np.arange(-128, 128, dtype=np.int8), (m, k // 256))


@pytest.mark.parametrize("m,k,bm,bk,kind", [
    *[(m, k, 128, 256, kind) for m, k in PATH_SHAPES
      for kind in ("planes3", "sparse")],
    (2304, 2304, 128, 256, "uniform"),
    (256, 256, 128, 256, "every"),
    (240, 256, 24, 16, "sparse"),
    (240, 512, 24, 16, "every"),
    (384, 256, 128, 128, "sparse"),
    (256, 1024, 128, 512, "every"),
    (256, 4096, 128, 4096, "sparse"),
])
def test_encode_model_covers_blocks_and_matches_reference(m, k, bm, bk,
                                                          kind):
    rng = np.random.default_rng(m + k + bm + bk)
    x = _encode_input(kind, m, k, bm * bk, rng)
    digits, mask, visits = encode_model(x, bm, bk)
    assert (visits == 1).all()
    want_d, want_m = jenc.ent_encode(jnp.asarray(x), block_m=bm, block_k=bk,
                                     interpret=True)
    np.testing.assert_array_equal(digits, np.asarray(want_d))
    np.testing.assert_array_equal(mask, np.asarray(want_m))
    if kind == "sparse":
        assert not mask.all() and mask.any()


# as chip_smoke.ENCODE_PLANTED: top live planes 0, 1, 1, 2, 2, 3, 3, 3, 3,
# and an empty block
PLANTED = (1, -3, 4, -12, 16, -48, 64, -128, 127, 0)


def planted(m, k, bm, bk):
    """Zeros, and in block (i, j) the byte PLANTED[(i * kb + j) % 10] in
    the block's last row and last 16-byte chunk, at column
    (i * kb + j) % 16 of it (chip_smoke.py's sparse B7 case)."""
    x = np.zeros((m, k), np.int8)
    kb = k // bk
    i, j = np.meshgrid(np.arange(m // bm), np.arange(kb), indexing="ij")
    at = i * kb + j
    x[i * bm + bm - 1, j * bk + bk - 16 + at % 16] = \
        np.asarray(PLANTED, np.int8)[at % len(PLANTED)]
    return x


@pytest.mark.parametrize("m,k,bm,bk", [
    (768, 2560, 128, 256), (2304, 2304, 128, 256), (384, 1280, 128, 128),
    (240, 512, 24, 16), (48, 160, 24, 16), (384, 4096, 128, 1024),
    (256, 1536, 128, 512), (256, 16384, 128, 4096),
])
def test_encode_flags_of_the_last_warp_reach_the_mask(m, k, bm, bk):
    threads = cta_threads(bm, bk)
    chunks = bm * (bk // 16)
    unroll = _constants()["kUnroll"]
    tid, last_pass = chunk_owner(chunks - 1, threads, unroll)
    assert tid // 32 == threads // 32 - 1
    assert last_pass == (chunks - 1) // (unroll * threads)
    x = planted(m, k, bm, bk)
    digits, mask, visits = encode_model(x, bm, bk)
    assert (visits == 1).all()
    want_d, want_m = jenc.ent_encode(jnp.asarray(x), block_m=bm, block_k=bk,
                                     interpret=True)
    np.testing.assert_array_equal(digits, np.asarray(want_d))
    np.testing.assert_array_equal(mask, np.asarray(want_m))
    planes = mask.reshape(4, -1)
    assert planes.any(1).all() and not planes.all(1).any()
