"""How B1-B4 (``csrc/bw_gemm.cu``, ``csrc/bw_gemm_sparse.cu``) cut their
work, as a numpy model, held against the plain versions and the
reference's Pallas kernels in interpret mode, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 3 holds
them against the plain versions).  The model follows the kernels' host-
visible decisions step by step:

* a warp owns an output row and a CTA one tile of NT columns and rows of
  one m-block: ``ROW_TILE`` (B1/B2) or ``ROW_STREAM_ROWS`` (B3/B4, whose
  CTA shares one weight table), so the grid is m_pad / 8 or m_pad / 4 x
  ceil(N / NT);
* it walks K a window of k-blocks at a time (``ROW_STREAM_SPANS``), knowing
  each live block's weight: B1/B2 from the mask, 32 k-blocks at a time
  (radix**plane), B3/B4 from a table of 256 k-blocks filled once a CTA
  from the schedule (one window of entries placed by
  ``bw_gemm.schedule_window``, kept when it holds both ends of the run;
  else a pivot search for the run's bounds and the whole run), adding the
  weights of repeated entries;
* lane l of a warp walks its row's 16-byte chunks l, l + 32, ... of the
  window, loading every plane whose weight is non-zero.

Checked: every live block's chunks are visited once for each row and
column tile, no masked or unscheduled block is read, the model's int32
sums equal the plain versions and the reference's interpret-mode kernels
bit for bit (fused: through the same epilogue, bit for bit without bias),
and the schedule cases take both the window and the search.  Cases: N in
{1, 2, 3, 4, 8}, the path's two K (2304 and 5888) at reduced M, an m-block
with only a sentinel entry, zero-weight padding, a repeated entry, runs
longer than 32 and than 256 entries (block_k 16: 144 k-blocks, and at
planes=8 past the 256-k-block table), and block_m = 24, which no
power-of-two unit above 8 divides (a CTA's 4 or 8 rows always divide
block_m, a multiple of 8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bw_gemm as jbw
from repro.kernels import ops as jops
from repro_torch.kernels import bw_gemm as tbw
from repro_torch.kernels import ops as tops

# One torch thread, as in the other port tests: the suite runs in parallel
# workers beside timing-sensitive tests.
torch.set_num_threads(1)

MASK_SPAN = tbw.ROW_STREAM_SPANS["mask"]
TABLE_SPAN = tbw.ROW_STREAM_SPANS["schedule"]
TABLE_ROWS = tbw.ROW_STREAM_ROWS
NS = (1, 2, 3, 4, 8)


def _capacity(bw_n):
    return 4 if bw_n <= 4 else 8


def mask_table(mask, mblk, kb0, wk, radix):
    """B1/B2: the weight table of m-block ``mblk``, k-blocks [kb0, +wk)."""
    bw_n = mask.shape[0]
    table = np.zeros((_capacity(bw_n), wk), np.int64)
    for p in range(bw_n):
        for i in range(wk):
            table[p, i] = radix ** p if mask[p, mblk, kb0 + i] else 0
    return table


def schedule_table(sched, mblks, kblks, bw_n, mblk, kb0, wk):
    """B3/B4: the weight table of m-block ``mblk`` and the way the CTA
    found its run ('window' or 'search')."""
    steps = sched.shape[0]
    rows = sched[:, 1]
    start, width = tbw.schedule_window(steps, mblks, mblk)
    if width > 0 and (start == 0 or rows[start] < mblk) and (
            start + width == steps or rows[start + width - 1] > mblk):
        entries, way = sched[start:start + width], "window"
    else:
        # the pivot search finds the run's bounds exactly (rows sorted)
        lo = int(np.searchsorted(rows, mblk, side="left"))
        hi = int(np.searchsorted(rows, mblk + 1, side="left"))
        entries, way = sched[lo:hi], "search"
    table = np.zeros((_capacity(bw_n), wk), np.int64)
    for plane, row, kblk, weight in (tuple(int(v) for v in e[:4])
                                     for e in entries):
        if (weight != 0 and row == mblk and 0 <= plane < bw_n
                and kb0 <= kblk < kb0 + wk):
            table[plane, kblk - kb0] += weight
    return table, way


def _lane_chunks(lo, end):
    """The chunk positions the 32 lanes of a warp visit in [lo, end)."""
    return [c for lane in range(32) for c in range(lo + lane, end, 32)]


def row_stream_model(digits, b, table_of, block_m, block_k, span, rows):
    """The kernels' walk, windows of ``span`` k-blocks, ``rows`` rows a
    CTA: int32 [M, N] and visits [tiles, BW, M, K / 16] (each chunk of a
    live block once a tile, dead ones never)."""
    bw_n, m_pad, k_pad = digits.shape
    n = b.shape[0]
    nt = tbw._nt_for(n)
    cpk, kblks = block_k // 16, k_pad // block_k
    tiles = -(-n // nt)
    out = np.zeros((m_pad, n), np.int64)
    visits = np.zeros((tiles, bw_n, m_pad, k_pad // 16), np.int64)
    d16 = digits.reshape(bw_n, m_pad, k_pad // 16, 16).astype(np.int64)
    b16 = b.reshape(n, k_pad // 16, 16).astype(np.int64)
    assert block_m % rows == 0
    windows = []
    for kb0 in range(0, kblks, span):
        wk = min(span, kblks - kb0)
        lo, end = kb0 * cpk, (kb0 + wk) * cpk
        chunks = _lane_chunks(lo, end)
        assert sorted(chunks) == list(range(lo, end))   # each once
        windows.append((kb0, wk, np.array(chunks)))
    for ct in range(tiles):
        cols = list(range(ct * nt, min(n, (ct + 1) * nt)))
        for m0 in range(0, m_pad, rows):
            cta = slice(m0, m0 + rows)
            acc = np.zeros((rows, len(cols)), np.int64)
            for kb0, wk, chunks in windows:
                table = table_of(m0 // block_m, kb0, wk)
                for p in range(bw_n):
                    w = table[p, chunks // cpk - kb0]
                    live = chunks[w != 0]
                    visits[ct, p, cta, live] += 1
                    acc += np.einsum("c,rcx,jcx->rj", w[w != 0],
                                     d16[p, cta][:, live],
                                     b16[cols][:, live])
            out[cta, cols] = acc
    return out.astype(np.int32), visits


def _planes_case(planes, m, k, seed, block_m=128, block_k=256):
    """Digits [4, m, k] live on planes < ``planes``, their mask with one
    live block masked off, and an all-empty m-block (m-block 1) when there
    are three or more."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(-2, 3, size=(4, m, k)).astype(np.int8)
    digits[planes:] = 0
    if m >= 3 * block_m:
        digits[:, block_m:2 * block_m] = 0
    mask = np.array(jops.plane_block_mask(jnp.asarray(digits), block_m,
                                          block_k))
    assert digits[0, :block_m, :block_k].any()
    mask[0, 0, 0] = False                   # live digits, never read
    return digits, mask


def _expect_visits(visits, mask, block_m, block_k):
    """Each chunk of a live block once a column tile; nothing else."""
    want = np.repeat(np.repeat(mask, block_m, 1), block_k // 16, 2)
    for tile in visits:
        np.testing.assert_array_equal(tile, want.astype(np.int64))


def _b(n, k, seed):
    return np.random.default_rng(seed).integers(
        -127, 128, size=(n, k)).astype(np.int8)


def _b_pad(b):
    pad = np.zeros((b.shape[1], 128), np.int8)
    pad[:, :b.shape[0]] = b.T
    return pad


# the path's shapes (M x K_pad: 2304 x 2304, 5760 x 2304, 2304 x 5888) at
# M cut to 3 m-blocks, K kept
SHAPES = ((384, 2304), (384, 5888))


def _mask_model(digits, b, mask, block_m=128, block_k=256):
    got, visits = row_stream_model(
        digits, b, lambda mblk, kb0, wk: mask_table(mask, mblk, kb0, wk, 4),
        block_m, block_k, MASK_SPAN, tbw.ROW_TILE)
    _expect_visits(visits, mask, block_m, block_k)
    return got


def _schedule_model(digits, b, sched, mask, block_m=128, block_k=256):
    """The B3/B4 walk; returns its sums and each m-block's way."""
    bw_n, m, k = digits.shape
    ways = {}

    def table_of(mblk, kb0, wk):
        table, ways[mblk] = schedule_table(sched, m // block_m, k // block_k,
                                           bw_n, mblk, kb0, wk)
        return table

    got, visits = row_stream_model(digits, b, table_of, block_m, block_k,
                                   TABLE_SPAN, TABLE_ROWS)
    _expect_visits(visits, mask, block_m, block_k)
    return got, ways


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m,k", SHAPES)
def test_mask_walk_covers_live_blocks_and_matches_reference(m, k, n):
    digits, mask = _planes_case(3, m, k, seed=m + k + n)
    b = _b(n, k, seed=n)
    got = _mask_model(digits, b, mask)
    plain = tbw.bw_gemm_plain(torch.from_numpy(digits), torch.from_numpy(b),
                              torch.from_numpy(mask), block_m=128,
                              block_k=256).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jbw.bw_gemm(jnp.asarray(digits), jnp.asarray(_b_pad(b)),
                                  jnp.asarray(mask), block_m=128,
                                  block_n=128, block_k=256,
                                  interpret=True))[:, :n]
    np.testing.assert_array_equal(got, want)
    assert not got[128:256].any()           # the all-empty m-block


def _skewed_mask(mblks, kblks, seed):
    """m-block 0 dense on all four planes, the rest sparse, m-block 2 empty
    (a sentinel): runs of very different lengths, so uniform windows
    miss."""
    rng = np.random.default_rng(seed)
    mask = rng.random((4, mblks, kblks)) < 0.15
    mask[:, 0] = True
    mask[:, 2] = False
    return mask


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", ["uniform", "skewed", "padded"])
def test_schedule_walk_covers_live_blocks_and_matches_reference(kind, n):
    m, k = (640, 2304) if kind != "skewed" else (768, 5888)
    if kind == "skewed":
        digits = np.random.default_rng(5).integers(
            -2, 3, size=(4, m, k)).astype(np.int8)
        mask = _skewed_mask(m // 128, k // 256, seed=n)
    else:
        digits, mask = _planes_case(2, m, k, seed=17 + n)
    sched = tops.build_schedule(mask, 4, "m_major")
    if kind == "padded":                    # zero-weight padding at the end
        sched = tops.pad_schedule(sched, sched.shape[0] + 37)
    b = _b(n, k, seed=30 + n)
    got, ways = _schedule_model(digits, b, sched, mask)
    plain = tbw.bw_gemm_sparse_plain(torch.from_numpy(digits),
                                     torch.from_numpy(b),
                                     torch.from_numpy(sched), block_m=128,
                                     block_k=256).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jbw.bw_gemm_sparse(
        jnp.asarray(digits), jnp.asarray(_b_pad(b)), jnp.asarray(sched),
        block_m=128, block_k=256, block_n=128, interpret=True))[:, :n]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _mask_model(digits, b, mask))
    if kind == "skewed":
        # a 92-entry run (m-block 0), a sentinel (m-block 2), and both ways
        assert (sched[:, 1] == 0).sum() == 4 * (k // 256) > 32
        assert set(ways.values()) == {"window", "search"}
    else:
        assert set(ways.values()) == {"window"}


def test_schedule_walk_adds_a_repeated_entry():
    """A schedule entry that appears twice counts twice, as in the plain
    version (the table adds weights)."""
    digits, mask = _planes_case(2, 384, 2304, seed=41)
    sched = tops.build_schedule(mask, 4, "m_major")
    i = int(np.flatnonzero(sched[:, 3])[5])
    sched = np.insert(sched, i, sched[i], axis=0)
    b = _b(4, 2304, seed=42)
    got, _ = row_stream_model(
        digits, b, lambda mblk, kb0, wk: schedule_table(
            sched, 3, 9, 4, mblk, kb0, wk)[0], 128, 256, TABLE_SPAN,
        TABLE_ROWS)
    np.testing.assert_array_equal(got, tbw.bw_gemm_sparse_plain(
        torch.from_numpy(digits), torch.from_numpy(b),
        torch.from_numpy(sched), block_m=128, block_k=256).numpy())
    assert not np.array_equal(got, _mask_model(digits, b, mask))


@pytest.mark.parametrize("bw_n", [4, 8])
def test_walk_long_runs_and_several_windows(bw_n):
    """block_k 16 at K 2304 and 4608: 144 and 288 k-blocks, so an
    m-block's run holds up to 576 or 2304 entries (more than a schedule
    window) and, at 288, the table takes two windows of 256 k-blocks.
    Eight planes (radix 2) take the 8-plane capacity."""
    m, bk = 256, 16
    k = 2304 if bw_n == 4 else 4608
    rng = np.random.default_rng(3)
    digits = rng.integers(-1, 2, size=(bw_n, m, k)).astype(np.int8)
    mask = rng.random((bw_n, m // 128, k // bk)) < 0.9
    radix = 4 if bw_n == 4 else 2
    sched = tops.build_schedule(mask, radix, "m_major")
    b = _b(4, k, seed=4)
    kblks = k // bk
    ways = {}

    def table_of(mblk, kb0, wk):
        table, ways[mblk, kb0] = schedule_table(sched, m // 128, kblks, bw_n,
                                                mblk, kb0, wk)
        return table

    got, visits = row_stream_model(digits, b, table_of, 128, bk, TABLE_SPAN,
                                   TABLE_ROWS)
    _expect_visits(visits, mask, 128, bk)
    t = torch.from_numpy
    np.testing.assert_array_equal(got, tbw.bw_gemm_sparse_plain(
        t(digits), t(b), t(sched), block_m=128, block_k=bk).numpy())
    dense, visits = row_stream_model(
        digits, b, lambda mblk, kb0, wk: mask_table(mask, mblk, kb0, wk,
                                                    radix), 128, bk, MASK_SPAN,
        tbw.ROW_TILE)
    _expect_visits(visits, mask, 128, bk)
    np.testing.assert_array_equal(dense, got)
    np.testing.assert_array_equal(dense, tbw.bw_gemm_plain(
        t(digits), t(b), t(mask), block_m=128, block_k=bk,
        radix=radix).numpy())
    assert set(ways.values()) == {"search"}
    assert {kb0 for _, kb0 in ways} == ({0} if kblks <= 256 else {0, 256})


@pytest.mark.parametrize("n", (3, 8))
def test_walk_at_block_m_24(n):
    """block_m = 24 (M = 72): a CTA's rows tile each m-block; B1's and
    B3's walks agree with the plain versions."""
    m, k, bm = 72, 512, 24
    digits, mask = _planes_case(3, m, k, seed=9, block_m=bm)
    sched = tops.build_schedule(mask, 4, "m_major")
    b = _b(n, k, seed=11)
    t = torch.from_numpy
    dense = _mask_model(digits, b, mask, block_m=bm)
    np.testing.assert_array_equal(dense, tbw.bw_gemm_plain(
        t(digits), t(b), t(mask), block_m=bm, block_k=256).numpy())
    sparse, _ = _schedule_model(digits, b, sched, mask, block_m=bm)
    np.testing.assert_array_equal(sparse, dense)


def test_fused_walk_matches_reference_epilogue():
    """The model's sums through the port's epilogue equal the reference's
    fused sparse kernel bit for bit (no bias, no activation)."""
    n = 4
    digits, mask = _planes_case(2, 384, 2304, seed=21)
    sched = tops.build_schedule(mask, 4, "m_major")
    b = _b(n, 2304, seed=22)
    rng = np.random.default_rng(23)
    scale = rng.uniform(1e-4, 1e-2, (384, 1)).astype(np.float32)
    scale_n = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    acc, _ = _schedule_model(digits, b, sched, mask)
    got = tbw._epilogue(torch.from_numpy(acc), torch.from_numpy(scale), None,
                        torch.from_numpy(scale_n), None).numpy()
    sn_pad = np.ones((1, 128), np.float32)
    sn_pad[:, :n] = scale_n
    want = np.asarray(jbw.bw_gemm_sparse_fused(
        jnp.asarray(digits), jnp.asarray(_b_pad(b)), jnp.asarray(sched),
        jnp.asarray(scale), None, jnp.asarray(sn_pad), block_m=128,
        block_k=256, block_n=128, interpret=True))[:, :n]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps,mblks", [(324, 18), (810, 45), (828, 18),
                                         (1, 1), (5, 7), (3000, 4)])
def test_schedule_window_stays_inside_the_schedule(steps, mblks):
    for mblk in range(mblks):
        start, width = tbw.schedule_window(steps, mblks, mblk)
        assert 0 <= start and start + width <= steps
        assert 0 < width <= tbw.ROW_STREAM_THREADS
        run = -(-steps // mblks)
        if 2 * run + 32 <= min(tbw.ROW_STREAM_THREADS, steps):
            # a uniform schedule's run lies inside its window
            lo, hi = mblk * steps // mblks, (mblk + 1) * steps // mblks
            assert start <= lo and hi <= start + width, (mblk, start, width)
