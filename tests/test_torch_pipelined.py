"""What the pipelined kernels (B5 ``bw_gemm_sparse_fused_pipelined``, B6
``bw_gemm_sparse_pipelined``) decide on the host, and their plain
versions against the reference, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 3 holds
them against these plain versions and against B3/B4).  Here:

* the CTA partition (``pipelined_ranges``), the grid sizing and the
  walk's length, as pure functions;
* a numpy model of the kernel's walk -- contiguous CTA ranges, panel
  windows of up to 32 entries with one slot per (column tile, m-block),
  the first entry of a key writing its slot and the rest adding, each
  window's slots added into a zeroed workspace -- held against the plain
  version on both schedule orders, including ranges that split an
  m-block row's entries across CTAs, a schedule shorter than the grid
  and an all-sentinel schedule;
* the shared-memory layout the wrapper checks (``_pipelined_layout``,
  the mirror of ``pipelined_layout`` in csrc/bw_gemm_sparse.cu), case by
  case, and what it refuses;
* the plain versions against the reference's Pallas kernels in
  interpret mode at N in {1, 2, 3, 4, 8}.

Integer results are compared bit for bit; fused ones as in
``test_torch_sparse.py`` (an activation within rtol 1e-5, atol 1e-6).
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

BM, BK = 128, 256
ORDERS = ("m_major", "k_major")
NS = (1, 2, 3, 4, 8)
ACT_TOL = dict(rtol=1e-5, atol=1e-6)


def _case(planes, seed, kind="masked", mb=3, kb=3):
    """Digits [4, mb*BM, kb*BK] live on planes < ``planes`` and their mask:
    'masked' has a False block over non-zero digits and an all-empty row
    block (a sentinel), 'few' a handful of live blocks, 'empty' none."""
    rng = np.random.default_rng(seed)
    digits = rng.integers(-2, 3, size=(4, mb * BM, kb * BK)).astype(np.int8)
    digits[planes:] = 0
    mask = np.array(jops.plane_block_mask(jnp.asarray(digits), BM, BK))
    if kind == "masked":
        digits[:, BM:2 * BM] = 0
        mask[:, 1] = False
        mask[0, 0, 0] = False
    elif kind == "few":
        mask[:] = False
        mask[0, ::2, 0] = True
    elif kind == "empty":
        mask[:] = False
    return digits, mask


def _kernel_model(digits, b, sched, ctas, window):
    """The pipelined kernel's walk in numpy.  Returns the int32 result, the
    CTAs that added into each (column tile, m-block), and how often each
    walk position was visited."""
    n = b.shape[0]
    nt = tbw._nt_for(n)
    steps = sched.shape[0]
    ws = np.zeros((digits.shape[1], n), np.int64)
    visits = np.zeros(tbw.pipelined_work(steps, n), np.int64)
    owners = {}
    for c, (lo, hi) in enumerate(tbw.pipelined_ranges(visits.size, ctas)):
        for base in range(lo, hi, window):
            slots = {}                      # (column tile, m-block) -> panel
            for f in range(base, min(hi, base + window)):
                visits[f] += 1
                ct, e = divmod(f, steps)
                plane, row, kblk, weight = (int(v) for v in sched[e, :4])
                if weight == 0:
                    continue
                blk = digits[plane, row * BM:(row + 1) * BM,
                             kblk * BK:(kblk + 1) * BK].astype(np.int64)
                cols = np.zeros((nt, BK), np.int64)
                part_b = b[ct * nt:(ct + 1) * nt, kblk * BK:(kblk + 1) * BK]
                cols[:part_b.shape[0]] = part_b
                part = weight * (blk @ cols.T)
                key = (ct, row)
                slots[key] = slots[key] + part if key in slots else part
            assert len(slots) <= window
            for (ct, row), panel in slots.items():
                owners.setdefault((ct, row), set()).add(c)
                width = min(n, (ct + 1) * nt) - ct * nt
                ws[row * BM:(row + 1) * BM, ct * nt:ct * nt + width] += \
                    panel[:, :width]
    return ws.astype(np.int32), owners, visits


@pytest.mark.parametrize("work,ctas", [(324, 132), (810, 132), (828, 132),
                                       (7, 132), (132, 132), (1, 1),
                                       (0, 4), (1000, 3)])
def test_pipelined_ranges_cover_every_position_once(work, ctas):
    ranges = tbw.pipelined_ranges(work, ctas)
    assert len(ranges) == ctas
    assert ranges[0][0] == 0 and ranges[-1][1] == work
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo <= hi == lo2                   # contiguous, in order
    lengths = [hi - lo for lo, hi in ranges]
    assert sum(lengths) == work
    assert max(lengths) - min(lengths) <= 1      # balanced
    if work < ctas:
        assert lengths.count(0) == ctas - work


def test_pipelined_grid_and_walk_length():
    assert tbw.pipelined_grid(132, 1) == 132
    assert tbw.pipelined_grid(132, 2) == 264
    for sms, per_sm in ((132, 0), (0, 1)):
        with pytest.raises(ValueError, match="holds no pipelined CTA"):
            tbw.pipelined_grid(sms, per_sm)
    # one pass a column tile of NT = 1, 2, 4 or 8 columns
    for n, tiles in ((1, 1), (2, 1), (3, 1), (4, 1), (8, 1), (9, 2),
                     (16, 2), (17, 3)):
        assert tbw.pipelined_work(10, n) == 10 * tiles
    with pytest.raises(ValueError):
        tbw.pipelined_ranges(5, 0)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind,planes,n,ctas", [
    ("masked", 2, 4, 5),        # ranges split rows across CTAs
    ("masked", 4, 3, 1),        # one CTA, several windows
    ("masked", 3, 8, 7),        # planes=3, window 16
    ("masked", 2, 9, 6),        # two column tiles
    ("masked", 2, 1, 132),      # L shorter than the grid
    ("few", 2, 2, 132),
    ("empty", 2, 4, 132),       # all sentinels
])
def test_kernel_walk_model_matches_plain(kind, planes, n, ctas, order):
    digits, mask = _case(planes, 30 + planes + n, kind)
    rng = np.random.default_rng(40 + n)
    b = rng.integers(-127, 128, size=(n, digits.shape[2])).astype(np.int8)
    sched = tops.build_schedule(mask, 4, order)
    window = tbw._pipelined_layout(n, BM, BK)["window"]
    got, owners, visits = _kernel_model(digits, b, sched, ctas, window)
    want = tbw.bw_gemm_sparse_pipelined_plain(
        torch.from_numpy(digits), torch.from_numpy(b),
        torch.from_numpy(sched), block_m=BM, block_k=BK).numpy()
    np.testing.assert_array_equal(got, want)
    assert (visits == 1).all()
    split = sum(len(cs) > 1 for cs in owners.values())
    if ctas == 5:
        assert split > 0                # the case exists to split rows
    if kind == "empty":
        assert not owners and not (sched[:, 3]).any()
    if ctas == 132:
        assert sched.shape[0] < ctas


_LAYOUT = tbw.PIPELINED_LAYOUT_FIELDS


@pytest.mark.parametrize("n,block_m,block_k,want", [
    (4, 128, 256, (128, 1, 32, 4, 34816, 1088, 209152)),   # the path
    (1, 128, 256, (128, 1, 32, 4, 34816, 272, 156736)),
    (8, 128, 256, (128, 1, 16, 4, 34816, 2176, 213504)),
    (16, 128, 256, (128, 1, 16, 4, 34816, 2176, 213504)),
    (4, 256, 512, (128, 2, 16, 2, 67584, 2112, 204928)),
    (4, 128, 128, (128, 1, 32, 4, 18432, 576, 141568)),
    (2, 384, 256, (128, 3, 21, 4, 34816, 544, 205952)),
    (4, 4096, 256, (128, 32, 1, 4, 34816, 1088, 209152)),
    (4, 128, 4096, (16, 8, 32, 2, 65792, 16448, 230016)),
    (4, 64, 256, (64, 1, 32, 4, 17408, 1088, 106752)),
])
def test_pipelined_layout_cases(n, block_m, block_k, want):
    assert tbw._check_pipelined("f", block_k, n, block_m) == \
        dict(zip(_LAYOUT, want))


@pytest.mark.parametrize("n,block_m,block_k,match", [
    (4, 8, 256, "multiple of 16"),         # not a whole 16-row mma tile
    (4, 128, 16, "of 32"),                 # not a whole 32-byte mma step
    (4, 100, 256, "multiple of 16"),
    (8, 4096, 256, "accumulator panel"),   # one m-block overflows it
    (4, 128, 8192, "shared memory"),       # two stages do not fit
])
def test_pipelined_layout_refusals(n, block_m, block_k, match):
    with pytest.raises(ValueError, match=f"^f: .*{match}"):
        tbw._check_pipelined("f", block_k, n, block_m)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", NS)
def test_pipelined_plain_match_reference(n, order):
    digits, mask = _case(2, 50 + n)
    rng = np.random.default_rng(60 + n)
    k = digits.shape[2]
    b = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
    b_pad = np.zeros((k, 128), np.int8)
    b_pad[:, :n] = b.T
    m = digits.shape[1]
    scale = rng.uniform(1e-4, 1e-2, (m, 1)).astype(np.float32)
    bias = rng.standard_normal((m, 1)).astype(np.float32)
    scale_n = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    scale_n_pad = np.ones((1, 128), np.float32)
    scale_n_pad[:, :n] = scale_n
    sched = jops.build_schedule(mask, 4, order)
    j, t = jnp.asarray, torch.from_numpy
    jblocks = dict(block_m=BM, block_n=128, block_k=BK, interpret=True)
    want = np.asarray(jbw.bw_gemm_sparse_pipelined(
        j(digits), j(b_pad), j(sched), **jblocks))[:, :n]
    got = tbw.bw_gemm_sparse_pipelined(t(digits), t(b), t(sched),
                                       block_m=BM, block_k=BK)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jbw.bw_gemm_sparse_fused_pipelined(
        j(digits), j(b_pad), j(sched), j(scale), j(bias), j(scale_n_pad),
        activation="silu", **jblocks))[:, :n]
    got = tbw.bw_gemm_sparse_fused_pipelined(
        t(digits), t(b), t(sched), t(scale), t(bias), t(scale_n),
        activation="silu", block_m=BM, block_k=BK)
    np.testing.assert_allclose(got.numpy(), want, **ACT_TOL)
