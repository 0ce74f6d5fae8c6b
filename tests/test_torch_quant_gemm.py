"""What the baseline GEMM kernels (B9 ``quant_gemm``, B8
``quant_gemm_fused``, ``csrc/quant_gemm.cu``) decide on the host, on the
CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 3 holds
them against their plain versions at every width and orientation).  Here:

* the design and instantiation each shape takes (``launch_plan``): rows
  when B has at most 16 columns, cols when A has at most 16 rows, wide
  otherwise, and the K splits that fill 132 SMs;
* a numpy model of the work split and of the one-launch sum: every
  CTA's contiguous range of (tile, K unit) pairs and its partial
  product, a tile's CTAs one cluster that sums its partials in shared
  memory, each CTA summing and storing its own share of the tile's rows
  -- every (m, n, k) product covered exactly once and every output
  stored once, the result equal to the plain version and to the
  reference's interpret-mode kernels;
* the layout the wrapper computes (``_layout``) against the source's
  constants and its refusals (the library's own is held against it on
  the card);
* the wide kernel's data flow, as the source computes it: the byte
  transpose against numpy; the raw B box under the 128-byte swizzle (a
  bijection, and the fragment loads of a warp on 32 distinct banks); the
  register A fragments -- every (row, K) byte of a slab in the register
  and byte the wgmma fragment layout reads it from, rows permuted to
  columns of C; the accumulators back to C, staged conflict-free; and
  the whole wide kernel emulated lane by lane against the plain version.

Integer results are compared bit for bit.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant_gemm as jqg
from repro_torch.kernels import quant_gemm as tqg

torch.set_num_threads(1)

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "quant_gemm.cu")


def _int8(rng, shape):
    return rng.integers(-128, 128, size=shape).astype(np.int8)


# ---------------------------------------------------------------------------
# The design by shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k,design,nt", [
    (2304, 1, 2304, "rows", 4), (2304, 4, 2304, "rows", 4),
    (5760, 8, 2304, "rows", 8), (2304, 16, 5888, "rows", 16),
    (1, 2304, 2304, "cols", 4), (3, 5760, 2304, "cols", 4),
    (5, 2304, 5888, "cols", 8), (16, 2304, 2304, "cols", 16),
    (4, 4, 64, "rows", 4), (2304, 17, 2304, "wide", 0),
    (17, 2304, 2304, "wide", 0), (64, 2304, 2304, "wide", 0),
    (2304, 512, 2304, "wide", 0), (512, 5760, 2304, "wide", 0)])
def test_launch_plan_picks_the_design_by_shape(m, n, k, design, nt):
    plan = tqg.launch_plan(m, n, k, 132)
    assert tqg.DESIGNS[plan["design"]] == design
    assert plan["nt"] == nt
    assert plan == dict(design=plan["design"], ctas=plan["ctas"],
                        **tqg._layout(m, n, k, plan["design"],
                                      plan["ctas"]))


@pytest.mark.parametrize("m,n,k,ctas", [
    (2304, 4, 2304, 288), (5760, 4, 2304, 360), (2304, 4, 5888, 288),
    (4, 2304, 2304, 144), (4, 5760, 2304, 180), (4, 2304, 5888, 144),
    (2304, 512, 2304, 108), (512, 2304, 5888, 108), (5760, 512, 2304, 90),
    (512, 5760, 2304, 92), (2304, 17, 2304, 126)])
def test_launch_plan_fills_the_card_at_the_path_shapes(m, n, k, ctas):
    """rows / cols split K until about 512 / 640 threads an SM (132 SMs),
    wide (one CTA an SM) until the grid would outgrow the SMs; each in
    clusters of at most 8, a cluster a tile."""
    plan = tqg.launch_plan(m, n, k, 132)
    assert plan["ctas"] == ctas
    assert plan["ctas"] % plan["tiles"] == 0
    splits = plan["ctas"] // plan["tiles"]
    assert splits <= min(tqg.MAX_CLUSTER, plan["units"])
    if plan["design"] == tqg.WIDE:
        assert plan["ctas"] <= 132 or splits == 1


# ---------------------------------------------------------------------------
# A numpy model of the work split and the flush
# ---------------------------------------------------------------------------

def _segments(plan):
    """(cta, tile, first unit, end unit) of every CTA's share of a tile."""
    tiles, units, ctas = plan["tiles"], plan["units"], plan["ctas"]
    total = tiles * units
    segs = []
    for c in range(ctas):
        u, u1 = tqg.cta_units(c, total, ctas)
        assert u < u1                      # no CTA is idle
        while u < u1:
            t = u // units
            s0, s1 = u - t * units, min(units, u1 - t * units)
            segs.append((c, t, s0, s1))
            u = t * units + s1
    return segs


def _region(plan, m, n, k, tile, s0, s1):
    """The rows, columns and K bytes one segment multiplies."""
    design = plan["design"]
    ub = tqg.UNIT_BYTES[design]
    ks = np.arange(s0 * ub, min(s1 * ub, k))
    if design == tqg.ROWS:
        rows = np.arange(tile * tqg.ROW_TILE, min((tile + 1) * tqg.ROW_TILE,
                                                  m))
        return rows, np.arange(n), ks
    if design == tqg.COLS:
        cols = np.arange(tile * tqg.COL_TILE, min((tile + 1) * tqg.COL_TILE,
                                                  n))
        return np.arange(m), cols, ks
    tiles_n = -(-n // tqg.WIDE_TILE_N)
    tm, tn = divmod(tile, tiles_n)
    return (np.arange(tm * tqg.WIDE_TILE_M,
                      min((tm + 1) * tqg.WIDE_TILE_M, m)),
            np.arange(tn * tqg.WIDE_TILE_N,
                      min((tn + 1) * tqg.WIDE_TILE_N, n)), ks)


def _model(a, b, plan, seed):
    """One call of the kernel, CTA by CTA in a shuffled completion order:
    (out, cover, stored).  A tile's CTAs are one cluster: each multiplies
    its K range, and once all have arrived each sums the cluster's
    partials over its share of the tile's outputs (rows and cols: a share
    of the flattened tile; wide: rows kTileM * rank / splits onwards) and
    stores them.  cover[m, n, k] counts the products taken, stored[m, n]
    the stores."""
    m, k = a.shape
    n = b.shape[1]
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    ctas, tiles = plan["ctas"], plan["tiles"]
    splits = ctas // tiles
    assert ctas % tiles == 0 and splits <= tqg.MAX_CLUSTER
    out = np.full((m, n), np.iinfo(np.int64).min)
    cover = np.zeros((m, n, k), np.int64)
    stored = np.zeros((m, n), np.int64)
    segs = _segments(plan)
    assert len(segs) == ctas                # one tile's K range a CTA
    parts = {}
    for i in np.random.default_rng(seed).permutation(len(segs)):
        c, tile, s0, s1 = segs[i]
        assert c // splits == tile
        rows, cols, ks = _region(plan, m, n, k, tile, s0, s1)
        cover[np.ix_(rows, cols, ks)] += 1
        parts[c] = (rows, cols, a64[np.ix_(rows, ks)] @ b64[np.ix_(ks, cols)])
    for tile in range(tiles):               # the cluster has arrived
        rows, cols, _ = parts[tile * splits]
        total = sum(parts[tile * splits + r][2] for r in range(splits))
        # the tile's nominal shape: its outputs as the kernel indexes them
        nominal = {tqg.ROWS: (tqg.ROW_TILE, n), tqg.COLS: (m, tqg.COL_TILE),
                   tqg.WIDE: (tqg.WIDE_TILE_M, tqg.WIDE_TILE_N)}
        height, width = nominal[plan["design"]]
        gr, gc = np.meshgrid(np.arange(len(rows)), np.arange(len(cols)),
                             indexing="ij")
        flat = gr * width + gc
        for rank in range(splits):
            if plan["design"] == tqg.WIDE:    # whole rows a rank
                lo = width * (height * rank // splits)
                hi = width * (height * (rank + 1) // splits)
            else:                              # cluster_sum's share
                lo = height * width * rank // splits
                hi = height * width * (rank + 1) // splits
            sub = (flat >= lo) & (flat < hi)
            rr, cc = np.nonzero(sub)
            out[rows[rr], cols[cc]] = total[rr, cc]
            stored[rows[rr], cols[cc]] += 1
    return out, cover, stored


def _plans(m, n, k):
    """The wrapper's plan on cards of 132, 8 and 1 SMs, and every other
    grid the layout accepts for the same design: every cluster size."""
    plans = {}
    for sms in (132, 8, 1):
        plan = tqg.launch_plan(m, n, k, sms)
        plans[plan["design"], plan["ctas"]] = plan
    design = tqg.launch_plan(m, n, k, 132)["design"]
    tiles = plans[design, tqg.launch_plan(m, n, k, 132)["ctas"]]["tiles"]
    for ctas in range(tiles, tiles * (tqg.MAX_CLUSTER + 1), tiles):
        try:
            lay = tqg._layout(m, n, k, design, ctas)
        except ValueError:
            continue
        plans[design, ctas] = dict(design=design, ctas=ctas, **lay)
    return list(plans.values())


MODEL_SHAPES = [(40, 3, 96), (33, 1, 48), (70, 16, 160), (3, 300, 96),
                (16, 129, 64), (1, 260, 208), (130, 140, 208),
                (17, 64, 272), (260, 33, 144)]


@pytest.mark.parametrize("m,n,k", MODEL_SHAPES)
def test_work_split_covers_every_product_once(m, n, k):
    rng = np.random.default_rng(m * 1000 + n * 10 + k)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    want = tqg.quant_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                                block_m=1, block_n=1, block_k=16).numpy()
    plans = _plans(m, n, k)
    assert any(p["ctas"] > p["tiles"] for p in plans)   # K is split
    for i, plan in enumerate(plans):
        out, cover, stored = _model(a, b, plan, seed=i)
        assert (cover == 1).all(), plan
        assert (stored == 1).all(), plan
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("m,n,k", [(40, 3, 96), (3, 300, 96),
                                   (130, 140, 208)])
def test_work_split_matches_the_reference(m, n, k):
    """The model's result on the wrapper's plan equals the reference's
    Pallas kernel in interpret mode (blocks that divide the shape)."""
    rng = np.random.default_rng(m + n + k)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    want = np.asarray(jqg.quant_gemm(jnp.asarray(a), jnp.asarray(b),
                                     block_m=m, block_n=n, block_k=16,
                                     interpret=True))
    for sms in (132, 4):
        out, _, _ = _model(a, b, tqg.launch_plan(m, n, k, sms), seed=sms)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 8, 16, 17, 64])
def test_plain_versions_match_the_reference_at_every_width(t):
    """B9 and B8 (the plain versions the card holds the kernels against)
    against the reference's kernels in interpret mode, in both
    orientations: the weight as A with t token columns, and t token rows
    with the weight as B."""
    m, k = 48, 64
    rng = np.random.default_rng(t)
    w, x = _int8(rng, (m, k)), _int8(rng, (t, k))
    for a, b in ((w, x.T.copy()), (x, w.T.copy())):
        blocks = dict(block_m=a.shape[0], block_n=b.shape[1], block_k=16)
        want = np.asarray(jqg.quant_gemm(jnp.asarray(a), jnp.asarray(b),
                                         interpret=True, **blocks))
        got = tqg.quant_gemm(torch.from_numpy(a), torch.from_numpy(b),
                             **blocks)
        np.testing.assert_array_equal(got.numpy(), want)
        scale = (rng.random((1, b.shape[1])) * 1e-3).astype(np.float32)
        want = np.asarray(jqg.quant_gemm_fused(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale),
            interpret=True, activation="relu2", **blocks))
        got = tqg.quant_gemm_fused(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(scale),
                                   activation="relu2", **blocks)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sms", [132, 114, 8, 1])
def test_wide_grid_stays_within_one_wave(sms):
    """wide takes one CTA an SM: where the tiles fit the card, the grid
    splits each tile's K as far as the SMs (and 8, and its K steps)
    allow and no further; a card with fewer SMs than tiles gets one CTA a
    tile."""
    for m, n, k in ((2304, 512, 2304), (512, 5760, 2304), (2304, 17, 5888),
                    (17, 2311, 2320), (300, 520, 272), (8192, 8192, 64)):
        plan = tqg.launch_plan(m, n, k, sms)
        assert plan["design"] == tqg.WIDE
        splits = plan["ctas"] // plan["tiles"]
        if plan["tiles"] <= sms:
            assert plan["ctas"] <= sms
            assert (splits == min(tqg.MAX_CLUSTER, plan["units"])
                    or plan["tiles"] * (splits + 1) > sms)
        else:
            assert splits == 1


# ---------------------------------------------------------------------------
# The layout, against the source
# ---------------------------------------------------------------------------

def _constants():
    src = CSRC.read_text()
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_layout_constants_mirror_the_source():
    c = _constants()
    assert c["kSkinnyMax"] == tqg.SKINNY_MAX
    assert c["kMaxCluster"] == tqg.MAX_CLUSTER
    assert c["kStageCap"] == tqg.STAGE_CAP
    assert c["kColTile"] == tqg.COL_TILE
    assert (c["kTileM"], c["kTileN"]) == (tqg.WIDE_TILE_M, tqg.WIDE_TILE_N)
    assert c["kStep"] == tqg.UNIT_BYTES[tqg.WIDE]
    assert c["kStages"] == tqg.WIDE_STAGES
    assert c["kThreads"] // 32 * c["kRowsPerWarp"] == tqg.ROW_TILE
    assert (c["kThreads"], c["kColThreads"]) == tqg.CTA_THREADS
    # the ring: an A tile and the raw B boxes (128 columns each) a stage,
    # 1024 bytes to align it; the staged sums (rows of kTileN + 4 ints)
    # fit in it, and a consumer warpgroup owns 128 columns
    stage = (c["kTileM"] * c["kStep"]
             + c["kTileN"] // c["kSwizzle"] * c["kStep"] * c["kSwizzle"])
    assert tqg.WIDE_SMEM == c["kStages"] * stage + 1024
    assert c["kTileM"] * (c["kTileN"] + 4) * 4 <= c["kStages"] * stage
    assert c["kTileN"] // c["kConsumers"] == 128
    assert tqg.WIDE_SMEM <= 232448 - 4096      # one CTA an SM, with statics
    assert "constexpr int kCRow = kTileN + 4;" in CSRC.read_text()


@pytest.mark.parametrize("m,n,k,design,ctas,want", [
    (2304, 4, 2304, tqg.ROWS, 288, (4, 144, 144, 288, 4608)),
    (2304, 3, 2304, tqg.ROWS, 144, (4, 144, 144, 576, 6912)),
    (4, 2304, 2304, tqg.COLS, 144, (4, 18, 576, 72, 3200)),
    (16, 2304, 5888, tqg.COLS, 18 * 8, (16, 18, 1472, 184, 19968)),
    (2311, 17, 2320, tqg.WIDE, 114, (0, 19, 19, 0, 197632)),
    (2304, 512, 2304, tqg.WIDE, 108, (0, 36, 18, 0, 197632))])
def test_layout_cases(m, n, k, design, ctas, want):
    assert tuple(tqg._layout(m, n, k, design, ctas).values()) == want


@pytest.mark.parametrize("m,n,k,design,ctas,match", [
    (64, 17, 64, tqg.ROWS, 4, "at most 16"),
    (17, 64, 64, tqg.COLS, 1, "at most 16"),
    (64, 4, 64, tqg.ROWS, 5, "do not split"),
    (64, 4, 64, tqg.ROWS, 4 * 5, "do not split"),      # 5 splits of 4 units
    (64, 4, 4096, tqg.ROWS, 4 * 9, "clusters of at most"),
    (64, 16, 4096, tqg.ROWS, 4, "staged bytes"),
    (64, 64, 64, tqg.WIDE, 2, "do not split"),         # 2 splits of 1 step
    (2304, 512, 2304, tqg.WIDE, 100, "do not split"),  # not a tile multiple
    (2304, 512, 8192, tqg.WIDE, 36 * 9, "clusters of at most"),
    (64, 4, 40, tqg.ROWS, 4, "multiple of 16"),
    (64, 4, 64, 3, 4, "unknown design")])
def test_layout_refusals(m, n, k, design, ctas, match):
    with pytest.raises(ValueError, match=match):
        tqg._layout(m, n, k, design, ctas)


# ---------------------------------------------------------------------------
# The wide kernel's data flow, as the source has it
# ---------------------------------------------------------------------------

def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes of y:x."""
    src = int(x) | (int(y) << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _transpose4(r0, r1, r2, r3):
    """transpose4 (csrc/epilogue.cuh, which csrc/quant_gemm.cu and
    csrc/encode.cu include), selector for selector."""
    lo01, hi01 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    lo23, hi23 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]


def test_transpose4_turns_rows_into_k_quads():
    assert '#include "epilogue.cuh"' in CSRC.read_text()
    src = (CSRC.parent / "epilogue.cuh").read_text()
    for sel in ("0x5140", "0x7362", "0x5410", "0x7632"):
        assert sel in src
    rng = np.random.default_rng(0)
    for _ in range(64):
        block = rng.integers(0, 256, size=(4, 4)).astype(np.uint8)  # [k, n]
        words = block.copy().view("<u4").reshape(4)
        cols = _transpose4(*words)
        want = block.T.copy().view("<u4").reshape(4)                 # [n, k]
        assert cols == [int(w) for w in want]


STEP, SWIZZLE = tqg.UNIT_BYTES[tqg.WIDE], 128


def _swizzled(r, c):
    """csrc/quant_gemm.cu swizzled: byte (r, c) of a box of 128-byte rows
    under the 128-byte swizzle, as TMA writes it."""
    return r * SWIZZLE + ((((c >> 4) ^ r) & 7) << 4) + (c & 15)


def _box(raw):
    """A raw B box [STEP K rows][128 columns] as shared memory holds it."""
    flat = np.zeros(STEP * SWIZZLE, np.uint8)
    for r in range(STEP):
        for c in range(SWIZZLE):
            flat[_swizzled(r, c)] = raw[r, c]
    return flat


def _rotl(x, s):
    return ((x << s) | (x >> (32 - s))) & 0xFFFFFFFF if s else x


def _fragment_loads(slab, wq, lane):
    """The byte offsets load_words reads, [half][j], for one lane."""
    g, q = lane >> 2, lane & 3
    col = 32 * wq + 4 * g
    offs = []
    for half in range(2):
        row0 = 32 * slab + 4 * (q + 4 * half)
        offs.append([_swizzled(row0 + ((j + q) & 3), col) for j in range(4)])
    return offs


def _fragments(box, slab, wq, lane):
    """load_words then to_fragments, step for step: f[t][register] of
    one lane."""
    q = lane & 3
    f = [[0] * 4, [0] * 4]
    for half, offs in enumerate(_fragment_loads(slab, wq, lane)):
        r = [int(box[o:o + 4].view("<u4")[0]) for o in offs]
        c = _transpose4(*r)
        for i in range(4):
            f[i >> 1][(i & 1) + 2 * half] = _rotl(c[i], 8 * q)
    return f


def test_fragment_loads_are_modelled_from_the_source():
    src = CSRC.read_text()
    for text in ("const int row = row0 + ((j + q) & 3);",
                 "(((chunk ^ row) & 7) << 4) + word",
                 "const int row0 = 32 * slab + 4 * (q + 4 * half);",
                 "const int chunk = 2 * wq + (g >> 2);",
                 "__funnelshift_l(c[i], c[i], 8 * q)",
                 "f[i >> 1][(i & 1) + 2 * half] = v;",
                 "return r * kSwizzle + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);",
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8"):
        assert text in src, text


def test_raw_b_box_is_a_bijection_and_fragment_loads_hit_32_banks():
    offsets = {_swizzled(r, c) for r in range(STEP) for c in range(SWIZZLE)}
    assert offsets == set(range(STEP * SWIZZLE))
    for slab in range(STEP // 32):
        for wq in range(4):
            for half in range(2):
                for j in range(4):
                    banks = {(_fragment_loads(slab, wq, lane)[half][j] // 4)
                             % 32 for lane in range(32)}
                    assert len(banks) == 32, (slab, wq, half, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_fragments_hold_every_byte_where_wgmma_reads_it(seed):
    """The wgmma A fragment of an 8-bit m64nNk32: register p of lane
    (g, q) of warp wq holds row 16 wq + g + 8 (p % 2), K bytes
    4 q + 16 (p // 2) .. + 3.  Fragment row 16 wq + g + 8 h of row tile
    t must be column 32 wq + 4 g + 2 t + h of the box; every (row, K)
    byte of each slab, of both row tiles, once."""
    raw = np.random.default_rng(seed).integers(0, 256, (STEP, SWIZZLE),
                                               dtype=np.uint8)
    box = _box(raw)
    for slab in range(STEP // 32):
        seen = set()
        for wq in range(4):
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                f = _fragments(box, slab, wq, lane)
                for t in range(2):
                    for p in range(4):
                        h, k0 = p % 2, 32 * slab + 4 * q + 16 * (p // 2)
                        col = 32 * wq + 4 * g + 2 * t + h
                        got = np.array([f[t][p]], "<u4").view(np.uint8)
                        np.testing.assert_array_equal(got,
                                                      raw[k0:k0 + 4, col])
                        seen.add((t, 16 * wq + g + 8 * h, k0))
        assert len(seen) == 2 * 64 * 8          # 2 tiles x 64 rows x 8 quads


def test_accumulators_map_onto_c_once_and_stage_without_conflicts():
    """Accumulator (t, 4 j + 2 h + x) of consumer thread (cg, wq, g8, q4)
    is C's row 8 j + 2 q4 + x, column 128 cg + 32 wq + 4 g8 + 2 t + h:
    every element of the 128 x 256 tile once, a thread's four (t, h) four
    consecutive columns, and each 16-byte store of a warp into the
    staged rows (kTileN + 4 ints) free of bank conflicts a phase."""
    seen = set()
    row_ints = tqg.WIDE_TILE_N + 4
    for cg in range(2):
        for wq in range(4):
            for j in range(16):
                for x in range(2):
                    phases = {}
                    for lane in range(32):
                        g8, q4 = lane >> 2, lane & 3
                        row = 8 * j + 2 * q4 + x
                        col = 128 * cg + 32 * wq + 4 * g8
                        cols = [col + 2 * t + h for t in range(2)
                                for h in range(2)]
                        assert cols == list(range(col, col + 4))
                        seen.update((row, c) for c in cols)
                        start = (row * row_ints + col) % 32
                        phases.setdefault(lane // 8, []).extend(
                            (start + w) % 32 for w in range(4))
                    for banks in phases.values():
                        assert len(set(banks)) == 32
    assert seen == {(r, c) for r in range(tqg.WIDE_TILE_M)
                    for c in range(tqg.WIDE_TILE_N)}


def _wide_kernel(a, b):
    """The wide kernel on one tile (M <= 128, N <= 256), lane by lane:
    each K step's raw B boxes swizzled, each consumer thread's register
    fragments by load_words and to_fragments, the wgmma products as the
    fragment layout defines them (D_t[r, c] += A_t[r, k] * a[c, k]), and
    the accumulators stored to C as the source maps them."""
    m, k = a.shape
    n = b.shape[1]
    kp = -(-k // STEP) * STEP
    a_pad = np.zeros((tqg.WIDE_TILE_M, kp), np.int64)
    a_pad[:m, :k] = a
    b_pad = np.zeros((kp, tqg.WIDE_TILE_N), np.uint8)
    b_pad[:k, :n] = b.view(np.uint8)
    d = np.zeros((2, 2, 64, tqg.WIDE_TILE_M), np.int64)  # [cg][t] D_t
    for s in range(kp // STEP):
        for cg in range(2):
            raw = b_pad[s * STEP:(s + 1) * STEP, 128 * cg:128 * (cg + 1)]
            box = _box(raw)
            for slab in range(STEP // 32):
                frag = np.zeros((2, 64, 32), np.int64)   # A_t [row, k]
                for wq in range(4):
                    for lane in range(32):
                        g, q = lane >> 2, lane & 3
                        f = _fragments(box, slab, wq, lane)
                        for t in range(2):
                            for p in range(4):
                                bytes_ = np.array([f[t][p]], "<u4").view(
                                    np.int8)
                                row = 16 * wq + g + 8 * (p % 2)
                                kk = 4 * q + 16 * (p // 2)
                                frag[t, row, kk:kk + 4] = bytes_
                ks = slice(s * STEP + 32 * slab, s * STEP + 32 * slab + 32)
                for t in range(2):
                    d[cg, t] += frag[t] @ a_pad[:, ks].T
    c = np.zeros((tqg.WIDE_TILE_M, tqg.WIDE_TILE_N), np.int64)
    for cg in range(2):
        for t in range(2):
            for wq in range(4):
                for g8 in range(8):
                    for h in range(2):
                        col = 128 * cg + 32 * wq + 4 * g8 + 2 * t + h
                        c[:, col] = d[cg, t, 16 * wq + g8 + 8 * h, :]
    return c[:m, :n]


@pytest.mark.parametrize("m,n,k", [(128, 256, 64), (37, 200, 160),
                                   (128, 17, 48)])
def test_wide_kernel_data_flow_matches_the_plain_version(m, n, k):
    rng = np.random.default_rng(m + n + k)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    want = tqg.quant_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                                block_m=1, block_n=1, block_k=16).numpy()
    np.testing.assert_array_equal(_wide_kernel(a, b), want)
