"""The baseline INT8 GEMM (the "parallel MAC" reference the paper
compares the bit-weight GEMM with): the Hopper kernels
(``csrc/quant_gemm.cu``) and their plain torch versions.

    quant_gemm        C[M, N] = A[M, K] @ B[K, N], exact int32
    quant_gemm_fused  C = act((A @ B) * scale + bias), float32 or bfloat16

A and B are int8 in the reference's layout: A K-contiguous, B ``[K, N]``
N-contiguous.  M, N and K must be multiples of ``block_m``, ``block_n``
and ``block_k`` (the reference's contract; the ``ops`` wrappers pad K to
16 and pass blocks that divide the rest); the kernel's own tiles are
independent of them.

The kernels take any M, N >= 1 and K a multiple of 16, either operand
the large one.  :func:`launch_plan` picks one of three designs by shape
(the source explains each): ``rows`` when B has at most 16 columns (A
streamed row by row), ``cols`` when A has at most 16 rows (B streamed
along N), ``wide`` otherwise (128 x 256 tiles of C on the tensor cores
by ``wgmma``, fed by TMA from a producer warp).  A call is one launch,
with no workspace: each design splits a tile's K over the CTAs of a
thread-block cluster, which add their sums in shared memory.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; there is no fallback from one to the
other.  Each counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bw_ref import exact_matmul
from .bw_gemm import (_ACT_CODES, _check_devices, _check_epilogue,
                      _check_float32, _epilogue)

__all__ = ["quant_gemm", "quant_gemm_fused", "quant_gemm_plain",
           "quant_gemm_fused_plain", "OUT_DTYPES", "DESIGNS",
           "LAYOUT_FIELDS", "launch_plan", "cta_units"]

# output dtypes the fused kernel writes
OUT_DTYPES = (torch.float32, torch.bfloat16)

# The kernels' work split (csrc/quant_gemm.cu, whose layout_of _layout
# mirrors).  rows: 16 rows of A a CTA, K in 16-byte chunks; cols: 128
# columns of B a CTA, K in quads of 4 bytes; wide: tiles of C of
# WIDE_TILE_M rows x WIDE_TILE_N columns, K in 128-byte steps.  rows and
# cols split a tile's K over a cluster of at most MAX_CLUSTER CTAs; their
# skinny operand (at most 16 rows or columns) is staged in shared memory,
# at most STAGE_CAP bytes a CTA.
DESIGNS = ("rows", "cols", "wide")
ROWS, COLS, WIDE = range(3)
SKINNY_MAX = 16
MAX_CLUSTER = 8
ROW_TILE, COL_TILE = 16, 128
WIDE_TILE_M, WIDE_TILE_N = 128, 256
UNIT_BYTES = (16, 4, 128)            # K bytes a unit, by design
STAGE_CAP = 32768
# wide's ring: WIDE_STAGES stages of an A tile (WIDE_TILE_M rows of a K
# step) and the raw B step (a K step's rows of WIDE_TILE_N columns), and
# 1024 bytes to align it for the 128-byte swizzle
WIDE_STAGES = 4
WIDE_SMEM = (WIDE_STAGES * (WIDE_TILE_M + WIDE_TILE_N) * UNIT_BYTES[2]
             + 1024)
LAYOUT_FIELDS = ("nt", "tiles", "units", "span", "smem")

# How finely a call is cut, by the card's SM count: rows / cols split K
# until the grid holds about THREADS_PER_SM threads an SM (CTAs of
# CTA_THREADS; a split keeps at least MIN_UNITS units: 32 chunks, a lane
# sweep of a row, or 32 quads, two a warp), the targets that timed best
# on an H100 (PERF.md); wide takes one CTA an SM (its ring fills the SM's
# shared memory) and splits K as far as the grid stays within the SMs.
CTA_THREADS = (256, 512)
THREADS_PER_SM = (512, 640)
MIN_UNITS = (32, 32)


def _check_gemm(fn: str, a, b, block_m: int, block_n: int, block_k: int,
                *vectors):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{fn}: expected a [M, K] and b [K, N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"{fn}: a has K={k} columns but b has K={k2} rows")
    for dim, name, blk, bname in ((m, "M", block_m, "block_m"),
                                  (n, "N", block_n, "block_n"),
                                  (k, "K", block_k, "block_k")):
        if blk <= 0 or dim % blk:
            raise ValueError(
                f"{fn}: {name}={dim} is not a multiple of {bname}={blk}; "
                f"pad the operands first (the ops wrappers do this)")
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != torch.int8:
            raise TypeError(f"{fn}: {name} must be torch.int8, got "
                            f"{t.dtype}")
    _check_devices(fn, a, b, *vectors)


def _check_fused(fn: str, a, b, scale, bias, activation, epilogue_axis,
                 out_dtype, blocks):
    _check_gemm(fn, a, b, *blocks, scale, bias)
    _check_epilogue(fn, activation, scale, bias, None, epilogue_axis,
                    a.shape[0], b.shape[1])
    if not out_dtype.is_floating_point:
        raise TypeError(f"{fn}: out_dtype must be a float dtype, got "
                        f"{out_dtype}")


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the card-side yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------

def quant_gemm_plain(a, b, *, block_m: int = 128, block_n: int = 128,
                     block_k: int = 256) -> torch.Tensor:
    """Plain torch version of :func:`quant_gemm`: exact int32 [M, N]."""
    _check_gemm("quant_gemm", a, b, block_m, block_n, block_k)
    return exact_matmul(a, b).to(torch.int32)


def quant_gemm_fused_plain(a, b, scale, bias=None, *, activation=None,
                           epilogue_axis: str = "n",
                           out_dtype=torch.float32, block_m: int = 128,
                           block_n: int = 128,
                           block_k: int = 256) -> torch.Tensor:
    """Plain torch version of :func:`quant_gemm_fused`."""
    blocks = (block_m, block_n, block_k)
    _check_fused("quant_gemm_fused", a, b, scale, bias, activation,
                 epilogue_axis, out_dtype, blocks)
    acc = exact_matmul(a, b).to(torch.int32)
    y = _epilogue(acc, scale.to(torch.float32),
                  None if bias is None else bias.to(torch.float32), None,
                  activation)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# The work split, as the kernels compute it
# ---------------------------------------------------------------------------

def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _layout(m: int, n: int, k: int, design: int, ctas: int) -> dict:
    """How a call of (m, n, k) cut into ``ctas`` CTAs of ``design`` sits on
    the card (LAYOUT_FIELDS): the skinny side's instantiation (4, 8 or
    16; 0 for wide), the tiles of C, the K units a tile, the words of a
    staged skinny row and a CTA's dynamic shared memory, as
    ``layout_of`` in csrc/quant_gemm.cu computes them; ValueError for
    what it refuses."""
    if m < 1 or n < 1 or k < 16 or k % 16 or ctas < 1:
        raise ValueError(f"m={m}, n={n} must be positive, k={k} a positive "
                         f"multiple of 16 and ctas={ctas} positive")
    if design not in (ROWS, COLS, WIDE):
        raise ValueError(f"unknown design {design}")
    if design == WIDE:
        tiles = _cdiv(m, WIDE_TILE_M) * _cdiv(n, WIDE_TILE_N)
        units = _cdiv(k, UNIT_BYTES[WIDE])
    else:
        skinny = n if design == ROWS else m
        tiles = _cdiv(m, ROW_TILE) if design == ROWS else _cdiv(n, COL_TILE)
        units = k // UNIT_BYTES[design]
        if skinny > SKINNY_MAX:
            raise ValueError(
                f"{DESIGNS[design]} takes at most {SKINNY_MAX} "
                f"{'columns of b' if design == ROWS else 'rows of a'}, got "
                f"{skinny}")
    if ctas % tiles or ctas // tiles > min(units, MAX_CLUSTER):
        raise ValueError(f"{ctas} CTAs do not split {tiles} tiles of "
                         f"{units} units in clusters of at most "
                         f"{MAX_CLUSTER}")
    if design == WIDE:
        return dict(zip(LAYOUT_FIELDS, (0, tiles, units, 0, WIDE_SMEM)))
    nt = 4 if skinny <= 4 else 8 if skinny <= 8 else 16
    per = _cdiv(units, ctas // tiles)
    span = 4 * per if design == ROWS else per
    if skinny * span * 4 > STAGE_CAP:
        raise ValueError(f"{skinny * span * 4} staged bytes a CTA, above "
                         f"{STAGE_CAP}")
    smem = skinny * span * 4 + (skinny * COL_TILE * 4 if design == COLS
                                else 0)
    return dict(zip(LAYOUT_FIELDS, (nt, tiles, units, span, smem)))


def launch_plan(m: int, n: int, k: int, sms: int) -> dict:
    """The design and grid a call of (m, n, k) takes on a card of ``sms``
    SMs, with its layout: ``rows`` when b has at most 16 columns (and no
    more than a has rows), ``cols`` when a has at most 16 rows, else (or
    where a cluster cannot stage the skinny operand's K) ``wide``."""
    design = (ROWS if n <= SKINNY_MAX and n <= m
              else COLS if m <= SKINNY_MAX else WIDE)
    if design != WIDE:
        skinny = n if design == ROWS else m
        tiles = (_cdiv(m, ROW_TILE) if design == ROWS
                 else _cdiv(n, COL_TILE))
        units = k // UNIT_BYTES[design]
        # the fewest splits whose staged rows fit, and enough to fill the
        # card where each split keeps MIN_UNITS units
        fit = _cdiv(units, STAGE_CAP // (skinny * UNIT_BYTES[design]))
        fill = min(_cdiv(THREADS_PER_SM[design] * sms,
                         CTA_THREADS[design] * tiles),
                   max(1, units // MIN_UNITS[design]), MAX_CLUSTER)
        if fit <= MAX_CLUSTER:
            ctas = tiles * min(units, max(fit, fill))
            return dict(design=design, ctas=ctas,
                        **_layout(m, n, k, design, ctas))
    # wide: one CTA an SM; the most K splits (a cluster a tile) that keep
    # the grid within the SMs
    tiles = _cdiv(m, WIDE_TILE_M) * _cdiv(n, WIDE_TILE_N)
    units = _cdiv(k, UNIT_BYTES[WIDE])
    ctas = tiles * max(1, min(sms // tiles, units, MAX_CLUSTER))
    return dict(design=WIDE, ctas=ctas, **_layout(m, n, k, WIDE, ctas))


def cta_units(c: int, total: int, ctas: int) -> tuple:
    """[begin, end) of the units CTA c of ``ctas`` takes, of ``total``
    (tiles * units, tile-major): contiguous, in order, every unit once."""
    return c * total // ctas, (c + 1) * total // ctas


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from . import _build
    lib = _build.load("quant_gemm")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_gemm_i32.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.quant_gemm_i32.restype = i
        lib.quant_gemm_fused.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.quant_gemm_fused.restype = i
        lib.quant_gemm_layout.argtypes = [i] * 5 + [p]
        lib.quant_gemm_layout.restype = i
        lib._argtypes_set = True
    return lib


def layout_of_kernel(m: int, n: int, k: int, design: int, ctas: int):
    """The layout csrc/quant_gemm.cu computes for the same call
    (LAYOUT_FIELDS), or None where it refuses it: the card-side twin of
    :func:`_layout`, which ``chip_smoke.py`` holds it against.  Builds the
    library; launches nothing."""
    out = (ctypes.c_int * len(LAYOUT_FIELDS))()
    if _lib().quant_gemm_layout(m, n, k, design, ctas, out) != 0:
        return None
    return dict(zip(LAYOUT_FIELDS, out))


_SMS: dict = {}


def _sms(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]


def _check_cuda(fn: str, a, b, *vectors):
    for t in (a, b, *vectors):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{fn}: a and b must be 16-byte aligned")
    if a.shape[1] % 16:
        raise ValueError(f"{fn}: K={a.shape[1]} is not a multiple of 16")


def _launch(fn: str, entry: str, a, b, out, vectors=(), flags=()):
    """Launch ``entry`` of the library: (a, b, *vectors, out, m, n, k,
    design, ctas, *flags, stream)."""
    m, k = a.shape
    n = b.shape[1]
    plan = launch_plan(m, n, k, _sms(a.device))
    with torch.cuda.device(a.device):
        err = getattr(_lib(), entry)(
            a.data_ptr(), b.data_ptr(), *vectors, out.data_ptr(), m, n, k,
            plan["design"], plan["ctas"], *flags,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{err}")


def quant_gemm(a, b, *, block_m: int = 128, block_n: int = 128,
               block_k: int = 256) -> torch.Tensor:
    """int8 A [M, K] @ int8 B [K, N] -> exact int32 [M, N].

    Replaces the reference's ``quant_gemm`` Pallas kernel.
    """
    if a.device.type != "cuda":
        return quant_gemm_plain(a, b, block_m=block_m, block_n=block_n,
                                block_k=block_k)
    fn = "quant_gemm"
    _check_gemm(fn, a, b, block_m, block_n, block_k)
    _check_cuda(fn, a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    _launch(fn, "quant_gemm_i32", a, b, out)
    quant_gemm.launches += 1
    return out


def quant_gemm_fused(a, b, scale, bias=None, *, activation=None,
                     epilogue_axis: str = "n", out_dtype=torch.float32,
                     block_m: int = 128, block_n: int = 128,
                     block_k: int = 256) -> torch.Tensor:
    """C = act((A @ B)_int * scale + bias), cast to ``out_dtype``.

    scale: f32 [1, N] (epilogue_axis='n') or [M, 1] (epilogue_axis='m');
    bias: optional, the same shape.  activation: a key of
    ``bw_gemm.EPILOGUE_ACTIVATIONS``, the epilogue B1 runs.  out_dtype:
    float32 or bfloat16 on the card.  Replaces the reference's
    ``quant_gemm_fused`` Pallas kernel.
    """
    blocks = (block_m, block_n, block_k)
    if a.device.type != "cuda":
        return quant_gemm_fused_plain(
            a, b, scale, bias, activation=activation,
            epilogue_axis=epilogue_axis, out_dtype=out_dtype,
            block_m=block_m, block_n=block_n, block_k=block_k)
    fn = "quant_gemm_fused"
    _check_fused(fn, a, b, scale, bias, activation, epilogue_axis,
                 out_dtype, blocks)
    _check_float32(fn, scale=scale, bias=bias)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{fn}: out_dtype must be one of {OUT_DTYPES} on "
                        f"the card, got {out_dtype}")
    _check_cuda(fn, a, b, scale, bias)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    _launch(fn, "quant_gemm_fused", a, b, out,
            (scale.data_ptr(), None if bias is None else bias.data_ptr()),
            (int(epilogue_axis == "n"), _ACT_CODES[activation],
             int(out_dtype == torch.bfloat16)))
    quant_gemm_fused.launches += 1
    return out


quant_gemm.launches = 0
quant_gemm_fused.launches = 0
