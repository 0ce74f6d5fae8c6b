"""Bit-weight decomposed INT8 GEMM with digit-plane block skipping: the
Hopper kernels (``csrc/bw_gemm.cu``, ``csrc/bw_gemm_sparse.cu``) and their
plain torch versions.

The multiplicand A is pre-encoded into BW digit planes (radix 4: digits in
{-2..2}), and a per-(plane, m-block, k-block) occupancy mask lets the
kernel skip a plane block outright:

    C = sum_bw (masked digits[bw] @ B) * radix**bw      (paper Eq. (4)/(5))

The dense kernels (``bw_gemm``, ``bw_gemm_fused``) read the mask.  The
sparse kernels (``bw_gemm_sparse[_fused]``, m_major schedules) and the
pipelined ones (``bw_gemm_sparse[_fused]_pipelined``, either order) read
a compacted block schedule instead (SCHED_COLS): one entry per live plane
block, whose weight is the plane's radix**plane.

Layout.  ``digits`` is int8 ``[BW, M, K]`` and K-contiguous; ``b`` holds
the activation rows as int8 ``[N, K]`` -- the transpose of the
reference's ``[K, N]`` B -- so both operands are read along K.  N (the
decode batch) is not padded.  M must be a multiple of ``block_m`` and K of
``block_k``; the ``ops`` wrappers pad.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; there is no fallback from one to the other.
Each counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.core.bw_ref import exact_matmul, weighted_plane_sum

__all__ = ["bw_gemm", "bw_gemm_fused", "bw_gemm_plain",
           "bw_gemm_fused_plain", "bw_gemm_sparse", "bw_gemm_sparse_fused",
           "bw_gemm_sparse_pipelined", "bw_gemm_sparse_fused_pipelined",
           "bw_gemm_sparse_plain", "bw_gemm_sparse_fused_plain",
           "bw_gemm_sparse_pipelined_plain",
           "bw_gemm_sparse_fused_pipelined_plain", "EPILOGUE_ACTIVATIONS",
           "SCHED_COLS", "ROW_STREAM_SPANS", "pipelined_grid",
           "pipelined_ranges", "pipelined_work", "schedule_window"]


def _gelu_tanh(x):
    """jax.nn.gelu's default tanh form as it computes it: its constants
    rounded to x's dtype, one rounding an op (in bfloat16 too)."""
    beta = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype,
                        device=x.device)
    kappa = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(beta * (x + kappa * x ** 3))))


# Activations the fused epilogue can apply on the dequantized accumulator,
# in the reference's formulas, op by op: silu is jax.nn.silu's x *
# sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), gelu the tanh form
# (jax.nn.gelu's default).  On every finite bfloat16 input each equals
# the reference wherever the reference's result is a normal number; XLA
# flushes subnormal results (and a subnormal sigmoid) to zero, torch does
# not (tests/test_torch_activations.py).  The kernel epilogue computes the
# same steps in float32.
EPILOGUE_ACTIVATIONS = {
    None: lambda x: x,
    "silu": lambda x: x * (1.0 / (1.0 + torch.exp(-x))),
    "gelu": _gelu_tanh,
    "relu2": lambda x: torch.square(F.relu(x)),
}

# activation name -> the kernel's Activation enum
_ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu2": 3}

# How B1-B4 cut their work, mirrored for the host-side model in the tests.
# Each walks an output row a warp, 16-byte chunks along K with the loads
# of every live plane at a chunk position in flight together, a window of
# k-blocks at a time whose live blocks' weights it knows first: B1/B2
# (csrc/bw_gemm.cu) read their mask bits 32 k-blocks at a time, a ballot a
# plane, each warp for itself, ROW_TILE rows a CTA; B3/B4
# (csrc/bw_gemm_sparse.cu) fill a shared table of 256 k-blocks from the
# schedule once a CTA of ROW_STREAM_ROWS rows.  block_m must be a multiple
# of ROW_TILE, so no CTA straddles two m-blocks.
ROW_TILE = 8
ROW_STREAM_ROWS = 4
ROW_STREAM_THREADS = 32 * ROW_STREAM_ROWS
ROW_STREAM_SPANS = {"mask": 32, "schedule": 256}


def schedule_window(steps: int, mblks: int, mblk: int) -> tuple:
    """(start, width): the schedule entries a B3/B4 CTA of m-block ``mblk``
    reads first (csrc/bw_gemm_sparse.cu fill_table), centred where the
    run would sit if each of the ``mblks`` m-blocks had steps / mblks
    entries, up to ROW_STREAM_THREADS wide.  The CTA keeps the window's
    entries when the window holds both ends of the run, and otherwise
    searches for the run."""
    per = max(mblks, 1)
    run = (steps + mblks - 1) // per
    width = min(ROW_STREAM_THREADS, steps, 2 * run + 32)
    guess = (mblk * steps + steps // 2) // per
    return max(0, min(steps - width, guess - width // 2)), width

# Column layout of the compacted block schedule (int32 [L, 9]), the
# reference's: one entry per live (plane, m-block, k-block) of the
# occupancy mask, plus one zero-weight sentinel per empty m-block row so
# its output rows are still written.  WEIGHT is the deferred-shift plane
# scale radix**plane (0 for sentinels and padding).  FIRST / LAST flag
# each row's first and last entry, and D_SLOT / B_SLOT / B_FETCH the TPU
# kernels' double-buffer slots and activation-block reuse; the Hopper
# kernels read the first four columns.  The sparse kernels take a schedule
# with at least six columns, the pipelined ones exactly nine.
SCHED_COLS = {"plane": 0, "row": 1, "kblk": 2, "weight": 3,
              "first": 4, "last": 5, "d_slot": 6, "b_slot": 7, "b_fetch": 8}
(_PLANE, _ROW, _KBLK, _WEIGHT, _FIRST, _LAST,
 _DSLOT, _BSLOT, _BFETCH) = range(9)


# ---------------------------------------------------------------------------
# Validation shared by the kernels and the plain versions
# ---------------------------------------------------------------------------

def _check_dims(fn: str, digits, b, block_m: int, block_k: int):
    if digits.dim() != 3 or b.dim() != 2:
        raise ValueError(f"{fn}: expected digits [BW, M, K] and b [N, K]; "
                         f"got {tuple(digits.shape)}, {tuple(b.shape)}")
    bw_n, m, k = digits.shape
    n, k2 = b.shape
    if k != k2:
        raise ValueError(f"{fn}: digits have K={k} but b has K={k2}")
    if n < 1:
        raise ValueError(f"{fn}: b has no rows")
    for dim, name, blk, bname in ((m, "M", block_m, "block_m"),
                                  (k, "K", block_k, "block_k")):
        if blk <= 0 or dim % blk:
            raise ValueError(
                f"{fn}: {name}={dim} is not a multiple of {bname}={blk}; "
                f"pad the operands first (the ops wrappers do this)")
    for t, name in ((digits, "digits"), (b, "b")):
        if t.dtype != torch.int8:
            raise TypeError(f"{fn}: {name} must be torch.int8, got "
                            f"{t.dtype}")


def _check_operands(fn: str, digits, b, mask, block_m: int, block_k: int):
    if mask.dim() != 3:
        raise ValueError(f"{fn}: expected mask [BW, M/block_m, K/block_k]; "
                         f"got {tuple(mask.shape)}")
    _check_dims(fn, digits, b, block_m, block_k)
    bw_n, m, k = digits.shape
    if tuple(mask.shape) != (bw_n, m // block_m, k // block_k):
        raise ValueError(
            f"{fn}: mask shape {tuple(mask.shape)} != expected "
            f"({bw_n}, {m // block_m}, {k // block_k}) = "
            f"[BW, M/block_m, K/block_k]")
    if mask.dtype != torch.bool:
        raise TypeError(f"{fn}: mask must be torch.bool, got {mask.dtype}")


def _check_schedule(fn: str, schedule, *, annotated: bool = False):
    """A sparse kernel's schedule: int32 [L, >= 6], or exactly [L, 9]
    (every SCHED_COLS column) when ``annotated``."""
    want = len(SCHED_COLS) if annotated else 6
    ok = (schedule.dim() == 2
          and (schedule.shape[1] == want if annotated
               else schedule.shape[1] >= want))
    if not ok:
        rel = "exactly" if annotated else "at least"
        raise ValueError(
            f"{fn}: schedule must be a 2-D int array with {rel} {want} "
            f"columns (SCHED_COLS), got shape {tuple(schedule.shape)}")
    if schedule.dtype != torch.int32:
        raise TypeError(f"{fn}: schedule must be torch.int32, got "
                        f"{schedule.dtype}")


def _check_devices(fn: str, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{fn}: all operands must be on {dev}, got "
                             f"one on {t.device}")


def _check_sparse(fn: str, digits, b, schedule, block_m: int, block_k: int,
                  annotated: bool, *vectors):
    """Every check of a sparse or pipelined call, on any device."""
    _check_dims(fn, digits, b, block_m, block_k)
    _check_schedule(fn, schedule, annotated=annotated)
    _check_devices(fn, digits, b, schedule, *vectors)


def _check_epilogue(fn: str, activation, scale, bias, scale_n,
                    epilogue_axis: str, m: int, n: int):
    if activation not in EPILOGUE_ACTIVATIONS:
        raise ValueError(
            f"{fn}: unknown activation {activation!r}; expected one of "
            f"{sorted(a for a in EPILOGUE_ACTIVATIONS if a)} or None")
    if epilogue_axis not in ("m", "n"):
        raise ValueError(f"{fn}: epilogue_axis must be 'm' or 'n', got "
                         f"{epilogue_axis!r}")
    want = (m, 1) if epilogue_axis == "m" else (1, n)
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} != "
                             f"expected {want}")
    if scale_n is not None:
        if epilogue_axis != "m":
            raise ValueError(f"{fn}: scale_n only supports "
                             f"epilogue_axis='m'")
        if tuple(scale_n.shape) != (1, n):
            raise ValueError(f"{fn}: scale_n shape {tuple(scale_n.shape)} "
                             f"!= expected (1, {n})")


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the card-side yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------

def bw_gemm_plain(digits, b, mask, *, block_m: int, block_k: int,
                  radix: int = 4) -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm`: exact int32 [M, N]."""
    _check_operands("bw_gemm", digits, b, mask, block_m, block_k)
    full = mask.repeat_interleave(block_m, 1).repeat_interleave(block_k, 2)
    masked = torch.where(full, digits, torch.zeros_like(digits))
    return weighted_plane_sum(masked, b.t(),
                              [radix ** p for p in range(digits.shape[0])])


def _epilogue(acc, scale, bias, scale_n, activation):
    s = scale if scale_n is None else scale * scale_n
    y = acc.to(torch.float32) * s
    if bias is not None:
        y = y + bias
    return EPILOGUE_ACTIVATIONS[activation](y)


def bw_gemm_fused_plain(digits, b, mask, scale, bias=None, scale_n=None, *,
                        block_m: int, block_k: int, radix: int = 4,
                        activation=None,
                        epilogue_axis: str = "m") -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm_fused`: f32 [M, N]."""
    _check_epilogue("bw_gemm_fused", activation, scale, bias, scale_n,
                    epilogue_axis, digits.shape[1], b.shape[0])
    acc = bw_gemm_plain(digits, b, mask, block_m=block_m, block_k=block_k,
                        radix=radix)
    return _epilogue(acc, scale.to(torch.float32),
                     None if bias is None else bias.to(torch.float32),
                     None if scale_n is None else scale_n.to(torch.float32),
                     activation)


def _schedule_sum(digits, b, schedule, block_m: int,
                  block_k: int) -> torch.Tensor:
    """sum over the schedule's entries with weight != 0 of
    digits[plane, row block, kblk] @ b[:, kblk].T * weight: exact int32
    [M, N].  Sentinel and padding entries (weight 0) add nothing; the
    entries' order does not matter."""
    bw_n, m, k = digits.shape
    n = b.shape[0]
    mb, kb = m // block_m, k // block_k
    s = schedule.long()
    s = s[s[:, _WEIGHT] != 0]
    acc = torch.zeros((mb, block_m, n), dtype=torch.int64,
                      device=digits.device)
    if s.shape[0]:
        blocks = digits.reshape(bw_n, mb, block_m, kb, block_k).permute(
            0, 1, 3, 2, 4)[s[:, _PLANE], s[:, _ROW], s[:, _KBLK]]
        cols = b.reshape(n, kb, block_k).permute(1, 2, 0)[s[:, _KBLK]]
        pp = exact_matmul(blocks, cols)         # [E, block_m, N]
        acc.index_add_(0, s[:, _ROW], pp * s[:, _WEIGHT, None, None])
    return acc.reshape(m, n).to(torch.int32)


def _sparse_plain(fn: str, annotated: bool, digits, b, schedule, *,
                  block_m: int, block_k: int) -> torch.Tensor:
    _check_sparse(fn, digits, b, schedule, block_m, block_k, annotated)
    return _schedule_sum(digits, b, schedule, block_m, block_k)


def _sparse_fused_plain(fn: str, annotated: bool, digits, b, schedule,
                        scale, bias=None, scale_n=None, *, block_m: int,
                        block_k: int, activation=None) -> torch.Tensor:
    _check_sparse(fn, digits, b, schedule, block_m, block_k, annotated,
                  scale, bias, scale_n)
    _check_epilogue(fn, activation, scale, bias, scale_n, "m",
                    digits.shape[1], b.shape[0])
    acc = _schedule_sum(digits, b, schedule, block_m, block_k)
    return _epilogue(acc, scale.to(torch.float32),
                     None if bias is None else bias.to(torch.float32),
                     None if scale_n is None else scale_n.to(torch.float32),
                     activation)


def bw_gemm_sparse_plain(digits, b, schedule, *, block_m: int,
                         block_k: int) -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm_sparse`: exact int32 [M, N]."""
    return _sparse_plain("bw_gemm_sparse", False, digits, b, schedule,
                         block_m=block_m, block_k=block_k)


def bw_gemm_sparse_fused_plain(digits, b, schedule, scale, bias=None,
                               scale_n=None, *, block_m: int, block_k: int,
                               activation=None) -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm_sparse_fused`: f32 [M, N]."""
    return _sparse_fused_plain("bw_gemm_sparse_fused", False, digits, b,
                               schedule, scale, bias, scale_n,
                               block_m=block_m, block_k=block_k,
                               activation=activation)


def bw_gemm_sparse_pipelined_plain(digits, b, schedule, *, block_m: int,
                                   block_k: int) -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm_sparse_pipelined`."""
    return _sparse_plain("bw_gemm_sparse_pipelined", True, digits, b,
                         schedule, block_m=block_m, block_k=block_k)


def bw_gemm_sparse_fused_pipelined_plain(digits, b, schedule, scale,
                                         bias=None, scale_n=None, *,
                                         block_m: int, block_k: int,
                                         activation=None) -> torch.Tensor:
    """Plain torch version of :func:`bw_gemm_sparse_fused_pipelined`."""
    return _sparse_fused_plain("bw_gemm_sparse_fused_pipelined", True,
                               digits, b, schedule, scale, bias, scale_n,
                               block_m=block_m, block_k=block_k,
                               activation=activation)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from . import _build
    lib = _build.load("bw_gemm")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bw_gemm_i32.argtypes = [p, p, p, p] + [i] * 7 + [p]
        lib.bw_gemm_i32.restype = i
        lib.bw_gemm_fused.argtypes = [p] * 7 + [i] * 9 + [p]
        lib.bw_gemm_fused.restype = i
        lib._argtypes_set = True
    return lib


def _check_cuda(fn: str, block_m: int, block_k: int, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{fn}: all operands must be on {dev}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
    for t in tensors[:2]:                        # digits and b: int4 loads
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: digits and b must be 16-byte aligned")
    if block_m % ROW_TILE:
        raise ValueError(f"{fn}: block_m={block_m} is not a multiple of "
                         f"the kernel's row tile {ROW_TILE}")
    if block_k % 16:
        raise ValueError(f"{fn}: block_k={block_k} is not a multiple of 16")
    if tensors[0].shape[0] > 8:
        raise ValueError(f"{fn}: at most 8 digit planes, got "
                         f"{tensors[0].shape[0]}")


def _raise_on(fn: str, err: int):
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def bw_gemm(digits, b, mask, *, block_m: int = 128, block_k: int = 256,
            radix: int = 4) -> torch.Tensor:
    """C[M, N] = sum_bw (masked digits[bw] @ b.T) * radix**bw, int32.

    digits: int8 [BW, M, K]; b: int8 [N, K]; mask: bool [BW, M/block_m,
    K/block_k].  Replaces the reference's ``bw_gemm`` Pallas kernel.
    """
    if digits.device.type != "cuda":
        return bw_gemm_plain(digits, b, mask, block_m=block_m,
                             block_k=block_k, radix=radix)
    _check_operands("bw_gemm", digits, b, mask, block_m, block_k)
    _check_cuda("bw_gemm", block_m, block_k, digits, b, mask)
    bw_n, m, k = digits.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bw_gemm_i32(
            digits.data_ptr(), b.data_ptr(), mask.data_ptr(),
            out.data_ptr(), bw_n, m, k, n, block_m, block_k, radix, stream)
    _raise_on("bw_gemm", err)
    bw_gemm.launches += 1
    return out


def bw_gemm_fused(digits, b, mask, scale, bias=None, scale_n=None, *,
                  block_m: int = 128, block_k: int = 256, radix: int = 4,
                  activation=None, epilogue_axis: str = "m") -> torch.Tensor:
    """C = act((sum_bw (masked digits[bw] @ b.T) * radix**bw) * s + bias).

    scale: f32 [M, 1] (epilogue_axis='m': weight channels on M, the
    planned-weight layout) or [1, N] (epilogue_axis='n').  bias: optional,
    same shape as scale.  scale_n: optional f32 [1, N] on the other axis
    (epilogue_axis='m' only) -- the per-token activation scales; the
    epilogue forms s = scale * scale_n before it touches the accumulator.
    Returns f32 [M, N].  Replaces the reference's ``bw_gemm_fused``.
    """
    if digits.device.type != "cuda":
        return bw_gemm_fused_plain(
            digits, b, mask, scale, bias, scale_n, block_m=block_m,
            block_k=block_k, radix=radix, activation=activation,
            epilogue_axis=epilogue_axis)
    _check_operands("bw_gemm_fused", digits, b, mask, block_m, block_k)
    bw_n, m, k = digits.shape
    n = b.shape[0]
    _check_epilogue("bw_gemm_fused", activation, scale, bias, scale_n,
                    epilogue_axis, m, n)
    _check_float32("bw_gemm_fused", scale=scale, bias=bias, scale_n=scale_n)
    _check_cuda("bw_gemm_fused", block_m, block_k, digits, b, mask, scale,
                bias, scale_n)
    out = torch.empty((m, n), dtype=torch.float32, device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bw_gemm_fused(
            digits.data_ptr(), b.data_ptr(), mask.data_ptr(),
            scale.data_ptr(), _ptr(scale_n), _ptr(bias), out.data_ptr(),
            bw_n, m, k, n, block_m, block_k, radix,
            int(epilogue_axis == "n"), _ACT_CODES[activation], stream)
    _raise_on("bw_gemm_fused", err)
    bw_gemm_fused.launches += 1
    return out


def _sparse_lib():
    from . import _build
    lib = _build.load("bw_gemm_sparse")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, n_ptr, n_int in (("bw_gemm_sparse_i32", 4, 8),
                                 ("bw_gemm_sparse_fused", 7, 9),
                                 ("bw_gemm_sparse_pipelined_i32", 5, 9),
                                 ("bw_gemm_sparse_fused_pipelined", 8, 10)):
            getattr(lib, fn).argtypes = [p] * n_ptr + [i] * n_int + [p]
            getattr(lib, fn).restype = i
        for fn, n_int in (("bw_gemm_sparse_pipelined_layout", 3),
                          ("bw_gemm_sparse_pipelined_per_sm", 4)):
            getattr(lib, fn).argtypes = [i] * n_int + [p]
            getattr(lib, fn).restype = i
        lib._argtypes_set = True
    return lib


def _check_float32(fn: str, **vectors):
    for name, t in vectors.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")


# The pipelined kernels' shared memory (csrc/bw_gemm_sparse.cu
# pipelined_layout, which _pipelined_layout mirrors): a ring of 2-4 stages,
# each a row tile of one plane block (at most 128 rows, one 16-row mma
# tile a warp, and 64 KB; rows padded by 16 bytes) and an activation slot
# [NT, block_k + 16], and an int32 accumulator panel [window, block_m, NT]
# of at most 64 KB, a window being up to 32 schedule entries; up to
# 227 KB, an H100 CTA's opt-in limit.
_PIPE_MAX_SMEM = 232448
_PIPE_TILE_BYTES = 64 * 1024
_PIPE_PANEL_BYTES = 64 * 1024
_PIPE_MAX_STAGES = 4
_PIPE_MAX_WINDOW = 32
_PIPE_MMA_ROWS, _PIPE_MMA_K, _PIPE_WARPS = 16, 32, 8
PIPELINED_LAYOUT_FIELDS = ("tile_rows", "tiles", "window", "stages",
                           "stage_bytes", "b_bytes", "smem")


def _nt_for(n: int) -> int:
    """The kernels' column tile: N columns are taken NT at a time."""
    return 1 if n <= 1 else 2 if n <= 2 else 4 if n <= 4 else 8


def _pipelined_layout(n: int, block_m: int, block_k: int) -> dict:
    """How a pipelined call of N columns sits in a CTA's shared memory
    (PIPELINED_LAYOUT_FIELDS), as ``pipelined_layout`` in
    csrc/bw_gemm_sparse.cu computes it; ValueError for what it refuses."""
    nt = _nt_for(n)
    if (block_m <= 0 or block_m % _PIPE_MMA_ROWS or block_k <= 0
            or block_k % _PIPE_MMA_K):
        raise ValueError(f"block_m={block_m} must be a positive multiple of "
                         f"{_PIPE_MMA_ROWS} and block_k={block_k} of "
                         f"{_PIPE_MMA_K} (whole int8 mma tiles)")
    # the largest power of two dividing block_m, one mma tile a warp at most
    rows = min(block_m & -block_m, _PIPE_WARPS * _PIPE_MMA_ROWS)
    while rows > _PIPE_MMA_ROWS and rows * block_k > _PIPE_TILE_BYTES:
        rows >>= 1
    window = min(_PIPE_MAX_WINDOW, _PIPE_PANEL_BYTES // (block_m * nt * 4))
    if window < 1:
        raise ValueError(f"block_m={block_m} at {nt} columns overflows the "
                         f"{_PIPE_PANEL_BYTES}-byte accumulator panel")
    stage, b_slot = rows * (block_k + 16), nt * (block_k + 16)
    panel = window * block_m * nt * 4
    stages = min(_PIPE_MAX_STAGES,
                 (_PIPE_MAX_SMEM - panel) // (stage + b_slot))
    if stages < 2:
        raise ValueError(f"block_m={block_m}, block_k={block_k} need more "
                         f"than {_PIPE_MAX_SMEM} bytes of shared memory for "
                         f"two stages and the panel")
    return dict(zip(PIPELINED_LAYOUT_FIELDS,
                    (rows, block_m // rows, window, stages, stage, b_slot,
                     stages * (stage + b_slot) + panel)))


def pipelined_layout_of_kernel(n: int, block_m: int, block_k: int):
    """The layout csrc/bw_gemm_sparse.cu computes for the same problem
    (PIPELINED_LAYOUT_FIELDS), or None where it refuses it: the card-side
    twin of :func:`_pipelined_layout`, which ``chip_smoke.py`` holds it
    against.  Builds the library; launches nothing."""
    out = (ctypes.c_int * len(PIPELINED_LAYOUT_FIELDS))()
    if _sparse_lib().bw_gemm_sparse_pipelined_layout(n, block_m, block_k,
                                                     out) != 0:
        return None
    return dict(zip(PIPELINED_LAYOUT_FIELDS, out))


def _check_pipelined(fn: str, block_k: int, n: int, block_m: int) -> dict:
    try:
        return _pipelined_layout(n, block_m, block_k)
    except ValueError as e:
        raise ValueError(f"{fn}: {e}") from None


def pipelined_work(steps: int, n: int) -> int:
    """Flat walk positions of a pipelined call: every schedule entry once
    for each column tile of NT columns."""
    return -(-n // _nt_for(n)) * steps


def pipelined_grid(sms: int, per_sm: int) -> int:
    """CTAs of a pipelined call: every CTA the card holds at once (its SMs
    times the CTAs an SM holds at the kernel's shared memory), since the
    call is one cooperative launch whose CTAs meet at grid barriers."""
    if sms < 1 or per_sm < 1:
        raise ValueError(f"the card holds no pipelined CTA ({sms} SMs x "
                         f"{per_sm} CTAs an SM)")
    return sms * per_sm


def pipelined_ranges(work: int, ctas: int) -> list:
    """[begin, end) of the flat walk positions each CTA of a pipelined
    call takes (the kernel computes the same bounds): CTA c of ``ctas``
    takes [c * work // ctas, (c + 1) * work // ctas), so the ranges are
    contiguous, in order, cover every position once and differ in length
    by at most one (ctas - work of them are empty when work < ctas)."""
    if work < 0 or ctas < 1:
        raise ValueError(f"pipelined_ranges: work={work}, ctas={ctas}")
    return [(c * work // ctas, (c + 1) * work // ctas) for c in range(ctas)]


# (device index, NT, block_m, block_k, fused) -> the cooperative grid,
# queried once per device and problem shape
_GRIDS: dict = {}

# (device index, stream) -> the pipelined kernels' int32 workspace.  It is
# zero between calls: a call sums into it and zeroes what it read, so no
# call pays for a memset or a barrier after one.  One per stream, since
# calls on one stream never overlap.
_WORKSPACES: dict = {}


def _pipelined_workspace(stream, numel: int) -> torch.Tensor:
    key = (stream.device.index, stream.cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < numel:
        grown = max(numel, 0 if ws is None else 2 * ws.numel())
        ws = _WORKSPACES[key] = torch.zeros(grown, dtype=torch.int32,
                                            device=stream.device)
    return ws


def _pipelined_ctas(device, n: int, block_m: int, block_k: int,
                    fused: bool) -> int:
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), _nt_for(n), block_m, block_k,
           fused)
    grid = _GRIDS.get(key)
    if grid is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            err = _sparse_lib().bw_gemm_sparse_pipelined_per_sm(
                n, block_m, block_k, int(fused), ctypes.byref(per_sm))
            _raise_on("bw_gemm_sparse_pipelined_per_sm", err)
            sms = torch.cuda.get_device_properties(
                key[0]).multi_processor_count
        grid = _GRIDS[key] = pipelined_grid(sms, per_sm.value)
    return grid


def _sparse_dims(digits, b, schedule):
    bw_n, m, k = digits.shape
    return (schedule.shape[0], schedule.shape[1], bw_n, m, k, b.shape[0])


def bw_gemm_sparse(digits, b, schedule, *, block_m: int = 128,
                   block_k: int = 256) -> torch.Tensor:
    """C[M, N] = sum over the schedule's entries of
    (digits[plane] block @ b.T block) * weight, int32.

    digits: int8 [BW, M, K]; b: int8 [N, K]; schedule: int32 [L, >= 6] in
    m_major order (SCHED_COLS; each m-block row's entries consecutive).
    Replaces the reference's ``bw_gemm_sparse`` Pallas kernel.
    """
    if digits.device.type != "cuda":
        return bw_gemm_sparse_plain(digits, b, schedule, block_m=block_m,
                                    block_k=block_k)
    fn = "bw_gemm_sparse"
    _check_sparse(fn, digits, b, schedule, block_m, block_k, False)
    _check_cuda(fn, block_m, block_k, digits, b, schedule)
    dims = _sparse_dims(digits, b, schedule)
    out = torch.empty((dims[3], dims[5]), dtype=torch.int32,
                      device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _sparse_lib().bw_gemm_sparse_i32(
            digits.data_ptr(), b.data_ptr(), schedule.data_ptr(),
            out.data_ptr(), *dims, block_m, block_k, stream)
    _raise_on(fn, err)
    bw_gemm_sparse.launches += 1
    return out


def bw_gemm_sparse_fused(digits, b, schedule, scale, bias=None, scale_n=None,
                         *, block_m: int = 128, block_k: int = 256,
                         activation=None) -> torch.Tensor:
    """bw_gemm_sparse with the fused epilogue of :func:`bw_gemm_fused`
    (epilogue_axis='m'): scale f32 [M, 1], optional bias [M, 1] and
    scale_n [1, N].  Returns f32 [M, N]; a sentinel row is
    act(0 * s + bias).  Replaces the reference's ``bw_gemm_sparse_fused``.
    """
    if digits.device.type != "cuda":
        return bw_gemm_sparse_fused_plain(
            digits, b, schedule, scale, bias, scale_n, block_m=block_m,
            block_k=block_k, activation=activation)
    fn = "bw_gemm_sparse_fused"
    _check_sparse(fn, digits, b, schedule, block_m, block_k, False, scale,
                  bias, scale_n)
    _check_epilogue(fn, activation, scale, bias, scale_n, "m",
                    digits.shape[1], b.shape[0])
    _check_float32(fn, scale=scale, bias=bias, scale_n=scale_n)
    _check_cuda(fn, block_m, block_k, digits, b, schedule, scale, bias,
                scale_n)
    dims = _sparse_dims(digits, b, schedule)
    out = torch.empty((dims[3], dims[5]), dtype=torch.float32,
                      device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _sparse_lib().bw_gemm_sparse_fused(
            digits.data_ptr(), b.data_ptr(), schedule.data_ptr(),
            scale.data_ptr(), _ptr(scale_n), _ptr(bias), out.data_ptr(),
            *dims, block_m, block_k, _ACT_CODES[activation], stream)
    _raise_on(fn, err)
    bw_gemm_sparse_fused.launches += 1
    return out


def bw_gemm_sparse_pipelined(digits, b, schedule, *, block_m: int = 128,
                             block_k: int = 256) -> torch.Tensor:
    """bw_gemm_sparse on a schedule in either order: int32 [M, N],
    bit-identical to bw_gemm_sparse on the same mask.

    schedule: int32 [L, 9] (every SCHED_COLS column).  One call is one
    cooperative launch (it walks the schedule into the stream's zeroed
    int32 workspace and, after a grid barrier, copies the sums out and
    zeroes the workspace again) and one counted launch.  Replaces the
    reference's ``bw_gemm_sparse_pipelined``.
    """
    if digits.device.type != "cuda":
        return bw_gemm_sparse_pipelined_plain(
            digits, b, schedule, block_m=block_m, block_k=block_k)
    fn = "bw_gemm_sparse_pipelined"
    _check_sparse(fn, digits, b, schedule, block_m, block_k, True)
    _check_cuda(fn, block_m, block_k, digits, b, schedule)
    _check_pipelined(fn, block_k, b.shape[0], block_m)
    dims = _sparse_dims(digits, b, schedule)
    out = torch.empty((dims[3], dims[5]), dtype=torch.int32,
                      device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream()
        ws = _pipelined_workspace(stream, out.numel())
        err = _sparse_lib().bw_gemm_sparse_pipelined_i32(
            digits.data_ptr(), b.data_ptr(), schedule.data_ptr(),
            ws.data_ptr(), out.data_ptr(), *dims, block_m, block_k,
            _pipelined_ctas(digits.device, dims[5], block_m, block_k, False),
            stream.cuda_stream)
    _raise_on(fn, err)
    bw_gemm_sparse_pipelined.launches += 1
    return out


def bw_gemm_sparse_fused_pipelined(digits, b, schedule, scale, bias=None,
                                   scale_n=None, *, block_m: int = 128,
                                   block_k: int = 256,
                                   activation=None) -> torch.Tensor:
    """bw_gemm_sparse_fused on a schedule in either order, bit-identical
    to it on the same mask.

    schedule: int32 [L, 9].  One call is one cooperative launch (as
    :func:`bw_gemm_sparse_pipelined`, with the epilogue where the copy
    was) and one counted launch.  Replaces the reference's
    ``bw_gemm_sparse_fused_pipelined``.
    """
    if digits.device.type != "cuda":
        return bw_gemm_sparse_fused_pipelined_plain(
            digits, b, schedule, scale, bias, scale_n, block_m=block_m,
            block_k=block_k, activation=activation)
    fn = "bw_gemm_sparse_fused_pipelined"
    _check_sparse(fn, digits, b, schedule, block_m, block_k, True, scale,
                  bias, scale_n)
    _check_epilogue(fn, activation, scale, bias, scale_n, "m",
                    digits.shape[1], b.shape[0])
    _check_float32(fn, scale=scale, bias=bias, scale_n=scale_n)
    _check_cuda(fn, block_m, block_k, digits, b, schedule, scale, bias,
                scale_n)
    _check_pipelined(fn, block_k, b.shape[0], block_m)
    dims = _sparse_dims(digits, b, schedule)
    out = torch.empty((dims[3], dims[5]), dtype=torch.float32,
                      device=digits.device)
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream()
        ws = _pipelined_workspace(stream, out.numel())
        err = _sparse_lib().bw_gemm_sparse_fused_pipelined(
            digits.data_ptr(), b.data_ptr(), schedule.data_ptr(),
            scale.data_ptr(), _ptr(scale_n), _ptr(bias), ws.data_ptr(),
            out.data_ptr(), *dims, block_m, block_k,
            _pipelined_ctas(digits.device, dims[5], block_m, block_k, True),
            _ACT_CODES[activation], stream.cuda_stream)
    _raise_on(fn, err)
    bw_gemm_sparse_fused_pipelined.launches += 1
    return out


bw_gemm.launches = 0
bw_gemm_fused.launches = 0
bw_gemm_sparse.launches = 0
bw_gemm_sparse_fused.launches = 0
bw_gemm_sparse_pipelined.launches = 0
bw_gemm_sparse_fused_pipelined.launches = 0
