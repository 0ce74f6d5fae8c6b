"""Weight planning and the quantized-linear entry points around the
bit-weight GEMM kernels: padding, plane encoding, occupancy masks, the
magnitude-ordered row permutation, compacted block schedules, dispatch
and dequantization.

The kernel-level API is the reference's: ``encode_planes`` and
``plane_density``; ``plan_operand``, whose ``encode_impl='kernel'``
encodes an EN-T int8 operand with the ``ent_encode`` kernel (B7);
``bw_gemm`` / ``bw_gemm_fused`` on a ``PlannedOperand`` (B2 / B1) and its
sparse and pipelined twins (B3-B6); and the parallel-MAC baseline
``quant_gemm`` / ``quant_gemm_fused`` (B9 / B8), which pad K to 16
and call the kernel (whose tiles take any M and N).  B is int8
``[K, N]`` throughout.

Every entry point is configured by one
:class:`repro_torch.engine.QuantSpec`.  A plan record built here holds the
same arrays as the reference's (``repro.kernels.ops.plan_dense_weight``),
its annotated ``[L, 9]`` block schedule included.  ``planned_dense_apply``
routes a call to one of three kernel pairs: ``dense`` (B1/B2, the mask),
``sparse`` (B3/B4, an m_major schedule) or ``pipelined`` (B5/B6, either
schedule order); ``auto`` picks by the schedule's density.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import encodings as enc
from repro_torch.core import quant as quantlib
from repro_torch.engine.spec import QuantSpec
from . import bw_gemm as _bw
from . import encode as _enc_kernel
from . import quant_gemm as _qg
from . import ref as kref

__all__ = ["PlannedOperand", "encode_planes", "plane_block_mask",
           "plane_density", "plan_operand", "bw_gemm", "bw_gemm_fused",
           "quant_gemm", "quant_gemm_fused", "select_block_sizes",
           "plan_dense_weight", "plan_params", "plan_tree_density",
           "planned_dense_apply", "quantized_dense", "build_schedule",
           "pad_schedule", "schedule_stats", "bw_gemm_sparse",
           "bw_gemm_sparse_fused", "bw_gemm_sparse_pipelined",
           "bw_gemm_sparse_fused_pipelined", "SPARSE_DENSITY_THRESHOLD",
           "SCHEDULE_ORDERS", "DISPATCHES"]


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()            # F.pad lists the last dim first
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return F.pad(x, widths)


def encode_planes(a: torch.Tensor, encoding: str = "ent",
                  bits: int = 8) -> torch.Tensor:
    """int8 A [M, K] -> digit planes int8 [BW, M, K]."""
    return kref.encode_planes_ref(a, encoding, bits)


# ---------------------------------------------------------------------------
# Per-shape block-size selection
# ---------------------------------------------------------------------------
# The reference's static dispatch table: first row whose minimum (M, K, N)
# thresholds are all met wins.  (The reference consults a measured autotune
# cache first; the port has none yet, so a shape the cache covers there
# may plan with other blocks here.)
_BLOCK_TABLE = (
    # (min_m, min_k, min_n)  ->  (block_m, block_k, block_n)
    ((512, 2048, 512), (256, 512, 256)),
    ((256, 1024, 256), (256, 512, 128)),
    ((128, 512, 128), (128, 256, 128)),
    ((0, 0, 0), (128, 128, 128)),
)


def select_block_sizes(m: int, k: int, n: int,
                       spec: Optional[QuantSpec] = None):
    """(block_m, block_k, block_n) for a logical [M, K] x [K, N] GEMM; a
    spec's explicit block overrides win component-wise."""
    sel = _BLOCK_TABLE[-1][1]
    for (mn_m, mn_k, mn_n), blocks in _BLOCK_TABLE:
        if m >= mn_m and k >= mn_k and n >= mn_n:
            sel = blocks
            break
    if spec is not None:
        sel = (spec.block_m or sel[0], spec.block_k or sel[1],
               spec.block_n or sel[2])
    return sel


def plane_block_mask(digits: torch.Tensor, block_m: int,
                     block_k: int) -> torch.Tensor:
    """bool [BW, M/bm, K/bk]: True where a plane block has a non-zero digit."""
    bw, m, k = digits.shape
    d = digits.reshape(bw, m // block_m, block_m, k // block_k, block_k)
    return (d != 0).any(dim=4).any(dim=2)


def plane_density(digits: torch.Tensor, block_m: int, block_k: int) -> dict:
    """Fraction of non-skippable blocks per plane (perf introspection)."""
    mask = plane_block_mask(digits, block_m, block_k)
    return {f"plane{i}": int(mask[i].sum()) / mask[i].numel()
            for i in range(mask.shape[0])}


# ---------------------------------------------------------------------------
# Compacted sparse block schedules (CSR-of-blocks over the occupancy mask)
# ---------------------------------------------------------------------------
# numpy on the host, once per weight, as in the reference
# (repro.kernels.ops); planning is not on the step path.

# Above this plane-block density the sparse routes give way to the dense
# kernels: the dense kernels retire every plane of a block in one pass.
SPARSE_DENSITY_THRESHOLD = 0.5

# Schedule visit orders (build_schedule order=):
#   m_major -- by m-block row, within a row by (k-block, plane): each output
#              row's entries form one consecutive run, as the sparse
#              kernels (B3/B4) require.
#   k_major -- sentinels first, then by k-block, within a k-block by (row,
#              plane): consecutive entries across different output rows
#              share an activation block; only the pipelined kernels
#              (B5/B6) take it.
SCHEDULE_ORDERS = ("m_major", "k_major")

# planned_dense_apply dispatch values ('auto' resolves to one of the rest)
DISPATCHES = ("dense", "sparse", "pipelined", "auto")


def _annotate_schedule(entries) -> np.ndarray:
    """(plane, row, kblk, weight) tuples -> int32 [L, 9] SCHED_COLS rows.

    FIRST/LAST mark each output row's overall first/last entry;
    D_SLOT/B_SLOT alternate per fetch and B_FETCH is 0 when the entry's
    k-block is already resident (the TPU kernels' double-buffer plumbing,
    kept so the record equals the reference's; the Hopper kernels read
    the first four columns).
    """
    first_step, last_step = {}, {}
    for i, (_p, row, _kk, _w) in enumerate(entries):
        first_step.setdefault(row, i)
        last_step[row] = i
    sched = np.zeros((len(entries), 9), dtype=np.int32)
    resident_k = None
    n_dfetch = n_bfetch = 0
    for i, (p, row, kk, w) in enumerate(entries):
        d_slot = b_slot = b_fetch = 0
        if w != 0:
            d_slot = n_dfetch % 2
            n_dfetch += 1
            if kk != resident_k:
                b_fetch = 1
                b_slot = n_bfetch % 2
                n_bfetch += 1
                resident_k = kk
            else:
                b_slot = (n_bfetch - 1) % 2
        sched[i] = (p, row, kk, w, int(first_step[row] == i),
                    int(last_step[row] == i), d_slot, b_slot, b_fetch)
    return sched


def build_schedule(mask, radix: int, order: str = "m_major") -> np.ndarray:
    """Compact a plane-block occupancy mask into an int32 [L, 9] schedule.

    mask: bool [BW, Mb, Kb] (numpy or a tensor on any device).  One entry
    per True cell, in the visit ``order`` (SCHEDULE_ORDERS); every empty
    row gets one zero-weight sentinel entry so its output rows are still
    written.  Columns are bw_gemm.SCHED_COLS: (plane, row, kblk,
    weight=radix**plane, first, last, d_slot, b_slot, b_fetch).
    """
    if order not in SCHEDULE_ORDERS:
        raise ValueError(f"order must be one of {SCHEDULE_ORDERS}, "
                         f"got {order!r}")
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    mask = np.asarray(mask)
    bw_n, mb, kb = mask.shape
    entries = []
    if order == "m_major":
        for row in range(mb):
            cells = np.argwhere(mask[:, row, :])      # (plane, kblk) pairs
            if cells.size == 0:
                entries.append((0, row, 0, 0))        # sentinel
                continue
            o = np.lexsort((cells[:, 0], cells[:, 1]))  # by (kblk, plane)
            entries.extend((int(p), row, int(kk), radix ** int(p))
                           for p, kk in cells[o])
    else:
        for row in range(mb):
            if not mask[:, row, :].any():
                entries.append((0, row, 0, 0))        # sentinels up front
        for kk in range(kb):
            cells = np.argwhere(mask[:, :, kk])       # (plane, row) pairs
            o = np.lexsort((cells[:, 0], cells[:, 1]))  # by (row, plane)
            entries.extend((int(p), int(row), kk, radix ** int(p))
                           for p, row in cells[o])
    return _annotate_schedule(entries)


def pad_schedule(schedule: np.ndarray, length: int) -> np.ndarray:
    """Pad a schedule to ``length`` entries with exact no-op entries.

    Padding repeats the final entry with weight 0 and every later column
    cleared (first/last and the fetch columns), appended after it.
    """
    sched = np.asarray(schedule)
    if sched.shape[0] > length:
        raise ValueError(f"cannot pad a {sched.shape[0]}-step schedule "
                         f"down to {length}")
    if sched.shape[0] == length:
        return sched
    pad = np.repeat(sched[-1:], length - sched.shape[0], axis=0)
    pad[:, _bw._WEIGHT:] = 0
    return np.concatenate([sched, pad], axis=0)


def schedule_stats(schedule, mask) -> dict:
    """Real (non-sentinel, non-padding) entry count and block density."""
    if isinstance(schedule, torch.Tensor):
        schedule = schedule.cpu().numpy()
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    sched = np.asarray(schedule)
    mask = np.asarray(mask)
    real = int((sched[:, _bw._WEIGHT] != 0).sum())  # weight 0: no-op entry
    total = int(mask.size)
    out = {"steps": int(sched.shape[0]), "nnz_blocks": real,
           "total_blocks": total,
           "density": real / total if total else 0.0}
    if sched.shape[1] >= 9:
        fetches = int(sched[:, _bw._BFETCH].sum())
        out["b_fetches"] = fetches
        out["b_dma_elided"] = real - fetches
    return out


@dataclasses.dataclass
class PlannedOperand:
    """A pre-encoded multiplicand ready for bw_gemm.

    row_perm sorts rows by high-plane occupancy so that non-zero
    high-weight digits cluster into few row blocks (turning the paper's
    element-level partial-product sparsity into block sparsity); inv_perm
    restores output order.
    """
    digits: torch.Tensor        # int8 [BW, M_pad, K_pad]
    mask: torch.Tensor          # bool [BW, M_pad/bm, K_pad/bk]
    row_perm: torch.Tensor      # int32 [M_pad]
    inv_perm: torch.Tensor      # int32 [M_pad]
    m: int                      # original M
    k: int
    block_m: int
    block_k: int
    encoding: str
    schedule: Optional[torch.Tensor] = None   # int32 [L, 9], build_schedule
    order: str = "m_major"                    # the schedule's visit order

    def density(self) -> float:
        """Fraction of non-zero plane blocks (the sparse-dispatch signal)."""
        return float(self.mask.to(torch.float32).mean())


# plan_operand encode_impl values: the torch oracle, or the ent_encode
# kernel (B7)
_ENCODE_IMPLS = ("ref", "kernel")


def plan_operand(a_int8: torch.Tensor, encoding: str = "ent",
                 block_m: int = 128, block_k: int = 256,
                 reorder_rows: bool = True, encode_impl: str = "ref",
                 bits: int = 8, order: str = "m_major") -> PlannedOperand:
    """Pad, magnitude-order the rows of, encode an int8 multiplicand, and
    compact its occupancy mask into a block schedule.

    a_int8: int8 [M, K] (e.g. a transposed weight matrix).  encode_impl:
    'ref' (the torch oracle) or 'kernel' (the fused EN-T encoder,
    ``encode.ent_encode``: the kernel on the card, its plain version on
    the CPU).  order: the schedule's visit order (SCHEDULE_ORDERS);
    'k_major' schedules need the pipelined kernels.  The schedule lands on
    the operand's device.
    """
    if encode_impl not in _ENCODE_IMPLS:
        raise ValueError(f"encode_impl must be one of {_ENCODE_IMPLS}, got "
                         f"{encode_impl!r}")
    a = a_int8.to(torch.int8)
    m, k = a.shape
    a = _pad_to(_pad_to(a, block_m, 0), block_k, 1)
    if reorder_rows:
        # sort rows by their high-plane digit counts (top min(2, BW) planes,
        # most significant first) so rows needing the high planes pack into
        # few row blocks; the stable sort keeps ties in row order
        d0 = kref.encode_planes_ref(a, encoding, bits)
        hi = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
        for p in range(min(2, d0.shape[0])):
            hi = hi * 1000 + (d0[-(p + 1)] != 0).sum(dim=1)
        row_perm = torch.argsort(-hi, stable=True).to(torch.int32)
    else:
        row_perm = torch.arange(a.shape[0], dtype=torch.int32,
                                device=a.device)
    inv_perm = torch.argsort(row_perm).to(torch.int32)
    a_sorted = a[row_perm.long()]
    if encode_impl == "kernel" and encoding == "ent" and bits == 8:
        digits, mask = _enc_kernel.ent_encode(a_sorted, block_m=block_m,
                                              block_k=block_k)
    else:
        # the reference's contract, chosen by argument: the kernel encodes
        # EN-T int8 only, and any other encoding or width takes the oracle
        digits = kref.encode_planes_ref(a_sorted, encoding, bits)
        mask = plane_block_mask(digits, block_m, block_k)
    schedule = torch.from_numpy(build_schedule(
        mask, enc.radix(encoding), order)).to(a.device)
    return PlannedOperand(digits, mask, row_perm, inv_perm, m, k, block_m,
                          block_k, encoding, schedule, order)


def _channel_rows(vec: torch.Tensor, n: int, m_pad: int,
                  row_perm: torch.Tensor) -> torch.Tensor:
    """[N] per-channel vector -> [M_pad, 1] rows in planned (permuted)
    order."""
    full = torch.zeros((m_pad,), dtype=torch.float32, device=row_perm.device)
    full[:n] = vec.to(torch.float32).reshape(-1)
    return full[row_perm.long()].reshape(-1, 1)




def plan_dense_weight(w: torch.Tensor, spec, order: str = "m_major") -> dict:
    """Quantize + plan a dense weight w [K, N] (d_in, d_out) into a record.

    The record holds the digit planes of W^T (output channels as kernel
    rows), the occupancy mask, the annotated block schedule in ``order``,
    the channel permutations and the permuted weight scales: the
    reference's record, on the weight's device.
    """
    spec = QuantSpec.coerce(spec)
    k, n = w.shape
    block_m, block_k, _ = select_block_sizes(n, k, 128, spec)
    qw, sw = quantlib.quantize_for_spec(w.to(torch.float32), spec, axis=0)
    planned = plan_operand(qw.t(), encoding=spec.encoding, block_m=block_m,
                           block_k=block_k, bits=spec.bits, order=order)
    m_pad = planned.digits.shape[1]
    return {
        "digits": planned.digits,                     # int8 [BW, M_pad, K_pad]
        "mask": planned.mask,                         # bool [BW, M/bm, K/bk]
        "schedule": planned.schedule,                 # int32 [L, 9]
        "row_perm": planned.row_perm,                 # int32 [M_pad]
        "inv_perm": planned.inv_perm,                 # int32 [M_pad]
        "sw_rows": _channel_rows(sw.reshape(-1), n, m_pad, planned.row_perm),
    }


def _resolve_dispatch(dispatch: str, plan: dict, spec, n_out: int, k: int,
                      batch: int, order: str) -> str:
    """Resolve to a concrete kernel route: 'dense'|'sparse'|'pipelined'.

    The decision reads shapes only, so it never waits on the device: the
    schedule length L counts live blocks + per-empty-row sentinels (+
    stack padding), and L / mask.numel() is the density proxy.  'auto'
    takes a sparse route when that proxy is at most
    SPARSE_DENSITY_THRESHOLD: 'sparse' (B3/B4) for m_major schedules,
    'pipelined' (B5/B6) for k_major ones, whose non-consecutive row
    revisits only the pipelined kernels take.  The reference first asks
    its measured autotune cache; the port has none yet, so it decides by
    the threshold alone (spec, n_out, k and batch would key that cache).
    """
    if order not in SCHEDULE_ORDERS:
        raise ValueError(f"order must be one of {SCHEDULE_ORDERS}, "
                         f"got {order!r}")
    if dispatch == "dense" or plan.get("schedule") is None:
        return "dense"
    if dispatch == "sparse":
        if order == "k_major":
            raise ValueError(
                "dispatch='sparse' (the v2 kernels) requires an m_major "
                "schedule: k_major revisits output rows non-consecutively"
                " -- use dispatch='pipelined' (or 'auto')")
        return "sparse"
    if dispatch == "pipelined":
        return "pipelined"
    if dispatch != "auto":
        raise ValueError(f"dispatch must be one of {DISPATCHES}, "
                         f"got {dispatch!r}")
    sparse_route = "pipelined" if order == "k_major" else "sparse"
    density = plan["schedule"].shape[0] / max(plan["mask"].numel(), 1)
    return sparse_route if density <= SPARSE_DENSITY_THRESHOLD else "dense"


# ---------------------------------------------------------------------------
# PlannedOperand entry points of the dense, sparse and pipelined kernels
# ---------------------------------------------------------------------------
# b is int8 [K, N] and the result [M, N] in the operand's original row
# order, as in the reference; scale / bias are per-row vectors of length M.

def _check_operand_k(k: int, planned_k: int) -> None:
    if k != planned_k:
        raise ValueError(
            f"b has K={k} rows but the planned operand was built with "
            f"K={planned_k}; re-plan the weight or fix the activation "
            f"reshape")


def _check_has_schedule(planned: PlannedOperand) -> None:
    if planned.schedule is None:
        raise ValueError(
            "plan has no schedule; build it with plan_operand / "
            "build_schedule before calling a sparse kernel")


def _check_m_major(fn: str, planned: PlannedOperand) -> None:
    # the v2 kernels find each row's entries as one consecutive run
    if planned.order != "m_major":
        raise ValueError(
            f"{fn} requires an m_major plan, got {planned.order!r} (use "
            f"{fn}_pipelined)")


def _kernel_b(planned: PlannedOperand, b: torch.Tensor) -> torch.Tensor:
    """[K, N] activations -> the kernels' contiguous [N, K_pad] rows."""
    k, _ = b.shape
    _check_operand_k(k, planned.k)
    return _pad_to(b.to(torch.int8).t(), planned.block_k, 1).contiguous()


def _sparse_b(planned: PlannedOperand, b: torch.Tensor) -> torch.Tensor:
    _check_has_schedule(planned)
    return _kernel_b(planned, b)


def _unplanned(planned: PlannedOperand, out: torch.Tensor,
               n: int) -> torch.Tensor:
    return out[planned.inv_perm.long()][:planned.m, :n]


def _scale_rows(planned: PlannedOperand, scale, bias):
    for vec, name in ((scale, "scale"), (bias, "bias")):
        if vec is not None and vec.numel() != planned.m:
            raise ValueError(
                f"{name} has {vec.numel()} entries; expected one per row of "
                f"the planned operand, M={planned.m}")
    m_pad = planned.digits.shape[1]
    rows = _channel_rows(scale, planned.m, m_pad, planned.row_perm)
    if bias is not None:
        bias = _channel_rows(bias, planned.m, m_pad, planned.row_perm)
    return rows, bias


def bw_gemm(planned: PlannedOperand, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with A pre-planned, through B2: b int8 [K, N] -> int32
    [M, N]."""
    _bw._check_devices("bw_gemm", planned.digits, b)
    bt = _kernel_b(planned, b)
    out = _bw.bw_gemm(planned.digits, bt, planned.mask,
                      block_m=planned.block_m, block_k=planned.block_k,
                      radix=enc.radix(planned.encoding))
    return _unplanned(planned, out, b.shape[1])


def bw_gemm_fused(planned: PlannedOperand, b: torch.Tensor, scale,
                  bias=None, *, activation=None,
                  out_dtype=torch.float32) -> torch.Tensor:
    """C = act((A @ B)_int * scale + bias) with A pre-planned, through B1.

    b: int8 [K, N].  scale / bias: per-row vectors of length M in the
    operand's original row order (permuted and padded here; epilogue axis
    'm', no per-column scale).  Returns ``out_dtype`` [M, N].
    """
    _bw._check_devices("bw_gemm_fused", planned.digits, b, scale, bias)
    bt = _kernel_b(planned, b)
    scale_rows, bias_rows = _scale_rows(planned, scale, bias)
    out = _bw.bw_gemm_fused(
        planned.digits, bt, planned.mask, scale_rows, bias_rows,
        block_m=planned.block_m, block_k=planned.block_k,
        radix=enc.radix(planned.encoding), activation=activation,
        epilogue_axis="m")
    return _unplanned(planned, out, b.shape[1]).to(out_dtype)


def bw_gemm_sparse(planned: PlannedOperand, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B through the sparse kernel (B4): int32 [M, N].

    Bit-identical to the dense route on the same plan; a plane block that
    is not in the schedule costs no read.
    """
    _check_m_major("bw_gemm_sparse", planned)
    bt = _sparse_b(planned, b)
    out = _bw.bw_gemm_sparse(planned.digits, bt, planned.schedule,
                             block_m=planned.block_m,
                             block_k=planned.block_k)
    return _unplanned(planned, out, b.shape[1])


def bw_gemm_sparse_fused(planned: PlannedOperand, b: torch.Tensor, scale,
                         bias=None, *, activation=None) -> torch.Tensor:
    """act((A @ B)_int * scale + bias) through the sparse kernel (B3)."""
    _check_m_major("bw_gemm_sparse_fused", planned)
    bt = _sparse_b(planned, b)
    scale_rows, bias_rows = _scale_rows(planned, scale, bias)
    out = _bw.bw_gemm_sparse_fused(
        planned.digits, bt, planned.schedule, scale_rows, bias_rows,
        block_m=planned.block_m, block_k=planned.block_k,
        activation=activation)
    return _unplanned(planned, out, b.shape[1])


def bw_gemm_sparse_pipelined(planned: PlannedOperand,
                             b: torch.Tensor) -> torch.Tensor:
    """C = A @ B through the pipelined kernel (B6), either schedule order;
    bit-identical to bw_gemm_sparse on the same mask."""
    bt = _sparse_b(planned, b)
    out = _bw.bw_gemm_sparse_pipelined(planned.digits, bt, planned.schedule,
                                       block_m=planned.block_m,
                                       block_k=planned.block_k)
    return _unplanned(planned, out, b.shape[1])


def bw_gemm_sparse_fused_pipelined(planned: PlannedOperand, b: torch.Tensor,
                                   scale, bias=None, *,
                                   activation=None) -> torch.Tensor:
    """bw_gemm_sparse_fused through the pipelined kernel (B5), either
    schedule order."""
    bt = _sparse_b(planned, b)
    scale_rows, bias_rows = _scale_rows(planned, scale, bias)
    out = _bw.bw_gemm_sparse_fused_pipelined(
        planned.digits, bt, planned.schedule, scale_rows, bias_rows,
        block_m=planned.block_m, block_k=planned.block_k,
        activation=activation)
    return _unplanned(planned, out, b.shape[1])


# ---------------------------------------------------------------------------
# The parallel-MAC baseline (B9 / B8)
# ---------------------------------------------------------------------------

# the kernels' K step: K is padded to it, M and N not at all
_QUANT_K = 16


def _padded_operands(a, b):
    """a [M, K], b [K, N] as int8 with K padded to _QUANT_K (zeros add
    zero), and the blocks (M, N, _QUANT_K) the kernel wrappers check the
    padded shapes against."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner-dim mismatch: a has K={k} columns but b "
                         f"has K={k2} rows")
    a = _pad_to(a.to(torch.int8), _QUANT_K, 1).contiguous()
    b = _pad_to(b.to(torch.int8), _QUANT_K, 0).contiguous()
    return a, b, dict(block_m=m, block_n=n, block_k=_QUANT_K)


def quant_gemm(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
               block_n: int = 128, block_k: int = 256) -> torch.Tensor:
    """Baseline int8 GEMM through B9: a [M, K] @ b [K, N] -> int32 [M, N].

    block_m, block_n and block_k are the reference's tile sizes, kept for
    its signature: the port pads K to 16 only, since the kernel tiles any
    M and N itself (the reference pads all three to its blocks; the
    padding's zeros change no result)."""
    a, b, blocks = _padded_operands(a, b)
    return _qg.quant_gemm(a, b, **blocks)


def _channel_cols(vec: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """[N] per-output-channel vector -> a [1, N] float32 row."""
    if vec.numel() != n:
        raise ValueError(f"quant_gemm_fused: {name} has {vec.numel()} "
                         f"entries; expected one per output column, N={n}")
    return vec.to(torch.float32).reshape(1, n).contiguous()


def quant_gemm_fused(a: torch.Tensor, b: torch.Tensor, scale, bias=None, *,
                     activation=None, block_m: int = 128,
                     block_n: int = 128, block_k: int = 256,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Baseline int8 GEMM + fused dequant epilogue through B8 (K padded
    to 16; the blocks as in :func:`quant_gemm`).

    scale / bias: per-output-channel vectors of length N (epilogue axis
    'n').  Returns ``out_dtype`` [M, N].
    """
    a, b, blocks = _padded_operands(a, b)
    n = b.shape[1]
    scale = _channel_cols(scale, "scale", n)
    if bias is not None:
        bias = _channel_cols(bias, "bias", n)
    return _qg.quant_gemm_fused(a, b, scale, bias, activation=activation,
                                epilogue_axis="n", out_dtype=out_dtype,
                                **blocks)


def planned_dense_apply(plan: dict, x: torch.Tensor, spec, n_out: int, *,
                        bias=None, activation=None,
                        out_dtype=torch.float32, fused: bool = True,
                        dispatch: str = "dense",
                        order: str = "m_major") -> torch.Tensor:
    """y = act((x @ w)_int * s_x * s_w + bias) through a bw_gemm kernel.

    plan: record from plan_dense_weight, built under the same spec.
    Activations are quantized here per the spec's act_quant policy:
    ``per_tensor`` folds the single activation scale into the per-channel
    weight scale; ``per_token`` keeps one scale per activation row and
    (fused=True) hands it to the kernel epilogue as a per-column vector,
    since tokens sit on the kernel N axis.  fused=True runs dequant, bias
    and activation in the kernel epilogue; fused=False takes the int32
    accumulator from the kernel and runs the epilogue here.

    dispatch: 'dense' (B1/B2, the mask), 'sparse' (B3/B4, an m_major
    schedule), 'pipelined' (B5/B6, either order) or 'auto' (a sparse route
    when the schedule's density proxy is at most
    SPARSE_DENSITY_THRESHOLD).  order names the plan's schedule order:
    'k_major' plans take only the dense or pipelined routes.
    """
    spec = QuantSpec.coerce(spec)
    digits, mask = plan["digits"], plan["mask"]
    bw_n, m_pad, k_pad = digits.shape
    if bw_n != spec.num_digits:
        raise ValueError(
            f"plan record has {bw_n} digit planes but spec "
            f"{spec.encoding!r}/{spec.bits}b implies {spec.num_digits}; "
            f"was the plan built under a different spec?")
    block_m = m_pad // mask.shape[1]
    block_k = k_pad // mask.shape[2]
    k = x.shape[-1]
    lead = x.shape[:-1]
    batch = x.numel() // max(k, 1)
    route = _resolve_dispatch(dispatch, plan, spec, n_out, k, batch, order)
    per_token = spec.act_quant == "per_token"
    qx, sx = quantlib.quantize_for_spec(x.to(torch.float32), spec,
                                        axis=-1 if per_token else None)
    bt = _pad_to(qx.reshape(-1, k), block_k, 1)     # [N, K_pad]: token rows
    inv_perm = plan["inv_perm"].long()
    blocks = dict(block_m=block_m, block_k=block_k)
    if fused:
        scale_rows = plan["sw_rows"] if per_token else plan["sw_rows"] * sx
        sx_cols = sx.reshape(1, -1) if per_token else None
        bias_rows = None
        if bias is not None:
            bias_rows = _channel_rows(bias, n_out, m_pad, plan["row_perm"])
        args = (digits, bt, plan.get("schedule"), scale_rows, bias_rows,
                sx_cols)
        if route == "pipelined":
            out = _bw.bw_gemm_sparse_fused_pipelined(
                *args, activation=activation, **blocks)
        elif route == "sparse":
            out = _bw.bw_gemm_sparse_fused(*args, activation=activation,
                                           **blocks)
        else:
            out = _bw.bw_gemm_fused(
                digits, bt, mask, scale_rows, bias_rows, sx_cols,
                radix=spec.radix, activation=activation,
                epilogue_axis="m", **blocks)
        y = out[inv_perm][:n_out].t()
    else:
        if route == "pipelined":
            acc = _bw.bw_gemm_sparse_pipelined(digits, bt, plan["schedule"],
                                               **blocks)
        elif route == "sparse":
            acc = _bw.bw_gemm_sparse(digits, bt, plan["schedule"], **blocks)
        else:
            acc = _bw.bw_gemm(digits, bt, mask, radix=spec.radix, **blocks)
        acc = acc[inv_perm][:n_out]
        sw = plan["sw_rows"][inv_perm][:n_out]        # original order
        s = sw * (sx.reshape(1, -1) if per_token else sx)
        y = (acc.to(torch.float32) * s).t()
        if bias is not None:
            y = y + bias.to(torch.float32)
        if activation is not None:
            y = _bw.EPILOGUE_ACTIVATIONS[activation](y)
    return y.reshape(*lead, n_out).to(out_dtype)


def quantized_dense(x: torch.Tensor, w: torch.Tensor, spec, *, bias=None,
                    activation=None, out_dtype=torch.float32,
                    fused: bool = True, dispatch: str = "dense",
                    order: str = "m_major") -> torch.Tensor:
    """Kernel-path dense on a raw weight: plan it, then apply.

    x: [..., K] float; w: [K, N] float; bias: optional [N].  The weight is
    planned (in ``order``) on every call; serving plans once through
    plan_params.
    """
    spec = QuantSpec.coerce(spec)
    plan = plan_dense_weight(w, spec, order=order)
    return planned_dense_apply(plan, x, spec, w.shape[1], bias=bias,
                               activation=activation, out_dtype=out_dtype,
                               fused=fused, dispatch=dispatch, order=order)


def plan_params(params, spec, order: Optional[str] = None):
    """Attach a 'w_plan' record next to every dense weight in a param tree.

    The tree is nested dicts and lists (the port keeps its layers as a
    list); every dict holding a 2-D "w" gets a plan.  order: the schedule
    order; None derives it from the spec's engine (k_major for
    pallas_pipelined, else m_major), as the reference does.  The
    schedules of one weight name across the list's layers are padded to
    the longest with no-op entries (pad_schedule), so layer i's record
    equals the reference's layer-stacked record sliced at i.  Returns
    (new_params, planned_count); the input tree is not mutated.
    """
    spec = QuantSpec.coerce(spec)
    if order is None:
        order = "k_major" if spec is not None and \
            spec.impl == "pallas_pipelined" else "m_major"
    count = 0

    # groups: weight path without list indices -> records.  It is passed
    # down rather than closed over, so the recursive closure's reference
    # cycle holds no plan once plan_params returns.
    def walk(node, path, groups):
        nonlocal count
        if isinstance(node, list):
            return [walk(v, path, groups) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, path + (k,), groups) for k, v in node.items()}
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            out["w_plan"] = plan_dense_weight(w, spec, order=order)
            groups.setdefault(path, []).append(out["w_plan"])
            count += 1
        return out

    groups = {}
    planned = walk(params, (), groups)
    for plans in groups.values():
        steps = max(p["schedule"].shape[0] for p in plans)
        for p in plans:
            if p["schedule"].shape[0] < steps:
                p["schedule"] = torch.from_numpy(pad_schedule(
                    p["schedule"].cpu().numpy(), steps)).to(
                        p["schedule"].device)
    return planned, count


def plan_tree_density(params) -> Optional[float]:
    """Plane-block density over every 'w_plan' record in a planned param
    tree (weighted by block count); None when the tree holds no plans."""
    nnz = total = 0

    def walk(node):
        nonlocal nnz, total
        if isinstance(node, list):
            for v in node:
                walk(v)
            return
        if not isinstance(node, dict):
            return
        plan = node.get("w_plan")
        if isinstance(plan, dict) and "mask" in plan:
            nnz += int(plan["mask"].sum())
            total += plan["mask"].numel()
        for key, v in node.items():
            if key != "w_plan":
                walk(v)

    walk(params)
    return (nnz / total) if total else None
