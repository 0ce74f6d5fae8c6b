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
schedule order); ``auto`` asks the measured autotune cache
(``kernels.autotune``) for a per-(shape, density) winner and otherwise
picks by the schedule's density.

With ``verify=`` (default: the ``REPRO_VERIFY`` env toggle) every plan is
run through the static analyzers (``repro_torch.analysis``) once, on the
host arrays it was built from, before its schedule goes to the device;
the apply seam reads only an identity memo of what planning settled.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import chaos as _chaos
from repro_torch.core import encodings as enc
from repro_torch.core import quant as quantlib
from repro_torch.engine.spec import QuantSpec
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from . import autotune
from . import bw_gemm as _bw
from . import encode as _enc_kernel
from . import quant_gemm as _qg
from . import ref as kref

# The reference's metric families, bound at import.  The plan-time ones
# observe host values while a weight is planned; the per-call dispatch
# counter and span sit behind obs_trace.enabled(), one branch when off,
# and read no device value either way.
_M_PLAN_HITS = obs_metrics.get_registry().counter(
    "repro_plan_cache_hits_total")
_M_PLAN_MISSES = obs_metrics.get_registry().counter(
    "repro_plan_cache_misses_total")
_M_SCHED_DENSITY = obs_metrics.get_registry().histogram(
    "repro_schedule_density", obs_metrics.GLOSSARY[
        "repro_schedule_density"]["edges"])
_M_B_ELIDED = obs_metrics.get_registry().counter(
    "repro_schedule_b_dma_elided_total")
_M_DISPATCH = obs_metrics.get_registry().counter(
    "repro_gemm_dispatch_total")

__all__ = ["PlannedOperand", "encode_planes", "plane_block_mask",
           "plane_density", "plan_operand", "bw_gemm", "bw_gemm_fused",
           "quant_gemm", "quant_gemm_fused", "select_block_sizes",
           "plan_dense_weight", "plan_params", "plan_tree_density",
           "plan_for", "plan_cache_stats", "plan_cache_clear",
           "planned_dense_apply", "quantized_dense", "build_schedule",
           "pad_schedule", "schedule_stats", "bw_gemm_sparse",
           "bw_gemm_sparse_fused", "bw_gemm_sparse_pipelined",
           "bw_gemm_sparse_fused_pipelined", "SPARSE_DENSITY_THRESHOLD",
           "SCHEDULE_ORDERS", "DISPATCHES", "verification_enabled",
           "ENV_VERIFY"]


# ---------------------------------------------------------------------------
# Static verification (repro_torch.analysis) at the planning/apply seams
# ---------------------------------------------------------------------------
# REPRO_VERIFY=1 turns the schedule verifier + slot-column walk on by
# default at every plan build; the test suite enables it globally.  A plan
# is verified on the host arrays build_schedule holds, before its schedule
# goes to the device.  Every schedule a plan builds enters an identity memo
# (weakref-evicted) with whether it was verified, so its default
# (verify=None) is settled once, when it is built: the apply seam reads
# only the memo, and the card pays no copy back to the host and no env
# read a call.

ENV_VERIFY = "REPRO_VERIFY"

_VERIFIED_SCHEDULES: dict = {}      # id -> (weakref, verified)


def _verify_enabled(verify: Optional[bool]) -> bool:
    if verify is not None:
        return bool(verify)
    return os.environ.get(ENV_VERIFY, "0").lower() not in (
        "", "0", "false", "off", "no")


def verification_enabled() -> bool:
    """True when plan verification is on by default ($REPRO_VERIFY)."""
    return _verify_enabled(None)


def _schedule_state(sched) -> Optional[bool]:
    """True: verified; False: planned here with verification off; None: a
    schedule no plan of this module built (or one since freed)."""
    entry = _VERIFIED_SCHEDULES.get(id(sched))
    if entry is None or entry[0]() is not sched:
        return None
    return entry[1]


def _schedule_verified(sched) -> bool:
    return bool(_schedule_state(sched))


def _mark_schedule(sched, verified: bool) -> None:
    try:
        _VERIFIED_SCHEDULES[id(sched)] = (weakref.ref(
            sched, lambda _r, key=id(sched):
            _VERIFIED_SCHEDULES.pop(key, None)), verified)
    except TypeError:
        pass                  # not weakref-able: skip the memo, stay correct


def _verify_schedule(schedule, host_schedule: np.ndarray,
                     host_mask: np.ndarray, radix: int, order: str) -> None:
    """Verify a plan's host arrays; memoize its (device) schedule tensor."""
    from repro_torch import analysis
    analysis.verify_plan({"schedule": host_schedule, "mask": host_mask},
                         radix, order).raise_if_errors()
    _mark_schedule(schedule, True)


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
# thresholds are all met wins.  It is the fallback: select_block_sizes asks
# the measured autotune cache (kernels.autotune, REPRO_AUTOTUNE_CACHE)
# first, and both packages read the same entries for the CPU's backend.
_BLOCK_TABLE = (
    # (min_m, min_k, min_n)  ->  (block_m, block_k, block_n)
    ((512, 2048, 512), (256, 512, 256)),
    ((256, 1024, 256), (256, 512, 128)),
    ((128, 512, 128), (128, 256, 128)),
    ((0, 0, 0), (128, 128, 128)),
)


def select_block_sizes(m: int, k: int, n: int,
                       spec: Optional[QuantSpec] = None, *, device=None):
    """(block_m, block_k, block_n) for a logical [M, K] x [K, N] GEMM.

    Resolution order: (1) a measured winner from the autotune cache for
    this (shape, spec-plan) key and the backend of ``device`` (None: the
    CPU), (2) the static table, with an AutotuneCacheMissWarning when an
    explicitly configured cache lacks the shape.  A spec's explicit block
    overrides win component-wise over both.
    """
    hit = autotune.get_cache().lookup(m, k, n, spec, device=device)
    if hit is not None:
        sel = (hit["block_m"], hit["block_k"], hit["block_n"])
    else:
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
    with obs_trace.span("plan.build_schedule", order=order,
                        blocks=int(mask.size)):
        return _build_schedule(mask, radix, order)


def _build_schedule(mask: np.ndarray, radix: int, order: str) -> np.ndarray:
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
    sched = _annotate_schedule(entries)
    if mask.size:                                  # metrics: built plans
        real = int((sched[:, _bw._WEIGHT] != 0).sum())
        _M_SCHED_DENSITY.observe(real / mask.size)
        _M_B_ELIDED.inc(real - int(sched[:, _bw._BFETCH].sum()))
    return sched


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
    return _plan_operand(a_int8, encoding, block_m, block_k, reorder_rows,
                         encode_impl, bits, order)[0]


def _plan_operand(a_int8, encoding, block_m, block_k, reorder_rows,
                  encode_impl, bits, order):
    """plan_operand, also returning the host schedule and mask the plan's
    schedule was built from (what plan-time verification reads)."""
    if encode_impl not in _ENCODE_IMPLS:
        raise ValueError(f"encode_impl must be one of {_ENCODE_IMPLS}, got "
                         f"{encode_impl!r}")
    a = a_int8.to(torch.int8)
    m, k = a.shape
    a = _pad_to(_pad_to(a, block_m, 0), block_k, 1)
    if reorder_rows:
        # sort rows by their high-plane digit counts (top min(2, BW) planes,
        # most significant first) so rows needing the high planes pack into
        # few row blocks; the stable sort keeps ties in row order.  Counted
        # a block of rows at a time: a tall weight's planes are gigabytes
        hi = torch.cat([_high_plane_key(d) for _, d in
                        kref.encode_row_blocks(a, encoding, bits)])
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
    host_mask = mask.cpu().numpy()
    host_schedule = build_schedule(host_mask, enc.radix(encoding), order)
    schedule = torch.from_numpy(host_schedule).to(digits.device)
    return (PlannedOperand(digits, mask, row_perm, inv_perm, m, k, block_m,
                           block_k, encoding, schedule, order),
            host_schedule, host_mask)


def _high_plane_key(d: torch.Tensor) -> torch.Tensor:
    """int64 [rows]: the rows' non-zero digit counts in the top min(2, BW)
    planes of d [BW, rows, K], most significant first, as one sort key."""
    hi = torch.zeros(d.shape[1], dtype=torch.int64, device=d.device)
    for p in range(min(2, d.shape[0])):
        hi = hi * 1000 + (d[-(p + 1)] != 0).sum(dim=1)
    return hi


def _channel_rows(vec: torch.Tensor, n: int, m_pad: int,
                  row_perm: torch.Tensor) -> torch.Tensor:
    """[N] per-channel vector -> [M_pad, 1] rows in planned (permuted)
    order."""
    full = torch.zeros((m_pad,), dtype=torch.float32, device=row_perm.device)
    full[:n] = vec.to(torch.float32).reshape(-1)
    return full[row_perm.long()].reshape(-1, 1)


# ---------------------------------------------------------------------------
# Weight-planning cache: plan once per parameter, reuse every call
# ---------------------------------------------------------------------------
# A tensor is keyed by identity and its version counter (torch tensors are
# mutable: an in-place update bumps ``_version``, so a stale plan is never
# returned), and a weakref evicts the entry when the tensor dies so a
# recycled id() cannot alias it.  numpy inputs are keyed by content.

class _PlanCache:
    MAX_ENTRIES = 256     # FIFO cap: content-keyed (numpy) entries have no
                          # weakref eviction and would otherwise grow forever

    def __init__(self):
        self._entries = {}
        self.hits = 0
        self.misses = 0

    def _key(self, w, params):
        if isinstance(w, np.ndarray):
            digest = hashlib.blake2b(np.ascontiguousarray(w).tobytes(),
                                     digest_size=16).hexdigest()
            return ("hash", w.shape, str(w.dtype), digest) + params, None
        return ("id", id(w), getattr(w, "_version", None)) + params, w

    def lookup(self, w, params, build):
        key, anchor = self._key(w, params)
        hit = self._entries.get(key)
        if hit is not None:
            self.hits += 1
            _M_PLAN_HITS.inc()
            return hit[0]
        self.misses += 1
        _M_PLAN_MISSES.inc()
        value = build()
        finalizer = None
        if anchor is not None:
            try:
                finalizer = weakref.ref(
                    anchor, lambda _ref, k=key: self._entries.pop(k, None))
            except TypeError:
                # id-keyed but not weakref-able: a recycled id() could
                # alias a stale plan, so do not cache
                return value
        while len(self._entries) >= self.MAX_ENTRIES:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (value, finalizer)
        return value

    def clear(self):
        self._entries.clear()
        self.hits = self.misses = 0

    def stats(self):
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses}


_PLAN_CACHE = _PlanCache()


def plan_cache_stats() -> dict:
    return _PLAN_CACHE.stats()


def plan_cache_clear() -> None:
    """Drop every cached plan (and the device memory it holds)."""
    _PLAN_CACHE.clear()


def _device_of(w) -> torch.device:
    return w.device if isinstance(w, torch.Tensor) else torch.device("cpu")


def _plan(w, spec: QuantSpec, order: str, verify: Optional[bool]):
    k, n = w.shape
    block_m, block_k, _ = select_block_sizes(n, k, 128, spec,
                                             device=_device_of(w))
    wt = torch.as_tensor(w)
    qw, sw = quantlib.quantize_for_spec(wt.to(torch.float32), spec, axis=0)
    planned, host_schedule, host_mask = _plan_operand(
        qw.t(), spec.encoding, block_m, block_k, True, "ref", spec.bits,
        order)
    if _verify_enabled(verify):
        _verify_schedule(planned.schedule, host_schedule, host_mask,
                         spec.radix, order)
    else:
        _mark_schedule(planned.schedule, False)
    return planned, sw.to(torch.float32), (host_schedule, host_mask)


def plan_for(w, spec, order: str = "m_major",
             verify: Optional[bool] = None):
    """Quantize + plan a dense weight for the kernel path, with caching.

    w: float [K, N] (d_in, d_out), a tensor or numpy.  Returns
    (PlannedOperand of W^T -- output channels as kernel rows -- and the
    per-channel weight scale sw [1, N]).  Entries key on (weight,
    spec.plan_key(), blocks, shape, order), so one weight planned under
    two specs or two orders holds two entries.

    verify: run the repro_torch.analysis schedule verifier + slot-column
    walk on the freshly built plan's host arrays and raise
    ``AnalysisError`` on any violation (None: the ``REPRO_VERIFY`` env
    toggle).  A cached plan whose schedule is in the verified memo is not
    re-checked; one cached unverified is verified now, from a host copy.
    """
    spec = QuantSpec.coerce(spec)
    k, n = w.shape
    block_m, block_k, _ = select_block_sizes(n, k, 128, spec,
                                             device=_device_of(w))
    params = spec.plan_key() + (int(block_m), int(block_k), k, n, order,
                                None)

    def build():
        with obs_trace.span("plan.plan_for", k=k, n=n, order=order,
                            planes=spec.planes, shards="1x1"):
            return _plan(w, spec, order, verify)[:2]

    planned, sw = _PLAN_CACHE.lookup(w, params, build)
    if planned.schedule is not None and \
            not _schedule_verified(planned.schedule) and \
            _verify_enabled(verify):
        # a hit on a plan first built with verification off
        _verify_schedule(planned.schedule, planned.schedule.cpu().numpy(),
                         planned.mask.cpu().numpy(), spec.radix, order)
    return planned, sw


def plan_dense_weight(w, spec, use_cache: bool = True,
                      order: str = "m_major",
                      verify: Optional[bool] = None) -> dict:
    """Quantize + plan a dense weight w [K, N] (d_in, d_out) into a record.

    The record holds the digit planes of W^T (output channels as kernel
    rows), the occupancy mask, the annotated block schedule in ``order``,
    the channel permutations and the permuted weight scales: the
    reference's record, on the weight's device.  use_cache: go through
    ``plan_for``'s cache (the reference's default).  verify: as in
    :func:`plan_for`.
    """
    return _plan_record(w, QuantSpec.coerce(spec), use_cache, order,
                        verify)[0]


def _plan_record(w, spec: QuantSpec, use_cache: bool, order: str,
                 verify: Optional[bool]):
    """plan_dense_weight's record, and the host (schedule, mask) it was
    built from when it was built here (None for a cached plan)."""
    host = None
    if use_cache:
        planned, sw = plan_for(w, spec, order=order, verify=verify)
    else:
        planned, sw, host = _plan(w, spec, order, verify)
    n = w.shape[1]
    m_pad = planned.digits.shape[1]
    return {
        "digits": planned.digits,                     # int8 [BW, M_pad, K_pad]
        "mask": planned.mask,                         # bool [BW, M/bm, K/bk]
        "schedule": planned.schedule,                 # int32 [L, 9]
        "row_perm": planned.row_perm,                 # int32 [M_pad]
        "inv_perm": planned.inv_perm,                 # int32 [M_pad]
        "sw_rows": _channel_rows(sw.reshape(-1), n, m_pad, planned.row_perm),
    }, host


def _resolve_dispatch(dispatch: str, plan: dict, spec, n_out: int, k: int,
                      batch: int, order: str) -> str:
    """Resolve to a concrete kernel route: 'dense'|'sparse'|'pipelined'.

    The decision reads shapes only, so it never waits on the device: the
    schedule length L counts live blocks + per-empty-row sentinels (+
    stack padding), and L / mask.numel() is the density proxy.  'auto'
    asks the measured autotune cache for a per-(shape, density-bucket)
    winner measured on the plan's device's backend, and on a miss takes a
    sparse route when the proxy is at most SPARSE_DENSITY_THRESHOLD:
    'sparse' (B3/B4) for m_major schedules, 'pipelined' (B5/B6) for
    k_major ones, whose non-consecutive row revisits only the pipelined
    kernels take.
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
    hit = autotune.get_cache().lookup(
        n_out, k, batch, spec, density=density,
        device=getattr(plan["schedule"], "device", None))
    if hit is not None and hit.get("dispatch") in ("sparse", "dense",
                                                   "pipelined"):
        won = hit["dispatch"]
        if won == "dense":
            return "dense"
        # a measured sparse-route winner only transfers when it was
        # measured under *this plan's* schedule order (a k_major-measured
        # pipelined win says nothing about an m_major schedule's walk);
        # entries without an order are trusted as order-agnostic
        if hit.get("order") in (None, order):
            if won == "pipelined":
                return "pipelined"
            if order == "m_major":                    # won == "sparse"
                return "sparse"
        elif won in ("sparse", "pipelined") and order == "k_major":
            # a sparse-route win that cannot run B3/B4 on this plan: the
            # nearest legal sparse route is still measured-informed
            return "pipelined"
        # otherwise the ranking does not transfer: fall through
    return sparse_route if density <= SPARSE_DENSITY_THRESHOLD else "dense"


def _maybe_verify_plan(plan: dict, spec, order: str,
                       verify: Optional[bool]) -> None:
    """planned_dense_apply's pre-kernel verification seam.

    It reads the identity memo first: a schedule verified at plan time
    (or by an earlier call) costs one dict lookup, and so does one planned
    with verification off when verify is None (its default was settled
    when it was built).  Only a record no plan built, or an explicit
    verify=True on an unverified plan, is verified here, from a host copy
    of its arrays, once."""
    sched, mask = plan.get("schedule"), plan.get("mask")
    if sched is None or getattr(sched, "ndim", 0) != 2:
        return
    state = _schedule_state(sched)
    if state or (verify is None and state is False) or \
            not _verify_enabled(verify):
        return
    host = [t.cpu().numpy() if isinstance(t, torch.Tensor) else
            np.asarray(t) for t in (sched, mask)]
    _verify_schedule(sched, host[0], host[1], spec.radix, order)


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
                        order: str = "m_major",
                        verify: Optional[bool] = None) -> torch.Tensor:
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
    schedule), 'pipelined' (B5/B6, either order) or 'auto' (the autotune
    cache's measured winner, else a sparse route when the schedule's
    density proxy is at most SPARSE_DENSITY_THRESHOLD).  order names the
    plan's schedule order: 'k_major' plans take only the dense or
    pipelined routes.

    verify: check the plan's schedule before any kernel sees it; a
    corrupt schedule raises ``repro_torch.analysis.AnalysisError``.  None
    keeps what was settled when the plan was built (verified or not, by
    ``REPRO_VERIFY`` then) and reads only the memo; a record no plan
    built follows the ``REPRO_VERIFY`` env toggle.
    """
    spec = QuantSpec.coerce(spec)
    bw_n = plan["digits"].shape[0]
    if bw_n != spec.num_digits:
        raise ValueError(
            f"plan record has {bw_n} digit planes but spec "
            f"{spec.encoding!r}/{spec.bits}b implies {spec.num_digits}; "
            f"was the plan built under a different spec?")
    # verify only after the spec/plan compatibility check: a plan applied
    # under a foreign spec fails with the message above, not with the
    # verifier's radix-mismatch diagnostics
    _maybe_verify_plan(plan, spec, order, verify)
    k = x.shape[-1]
    batch = x.numel() // max(k, 1)
    route = _resolve_dispatch(dispatch, plan, spec, n_out, k, batch, order)
    # chaos seam: one branch when no plan is armed
    if _chaos.enabled():
        _chaos.maybe_raise("kernel.dispatch", target=route)
    if obs_trace.enabled():
        _M_DISPATCH.labels(route=route).inc()
        sp = obs_trace.span("ops.planned_dense_apply", cat="kernel",
                            route=route, fused=bool(fused), order=order,
                            m=int(n_out), k=int(k), n=int(batch))
    else:
        sp = obs_trace.NULL_SPAN
    with sp:
        return _apply_route(plan, x, spec, n_out, route, bias=bias,
                            activation=activation, out_dtype=out_dtype,
                            fused=fused)


def _apply_route(plan, x, spec, n_out, route, *, bias, activation,
                 out_dtype, fused):
    digits, mask = plan["digits"], plan["mask"]
    _, m_pad, k_pad = digits.shape
    block_m = m_pad // mask.shape[1]
    block_k = k_pad // mask.shape[2]
    k = x.shape[-1]
    lead = x.shape[:-1]
    per_token = spec.act_quant == "per_token"
    qx, sx = quantlib.quantize_for_spec(x.to(torch.float32), spec,
                                        axis=-1 if per_token else None)
    # [N, K_pad]: token rows, contiguous for the kernels (an activation
    # fused into the previous projection's epilogue leaves x transposed)
    bt = _pad_to(qx.reshape(-1, k), block_k, 1).contiguous()
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
    planned (in ``order``) through ``plan_for``'s cache, so a weight that
    is still alive and unchanged is planned once; the cache holds up to
    ``_PlanCache.MAX_ENTRIES`` plans on the weights' device until
    ``plan_cache_clear()``.  Serving plans once through plan_params.
    """
    spec = QuantSpec.coerce(spec)
    plan = plan_dense_weight(w, spec, order=order)
    return planned_dense_apply(plan, x, spec, w.shape[1], bias=bias,
                               activation=activation, out_dtype=out_dtype,
                               fused=fused, dispatch=dispatch, order=order)


# Param-dict names whose "w" never flows through the quantized dense path
# (raw matmuls, unquantized projections): planning them would carry dead
# digit planes through every serve step.  The reference's set, families
# not yet ported included.
_NO_PLAN_KEYS = frozenset({
    "router", "frontend_proj",                      # raw matmul / unquantized
    "mix_w1", "mix_w2", "w_lora1", "w_lora2",       # rwkv6 mixing loras
    "dt_proj", "x_to_dt", "x_to_bc",                # ssm fp32 projections
})


def plan_params(params, spec, order: Optional[str] = None):
    """Attach a 'w_plan' record next to every dense weight in a param tree.

    The tree is nested dicts and lists (the port keeps its layers as a
    list); every dict holding a 2-D "w" gets a plan, but a dict whose own
    key is in ``_NO_PLAN_KEYS`` (the MoE router), as the reference's
    default ``should_plan`` decides.  order: the schedule
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
    # A weight under a list is one layer of what the reference stacks and
    # plans uncached; any other weight goes through the plan cache, as a
    # 2-D weight does there.
    def walk(node, path, groups, layered=False):
        nonlocal count
        if isinstance(node, list):
            return [walk(v, path, groups, True) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, path + (k,), groups, layered)
               for k, v in node.items()}
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2 and \
                not (path and path[-1] in _NO_PLAN_KEYS):
            out["w_plan"], host = _plan_record(w, spec, not layered, order,
                                               None)
            groups.setdefault(path, []).append((out["w_plan"], host))
            count += 1
        return out

    # Padding a layer's schedule makes a new tensor: it is padded from, and
    # verified on, the host arrays the layer was planned from.
    groups = {}
    planned = walk(params, (), groups)
    for plans in groups.values():
        steps = max(p["schedule"].shape[0] for p, _ in plans)
        for p, host in plans:
            if p["schedule"].shape[0] < steps:
                # a padded weight is a layer's, planned here: host is set
                host_schedule, host_mask = host
                host_schedule = pad_schedule(host_schedule, steps)
                p["schedule"] = torch.from_numpy(host_schedule).to(
                    p["schedule"].device)
                if verification_enabled():
                    _verify_schedule(p["schedule"], host_schedule,
                                     host_mask, spec.radix, order)
                else:
                    _mark_schedule(p["schedule"], False)
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
