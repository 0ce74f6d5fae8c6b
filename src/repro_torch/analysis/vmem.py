"""Shared-memory budget pass for the bw_gemm kernels' launch configurations.

The reference's pass (``repro.analysis.vmem``) prices a Pallas grid step's
resident VMEM.  On this card the budget is a CTA's dynamic shared memory:
232,448 bytes by default (227 KB, an H100 CTA's opt-in limit, ``kMaxSmem``
in ``kernels/csrc/bw_gemm_sparse.cu``), overridden with
``REPRO_VMEM_BUDGET`` (bytes).  The public names, the diagnostic code
``VMEM_OVER_BUDGET`` and the env var stay the reference's, so a finding
and a counter mean the same in both packages.

Footprints follow the port's kernels, not the Pallas BlockSpecs:

- ``dense`` (B1/B2, ``csrc/bw_gemm.cu``): a warp walks one row in
  registers and keeps no shared memory; the launch needs
  ``block_m % 8 == 0`` and ``block_k % 16 == 0``;
- ``sparse`` (B3/B4, ``csrc/bw_gemm_sparse.cu``): a CTA holds one static
  ``int table[BW][256]`` of its m-block's weights (BW 4 for the radix-4
  encodings, 8 bit-serially), under the same launch conditions;
- ``pipelined`` (B5/B6): the ``cp.async`` ring and the accumulator panel
  that ``kernels.bw_gemm._pipelined_layout(n, block_m, block_k)`` computes
  as the kernel does; a ``ValueError`` there means the block shape does
  not fit.

A block shape a kernel refuses counts as not fitting, whatever the budget.
``block_n`` is kept for the reference's signatures: the port's kernels
take every column of a call (tiles of 1-8), so it prices nothing.  The
register budget is out of scope: ptxas fixes registers per kernel, not per
config.

``vmem_footprint`` itemizes the bytes per route; ``check_vmem`` turns a
footprint that does not fit into a ``VMEM_OVER_BUDGET`` diagnostic
carrying a machine-actionable ``suggestion`` dict;
``filter_vmem_configs`` is the autotuner's hard candidate filter
(candidates that do not fit are never launched).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .diagnostics import Report, INFO

__all__ = ["DEFAULT_VMEM_BUDGET", "ENV_BUDGET", "vmem_budget",
           "vmem_footprint", "check_vmem", "clamp_suggestion",
           "filter_vmem_configs"]

DEFAULT_VMEM_BUDGET = 232448              # bytes of shared memory a CTA
ENV_BUDGET = "REPRO_VMEM_BUDGET"

# Block dims the clamp search walks, largest first (the reference's).
_CLAMP_STEPS = (512, 384, 256, 128)

# csrc/bw_gemm.cu and bw_gemm_sparse.cu `valid`: rows a CTA's warps split
# (kWarps) and the 16-byte loads a k-block is read in
_ROW_MULTIPLE, _K_MULTIPLE = 8, 16
_TABLE_KBLKS = 256                        # kTableKblks, bw_gemm_sparse.cu


def vmem_budget(budget: Optional[int] = None) -> int:
    """The shared-memory byte budget: explicit arg > $REPRO_VMEM_BUDGET >
    232,448."""
    if budget is not None:
        return int(budget)
    env = os.environ.get(ENV_BUDGET)
    return int(env) if env else DEFAULT_VMEM_BUDGET


def _launch_refusal(block_m: int, block_k: int) -> Optional[str]:
    if block_m <= 0 or block_m % _ROW_MULTIPLE or block_k <= 0 or \
            block_k % _K_MULTIPLE:
        return (f"block_m={block_m} must be a positive multiple of "
                f"{_ROW_MULTIPLE} and block_k={block_k} of {_K_MULTIPLE}")
    return None


def vmem_footprint(route: str, m: int, k: int, n: int, *, block_m: int,
                   block_k: int, block_n: int, n_planes: int,
                   fused: bool = True, out_bytes: int = 4) -> dict:
    """Shared-memory bytes one CTA of ``route``'s kernel holds.

    route: 'dense' | 'sparse' | 'pipelined' (the planned_dense_apply
    dispatch routes).  m/k: the GEMM's rows and depth (no footprint
    depends on them: the port's kernels stream every row and k-block);
    n: the columns of a call, which set the pipelined kernels' column
    tile.  n_planes: digit planes of the plan (the sparse table's BW).
    fused / out_bytes / block_n: the reference's signature (the epilogue
    runs in registers).  Itemized dict; 'total' is the comparison key, and
    'refused' (when present) says why the kernel refuses the block shape,
    which no budget admits.
    """
    if route not in ("dense", "sparse", "pipelined"):
        raise ValueError(f"route must be dense|sparse|pipelined, "
                         f"got {route!r}")
    parts = {}
    refusal = _launch_refusal(block_m, block_k)
    if route == "dense":
        parts["smem"] = 0
    elif route == "sparse":
        parts["run_table"] = (4 if n_planes <= 4 else 8) * _TABLE_KBLKS * 4
    else:
        from repro_torch.kernels import bw_gemm as _bw
        try:
            lay = _bw._pipelined_layout(max(int(n), 1), block_m, block_k)
        except ValueError as e:
            refusal = refusal or str(e)
            lay = None
        if lay is not None:
            parts["ring"] = lay["stages"] * (lay["stage_bytes"]
                                             + lay["b_bytes"])
            parts["acc_panel"] = lay["smem"] - parts["ring"]
    parts["total"] = sum(parts.values())
    if refusal is not None:
        parts["refused"] = refusal
    return parts


def _fits(parts: dict, budget: int) -> bool:
    return "refused" not in parts and parts["total"] <= budget


def clamp_suggestion(route: str, m: int, k: int, n: int, *, block_m: int,
                     block_k: int, block_n: int, n_planes: int,
                     fused: bool = True, out_bytes: int = 4,
                     budget: Optional[int] = None) -> Optional[dict]:
    """Smallest-change config that fits ``budget``, or a route fallback.

    Returns a suggestion dict ``{"block_m":…, "block_k":…, "block_n":…}``
    (clamped dims only differ from the input), or ``{"route": …}`` when
    no block shrink can fit (the pipelined kernels fall back to the
    sparse ones, which keep no ring), or None when the input already
    fits.
    """
    budget = vmem_budget(budget)

    def fits(bm, bk, bn):
        return _fits(vmem_footprint(route, m, k, n, block_m=bm, block_k=bk,
                                    block_n=bn, n_planes=n_planes,
                                    fused=fused, out_bytes=out_bytes),
                     budget)

    if fits(block_m, block_k, block_n):
        return None
    options = [bn for bn in _CLAMP_STEPS if bn <= block_n] or [128]
    for bn in sorted(set(options)):
        for bk in sorted({bk for bk in _CLAMP_STEPS if bk <= block_k}
                         | {128}):
            for bm in sorted({bm for bm in _CLAMP_STEPS if bm <= block_m}
                             | {128}):
                if fits(bm, bk, bn):
                    return {"block_m": bm, "block_k": bk, "block_n": bn}
    if route == "pipelined":
        return {"route": "sparse", "order": "m_major"}
    return {"route": "dense"}


def check_vmem(route: str, m: int, k: int, n: int, *, block_m: int,
               block_k: int, block_n: int, n_planes: int,
               fused: bool = True, out_bytes: int = 4,
               budget: Optional[int] = None,
               severity: str = "error", where: Optional[str] = None,
               report: Optional[Report] = None) -> Report:
    """Add a ``VMEM_OVER_BUDGET`` diagnostic when the footprint exceeds
    the budget (or the kernel refuses the blocks), carrying the
    clamp/fallback suggestion."""
    report = report if report is not None else Report("vmem")
    budget = vmem_budget(budget)
    parts = vmem_footprint(route, m, k, n, block_m=block_m, block_k=block_k,
                           block_n=block_n, n_planes=n_planes, fused=fused,
                           out_bytes=out_bytes)
    if _fits(parts, budget):
        return report
    suggestion = clamp_suggestion(
        route, m, k, n, block_m=block_m, block_k=block_k, block_n=block_n,
        n_planes=n_planes, fused=fused, out_bytes=out_bytes, budget=budget)
    if "refused" in parts:
        why = f"the kernel refuses the blocks: {parts['refused']}"
    else:
        top = max((v, name) for name, v in parts.items()
                  if name != "total")
        why = (f"a CTA holds {parts['total']:,} bytes of shared memory "
               f"(budget {budget:,}; dominant term {top[1]}={top[0]:,})")
    report.add(
        "VMEM_OVER_BUDGET",
        f"route {route!r} at blocks (m={block_m}, k={block_k}, "
        f"n={block_n}) for a {m}x{k}x{n} GEMM: {why}",
        severity=severity,
        where=where or f"{m}x{k}x{n}/{route}", suggestion=suggestion)
    return report


def filter_vmem_configs(m: int, k: int, n: int, configs: List[dict], *,
                        n_planes: int = 4, budget: Optional[int] = None) \
        -> Tuple[List[dict], Report]:
    """The autotuner's hard candidate filter.

    Splits candidate configs (dicts with block_m/block_k/block_n and a
    ``dispatch`` route) into the list that fits and a Report holding one
    INFO diagnostic per rejected candidate (info: rejection is the guard
    *working*).  Never empties the pool: if no candidate fits, the
    smallest-footprint one is kept so the sweep still returns a winner
    (with its diagnostic left at error severity in that case).
    """
    report = Report(f"vmem-filter {m}x{k}x{n}")
    kept, rejected = [], []
    for cfg in configs:
        route = cfg.get("dispatch", "dense")
        parts = vmem_footprint(route, m, k, n, block_m=cfg["block_m"],
                               block_k=cfg["block_k"], block_n=cfg["block_n"],
                               n_planes=n_planes)
        if _fits(parts, vmem_budget(budget)):
            kept.append(cfg)
        else:
            rejected.append((parts["total"], cfg))
            check_vmem(route, m, k, n, block_m=cfg["block_m"],
                       block_k=cfg["block_k"], block_n=cfg["block_n"],
                       n_planes=n_planes, budget=budget, severity=INFO,
                       report=report)
    if not kept and rejected:
        rejected.sort(key=lambda t: t[0])
        fallback = rejected[0][1]
        check_vmem(fallback.get("dispatch", "dense"), m, k, n,
                   block_m=fallback["block_m"], block_k=fallback["block_k"],
                   block_n=fallback["block_n"], n_planes=n_planes,
                   budget=budget, report=report)
        kept = [fallback]
    return kept, report
