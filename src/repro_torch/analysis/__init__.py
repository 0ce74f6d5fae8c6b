"""repro_torch.analysis -- static analysis for the bit-weight kernel stack
(the reference's ``repro.analysis``).

Three analyzers that run *before* any kernel launch (all numpy on the
host; nothing here touches the card):

- :func:`verify_schedule` (``analysis.schedule``) -- every SCHED_COLS
  invariant ``ops.build_schedule`` guarantees: coverage, deferred-shift
  weights, FIRST/LAST protocol, sentinels/padding, order legality,
  B_FETCH residency;
- :func:`check_dma_hazards` (``analysis.dma``) -- a symbolic replay of the
  schedule's double-buffer slot columns (the plan record's contract; the
  Hopper kernels read columns 0-3 and run their own ring);
- :func:`check_vmem` / :func:`filter_vmem_configs` (``analysis.vmem``) --
  the shared-memory budget pass over the port's kernels (a CTA's 227 KB
  on the H100), with machine-actionable clamp suggestions, used by the
  autotuner as a hard candidate filter;

plus :func:`crosscheck_cost` (``analysis.cost``), which re-derives the
``GemmEngine.cost()`` counters from a symbolic schedule walk so the cost
model cannot drift from the plans it prices, and :func:`verify_snapshot`
(``analysis.ckpt``), the host-side audit of serialized decode-state
snapshots (slot-restore invariants + engine compatibility).

Execution-path wiring: ``ops.plan_for`` / ``ops.plan_dense_weight`` /
``ops.planned_dense_apply`` accept ``verify=`` (default: the
``REPRO_VERIFY`` env toggle; the test suite turns it on globally) and
raise :class:`AnalysisError` on any error-severity finding.  A plan is
verified once, on the host arrays it was built from, before its schedule
goes to the device.  ``python -m repro_torch.analysis`` audits the
checked-in autotune cache, the config registry, and the CI-shape plans.
"""
from __future__ import annotations

from typing import Optional

from .diagnostics import (AnalysisError, CODES, Diagnostic, ERROR, INFO,
                          Report, WARNING)
from .schedule import verify_schedule
from .dma import check_dma_hazards
from .vmem import (DEFAULT_VMEM_BUDGET, check_vmem, clamp_suggestion,
                   filter_vmem_configs, vmem_budget, vmem_footprint)
from .cost import ENGINE_ROUTES, crosscheck_cost, symbolic_counters
from .ckpt import verify_snapshot

__all__ = [
    "AnalysisError", "CODES", "Diagnostic", "Report",
    "ERROR", "WARNING", "INFO",
    "verify_schedule", "check_dma_hazards", "verify_plan",
    "verify_sharded_plan",
    "DEFAULT_VMEM_BUDGET", "vmem_budget", "vmem_footprint", "check_vmem",
    "clamp_suggestion", "filter_vmem_configs",
    "ENGINE_ROUTES", "symbolic_counters", "crosscheck_cost",
    "verify_snapshot",
]

_SCHED_COLS_CHECKED = False


def _host(a):
    """An array or a tensor on any device, as numpy."""
    import numpy as np
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _check_sched_cols() -> None:
    """One-time guard: the analyzers' hard-coded column indices must match
    the kernel module's SCHED_COLS layout (lazy, so the numpy-only passes
    import without the kernel modules)."""
    global _SCHED_COLS_CHECKED
    if _SCHED_COLS_CHECKED:
        return
    from repro_torch.kernels.bw_gemm import SCHED_COLS
    expected = {"plane": 0, "row": 1, "kblk": 2, "weight": 3, "first": 4,
                "last": 5, "d_slot": 6, "b_slot": 7, "b_fetch": 8}
    if SCHED_COLS != expected:
        raise RuntimeError(
            f"repro_torch.analysis is out of sync with bw_gemm.SCHED_COLS: "
            f"{SCHED_COLS} != {expected}; update the analyzers' column "
            f"indices together with the kernel layout")
    _SCHED_COLS_CHECKED = True


def verify_plan(plan, radix: int, order: str = "m_major", *,
                report: Optional[Report] = None) -> Report:
    """Run the schedule verifier (+ DMA-hazard walk when annotated) over a
    plan.

    plan: an ``ops.PlannedOperand`` or a plan record dict from
    ``ops.plan_dense_weight`` (its ``schedule`` and ``mask`` as tensors on
    any device, or numpy arrays: a tensor on the card is copied to the
    host, so the execution seams pass the host arrays).  radix:
    the encoding radix baked into the schedule's WEIGHT column.  Returns
    the combined Report; callers raise via ``report.raise_if_errors()``.
    """
    _check_sched_cols()
    report = report if report is not None else Report("plan")
    if isinstance(plan, dict):
        schedule, mask = plan.get("schedule"), plan.get("mask")
    else:
        schedule = getattr(plan, "schedule", None)
        mask = getattr(plan, "mask", None)
        order = getattr(plan, "order", order)
    if schedule is None or mask is None:
        report.add("SCHED_BAD_SHAPE",
                   "plan carries no schedule/mask to verify")
        return report
    schedule = _host(schedule)
    verify_schedule(schedule, _host(mask), radix, order, report=report)
    if schedule.ndim == 2 and schedule.shape[1] == 9:
        check_dma_hazards(schedule, report=report)
    return report


def verify_sharded_plan(splan, *, report: Optional[Report] = None) -> Report:
    """Verify a sharded plan shard by shard: any object with ``.plan``
    (a record with a ``mask``), ``.schedules`` ([s_model, s_data, L, 9]),
    ``.s_model``, ``.s_data``, ``.radix`` and ``.order``, such as the
    reference's ``repro.parallel.plan.ShardedPlan``.

    Two layers of checks (pure numpy, no devices needed):

    1. every shard's [L_s, 9] schedule is run through the full schedule
       verifier + DMA-hazard walk against its *shard-local* mask slab
       (re-derived FIRST/LAST, sentinels, B_FETCH residency — the same
       invariants the single-device plans carry);
    2. the shard schedules' real (non-sentinel) visits, offset back to
       global block coordinates, must *exactly* partition the global
       occupancy mask: a plane-block scheduled on no shard (missing
       work), two shards (double-counted partial sums) or an empty one
       (phantom DMA) is reported as ``SHARD_BAD_PARTITION``.
    """
    import numpy as np

    _check_sched_cols()
    report = report if report is not None else Report("sharded plan")
    mask = _host(splan.plan["mask"])
    scheds = _host(splan.schedules)
    s_model, s_data = splan.s_model, splan.s_data
    bw_n, mb, kb = mask.shape
    if scheds.ndim != 4 or scheds.shape[:2] != (s_model, s_data) or \
            mb % s_model or kb % s_data:
        report.add("SHARD_BAD_SHAPE",
                   f"schedule table {scheds.shape} / mask block grid "
                   f"({mb}, {kb}) do not match the shard grid "
                   f"(model={s_model}, data={s_data})")
        return report
    mb_s, kb_s = mb // s_model, kb // s_data
    visits = np.zeros(mask.shape, dtype=np.int64)
    for i in range(s_model):
        for j in range(s_data):
            local = mask[:, i * mb_s:(i + 1) * mb_s,
                         j * kb_s:(j + 1) * kb_s]
            shard = Report(f"shard[model={i},data={j}]")
            verify_plan({"schedule": scheds[i, j], "mask": local},
                        splan.radix, splan.order, report=shard)
            for d in shard.diagnostics:
                report.add(d.code, d.message, severity=d.severity,
                           step=d.step,
                           where=f"shard[model={i},data={j}]"
                                 + (f" {d.where}" if d.where else ""),
                           suggestion=d.suggestion)
            real = scheds[i, j][scheds[i, j][:, 3] != 0]
            np.add.at(visits, (real[:, 0], i * mb_s + real[:, 1],
                               j * kb_s + real[:, 2]), 1)
    want = mask.astype(np.int64)
    if not np.array_equal(visits, want):
        missing = int((want & (visits == 0)).sum())
        dup = int((visits > 1).sum())
        phantom = int(((visits > 0) & (want == 0)).sum())
        report.add("SHARD_BAD_PARTITION",
                   f"shard schedules vs global mask: {missing} non-zero "
                   f"plane-block(s) scheduled on no shard, {dup} visited "
                   f"more than once, {phantom} phantom visit(s) to empty "
                   f"blocks")
    return report
