"""Cross-check of ``GemmEngine.cost()`` counters against a symbolic walk
(the reference's ``repro.analysis.cost``).

The engine cost models (``repro_torch.engine.registry``) are the
autotuner's and the serving tier router's view of the kernels:
``grid_steps``, ``dma_bytes`` and ``b_dma_elided`` describe the walk the
reference's kernels take over a plan (the port's models give the
reference's numbers on the reference's designs).  This pass re-derives
the three counters by walking the plan's schedule step by step with those
fetch rules (dense grid: every BW plane of every block each step; sparse:
one digit block + one B block per scheduled step, sentinels included;
pipelined: digit copies only on real steps, B copies only where
B_FETCH=1, flushes at LAST steps) and reports any divergence as
``COST_MODEL_DRIFT``: a model edit, or a change to the plan's block grid,
cannot silently re-rank the routes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .diagnostics import Report

__all__ = ["ENGINE_ROUTES", "symbolic_counters", "crosscheck_cost"]

_WEIGHT, _LAST, _BFETCH = 3, 5, 8


def _host(a) -> np.ndarray:
    """A schedule as numpy (a tensor on any device, or an array)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)

# kernel engine name -> the dispatch route its cost model prices
ENGINE_ROUTES = {
    "pallas": "dense",
    "pallas_fused": "dense",
    "pallas_sparse": "sparse",
    "pallas_pipelined": "pipelined",
}


def symbolic_counters(route: str, n: int, *, block_m: int, block_k: int,
                      block_n: int, mb: int, kb: int, n_planes: int,
                      schedule=None, acc_hbm_bytes: int = 0) -> dict:
    """Walk one launch of ``route``'s kernel and count what it executes.

    Returns {'grid_steps', 'dma_bytes', 'b_dma_elided'} — the counters
    the engine cost models must reproduce.  ``schedule`` is required for
    the sparse routes (the walk IS the schedule); ``mb``/``kb`` are the
    padded block-grid dims (from the plan's mask), ``acc_hbm_bytes`` the
    engine's epilogue-placement HBM term (0 for the fused engines).
    """
    nb = -(-n // block_n)
    if route == "dense":
        # full predicated grid: every step fetches all BW planes of the A
        # block and the B block; one out block per (m, n) tile
        grid = mb * nb * kb
        dma = grid * (n_planes * block_m * block_k + block_k * block_n) \
            + mb * nb * block_m * block_n * 4 + acc_hbm_bytes
        return {"grid_steps": grid, "dma_bytes": int(dma),
                "b_dma_elided": 0}
    if schedule is None:
        raise ValueError(f"route {route!r} needs the plan's schedule")
    sched = _host(schedule)
    steps = sched.shape[0]
    dma = elided = flushes = 0
    if route == "sparse":
        # the reference's v2 kernels: one digit plane block and one B
        # block EVERY step, sentinels and padding included; the out block
        # is written once per row (its LAST step)
        for s in range(steps):
            dma += block_m * block_k + block_k * block_n
            if sched[s, _LAST] == 1:
                flushes += 1
    elif route == "pipelined":
        # the reference's v3 kernels: digit copies only on real steps, B
        # copies only where B_FETCH=1 (the reuse walk elides the rest),
        # a flush at each LAST step
        for s in range(steps):
            if sched[s, _WEIGHT] != 0:
                dma += block_m * block_k
                if sched[s, _BFETCH] == 1:
                    dma += block_k * block_n
                else:
                    elided += 1
        for s in range(steps):
            if sched[s, _LAST] == 1:
                flushes += 1
    else:
        raise ValueError(f"unknown route {route!r}")
    return {
        "grid_steps": steps * nb,
        "dma_bytes": int(dma * nb + flushes * nb * block_m * block_n * 4
                         + acc_hbm_bytes),
        "b_dma_elided": elided * nb,
    }


def crosscheck_cost(impl: str, m: int, k: int, n: int, spec, plan, *,
                    report: Optional[Report] = None) -> Report:
    """Compare ``get_engine(impl).cost(..., plan=plan)`` to the walk.

    plan: a plan record (``ops.plan_dense_weight``) or PlannedOperand for
    the [M, K] operand.  Any diverging counter is a ``COST_MODEL_DRIFT``
    error naming both values — the cost model may not disagree with the
    schedule it claims to price.
    """
    from repro_torch.engine.registry import get_engine

    report = report if report is not None else Report(f"cost {impl}")
    route = ENGINE_ROUTES.get(impl)
    if route is None:
        report.add("COST_MODEL_DRIFT",
                   f"impl {impl!r} has no schedule-backed cost model to "
                   f"cross-check (kernel engines: {list(ENGINE_ROUTES)})")
        return report
    engine = get_engine(impl)
    got = engine.cost(m, k, n, spec, plan=plan)
    bm, bk, bn, mb, kb, _nb = engine._geometry(m, k, n, spec, plan)
    sched = plan["schedule"] if isinstance(plan, dict) \
        else getattr(plan, "schedule", None)
    if sched is not None:
        sched = _host(sched)
        if sched.ndim != 2:
            sched = None                  # stacked plans: nothing to walk
    if route != "dense" and sched is None:
        report.add("COST_MODEL_DRIFT",
                   f"impl {impl!r} prices the {route!r} route but the plan "
                   f"carries no walkable schedule", where=f"{m}x{k}x{n}")
        return report
    want = symbolic_counters(
        route, n, block_m=bm, block_k=bk, block_n=bn, mb=mb, kb=kb,
        n_planes=spec.num_digits, schedule=sched,
        acc_hbm_bytes=engine._acc_hbm_bytes(m, n))
    for key, expected in want.items():
        if int(got.get(key, -1)) != int(expected):
            report.add(
                "COST_MODEL_DRIFT",
                f"{impl}.cost() reports {key}={got.get(key)} but the "
                f"symbolic walk of the plan's schedule counts {expected}",
                where=f"{m}x{k}x{n}/{route}")
    return report
