"""Static verifier for compacted SCHED_COLS block schedules (the
reference's ``repro.analysis.schedule``, unchanged: numpy on the schedule
and the mask).

``ops.build_schedule`` + ``_annotate_schedule`` are supposed to guarantee a
set of invariants the kernels rely on but never check at runtime -- a wrong
FIRST flag zeroes a partial sum, a duplicated visit double-counts a block,
a missing B_FETCH reads a stale k-block, and none of them *crash*: the
GEMM silently returns wrong numbers.  The Hopper kernels read columns 0-3
(plane, row, k-block, weight); the flag and slot columns stay in the plan
record bit for bit as the reference builds them, and this pass holds the
whole record.  It re-derives every invariant from the (schedule, mask,
radix, order) tuple alone and reports each violation under a stable
diagnostic code (see ``diagnostics.CODES``):

- **coverage** — each non-zero mask cell (plane, row, kblk) visited exactly
  once (``SCHED_MISSING_VISIT`` / ``SCHED_DUPLICATE_VISIT``), and no visit
  to an empty cell (``SCHED_PHANTOM_VISIT``);
- **weights** — ``weight == radix**plane`` on every real entry
  (``SCHED_BAD_WEIGHT``; the deferred-shift scale is baked in at build
  time, so a corrupt one mis-scales a whole plane);
- **flags** — exactly one FIRST at each row's first step and one LAST at
  its last real step, nothing real after the LAST
  (``SCHED_BAD_FIRST`` / ``SCHED_BAD_LAST``);
- **sentinels / padding** — empty rows carry exactly one zero-weight
  sentinel; trailing ``pad_schedule`` no-ops have cleared flags and issue
  no DMA (``SCHED_BAD_SENTINEL`` / ``SCHED_BAD_PADDING``);
- **order legality** — ``m_major`` rows form contiguous runs (the v2
  out-BlockSpec accumulation contract); ``k_major`` k-blocks form
  contiguous runs so B-reuse can elide fetches
  (``SCHED_ORDER_VIOLATION``);
- **B_FETCH consistency** — the fetch bit matches a symbolic k-block
  residency walk: one fetch per k-block run, none on zero-weight steps
  (``SCHED_BAD_BFETCH``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .diagnostics import Report, WARNING

__all__ = ["verify_schedule"]

# SCHED_COLS indices (kept numerically in sync with kernels.bw_gemm by a
# one-time check in analysis.__init__)
_PLANE, _ROW, _KBLK, _WEIGHT, _FIRST, _LAST, _DSLOT, _BSLOT, _BFETCH = \
    range(9)


def _shape_ok(sched, mask, report: Report) -> bool:
    if sched.ndim != 2 or sched.shape[1] not in (6, 9):
        report.add("SCHED_BAD_SHAPE",
                   f"schedule must be [L, 6] or [L, 9], got "
                   f"{tuple(sched.shape)}")
        return False
    if not np.issubdtype(sched.dtype, np.integer):
        report.add("SCHED_BAD_SHAPE",
                   f"schedule dtype must be integer, got {sched.dtype}")
        return False
    if mask.ndim != 3:
        report.add("SCHED_BAD_SHAPE",
                   f"mask must be [BW, Mb, Kb], got {tuple(mask.shape)}")
        return False
    return True


def verify_schedule(schedule, mask, radix: int, order: str = "m_major", *,
                    report: Optional[Report] = None) -> Report:
    """Check every build_schedule invariant of ``schedule`` against ``mask``.

    schedule: int [L, 6|9] SCHED_COLS rows (6-wide schedules skip the
    B_FETCH residency check — the v2 kernels never read it).
    mask: bool [BW, Mb, Kb] plane-block occupancy the schedule was built
    from.  radix: the encoding radix baked into the WEIGHT column.  order:
    the visit order the schedule claims ("m_major" / "k_major").
    """
    report = report if report is not None else Report("schedule")
    sched = np.asarray(schedule)
    mask = np.asarray(mask).astype(bool)
    if not _shape_ok(sched, mask, report):
        return report
    bw_n, mb, kb = mask.shape
    annotated = sched.shape[1] == 9

    # -- index ranges (everything else indexes through these) ---------------
    in_range = np.ones(sched.shape[0], dtype=bool)
    for col, bound, name in ((_PLANE, bw_n, "plane"), (_ROW, mb, "row"),
                             (_KBLK, kb, "kblk")):
        bad = (sched[:, col] < 0) | (sched[:, col] >= bound)
        for s in np.nonzero(bad)[0]:
            report.add("SCHED_OUT_OF_RANGE",
                       f"{name}={int(sched[s, col])} outside [0, {bound})",
                       step=int(s))
        in_range &= ~bad
    if not in_range.all():
        return report                     # indices below would be garbage

    weights = sched[:, _WEIGHT]
    real = weights != 0

    # -- coverage: every non-zero mask cell exactly once --------------------
    visits: dict = {}
    for s in np.nonzero(real)[0]:
        cell = (int(sched[s, _PLANE]), int(sched[s, _ROW]),
                int(sched[s, _KBLK]))
        visits.setdefault(cell, []).append(int(s))
    for cell, steps in visits.items():
        p, r, kk = cell
        if len(steps) > 1:
            report.add("SCHED_DUPLICATE_VISIT",
                       f"plane-block (plane={p}, row={r}, kblk={kk}) "
                       f"visited at steps {steps} — partial product "
                       f"double-counted", step=steps[1])
        if not mask[p, r, kk]:
            report.add("SCHED_PHANTOM_VISIT",
                       f"plane-block (plane={p}, row={r}, kblk={kk}) is "
                       f"empty in the mask but scheduled", step=steps[0])
    for p, r, kk in np.argwhere(mask):
        if (int(p), int(r), int(kk)) not in visits:
            report.add("SCHED_MISSING_VISIT",
                       f"non-zero plane-block (plane={int(p)}, row={int(r)},"
                       f" kblk={int(kk)}) never scheduled — its partial "
                       f"product is dropped", where=f"row {int(r)}")

    # -- deferred-shift weights ---------------------------------------------
    for s in np.nonzero(real)[0]:
        want = radix ** int(sched[s, _PLANE])
        if int(weights[s]) != want:
            report.add("SCHED_BAD_WEIGHT",
                       f"weight={int(weights[s])} but plane="
                       f"{int(sched[s, _PLANE])} implies radix**plane="
                       f"{want}", step=int(s))

    # -- per-row FIRST/LAST protocol + sentinels + padding ------------------
    for r in range(mb):
        steps_r = np.nonzero(sched[:, _ROW] == r)[0]
        row_empty = not mask[:, r, :].any()
        if steps_r.size == 0:
            if row_empty:
                report.add("SCHED_BAD_SENTINEL",
                           f"empty row {r} has no sentinel entry — its "
                           f"output block is never zeroed or written",
                           where=f"row {r}")
            # non-empty rows with no entries already raised MISSING_VISIT,
            # but the flush is also lost:
            else:
                report.add("SCHED_BAD_LAST",
                           f"row {r} has no entries, so no LAST flush",
                           where=f"row {r}")
            continue
        firsts = steps_r[sched[steps_r, _FIRST] == 1]
        lasts = steps_r[sched[steps_r, _LAST] == 1]
        if firsts.size != 1 or firsts[0] != steps_r[0]:
            report.add("SCHED_BAD_FIRST",
                       f"row {r} needs exactly one FIRST at its first "
                       f"step {int(steps_r[0])}; flags at "
                       f"{[int(x) for x in firsts]}", where=f"row {r}",
                       step=int(steps_r[0]))
        if lasts.size != 1:
            report.add("SCHED_BAD_LAST",
                       f"row {r} needs exactly one LAST; flags at "
                       f"{[int(x) for x in lasts]}", where=f"row {r}",
                       step=int(steps_r[-1]))
        else:
            # entries after the LAST must be pure padding (weight 0, flags
            # clear): anything real would mutate a flushed accumulator
            after = steps_r[steps_r > lasts[0]]
            for s in after:
                if weights[s] != 0:
                    report.add("SCHED_BAD_LAST",
                               f"row {r} has a real entry at step {int(s)} "
                               f"after its LAST at {int(lasts[0])} — the "
                               f"flushed output misses it", step=int(s))
        # zero-weight entries: sentinel (sole entry of an empty row, both
        # flags set) or padding (flags clear, after the row's LAST)
        for s in steps_r[weights[steps_r] == 0]:
            f, last = int(sched[s, _FIRST]), int(sched[s, _LAST])
            if f == 1 and last == 1:
                if not row_empty:
                    report.add("SCHED_BAD_SENTINEL",
                               f"row {r} carries a sentinel at step "
                               f"{int(s)} but its mask has real work",
                               step=int(s))
            elif f == 0 and last == 0:
                if lasts.size == 1 and s < lasts[0]:
                    report.add("SCHED_BAD_PADDING",
                               f"zero-weight no-op at step {int(s)} sits "
                               f"*before* row {r}'s LAST — padding must "
                               f"trail the flush", step=int(s))
                if annotated and int(sched[s, _BFETCH]) != 0:
                    report.add("SCHED_BAD_BFETCH",
                               f"padding step {int(s)} has B_FETCH=1 — "
                               f"no-ops must issue no DMA", step=int(s))
            else:
                report.add("SCHED_BAD_PADDING",
                           f"zero-weight entry at step {int(s)} has flags "
                           f"first={f} last={last}; sentinels set both, "
                           f"padding neither", step=int(s))

    # -- order legality ------------------------------------------------------
    real_steps = np.nonzero(real)[0]
    if order == "m_major":
        # each row's real visits must be one contiguous run of steps: the
        # sparse kernels (B3/B4) find a row's entries as one run, and the
        # reference's v2 kernels accumulate an output block over one run
        rows_seq = sched[real_steps, _ROW]
        seen: set = set()
        prev = None
        for s, r in zip(real_steps, rows_seq):
            if r != prev and int(r) in seen:
                report.add("SCHED_ORDER_VIOLATION",
                           f"m_major schedule revisits row {int(r)} at "
                           f"step {int(s)} after leaving it — v2 kernels "
                           f"would clobber the partial sum", step=int(s))
            seen.add(int(r))
            prev = r
    elif order == "k_major":
        # contract: each k-block is walked in one contiguous run so B-reuse
        # elides all but one fetch per k-block (suboptimal, not incorrect,
        # for the pipelined kernels -> warning)
        ks_seq = sched[real_steps, _KBLK]
        seen = set()
        prev = None
        for s, kk in zip(real_steps, ks_seq):
            if kk != prev and int(kk) in seen:
                report.add("SCHED_ORDER_VIOLATION",
                           f"k_major schedule revisits k-block {int(kk)} "
                           f"at step {int(s)} — an extra B fetch the "
                           f"order promised to elide", step=int(s),
                           severity=WARNING)
            seen.add(int(kk))
            prev = kk
    else:
        report.add("SCHED_BAD_SHAPE", f"unknown schedule order {order!r}")

    # -- B_FETCH vs the symbolic residency walk -----------------------------
    if annotated:
        resident = None
        for s in range(sched.shape[0]):
            if weights[s] == 0:
                # padding B_FETCH=1 already flagged above; sentinels leave
                # residency alone in _annotate_schedule
                continue
            kk, fetch = int(sched[s, _KBLK]), int(sched[s, _BFETCH])
            if kk != resident and fetch != 1:
                report.add("SCHED_BAD_BFETCH",
                           f"step {s} needs k-block {kk} but the resident "
                           f"block is {resident} and B_FETCH=0 — the MXU "
                           f"consumes stale B data", step=s)
            if kk == resident and fetch != 0:
                report.add("SCHED_BAD_BFETCH",
                           f"step {s} re-fetches already-resident k-block "
                           f"{kk} — fetch the reuse walk elides", step=s,
                           severity=WARNING)
            if fetch == 1:
                resident = kk
            elif kk != resident:
                resident = kk    # keep walking past the error coherently
    return report
