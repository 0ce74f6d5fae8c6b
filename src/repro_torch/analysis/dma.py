"""Symbolic walk of the schedule's double-buffer slot columns (the
reference's ``repro.analysis.dma``, unchanged).

The annotated ``[L, 9]`` schedule carries three columns for the
reference's pipelined TPU kernels: ``D_SLOT`` / ``B_SLOT`` name the
double-buffer slot each step's digit block and activation block land in,
and ``B_FETCH`` says whether the step copies its activation block at all.
The port keeps them in every plan record bit for bit as the reference
builds them (a later sharded planner reads them too).  The Hopper kernels
read only columns 0-3: B5/B6 run their ``cp.async`` ring from their own
shared-memory layout (``bw_gemm._pipelined_layout``), not from these
columns, so this walk guards the plan record, not the ring; the ring is
held on the card by B5/B6's bit-exactness against B3/B4.

The walk replays the reference kernels' timeline, per grid step ``s``:

1. warm-up (``s == 0``): issue step 0's digit copy (if ``weight[0] != 0``)
   and B copy (if ``b_fetch[0] == 1``) into their schedule-named slots;
2. prefetch: issue step ``s+1``'s copies (same predicates on row ``s+1``)
   -- *before* step ``s``'s waits, so the copy lands under s's pass;
3. wait: step ``s`` waits its digit semaphore iff ``weight[s] != 0`` and
   its B semaphore iff ``b_fetch[s] == 1``;
4. compute: read ``d_buf[d_slot[s]]`` / ``b_buf[b_slot[s]]``.

tracking per-slot in-flight copies, landed contents, and semaphore
signal/wait counts, and flags the three ways a corrupted slot column
breaks that contract:

- ``DMA_WAR_HAZARD`` -- the prefetch issued during step ``s`` targets the
  very slot step ``s``'s compute is reading;
- ``DMA_STALE_READ`` -- a compute step consumes a slot whose landed
  content is not the block the schedule promises (never-fetched slot, or
  a ``b_slot``/``b_fetch`` corruption leaving the wrong k-block
  resident);
- ``DMA_SEM_UNBALANCED`` -- signal (copy-start) and wait counts diverge
  on some semaphore, or copies are still in flight when the walk ends.
  Issue- and wait-predicates come from the *same* schedule cells, so
  this cannot arise from pure column corruption; it is kept as a model
  invariant.

The walk is identical for every output-column tile, so one pass over the
schedule covers the whole call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .diagnostics import Report

__all__ = ["check_dma_hazards"]

_PLANE, _ROW, _KBLK, _WEIGHT, _FIRST, _LAST, _DSLOT, _BSLOT, _BFETCH = \
    range(9)


class _SlotMachine:
    """Two buffer slots + their DMA semaphores for one operand stream."""

    def __init__(self, name: str, report: Report):
        self.name = name
        self.report = report
        self.inflight = {0: None, 1: None}   # slot -> payload in flight
        self.landed = {0: None, 1: None}     # slot -> payload after wait
        self.signals = {0: 0, 1: 0}
        self.waits = {0: 0, 1: 0}

    def start(self, slot: int, payload, step: int) -> None:
        if slot not in (0, 1):
            return                        # flagged by SCHED_OUT_OF_RANGE-ish
        if self.inflight[slot] is not None:
            # two starts race on one semaphore before any wait: the first
            # completion satisfies a wait meant for the second copy
            self.report.add(
                "DMA_SEM_UNBALANCED",
                f"{self.name} copy for step {step} starts into slot {slot} "
                f"while the copy for {self.inflight[slot][0]} is still in "
                f"flight there (double signal before a wait)", step=step)
        self.inflight[slot] = (step, payload)
        self.signals[slot] += 1

    def wait(self, slot: int, step: int) -> None:
        if slot not in (0, 1):
            return
        self.waits[slot] += 1
        if self.waits[slot] > self.signals[slot]:
            self.report.add(
                "DMA_SEM_UNBALANCED",
                f"step {step} waits the {self.name} semaphore of slot "
                f"{slot} ({self.waits[slot]} waits vs "
                f"{self.signals[slot]} signals so far) — the kernel hangs "
                f"or consumes a leftover signal", step=step)
            return
        if self.inflight[slot] is not None:
            self.landed[slot] = self.inflight[slot][1]
            self.inflight[slot] = None

    def read(self, slot: int, want, step: int) -> None:
        if slot not in (0, 1):
            return
        if self.landed[slot] != want:
            have = self.landed[slot]
            detail = "was never fetched" if have is None else \
                f"holds {have}"
            self.report.add(
                "DMA_STALE_READ",
                f"step {step} consumes {self.name} slot {slot} expecting "
                f"{want}, but the slot {detail}", step=step)

    def finish(self, steps: int) -> None:
        for slot in (0, 1):
            if self.inflight[slot] is not None:
                src = self.inflight[slot][0]
                self.report.add(
                    "DMA_SEM_UNBALANCED",
                    f"{self.name} copy for step {src} into slot {slot} is "
                    f"never waited on — its signal leaks into the next "
                    f"grid iteration", step=src)
            if self.signals[slot] != self.waits[slot]:
                self.report.add(
                    "DMA_SEM_UNBALANCED",
                    f"{self.name} semaphore of slot {slot} ends the walk "
                    f"with {self.signals[slot]} signals vs "
                    f"{self.waits[slot]} waits over {steps} steps")


def check_dma_hazards(schedule, *,
                      report: Optional[Report] = None) -> Report:
    """Replay the pipelined kernels' DMA timeline over ``schedule``.

    schedule: int [L, 9] annotated SCHED_COLS rows (the 6-wide v2
    schedules have no slot machine to check and are rejected).
    """
    report = report if report is not None else Report("dma")
    sched = np.asarray(schedule)
    if sched.ndim != 2 or sched.shape[1] != 9:
        report.add("SCHED_BAD_SHAPE",
                   f"DMA-hazard walk needs the annotated [L, 9] schedule, "
                   f"got {tuple(sched.shape)}")
        return report
    for col, name in ((_DSLOT, "d_slot"), (_BSLOT, "b_slot")):
        for s in np.nonzero((sched[:, col] < 0) | (sched[:, col] > 1))[0]:
            report.add("SCHED_OUT_OF_RANGE",
                       f"{name}={int(sched[s, col])} is not a double-buffer "
                       f"slot (0 or 1)", step=int(s))
    steps = sched.shape[0]
    d = _SlotMachine("digit", report)
    b = _SlotMachine("B", report)

    def issue(step: int, during: int) -> None:
        # the copy *targets* the slots named by the schedule row it is
        # issued for; `during` is the grid step whose body issues it
        if sched[step, _WEIGHT] != 0:
            d.start(int(sched[step, _DSLOT]),
                    ("digit", step), during)
        if sched[step, _BFETCH] == 1:
            b.start(int(sched[step, _BSLOT]),
                    ("B", int(sched[step, _KBLK])), during)

    for s in range(steps):
        if s == 0:
            issue(0, during=0)               # warm-up
        if s + 1 < steps:
            issue(s + 1, during=s)           # prefetch under s's MXU pass
            # WAR: the just-issued copy may land while step s is still
            # consuming that slot (prefetch precedes s's waits AND s's
            # compute — there is no fence between them)
            if sched[s, _WEIGHT] != 0:
                if sched[s + 1, _WEIGHT] != 0 and \
                        sched[s + 1, _DSLOT] == sched[s, _DSLOT]:
                    report.add(
                        "DMA_WAR_HAZARD",
                        f"digit copy for step {s + 1} targets slot "
                        f"{int(sched[s, _DSLOT])} while step {s}'s MXU "
                        f"pass is reading it (slots must alternate per "
                        f"fetch)", step=s)
                if sched[s + 1, _BFETCH] == 1 and \
                        sched[s + 1, _BSLOT] == sched[s, _BSLOT]:
                    report.add(
                        "DMA_WAR_HAZARD",
                        f"B copy for step {s + 1} targets slot "
                        f"{int(sched[s, _BSLOT])} while step {s}'s MXU "
                        f"pass is reading it", step=s)
        if sched[s, _WEIGHT] != 0:
            d.wait(int(sched[s, _DSLOT]), s)
        if sched[s, _BFETCH] == 1:
            b.wait(int(sched[s, _BSLOT]), s)
        if sched[s, _WEIGHT] != 0:           # compute reads both buffers
            d.read(int(sched[s, _DSLOT]), ("digit", s), s)
            b.read(int(sched[s, _BSLOT]),
                   ("B", int(sched[s, _KBLK])), s)
    d.finish(steps)
    b.finish(steps)
    return report
