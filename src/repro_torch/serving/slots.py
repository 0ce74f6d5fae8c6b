"""SlotAllocator: decode-slot bookkeeping (``repro.serving.slots``).

The engine's serve step is a fixed-batch program; the allocator owns
the per-slot host state (which request occupies which row, its KV position,
its teacher-forcing cursor, the token fed next step) and the slot lifecycle
(bind on admission, release on completion).  Positions always restart at 0
on bind, so a reused slot never continues a previous request's KV
positions — the attention mask over ``pos`` guarantees cache rows beyond
the new position are never read.  (Recurrent state families need an
explicit state reset on rebind; the engine handles that, keyed off the
``rebind`` flag this allocator returns.)

With ``audit=True`` the allocator records a (generation, slot, rid, pos)
event per step, which the property tests replay to check the continuous
batching invariants: every request finishes exactly once, and within one
binding the position sequence starts at 0 and is strictly increasing.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .request import DECODE, DONE, PREFILL, ServeRequest

__all__ = ["SlotAllocator", "SlotEvent"]


@dataclasses.dataclass(frozen=True)
class SlotEvent:
    """One audit record: request ``rid`` occupied ``slot`` (binding number
    ``generation`` of that slot) at KV position ``pos`` this step."""
    generation: int
    slot: int
    rid: int
    pos: int


class SlotAllocator:
    def __init__(self, n_slots: int, max_len: int, audit: bool = False):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.n_slots = n_slots
        self.max_len = max_len
        self._reqs: List[Optional[ServeRequest]] = [None] * n_slots
        # teacher-forced prefix per binding: the prompt, plus any tokens a
        # migrated request already committed on a previous tier (the
        # token-preserving re-prefill path feeds prompt + out and only
        # appends *new* tokens — no token is ever generated twice)
        self._forced: List[Optional[List[int]]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)
        self.cursor = np.zeros(n_slots, np.int32)   # teacher-forcing cursor
        self.cur = np.zeros((n_slots, 1), np.int32)  # token fed this step
        self.generation = np.zeros(n_slots, np.int64)  # bindings per slot
        self._ever_bound = np.zeros(n_slots, bool)
        self.trace: List[SlotEvent] = [] if audit else None

    # -- queries -------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._reqs) if r is None]

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._reqs)

    @property
    def occupancy(self) -> float:
        return self.active / self.n_slots

    def request_at(self, slot: int) -> Optional[ServeRequest]:
        return self._reqs[slot]

    def bound(self) -> List[tuple]:
        """(slot, request) for every occupied slot, in slot order."""
        return [(i, r) for i, r in enumerate(self._reqs) if r is not None]

    def decode_ready(self, slot: int) -> bool:
        """True when ``slot``'s occupant has finished teacher-forcing:
        the cursor is parked at the end of the forced prefix, so the slot
        satisfies the snapshot invariant
        ``pos == len(prompt) + len(out) - 1``.  A migrated request still
        re-prefilling prompt + committed output is *not* decode-ready —
        its pos/cursor/cur are mid-forcing, and a snapshot taken now
        could never be restored."""
        req = self._reqs[slot]
        if req is None:
            return False
        return int(self.cursor[slot]) >= len(self._forced[slot]) - 1

    def backlog_tokens(self) -> int:
        """Tokens still owed by bound requests (forced-prefix remainder +
        decode).  The forced prefix is prompt + committed output, so a
        re-prefilling migrant's replay steps are priced as real work."""
        total = 0
        for i, r in enumerate(self._reqs):
            if r is None:
                continue
            forced = self._forced[i] or r.prompt
            total += max(len(forced) - 1 - int(self.cursor[i]), 0)
            total += max(r.max_tokens - len(r.out), 0)
        return total

    # -- lifecycle -----------------------------------------------------------

    def bind(self, slot: int, req: ServeRequest,
             now: Optional[float] = None) -> bool:
        """Bind ``req`` to ``slot``; returns True when the slot is being
        *reused* (a previous request decoded here — recurrent-state families
        must reset that row's state)."""
        if self._reqs[slot] is not None:
            raise ValueError(f"slot {slot} is occupied by request "
                             f"{self._reqs[slot].rid}")
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) + 1 > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"does not fit max_len {self.max_len} (needs room for at "
                f"least one generated token)")
        req.to(PREFILL, now)
        rebind = bool(self._ever_bound[slot])
        self._reqs[slot] = req
        # a fresh request forces just its prompt (out is empty); a
        # token-preserving migrant re-prefills prompt + committed output
        self._forced[slot] = list(req.prompt) + list(req.out)
        self.pos[slot] = 0
        self.cursor[slot] = 0
        self.cur[slot, 0] = req.prompt[0]
        self.generation[slot] += 1
        self._ever_bound[slot] = True
        return rebind

    def bind_restored(self, slot: int, req: ServeRequest, pos: int,
                      cursor: int, cur: int,
                      now: Optional[float] = None) -> None:
        """Bind a snapshot-restored request mid-decode: its KV/state row
        is being written back bit-exactly by the engine, so the slot
        resumes at ``pos`` with ``cur`` (the last committed token) fed
        next step — no re-prefill steps at all.  The caller overwrites
        the whole state row, so no recurrent-state reset is needed."""
        if self._reqs[slot] is not None:
            raise ValueError(f"slot {slot} is occupied by request "
                             f"{self._reqs[slot].rid}")
        if not req.out:
            raise ValueError(f"request {req.rid}: nothing to restore "
                             f"(no committed tokens — use bind())")
        if pos != len(req.prompt) + len(req.out) - 1:
            raise ValueError(
                f"request {req.rid}: snapshot position {pos} breaks the "
                f"slot invariant pos == len(prompt) + len(out) - 1 = "
                f"{len(req.prompt) + len(req.out) - 1}")
        if pos >= self.max_len - 1:
            raise ValueError(f"request {req.rid}: snapshot position {pos} "
                             f"leaves no room in max_len {self.max_len}")
        req.to(PREFILL, now)
        self._reqs[slot] = req
        # forcing is already complete (out is non-empty): the cursor parks
        # at the end of the prompt and every subsequent token is appended
        self._forced[slot] = list(req.prompt)
        self.pos[slot] = pos
        self.cursor[slot] = cursor
        self.cur[slot, 0] = cur
        self.generation[slot] += 1
        self._ever_bound[slot] = True

    def evict(self, slot: int) -> Optional[ServeRequest]:
        """Unbind ``slot`` without finishing its request (worker-death
        drain).  The occupant (if any) is returned still mid-lifecycle;
        its KV/state rows are simply abandoned — positions restart at 0
        on the next bind, so a stale row is never read."""
        req, self._reqs[slot] = self._reqs[slot], None
        self._forced[slot] = None
        return req

    def evict_all(self) -> List[ServeRequest]:
        """Evict every bound request (slot order — deterministic)."""
        return [r for r in (self.evict(i) for i in range(self.n_slots))
                if r is not None]

    def advance(self, next_tokens: np.ndarray,
                now: Optional[float] = None) -> List[ServeRequest]:
        """Consume one engine step's sampled tokens; returns requests that
        finished (and released their slot) this step."""
        finished: List[ServeRequest] = []
        for i, req in enumerate(self._reqs):
            if req is None:
                continue
            if self.trace is not None:
                self.trace.append(SlotEvent(int(self.generation[i]), i,
                                            req.rid, int(self.pos[i])))
            self.pos[i] += 1
            c = int(self.cursor[i]) + 1
            forced = self._forced[i]
            if c < len(forced):
                # still teacher-forcing (prompt, plus committed output
                # when re-prefilling a migrated request)
                self.cursor[i] = c
                self.cur[i, 0] = forced[c]
                continue
            tok = int(next_tokens[i, 0])
            if req.state == PREFILL:
                req.to(DECODE, now)
            req.out.append(tok)
            self.cur[i, 0] = tok
            if len(req.out) >= req.max_tokens or \
                    self.pos[i] >= self.max_len - 1:
                req.to(DONE, now)
                finished.append(req)
                self._reqs[i] = None
                self._forced[i] = None
        return finished
