"""SlotAllocator: decode-slot bookkeeping (``repro.serving.slots``).

The engine's serve step is a fixed-batch program; the allocator owns the
per-slot host state (which request occupies which row, its KV position,
its teacher-forcing cursor, the token fed next step) and the slot
lifecycle (bind on admission, release on completion).  Positions restart
at 0 on bind, so a reused slot never continues a previous request's KV
positions: the attention mask over ``pos`` keeps stale cache rows unread.

Prompts are teacher-forced through the decode step one token per step;
there is no separate prefill.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .request import DECODE, DONE, PREFILL, ServeRequest

__all__ = ["SlotAllocator"]


class SlotAllocator:
    def __init__(self, n_slots: int, max_len: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.n_slots = n_slots
        self.max_len = max_len
        self._reqs: List[Optional[ServeRequest]] = [None] * n_slots
        self._forced: List[Optional[List[int]]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)
        self.cursor = np.zeros(n_slots, np.int32)   # teacher-forcing cursor
        self.cur = np.zeros((n_slots, 1), np.int32)  # token fed this step

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._reqs) if r is None]

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._reqs)

    def bind(self, slot: int, req: ServeRequest,
             now: Optional[float] = None) -> None:
        """Bind ``req`` to ``slot``; its prompt is forced from position 0."""
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
        self._reqs[slot] = req
        self._forced[slot] = list(req.prompt)
        self.pos[slot] = 0
        self.cursor[slot] = 0
        self.cur[slot, 0] = req.prompt[0]

    def advance(self, next_tokens: np.ndarray,
                now: Optional[float] = None) -> List[ServeRequest]:
        """Consume one engine step's sampled tokens [n_slots, 1]; returns
        requests that finished (and released their slot) this step."""
        finished: List[ServeRequest] = []
        for i, req in enumerate(self._reqs):
            if req is None:
                continue
            self.pos[i] += 1
            c = int(self.cursor[i]) + 1
            forced = self._forced[i]
            if c < len(forced):                 # still teacher-forcing
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
