"""Request lifecycle for the serving subsystem (``repro.serving.request``).

A request moves through ``QUEUED -> PREFILL -> DECODE -> DONE`` (or exits
early to ``REJECTED`` at admission).  Each transition stamps a timestamp
on the server's clock, so TTFT / TPOT / latency are derived properties of
the request itself.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["ServeRequest", "Request", "QUEUED", "PREFILL", "DECODE",
           "DONE", "REJECTED"]

QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"
REJECTED = "REJECTED"

_TRANSITIONS = {
    QUEUED: (PREFILL, REJECTED),
    PREFILL: (DECODE,),
    DECODE: (DONE,),
    DONE: (),
    REJECTED: (),
}


@dataclasses.dataclass
class ServeRequest:
    """One generation request with lifecycle state and timing.

    arrival/deadline/priority drive the admission policies; the ``*_at``
    stamps feed the TTFT/TPOT metrics.
    """
    rid: int
    prompt: List[int]
    max_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    arrival: float = 0.0
    deadline: Optional[float] = None
    priority: int = 0
    state: str = QUEUED
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: Optional[str] = None

    def to(self, state: str, now: Optional[float] = None) -> "ServeRequest":
        """Transition to ``state``, stamping the matching timestamp."""
        if state not in _TRANSITIONS[self.state]:
            raise ValueError(f"request {self.rid}: illegal transition "
                             f"{self.state} -> {state}")
        self.state = state
        if state == PREFILL:
            self.admitted_at = now
        elif state == DECODE:
            if self.first_token_at is None:
                self.first_token_at = now
        elif state == DONE:
            self.finished_at = now
            self.done = True
        return self

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: arrival -> first generated token."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token over the decode phase."""
        if self.finished_at is None or self.first_token_at is None:
            return None
        return ((self.finished_at - self.first_token_at)
                / max(len(self.out) - 1, 1))


Request = ServeRequest
