"""Request lifecycle for the serving subsystem (``repro.serving.request``).

A request moves through ``QUEUED -> PREFILL -> DECODE -> DONE`` (or exits
early to ``REJECTED`` at admission).  Each transition stamps a timestamp on
the server's clock — wall seconds in realtime mode, simulated seconds in
virtual-time mode — so TTFT / TPOT / latency are derived properties of the
request itself, not of any particular collector.

``ServeRequest`` is also the launcher's ``Request``: the
first three fields keep their historical positional order and the ``out`` /
``done`` fields their historical meaning, so pre-serving callers
(``Request(rid, prompt, max_tokens)``; read ``.out`` / ``.done``) work
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["ServeRequest", "Request", "QUEUED", "PREFILL", "DECODE",
           "DONE", "REJECTED", "LIFECYCLE"]

QUEUED = "QUEUED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"
REJECTED = "REJECTED"

LIFECYCLE = (QUEUED, PREFILL, DECODE, DONE)

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

    rid/prompt/max_tokens/out/done are the legacy surface; everything else
    is the serving subsystem's: arrival/deadline/priority drive admission
    policies, ``tier`` records the quant tier the router assigned, and the
    ``*_at`` stamps feed TTFT/TPOT metrics.
    """
    rid: int
    prompt: List[int]
    max_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    arrival: float = 0.0
    deadline: Optional[float] = None
    priority: int = 0
    tier: Optional[str] = None
    state: str = QUEUED
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: Optional[str] = None
    retries: int = 0       # restart attempts after a worker death
    migrations: int = 0    # times re-routed away from a dead tier
    # decode-state snapshot attached by a dying worker's drain (restore-
    # mode failover); consumed — and cleared — at the next admission
    snapshot: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def to(self, state: str, now: Optional[float] = None) -> "ServeRequest":
        """Transition to ``state``, stamping the matching timestamp."""
        if state not in _TRANSITIONS[self.state]:
            raise ValueError(f"request {self.rid}: illegal transition "
                             f"{self.state} -> {state}")
        self.state = state
        if state == PREFILL:
            self.admitted_at = now
        elif state == DECODE:
            # only the *first* token ever emitted stamps TTFT: a request
            # migrated after a worker death re-enters DECODE on its new
            # tier, and re-stamping would report a fake (too-late) TTFT
            if self.first_token_at is None:
                self.first_token_at = now
        elif state == DONE:
            self.finished_at = now
            self.done = True
        return self

    def requeue(self, now: Optional[float] = None,
                keep_tokens: bool = False) -> "ServeRequest":
        """Return to QUEUED after a worker death.

        ``keep_tokens=False`` (the restart path): partial output is
        discarded and the request restarts from its prompt on whatever
        tier the router picks next.  ``keep_tokens=True`` (checkpoint/
        restore failover): committed tokens — and any attached decode
        snapshot — survive; the next engine either restores the slot
        bit-exactly (same QuantSpec) or teacher-forces prompt + output.

        Either way, ``first_token_at`` is preserved whenever a first
        token *was* emitted — the TTFT already happened and must not be
        re-reported against the second tier — and ``arrival`` is kept so
        latency keeps pricing the lost work.  Terminal requests cannot
        be requeued (finish-exactly-once)."""
        if self.terminal:
            raise ValueError(f"request {self.rid}: cannot requeue in "
                             f"terminal state {self.state}")
        first = self.first_token_at if self.out else None
        self.state = QUEUED
        if not keep_tokens:
            self.out = []
            self.snapshot = None
        self.done = False
        self.admitted_at = None
        self.first_token_at = first
        self.tier = None
        return self

    # -- derived timings (None until the relevant stamps exist) -------------

    @property
    def terminal(self) -> bool:
        return self.state in (DONE, REJECTED)

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

    @property
    def latency(self) -> Optional[float]:
        """End-to-end: arrival -> done."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    @property
    def deadline_met(self) -> Optional[bool]:
        """None when the request carries no deadline or is unfinished."""
        if self.deadline is None or self.finished_at is None:
            return None
        return self.finished_at <= self.deadline


# Legacy alias, as in the reference
Request = ServeRequest
