"""Admission scheduling: a queue with pluggable ordering policies
(``repro.serving.scheduler``).

    fcfs      -- submission order
    priority  -- highest ``priority`` first, FCFS among equals
    deadline  -- earliest deadline first; deadline-less requests queue
                 behind any deadline, FCFS among themselves

Too-long prompts are handled per ``on_too_long``: ``"error"`` raises at
submission, ``"reject"`` marks the request ``REJECTED``, ``"truncate"``
clips the prompt head to fit and warns.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

from .request import QUEUED, REJECTED, ServeRequest

__all__ = ["AdmissionPolicy", "FcfsPolicy", "PriorityPolicy",
           "DeadlinePolicy", "POLICIES", "make_policy", "Scheduler"]


class AdmissionPolicy:
    """Selects which queued request a freed slot admits next."""

    name = ""

    def select(self, queue: List[ServeRequest], now: float) -> int:
        """Index into ``queue`` (submission-ordered) of the next request."""
        raise NotImplementedError


class FcfsPolicy(AdmissionPolicy):
    name = "fcfs"

    def select(self, queue, now):
        return 0


class PriorityPolicy(AdmissionPolicy):
    name = "priority"

    def select(self, queue, now):
        # max() is stable on the first maximum -> FCFS among equals
        return max(range(len(queue)), key=lambda i: queue[i].priority)


class DeadlinePolicy(AdmissionPolicy):
    name = "deadline"

    def select(self, queue, now):
        return min(range(len(queue)),
                   key=lambda i: (queue[i].deadline is None,
                                  queue[i].deadline or 0.0))


POLICIES = {p.name: p for p in (FcfsPolicy(), PriorityPolicy(),
                                DeadlinePolicy())}

ON_TOO_LONG = ("error", "reject", "truncate")


def make_policy(policy) -> AdmissionPolicy:
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown admission policy {policy!r}; "
                         f"one of {tuple(POLICIES)}") from None


class Scheduler:
    def __init__(self, policy="fcfs", max_len: Optional[int] = None,
                 on_too_long: str = "error"):
        if on_too_long not in ON_TOO_LONG:
            raise ValueError(f"on_too_long must be one of {ON_TOO_LONG}, "
                             f"got {on_too_long!r}")
        self.policy = make_policy(policy)
        self.max_len = max_len
        self.on_too_long = on_too_long
        self._queue: List[ServeRequest] = []
        self.rejected: List[ServeRequest] = []
        self.submitted = 0

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Validate and enqueue; returns False when the request was
        rejected (it is then in ``self.rejected`` with ``req.error`` set)."""
        if req.state != QUEUED:
            raise ValueError(f"request {req.rid}: cannot submit in state "
                             f"{req.state}")
        self.submitted += 1
        error = None
        if not req.prompt:
            error = "empty prompt"
        elif self.max_len is not None and \
                len(req.prompt) + 1 > self.max_len:
            error = (f"prompt length {len(req.prompt)} does not fit "
                     f"max_len {self.max_len}")
            if self.on_too_long == "truncate":
                keep = self.max_len - 1
                warnings.warn(
                    f"request {req.rid}: truncating prompt "
                    f"{len(req.prompt)} -> {keep} tokens to fit max_len "
                    f"{self.max_len}", stacklevel=2)
                req.prompt = list(req.prompt[:keep])
                error = None
        if error is not None:
            if self.on_too_long == "error" or error == "empty prompt":
                self.submitted -= 1
                raise ValueError(f"request {req.rid}: {error}")
            req.error = error
            req.to(REJECTED, now)
            self.rejected.append(req)
            return False
        self._queue.append(req)
        return True

    def pop(self, now: float = 0.0) -> Optional[ServeRequest]:
        """Release the next request per the admission policy."""
        if not self._queue:
            return None
        return self._queue.pop(self.policy.select(self._queue, now))
