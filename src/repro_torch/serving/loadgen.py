"""Synthetic traffic for offline load tests.

Arrival processes (all deterministic under a seed):

    poisson -- exponential inter-arrival gaps at ``rate`` req/s, the
               standard open-loop serving-benchmark arrival model
    burst   -- groups of ``burst`` simultaneous arrivals every ``gap``
               seconds (worst-case queue pressure)
    uniform -- evenly spaced arrivals at ``rate`` req/s
    none    -- everything arrives at t=0 (closed-loop / batch mode)

``synthesize`` builds full ``ServeRequest`` loads: random prompt lengths
and token budgets, optional per-request deadlines (arrival + slack, the
SLO the deadline policies act on) and priorities.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .request import ServeRequest

__all__ = ["ARRIVAL_PATTERNS", "arrival_times", "synthesize"]

ARRIVAL_PATTERNS = ("poisson", "burst", "uniform", "none")


def arrival_times(n: int, pattern: str = "poisson", rate: float = 8.0,
                  burst: int = 4, gap: float = 0.5,
                  seed: int = 0) -> np.ndarray:
    """n arrival offsets (seconds from load start), non-decreasing."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if pattern == "none":
        return np.zeros(n)
    if pattern == "uniform":
        return np.arange(n) / max(rate, 1e-9)
    if pattern == "burst":
        return (np.arange(n) // max(burst, 1)) * gap
    if pattern == "poisson":
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
        t = np.cumsum(gaps)
        return t - t[0] if n else t
    raise ValueError(f"unknown arrival pattern {pattern!r}; "
                     f"one of {ARRIVAL_PATTERNS}")


def synthesize(vocab_size: int, n: int, *,
               prompt_len: Tuple[int, int] = (4, 12),
               max_tokens: Tuple[int, int] = (4, 16),
               pattern: str = "poisson", rate: float = 8.0,
               burst: int = 4, gap: float = 0.5,
               deadline_slack: Optional[Tuple[float, float]] = None,
               priorities: Sequence[int] = (0,),
               seed: int = 0) -> List[ServeRequest]:
    """A synthetic request load.  ``prompt_len`` / ``max_tokens`` are
    inclusive ranges; ``deadline_slack=(lo, hi)`` gives each request a
    deadline of ``arrival + U(lo, hi)`` (None leaves deadlines unset)."""
    rng = np.random.default_rng(seed)
    arrivals = arrival_times(n, pattern, rate, burst, gap, seed=seed + 1)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        mtok = int(rng.integers(max_tokens[0], max_tokens[1] + 1))
        deadline = None
        if deadline_slack is not None:
            lo, hi = deadline_slack
            deadline = float(arrivals[i] + lo + (hi - lo) * rng.random())
        reqs.append(ServeRequest(
            rid=i,
            prompt=rng.integers(0, vocab_size, plen).tolist(),
            max_tokens=mtok,
            arrival=float(arrivals[i]),
            deadline=deadline,
            priority=int(rng.choice(np.asarray(priorities))),
        ))
    return reqs
