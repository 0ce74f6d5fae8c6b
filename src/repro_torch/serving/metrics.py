"""Serving metrics: summary statistics of per-request timings."""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

__all__ = ["dist"]


def dist(values: Iterable[float], ndigits: int = 4) -> Optional[dict]:
    """mean/p50/p95/max summary of a sample list (None when empty)."""
    vals = np.asarray([v for v in values if v is not None], np.float64)
    if vals.size == 0:
        return None
    return {"mean": round(float(vals.mean()), ndigits),
            "p50": round(float(np.percentile(vals, 50)), ndigits),
            "p95": round(float(np.percentile(vals, 95)), ndigits),
            "max": round(float(vals.max()), ndigits)}
