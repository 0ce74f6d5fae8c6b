"""Collective-traffic arithmetic for the cost model: a private copy of
``repro.parallel.collectives``' pure-arithmetic helpers.

The port serves one device; these price a tier's shard grid the way the
reference does, so ``GemmEngine.cost(shards=...)`` and
``serving.tiers.step_cost`` give the reference's numbers.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["normalize_shards", "allreduce_bytes", "gemm_collective_bytes"]


def normalize_shards(shards) -> Tuple[int, int]:
    """Coerce a shards argument to ``(s_data, s_model)``.

    Accepts None (unsharded), an int (data-parallel only) or a 2-tuple.
    """
    if shards is None:
        return (1, 1)
    if isinstance(shards, int):
        shards = (shards, 1)
    s_data, s_model = (int(shards[0]), int(shards[1]))
    if len(tuple(shards)) != 2 or s_data < 1 or s_model < 1:
        raise ValueError(f"shards must be (s_data, s_model) with positive "
                         f"sizes, got {shards!r}")
    return (s_data, s_model)


def allreduce_bytes(payload_bytes: int, world: int, *,
                    reduce: str = "psum") -> int:
    """Per-device bytes a ring collective moves for one reduction:
    ``psum`` (all-reduce) is ``2 * (world-1)/world * payload``,
    ``psum_scatter`` half that.  ``world <= 1`` is free."""
    if world <= 1:
        return 0
    if reduce == "psum":
        phases = 2
    elif reduce == "psum_scatter":
        phases = 1
    else:
        raise ValueError(f"unknown reduce {reduce!r}; "
                         f"one of ('psum', 'psum_scatter')")
    return int(phases * (world - 1) * payload_bytes // world)


def gemm_collective_bytes(m: int, n: int, s_data: int, s_model: int = 1, *,
                          acc_bytes: int = 4,
                          reduce: str = "psum") -> int:
    """Per-device collective traffic of one sharded [M,K]x[K,N] GEMM: a
    K split ``s_data`` ways leaves a partial accumulator of the device's
    ``m x ceil(n / s_model)`` output tile to sum across the axis; an M/N
    split alone (``s_data == 1``) needs no collective."""
    if s_data <= 1:
        return 0
    n_shard = -(-int(n) // max(int(s_model), 1))
    payload = int(m) * n_shard * int(acc_bytes)
    return allreduce_bytes(payload, int(s_data), reduce=reduce)
