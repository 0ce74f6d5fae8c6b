"""Snapshot audit pass: verify a serialized/in-memory DecodeSnapshot (the
reference's ``repro.analysis.ckpt``, on the port's ``serving/ckpt.py``).

Decode-state snapshots (``repro_torch.serving.ckpt.DecodeSnapshot``) are the
unit of token-preserving failover and crash recovery, so a corrupt or
internally-inconsistent snapshot is a silent-token-loss bug waiting for
a restore.  :func:`verify_snapshot` is the static audit: pure host-side
checks (no engine step, no device work) of the bookkeeping invariants
the slot allocator and engine rely on, plus — when given a target
engine — the same-spec compatibility gate the restore path enforces.

Invariants checked (mirrors ``SlotAllocator.bind_restored`` and
``ServeEngine.restorable``):

- committed output is non-empty (an empty snapshot is never written);
- ``pos == len(prompt) + len(out) - 1`` — the KV position accounts for
  exactly the prompt and every committed token, nothing else;
- the teacher-forcing cursor is parked (``len(prompt) - 1 <= cursor <=
  pos``): forcing completed before any token was committed;
- ``cur == out[-1]`` — the token fed next step is the last committed
  one (feeding anything else would fork the sequence on restore);
- ``pos < max_len - 1`` — headroom to generate at least one token;
- the sampling mode is deterministic (``greedy``) — restores of a
  stochastic decode would need RNG-state capture this format does not
  carry;
- state rows are present and finite.

Rows are tensors; a bfloat16 row (every dense engine's KV rows) is read
back from its RPCKPT bytes and checked like any other, where the
reference's reader refuses it (ROADMAP C4).

``python -m repro_torch.analysis`` does not audit snapshots (they are runtime
artifacts, not checked-in); the serve CLI and the checkpoint tests call
this directly.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

from .diagnostics import Report

__all__ = ["verify_snapshot"]


def _load(source, report: Report):
    """Resolve a path / bytes / DecodeSnapshot into a snapshot object,
    reporting parse failures as SNAP_BAD_ARTIFACT (returns None)."""
    from repro_torch.serving.ckpt import DecodeSnapshot, SnapshotError
    if isinstance(source, DecodeSnapshot):
        return source
    try:
        if isinstance(source, (bytes, bytearray)):
            return DecodeSnapshot.from_bytes(bytes(source))
        if isinstance(source, (str, os.PathLike)):
            return DecodeSnapshot.load(source)
    except SnapshotError as e:
        report.add("SNAP_BAD_ARTIFACT", str(e), where=str(source)[:80])
        return None
    report.add("SNAP_BAD_ARTIFACT",
               f"cannot interpret {type(source).__name__} as a snapshot")
    return None


def verify_snapshot(source: Union[str, bytes, object],
                    engine: Optional[object] = None, *,
                    report: Optional[Report] = None) -> Report:
    """Audit one decode-state snapshot.

    source: a ``DecodeSnapshot``, raw ``to_bytes()`` payload, or a file
    path (checksum/format validation happens during parsing — failures
    land as ``SNAP_BAD_ARTIFACT``).  engine: optional target
    ``ServeEngine``; when given, the restore-compatibility gate
    (``engine.restorable``) is consulted and an incompatibility is a
    ``SNAP_SPEC_MISMATCH`` *warning* (restore falls back to the
    token-preserving re-prefill path, so it is lossless but not free).
    Returns the combined :class:`Report`.
    """
    report = report if report is not None else Report("snapshot")
    snap = _load(source, report)
    if snap is None:
        return report
    where = f"rid={snap.rid}"

    if not snap.out:
        report.add("SNAP_BAD_STATE",
                   "no committed tokens (snapshots are only taken "
                   "mid-decode; an empty one restores nothing)",
                   where=where)
    if not snap.prompt:
        report.add("SNAP_BAD_STATE", "empty prompt", where=where)
    want_pos = len(snap.prompt) + len(snap.out) - 1
    if snap.prompt and snap.out and snap.pos != want_pos:
        report.add("SNAP_BAD_STATE",
                   f"pos {snap.pos} breaks the slot invariant "
                   f"len(prompt) + len(out) - 1 = {want_pos}",
                   where=where)
    lo = len(snap.prompt) - 1
    if snap.prompt and not lo <= snap.cursor <= snap.pos:
        report.add("SNAP_BAD_STATE",
                   f"teacher-forcing cursor {snap.cursor} not parked in "
                   f"[{lo}, {snap.pos}] (forcing must complete before "
                   f"tokens commit)", where=where)
    if snap.out and snap.cur != snap.out[-1]:
        report.add("SNAP_BAD_STATE",
                   f"cur {snap.cur} != last committed token "
                   f"{snap.out[-1]} (restore would fork the sequence)",
                   where=where)
    if snap.pos >= snap.max_len - 1:
        report.add("SNAP_NO_HEADROOM",
                   f"pos {snap.pos} leaves no room to generate in "
                   f"max_len {snap.max_len}", where=where)
    if snap.sampling != "greedy":
        report.add("SNAP_BAD_STATE",
                   f"sampling mode {snap.sampling!r} is not "
                   f"deterministic; no RNG state is captured",
                   where=where)
    if not snap.rows:
        report.add("SNAP_BAD_STATE", "no decode-state rows", where=where)
    for i, row in enumerate(snap.rows):
        row = torch.as_tensor(row)
        if row.is_floating_point() and not bool(torch.isfinite(row).all()):
            report.add("SNAP_BAD_STATE",
                       f"state row {i} contains non-finite values",
                       where=where)

    if engine is not None:
        why = engine.restorable(snap)
        if why is not None:
            report.add("SNAP_SPEC_MISMATCH",
                       f"not restorable on this engine ({why}); restore "
                       f"falls back to token-preserving re-prefill",
                       severity="warning", where=where)
    return report
