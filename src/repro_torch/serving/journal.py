"""Write-ahead request journal: crash-recoverable serving.

The ``AsyncServer`` appends one JSONL record per durable event — request
admission, committed-token batches after each engine pump, completion,
loss, restart-mode requeues (which retract uncommitted work), and worker
deaths — so a server killed mid-run (the ``crash_server`` chaos fault, a
real ``kill -9``) can be restarted with ``--resume``: the journal replay
reconstructs which requests already finished (their outputs are final)
and which were in flight (they re-enter the queue at their last
committed token, teacher-forced through prompt + committed output so no
token is ever generated twice).

Every record carries a CRC32 of its body; ``replay`` is
corruption-truncating: the first record that fails to parse or verify
ends the replay (everything after a torn write is untrusted), mirroring
how a real WAL recovers from a partial final page.  Appends are flushed
per record so the journal is never behind the tokens the server has
committed.

Record kinds::

    hdr    journal header (format version, seed)
    admit  request entered the system  {rid, prompt, max_tokens, ...}
    tok    committed-token batch       {rid, toks, t}
    done   request completed           {rid, t}
    rst    restart-mode requeue        {rid, t}  (retracts its tokens)
    drop   request lost (REJECTED)     {rid, why, t}
    death  a tier worker died          {tier, t}
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Dict, List, Optional

from repro_torch.obs import metrics as obs_metrics

from .request import ServeRequest

__all__ = ["RequestJournal", "JournalReplay", "replay", "resume_split"]

JOURNAL_VERSION = 1

_REG = obs_metrics.get_registry()
_M_RECORDS = _REG.counter("repro_serve_journal_records_total")
_M_REPLAYED = _REG.counter("repro_serve_journal_replayed_total")
_M_TRUNCATED = _REG.counter("repro_serve_journal_truncated_total")


def _pack(rec: dict) -> str:
    body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    return json.dumps({"c": zlib.crc32(body.encode("utf-8")), "r": rec},
                      sort_keys=True, separators=(",", ":"))


def _unpack(line: str) -> Optional[dict]:
    """The record, or None when the line is torn/corrupt."""
    try:
        outer = json.loads(line)
        rec = outer["r"]
        body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        if outer["c"] != zlib.crc32(body.encode("utf-8")):
            return None
        return rec
    except (json.JSONDecodeError, KeyError, TypeError):
        return None


class RequestJournal:
    """Append-only writer (thread-safe: realtime worker threads commit
    concurrently).  ``resume=True`` appends to an existing journal after
    a replay instead of truncating it — the committed-token counts are
    seeded from the replay so re-served requests do not re-journal the
    tokens the previous process already committed.

    A fresh (non-resume) journal refuses to truncate an existing
    non-empty file: after a crash the WAL is the *only* recovery
    artifact, and silently clobbering it on a rerun without ``--resume``
    would destroy it before it could be replayed.  Pass
    ``overwrite=True`` to discard it deliberately."""

    def __init__(self, path: str, resume: bool = False,
                 seed: int = 0, overwrite: bool = False):
        self.path = path
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._admitted: set = set()
        self._done: set = set()
        mode = "a" if resume and os.path.exists(path) else "w"
        if mode == "w" and not overwrite and \
                os.path.exists(path) and os.path.getsize(path) > 0:
            raise FileExistsError(
                f"journal {path!r} already exists; pass --resume to "
                f"replay it (keeping committed tokens), or delete it / "
                f"use overwrite=True to start over")
        self._f = open(path, mode)
        if mode == "w":
            self._append({"k": "hdr", "version": JOURNAL_VERSION,
                          "seed": seed})

    def seed_from(self, rep: "JournalReplay") -> None:
        """Prime the committed state from a replay (resume path)."""
        with self._lock:
            for rid, toks in rep.committed.items():
                self._counts[rid] = len(toks)
            self._admitted |= set(rep.admitted)
            self._done |= set(rep.completed)

    def _append(self, rec: dict) -> None:
        self._f.write(_pack(rec) + "\n")
        self._f.flush()
        _M_RECORDS.labels(kind=rec["k"]).inc()

    # -- event surface (server-side) ----------------------------------------

    def admit(self, req: ServeRequest, now: float) -> None:
        with self._lock:
            if req.rid in self._admitted:
                return
            self._admitted.add(req.rid)
            self._append({"k": "admit", "rid": req.rid,
                          "prompt": list(req.prompt),
                          "max_tokens": req.max_tokens,
                          "arrival": req.arrival,
                          "deadline": req.deadline,
                          "priority": req.priority, "t": now})

    def commit(self, req: ServeRequest, now: float) -> None:
        """Append the tokens committed since the last commit for this
        request, plus its completion record once it is DONE."""
        with self._lock:
            n = self._counts.get(req.rid, 0)
            new = list(req.out[n:])
            if new:
                self._counts[req.rid] = len(req.out)
                self._append({"k": "tok", "rid": req.rid, "toks": new,
                              "t": now})
            if req.done and req.rid not in self._done:
                self._done.add(req.rid)
                self._append({"k": "done", "rid": req.rid, "t": now})

    def retract(self, req: ServeRequest, now: float) -> None:
        """Restart-mode requeue: the request's committed tokens are void
        (it will regenerate from its prompt)."""
        with self._lock:
            if self._counts.pop(req.rid, 0):
                self._append({"k": "rst", "rid": req.rid, "t": now})

    def drop(self, req: ServeRequest, why: str, now: float) -> None:
        with self._lock:
            self._counts.pop(req.rid, None)
            self._append({"k": "drop", "rid": req.rid, "why": why,
                          "t": now})

    def death(self, tier: str, now: float) -> None:
        with self._lock:
            self._append({"k": "death", "tier": tier, "t": now})

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class JournalReplay:
    """The recovered state of one journal file."""
    version: int
    seed: int
    records: int                      # valid records replayed
    truncated: int                    # trailing lines dropped as corrupt
    admitted: Dict[int, dict]         # rid -> admit fields
    committed: Dict[int, List[int]]   # rid -> committed tokens (in flight)
    completed: Dict[int, List[int]]   # rid -> final output
    dropped: Dict[int, str]           # rid -> loss reason
    first_token_t: Dict[int, float]   # rid -> clock of first committed tok
    deaths: List[dict]                # worker-death markers, in order


def replay(path: str) -> JournalReplay:
    """Corruption-truncating replay: stop at the first unparseable or
    checksum-failing line (a torn final write truncates, it does not
    poison the prefix)."""
    version, seed = JOURNAL_VERSION, 0
    admitted: Dict[int, dict] = {}
    committed: Dict[int, List[int]] = {}
    completed: Dict[int, List[int]] = {}
    dropped: Dict[int, str] = {}
    first_tok: Dict[int, float] = {}
    deaths: List[dict] = []
    n_ok = n_bad = 0
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        rec = _unpack(line)
        if rec is None or "k" not in rec:
            n_bad = sum(1 for x in lines[i:] if x.strip())
            break
        n_ok += 1
        k = rec["k"]
        if k == "hdr":
            version = rec.get("version", JOURNAL_VERSION)
            seed = rec.get("seed", 0)
            if version != JOURNAL_VERSION:
                raise ValueError(f"journal version {version} != supported "
                                 f"{JOURNAL_VERSION}")
        elif k == "admit":
            admitted[rec["rid"]] = rec
        elif k == "tok":
            toks = committed.setdefault(rec["rid"], [])
            if not toks:
                first_tok[rec["rid"]] = rec["t"]
            toks.extend(rec["toks"])
        elif k == "rst":
            committed.pop(rec["rid"], None)
            first_tok.pop(rec["rid"], None)
        elif k == "done":
            completed[rec["rid"]] = committed.pop(rec["rid"], [])
        elif k == "drop":
            committed.pop(rec["rid"], None)
            dropped[rec["rid"]] = rec.get("why", "")
        elif k == "death":
            deaths.append(rec)
        # unknown kinds are skipped: forward-compatible replay
    _M_REPLAYED.inc(n_ok)
    if n_bad:
        _M_TRUNCATED.inc(n_bad)
    return JournalReplay(version=version, seed=seed, records=n_ok,
                         truncated=n_bad, admitted=admitted,
                         committed=committed, completed=completed,
                         dropped=dropped, first_token_t=first_tok,
                         deaths=deaths)


def resume_split(rep: JournalReplay, reqs) -> tuple:
    """Split a regenerated load against a replay: ``(to_serve, outputs)``.

    ``outputs`` maps rid -> final output for requests the journal proves
    complete (they are not re-served).  ``to_serve`` is every other
    request, with in-flight requests primed at their last committed
    token: ``out`` pre-filled (the engine teacher-forces prompt +
    committed output, so generation resumes at the exact next position)
    and the first-token stamp restored so TTFT survives the restart.
    """
    outputs: Dict[int, List[int]] = {}
    to_serve: List[ServeRequest] = []
    for r in reqs:
        if r.rid in rep.completed:
            outputs[r.rid] = list(rep.completed[r.rid])
            continue
        toks = rep.committed.get(r.rid)
        if toks:
            r.out = list(toks)
            r.first_token_at = rep.first_token_t.get(r.rid)
        to_serve.append(r)
    return to_serve, outputs
