"""Decode-state snapshots for checkpoint/restore failover
(``repro.serving.ckpt``).

A ``DecodeSnapshot`` captures everything one request's decode slot owns:
the per-slot rows of the engine's decode-state tree (the KV cache rows of
the dense family), the generated-token ids, the teacher-forcing cursor
and the token fed next step, and the lifecycle stamps that keep TTFT
honest across a migration.  ``ServeEngine.snapshot_slot`` produces one
and ``ServeEngine.restore_slot`` writes it back into a *compatible*
engine (same QuantSpec, family, and state-leaf geometry) -- the
bit-exact same-spec failover path.  An incompatible engine falls back to
the token-preserving re-prefill path instead (``ServeEngine.admit_from``).

Serialization is the reference's RPCKPT v1 format, byte for byte:

    MAGIC (8 bytes) | u32 header length | JSON header | npz payload

The header carries a format version, every scalar field, the payload's
CRC32 and byte length, and the row shapes/dtypes, so ``from_bytes``
rejects truncation, corruption, and version skew before any array is
touched.  ``save`` writes atomically (tmp + ``os.replace``).

Rows are CPU tensors.  A bfloat16 row is stored as the reference stores
one: two raw bytes an element under the npy descr ``'<V2'`` (what
``np.savez`` writes for an ``ml_dtypes`` bfloat16 array), with
``"bfloat16"`` in the header.  ``from_bytes`` reads such a row back into
a bfloat16 tensor bit for bit, so the port reads the reference's files.
(The reference's own reader compares the stored array's dtype, ``|V2``,
with the header's ``bfloat16`` and refuses them.)

Decode here is greedy (argmax): there is no sampling RNG to capture, and
the header records ``sampling="greedy"`` so a future stochastic decoder
cannot silently restore from a snapshot that under-specifies its state.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import zipfile
import zlib
from typing import List, Optional

import numpy as np
import torch

__all__ = ["DecodeSnapshot", "SnapshotError", "SnapshotMismatch",
           "CKPT_MAGIC", "CKPT_VERSION"]

CKPT_MAGIC = b"RPCKPT\x00\n"
CKPT_VERSION = 1

# the npy descr np.savez writes for an ml_dtypes bfloat16 array
_BF16_DESCR = "<V2"


def _dtype_name(t: torch.Tensor) -> str:
    """The header's dtype string: numpy's name for the row's dtype."""
    return str(t.dtype).removeprefix("torch.")


def _savez_rows(rows: List[torch.Tensor]) -> bytes:
    """``np.savez(buf, row000=..., ...)`` of the rows, byte for byte: the
    same zip layout, with a bfloat16 row written under descr '<V2'."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zipf:
        for i, row in enumerate(rows):
            t = row.detach().cpu().contiguous()
            with zipf.open(f"row{i:03d}.npy", "w", force_zip64=True) as fid:
                if t.dtype == torch.bfloat16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": _BF16_DESCR, "fortran_order": False,
                              "shape": tuple(t.shape)})
                    fid.write(t.view(torch.int16).numpy().tobytes("C"))
                else:
                    np.lib.format.write_array(fid, t.numpy(),
                                              allow_pickle=True,
                                              pickle_kwargs=None)
    return buf.getvalue()


def _row_from_npy(arr: np.ndarray, meta: dict) -> torch.Tensor:
    """One stored array as a tensor, checked against its header entry."""
    if meta["dtype"] == "bfloat16" and arr.dtype == np.dtype("V2"):
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    elif str(arr.dtype) == meta["dtype"]:
        t = torch.from_numpy(np.array(arr))
    else:
        t = None
    if t is None or list(t.shape) != meta["shape"]:
        raise SnapshotError(
            f"snapshot row {meta} does not match its stored array "
            f"{arr.shape}/{arr.dtype}")
    return t


class SnapshotError(ValueError):
    """A snapshot failed to parse or validate (corruption, version skew,
    inconsistent header fields)."""


class SnapshotMismatch(SnapshotError):
    """A structurally valid snapshot that is incompatible with the engine
    asked to restore it (different QuantSpec / family / state geometry).
    The server falls back to token-preserving re-prefill on this."""


@dataclasses.dataclass
class DecodeSnapshot:
    """One slot's decode state, detached from any engine.

    ``rows`` holds the axis-1 (batch) slice of every decode-state leaf, as
    CPU tensors, in the reference's leaf order (``jax.tree.leaves``: dict
    keys sorted, so ``k`` then ``v``) -- shape ``[L, 1, ...]`` for
    per-slot leaves; leaves with ndim < 2 are shared (not per-slot) and
    are carried verbatim but ignored on restore.  The slot invariant
    ``pos == len(prompt) + len(out) - 1`` must hold; ``cur`` is the token
    fed next step, i.e. ``out[-1]`` for a mid-decode slot.
    """
    rid: int
    spec: Optional[str]          # str(QuantSpec) of the source engine
    family: str                  # model family (dense/moe/rwkv/...)
    max_len: int
    pos: int
    cursor: int
    cur: int
    prompt: List[int]
    out: List[int]
    rows: List[torch.Tensor]
    arrival: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    sampling: str = "greedy"
    version: int = CKPT_VERSION

    # -- serialization -------------------------------------------------------

    def to_bytes(self) -> bytes:
        payload = _savez_rows(self.rows)
        header = {
            "version": self.version, "rid": self.rid, "spec": self.spec,
            "family": self.family, "max_len": self.max_len,
            "pos": self.pos, "cursor": self.cursor, "cur": self.cur,
            "prompt": list(self.prompt), "out": list(self.out),
            "arrival": self.arrival, "admitted_at": self.admitted_at,
            "first_token_at": self.first_token_at,
            "sampling": self.sampling,
            "rows": [{"shape": list(r.shape), "dtype": _dtype_name(r)}
                     for r in self.rows],
            "payload_len": len(payload),
            "payload_crc32": zlib.crc32(payload),
        }
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        return CKPT_MAGIC + struct.pack(">I", len(hdr)) + hdr + payload

    @classmethod
    def from_bytes(cls, data: bytes) -> "DecodeSnapshot":
        if len(data) < len(CKPT_MAGIC) + 4 or \
                not data.startswith(CKPT_MAGIC):
            raise SnapshotError("not a decode snapshot (bad magic)")
        off = len(CKPT_MAGIC)
        (hlen,) = struct.unpack(">I", data[off:off + 4])
        off += 4
        if len(data) < off + hlen:
            raise SnapshotError("truncated snapshot header")
        try:
            header = json.loads(data[off:off + hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SnapshotError(f"corrupt snapshot header: {e}") from None
        if header.get("version") != CKPT_VERSION:
            raise SnapshotError(
                f"snapshot format version {header.get('version')!r} != "
                f"supported {CKPT_VERSION}")
        payload = data[off + hlen:]
        if len(payload) != header["payload_len"]:
            raise SnapshotError(
                f"truncated snapshot payload: {len(payload)} bytes, "
                f"header promises {header['payload_len']}")
        if zlib.crc32(payload) != header["payload_crc32"]:
            raise SnapshotError("snapshot payload checksum mismatch")
        with np.load(io.BytesIO(payload)) as z:
            rows = [_row_from_npy(z[f"row{i:03d}"], meta)
                    for i, meta in enumerate(header["rows"])]
        return cls(rid=header["rid"], spec=header["spec"],
                   family=header["family"], max_len=header["max_len"],
                   pos=header["pos"], cursor=header["cursor"],
                   cur=header["cur"], prompt=header["prompt"],
                   out=header["out"], rows=rows,
                   arrival=header["arrival"],
                   admitted_at=header["admitted_at"],
                   first_token_at=header["first_token_at"],
                   sampling=header["sampling"],
                   version=header["version"])

    def save(self, path: str) -> str:
        """Atomic write (tmp + ``os.replace``): a reader never observes a
        partial snapshot, a crashed writer leaves the old file intact."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(self.to_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "DecodeSnapshot":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -- queries -------------------------------------------------------------

    @property
    def tokens(self) -> int:
        return len(self.out)

    def describe(self) -> dict:
        return {"rid": self.rid, "spec": self.spec, "family": self.family,
                "pos": self.pos, "prompt_len": len(self.prompt),
                "tokens": len(self.out), "rows": len(self.rows),
                "bytes": sum(r.nbytes for r in self.rows)}
