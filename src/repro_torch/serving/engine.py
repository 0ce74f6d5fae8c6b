"""ServeEngine: the fixed-batch continuous-batching decode engine
(``repro.serving.engine``).

One engine serves one ``QuantSpec`` (baked into its cfg) on one device.
With a kernel impl (KERNEL_IMPLS) every dense weight is planned once at
construction (quantize -> row permutation -> digit planes -> occupancy
mask -> block schedule) and each planned projection (seven a transformer
block, eight an RWKV block, nine a hybrid block, and an untied head)
runs a Hopper bw_gemm kernel at every step.  Each step feeds every slot one
token -- prompt tokens are teacher-forced through the same decode step --
and greedily samples the next.

The engine exposes the stepping surface the async server drives
(``admit_from`` / ``step`` / ``has_work``) and the checkpoint seam of
restore-mode failover (``snapshot_slot`` / ``restorable`` /
``restore_slot``), and keeps the blocking ``run(requests)`` loop.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.engine.spec import QuantSpec
from repro_torch.models.api import get_api
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .ckpt import DecodeSnapshot, SnapshotMismatch
from .metrics import dist, emit_request_trace
from .request import QUEUED, ServeRequest
from .scheduler import Scheduler
from .slots import SlotAllocator

__all__ = ["ServeEngine", "KERNEL_IMPLS", "RESET_STATE_FAMILIES",
           "state_leaves"]

_REG = obs_metrics.get_registry()
_M_STEPS = _REG.counter("repro_serve_engine_steps_total")
_M_SNAPSHOTS = _REG.counter("repro_serve_snapshots_total")
_M_RESTORES = _REG.counter("repro_serve_restores_total")
_M_TOK_RECOVERED = _REG.counter("repro_serve_tokens_recovered_total")

# engines that serve from pre-planned weights through the port's kernels
KERNEL_IMPLS = ("pallas", "pallas_fused", "pallas_sparse",
                "pallas_pipelined")

# Families whose decode state holds a recurrence (not only a
# position-masked cache): their per-slot state rows, every leaf of the
# tree, are re-initialized when a slot is reused.
RESET_STATE_FAMILIES = ("rwkv", "hybrid")


def _clone_tree(tree):
    """A copy of a decode-state tree of dicts at any depth
    (``jax.tree.map(jnp.copy, ...)``)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def state_leaves(state) -> List[torch.Tensor]:
    """The decode-state tree's leaves in the reference's order
    (``jax.tree.leaves``: dict keys sorted, lists in order)."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in state_leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in state_leaves(v)]
    return [state]


@torch.no_grad()
def _reset_state_row(state, state0, slot: int) -> None:
    """Restore one batch row (axis 1: leaves are [L, B, ...]) of every
    decode-state leaf to its initial value, in place."""
    for s, s0 in zip(state_leaves(state), state_leaves(state0)):
        if s.dim() >= 2:
            s[:, slot] = s0[:, slot]


class ServeEngine:
    """Fixed-batch continuous-batching engine over the decode state.

    quant: a QuantSpec, or None to defer to ``cfg.quant_spec()``.
    params: a param tree in the port's layout (e.g. from
    ``repro_torch.convert.params_from_numpy``) on ``device``; None draws
    random params from ``torch.Generator`` seeded with ``seed``.  The tree
    is not mutated: the engine plans into its own copy, so one tree can
    be handed to several engines.
    device: where the engine runs; None means "cuda", which raises without
    a card (pass device="cpu" to run on the CPU).
    audit: record the slot allocator's per-step audit events.
    """

    def __init__(self, cfg, batch: int, max_len: int, seed: int = 0,
                 quant: Optional[QuantSpec] = None,
                 on_too_long: str = "error", audit: bool = False, *,
                 params=None, device=None):
        self.device = resolve_device(device)
        if quant is not None and not isinstance(quant, QuantSpec):
            raise TypeError(f"quant must be a QuantSpec or None; got "
                            f"{type(quant).__name__}")
        spec = cfg.quant_spec() if quant is None else \
            (quant if quant.enabled else None)
        self.spec = spec
        cfg = cfg.replace(quant=spec)
        self.cfg = cfg
        self.api = get_api(cfg)
        self.batch = batch
        self.max_len = max_len
        self.on_too_long = on_too_long
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init(gen, cfg, self.device)
        self.params = params
        self.state = self.api.init_decode(cfg, batch, max_len, self.device)
        self._state0 = (_clone_tree(self.state)
                        if self.api.family in RESET_STATE_FAMILIES else None)
        self._kernel_path = spec is not None and spec.impl in KERNEL_IMPLS
        self.plan_density = None
        self.plan_stats = None
        if self._kernel_path:
            from repro_torch.kernels import ops
            self.params, planned = ops.plan_params(self.params, spec)
            self.plan_density = ops.plan_tree_density(self.params)
            self.plan_stats = {"planned_weights": planned,
                               "plane_block_density": self.plan_density,
                               "schedules_verified":
                                   ops.verification_enabled(),
                               **ops.plan_cache_stats()}
        self.slots = SlotAllocator(batch, max_len, audit=audit)
        self.steps = 0
        self.warmed = False
        # checkpoint/restore tallies (the async server folds the per-run
        # deltas into its failover stats)
        self.ckpt_stats = {"snapshots": 0, "restored": 0,
                           "reprefilled": 0, "tokens_recovered": 0,
                           "tokens_reprefilled": 0}

    # -- stepping surface (driven by the async server) -----------------------

    @property
    def active(self) -> int:
        return self.slots.active

    def has_work(self, scheduler: Optional[Scheduler] = None) -> bool:
        return self.slots.active > 0 or \
            (scheduler is not None and scheduler.queue_depth > 0)

    def admit_from(self, scheduler: Scheduler, now: float = 0.0) -> int:
        """Fill free slots from the scheduler (per its admission policy);
        returns the number of requests admitted.

        A request carrying a decode snapshot (restore-mode failover) is
        restored bit-exactly when the snapshot is compatible with this
        engine; otherwise, and for any request with committed tokens but
        no usable snapshot, it re-prefills prompt + committed output, so
        the tokens survive either way."""
        admitted = 0
        for slot in self.slots.free_slots():
            req = scheduler.pop(now)
            if req is None:
                break
            snap, req.snapshot = req.snapshot, None
            if snap is not None and self.restorable(snap) is None:
                try:
                    self.restore_slot(slot, req, snap, now)
                    admitted += 1
                    continue
                except (SnapshotMismatch, ValueError):
                    # a snapshot that fails mid-restore reads as
                    # "re-prefill": the request is already off the
                    # scheduler, and an exception here would read as the
                    # healthy destination tier dying
                    if self.slots.request_at(slot) is req:
                        self.slots.evict(slot)
                    if req.state != QUEUED:
                        req.requeue(now, keep_tokens=True)
                    if obs_trace.enabled():
                        obs_trace.instant("serve.restore_failed",
                                          cat="serve", rid=req.rid)
            rebind = self.slots.bind(slot, req, now)
            if rebind and self._state0 is not None:
                _reset_state_row(self.state, self._state0, slot)
            if req.out:
                # token-preserving re-prefill: committed tokens are
                # replayed by teacher forcing, never regenerated
                self.ckpt_stats["reprefilled"] += 1
                self.ckpt_stats["tokens_recovered"] += len(req.out)
                self.ckpt_stats["tokens_reprefilled"] += len(req.out)
                _M_RESTORES.labels(mode="cross_spec").inc()
                _M_TOK_RECOVERED.inc(len(req.out))
                if obs_trace.enabled():
                    obs_trace.instant("serve.restore", cat="serve",
                                      rid=req.rid, mode="cross_spec",
                                      tokens=len(req.out))
            admitted += 1
        return admitted

    # -- checkpoint/restore seam ---------------------------------------------

    def snapshot_slot(self, slot: int) -> DecodeSnapshot:
        """Capture everything ``slot`` owns as a ``DecodeSnapshot``: its
        decode-state rows ([L, 1, ...] of each leaf, copied to the host),
        the occupant's committed tokens, teacher-forcing cursor,
        next-step token and lifecycle stamps."""
        req = self.slots.request_at(slot)
        if req is None:
            raise ValueError(f"slot {slot} is not bound; nothing to "
                             f"snapshot")
        if not self.slots.decode_ready(slot):
            raise ValueError(
                f"slot {slot} (request {req.rid}) is still "
                f"teacher-forcing its prefix: pos "
                f"{int(self.slots.pos[slot])} violates the snapshot "
                f"invariant pos == len(prompt) + len(out) - 1; migrate "
                f"it via the token-preserving re-prefill path instead")
        rows = [(x[:, slot:slot + 1] if x.dim() >= 2 else x).cpu().clone()
                for x in state_leaves(self.state)]
        snap = DecodeSnapshot(
            rid=req.rid, spec=str(self.spec) if self.spec else None,
            family=self.api.family, max_len=self.max_len,
            pos=int(self.slots.pos[slot]),
            cursor=int(self.slots.cursor[slot]),
            cur=int(self.slots.cur[slot, 0]),
            prompt=list(req.prompt), out=list(req.out),
            rows=rows, arrival=req.arrival, admitted_at=req.admitted_at,
            first_token_at=req.first_token_at)
        self.ckpt_stats["snapshots"] += 1
        _M_SNAPSHOTS.inc()
        if obs_trace.enabled():
            obs_trace.instant("serve.snapshot", cat="serve", rid=req.rid,
                              pos=snap.pos, tokens=len(snap.out))
        return snap

    def restorable(self, snap: DecodeSnapshot) -> Optional[str]:
        """None when ``snap`` can be restored bit-exactly into this
        engine, else the reason it cannot (the caller then re-prefills)."""
        if not snap.out:
            return "no committed tokens to restore"
        if snap.pos != len(snap.prompt) + len(snap.out) - 1:
            return (f"position invariant violated: pos {snap.pos} != "
                    f"len(prompt) + len(out) - 1 = "
                    f"{len(snap.prompt) + len(snap.out) - 1}")
        spec = str(self.spec) if self.spec else None
        if snap.spec != spec:
            return f"spec mismatch: snapshot {snap.spec!r} vs {spec!r}"
        if snap.family != self.api.family:
            return (f"family mismatch: snapshot {snap.family!r} vs "
                    f"{self.api.family!r}")
        if snap.max_len != self.max_len:
            return (f"max_len mismatch: snapshot {snap.max_len} vs "
                    f"{self.max_len}")
        if snap.sampling != "greedy":
            return f"unsupported sampling state {snap.sampling!r}"
        leaves = state_leaves(self.state)
        if len(snap.rows) != len(leaves):
            return (f"state tree mismatch: snapshot has {len(snap.rows)} "
                    f"rows, engine has {len(leaves)} leaves")
        for i, (row, leaf) in enumerate(zip(snap.rows, leaves)):
            want = (tuple(leaf.shape) if leaf.dim() < 2
                    else (leaf.shape[0], 1) + tuple(leaf.shape[2:]))
            if tuple(row.shape) != want or row.dtype != leaf.dtype:
                return (f"state leaf {i} mismatch: snapshot row "
                        f"{tuple(row.shape)}/{row.dtype}, engine expects "
                        f"{want}/{leaf.dtype}")
        return None

    @torch.no_grad()
    def restore_slot(self, slot: int, req: ServeRequest,
                     snap: DecodeSnapshot, now: float = 0.0) -> None:
        """Write ``snap`` back into ``slot`` bit-exactly and resume
        ``req`` mid-decode (no re-prefill steps).  Raises
        ``SnapshotMismatch`` when the snapshot is incompatible."""
        why = self.restorable(snap)
        if why is not None:
            raise SnapshotMismatch(f"request {req.rid}: {why}")
        if req.rid != snap.rid:
            raise SnapshotMismatch(f"snapshot belongs to request "
                                   f"{snap.rid}, not {req.rid}")
        self.slots.bind_restored(slot, req, pos=snap.pos,
                                 cursor=snap.cursor, cur=snap.cur,
                                 now=now)
        for leaf, row in zip(state_leaves(self.state), snap.rows):
            if leaf.dim() >= 2:
                leaf[:, slot:slot + 1].copy_(row)
        self.ckpt_stats["restored"] += 1
        self.ckpt_stats["tokens_recovered"] += len(req.out)
        _M_RESTORES.labels(mode="same_spec").inc()
        _M_TOK_RECOVERED.inc(len(req.out))
        if obs_trace.enabled():
            obs_trace.instant("serve.restore", cat="serve", rid=req.rid,
                              mode="same_spec", pos=snap.pos,
                              tokens=len(req.out))

    @torch.no_grad()
    def step(self, now: float = 0.0) -> List[ServeRequest]:
        """One batched decode step with greedy sampling; returns requests
        finished this step."""
        if obs_trace.enabled():
            _M_STEPS.inc()
            sp = obs_trace.span("serve.decode_step", cat="serve",
                                active=self.slots.active,
                                impl=self.spec.impl if self.spec
                                else None)
        else:
            sp = obs_trace.NULL_SPAN
        with sp:
            tokens = torch.as_tensor(self.slots.cur, device=self.device)
            pos = torch.as_tensor(self.slots.pos, device=self.device)
            logits, self.state = self.api.decode_step(
                self.params, tokens, pos, self.state, self.cfg)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            self.steps += 1
            return self.slots.advance(nxt[:, None].cpu().numpy(), now)

    @torch.no_grad()
    def warm(self) -> None:
        """One decode step on a scratch decode state: builds or loads the
        kernels and warms the device's libraries without touching the
        slots, the decode state or ``steps``.  Once an engine: later
        calls return at once."""
        if self.warmed:
            return
        state = self.api.init_decode(self.cfg, self.batch, self.max_len,
                                     self.device)
        tokens = torch.zeros((self.batch, 1), dtype=torch.int32,
                             device=self.device)
        pos = torch.zeros((self.batch,), dtype=torch.int32,
                          device=self.device)
        logits, _ = self.api.decode_step(self.params, tokens, pos, state,
                                         self.cfg)
        logits[:, -1, :1].cpu()
        self.warmed = True

    # -- blocking loop -------------------------------------------------------

    def run(self, requests: List[ServeRequest], policy: str = "fcfs") -> dict:
        """Serve ``requests`` to completion: admit into free slots per
        ``policy``, step, repeat.  The stats have the reference's keys;
        times are not rounded."""
        sched = Scheduler(policy, max_len=self.max_len,
                          on_too_long=self.on_too_long)
        t0 = time.perf_counter()
        for req in requests:
            sched.submit(req, now=0.0)
        done: List[ServeRequest] = []
        while self.has_work(sched):
            now = time.perf_counter() - t0
            self.admit_from(sched, now)
            done.extend(self.step(now=time.perf_counter() - t0))
        dt = time.perf_counter() - t0
        if obs_trace.enabled():
            for r in done:
                emit_request_trace(r)
        gen = sum(len(r.out) for r in done)
        stats = {"requests": len(done), "generated_tokens": gen,
                 "engine_steps": self.steps, "wall_s": dt,
                 "tok_per_s": gen / max(dt, 1e-9),
                 "quant_spec": str(self.spec) if self.spec else None,
                 "quant_planes": self.spec.planes if self.spec else 0,
                 "quant_impl": self.spec.impl if self.spec else None,
                 "rejected": len(sched.rejected),
                 "admission_policy": sched.policy.name,
                 "ttft": dist(r.ttft for r in done),
                 "tpot": dist(r.tpot for r in done)}
        if self._kernel_path:
            from repro_torch.kernels import ops
            stats["plan_cache"] = ops.plan_cache_stats()
        return stats
