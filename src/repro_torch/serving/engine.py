"""ServeEngine: the fixed-batch continuous-batching decode engine
(``repro.serving.engine``).

One engine serves one ``QuantSpec`` (baked into its cfg) on one device.
With a kernel impl (KERNEL_IMPLS) every dense weight is planned once at
construction (quantize -> row permutation -> digit planes -> occupancy
mask -> block schedule) and each of the seven projections per block runs
a Hopper bw_gemm kernel at every step.  Each step feeds every slot one
token -- prompt tokens are teacher-forced through the same decode step --
and greedily samples the next.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.engine.spec import QuantSpec
from repro_torch.models.api import get_api

from .metrics import dist
from .request import ServeRequest
from .scheduler import Scheduler
from .slots import SlotAllocator

__all__ = ["ServeEngine", "KERNEL_IMPLS"]

# engines that serve from pre-planned weights through the port's kernels
KERNEL_IMPLS = ("pallas", "pallas_fused", "pallas_sparse",
                "pallas_pipelined")


class ServeEngine:
    """Fixed-batch continuous-batching engine over the decode state.

    quant: a QuantSpec, or None to defer to ``cfg.quant_spec()``.
    params: a param tree in the port's layout (e.g. from
    ``repro_torch.convert.params_from_numpy``) on ``device``; None draws
    random params from ``torch.Generator`` seeded with ``seed``.  The tree
    is not mutated: the engine plans into its own copy.
    device: where the engine runs; None means "cuda", which raises without
    a card (pass device="cpu" to run on the CPU).
    """

    def __init__(self, cfg, batch: int, max_len: int, seed: int = 0,
                 quant: Optional[QuantSpec] = None,
                 on_too_long: str = "error", *, params=None, device=None):
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
        self._kernel_path = spec is not None and spec.impl in KERNEL_IMPLS
        self.plan_density = None
        self.plan_stats = None
        if self._kernel_path:
            from repro_torch.kernels import ops
            self.params, planned = ops.plan_params(self.params, spec)
            self.plan_density = ops.plan_tree_density(self.params)
            self.plan_stats = {"planned_weights": planned,
                               "plane_block_density": self.plan_density}
        self.slots = SlotAllocator(batch, max_len)
        self.steps = 0

    @property
    def active(self) -> int:
        return self.slots.active

    def has_work(self, scheduler: Optional[Scheduler] = None) -> bool:
        return self.slots.active > 0 or \
            (scheduler is not None and scheduler.queue_depth > 0)

    def admit_from(self, scheduler: Scheduler, now: float = 0.0) -> int:
        """Fill free slots from the scheduler (per its admission policy);
        returns the number of requests admitted."""
        admitted = 0
        for slot in self.slots.free_slots():
            req = scheduler.pop(now)
            if req is None:
                break
            self.slots.bind(slot, req, now)
            admitted += 1
        return admitted

    @torch.no_grad()
    def step(self, now: float = 0.0) -> List[ServeRequest]:
        """One batched decode step with greedy sampling; returns requests
        finished this step."""
        tokens = torch.as_tensor(self.slots.cur, device=self.device)
        pos = torch.as_tensor(self.slots.pos, device=self.device)
        logits, self.state = self.api.decode_step(self.params, tokens, pos,
                                                  self.state, self.cfg)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        self.steps += 1
        return self.slots.advance(nxt[:, None].cpu().numpy(), now)

    def run(self, requests: List[ServeRequest], policy: str = "fcfs") -> dict:
        """Serve ``requests`` to completion: admit into free slots per
        ``policy``, step, repeat."""
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
        gen = sum(len(r.out) for r in done)
        return {"requests": len(done), "generated_tokens": gen,
                "engine_steps": self.steps, "wall_s": dt,
                "tok_per_s": gen / max(dt, 1e-9),
                "quant_spec": str(self.spec) if self.spec else None,
                "quant_impl": self.spec.impl if self.spec else None,
                "rejected": len(sched.rejected),
                "admission_policy": sched.policy.name,
                "device": str(self.device),
                "ttft": dist(r.ttft for r in done),
                "tpot": dist(r.tpot for r in done)}
