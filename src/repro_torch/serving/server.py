"""AsyncServer: continuous-batching serving across QuantSpec-tiered workers
(``repro.serving.server``).

One ``TierWorker`` per tier: a ``ServeEngine`` baked with that tier's
QuantSpec (e.g. a ``planes=2`` fast tier next to a ``planes=4`` /
``pallas_fused`` quality tier), fed by its own admission ``Scheduler``.
The server routes each arriving request to a tier through a ``TierRouter``
policy driven by GemmEngine.cost / core.hwmodel service-time estimates,
then drives the workers in one of two modes:

    virtual  (default) -- deterministic discrete-event simulation: the
        clock advances by per-tier estimated step times, arrivals are
        released at their (virtual) timestamps.  Offline load tests and CI
        run this mode: same seed -> same schedule -> same metrics.
    realtime -- one thread per tier worker plus an arrival feeder; step
        times are measured (EWMA) and fed back into the router's
        estimates.  Request outputs are identical to virtual mode for a
        given routing, because each worker admits in FCFS submission order
        and greedy decode is deterministic.

Per-request outputs are bit-identical to a standalone ``ServeEngine`` run
under the same QuantSpec: a tier worker *is* a standalone engine, and a
decode row depends only on its own slot state for the dense families.

Every worker serves from one float param tree (``params=``: a converted
reference tree, or one drawn once from ``seed``), which no worker
mutates: each engine plans into its own copy.  In realtime mode each
engine runs one decode step on a scratch state before its first clock
starts (once an engine: a later run does not repeat it),
so building or loading the kernels and warming the device's libraries is
not read as a missed heartbeat.  The worker threads issue onto the
device's default stream.

Fault tolerance
---------------
Workers can die: an injected ``repro_torch.chaos`` fault, an engine exception,
or a ``WorkerWatchdog`` heartbeat timeout (no completed step for
``miss_limit`` x the worker's EWMA step time, on whichever clock the mode
runs).  A dead worker's queued *and* in-flight requests are drained back
to the router: slot/KV state is discarded, the request restarts from its
prompt on a surviving tier (``ServeRequest.requeue``), bounded by
``retry_budget`` with exponential backoff.  Every admitted request still
finishes exactly once — either DONE on some tier or REJECTED with its
``error`` explaining the exhausted budget.  Injected faults and watchdog
verdicts are part of normal operation; any *other* worker exception is
re-raised as ``WorkerDied`` when ``run`` returns, so an engine bug can
never die silently in a worker thread.

With no chaos plan installed (``REPRO_CHAOS`` unset) the fault machinery
costs one ``is not None`` branch per scheduling round and injects zero
events.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.chaos import (FaultPlan, InjectedFault, ServerCrashed,
                         WorkerKilled, active_plan)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.calibrate import get_calibrator
from repro_torch.train.fault import WorkerWatchdog

from .engine import ServeEngine
from .journal import RequestJournal
from .metrics import ServerMetrics, emit_request_trace
from .request import REJECTED, ServeRequest
from .scheduler import Scheduler
from .tiers import (BrownoutPolicy, Tier, TierRouter, default_tiers,
                    estimate_step_time)

__all__ = ["TierWorker", "AsyncServer", "WorkerDied", "FAILOVER_MODES"]

#: how a dying worker's in-flight requests migrate:
#:   restore -- drain with decode snapshots; a same-QuantSpec tier
#:              restores the slot bit-exactly, any other tier keeps the
#:              committed tokens and re-prefills prompt + output
#:   restart -- the lossy path: partial output is discarded and the
#:              request regenerates from its prompt
FAILOVER_MODES = ("restore", "restart")

_REG = obs_metrics.get_registry()
_M_WORKER_DEATHS = _REG.counter("repro_serve_worker_deaths_total")
_M_RETRIES = _REG.counter("repro_serve_retries_total")
_M_MIGRATIONS = _REG.counter("repro_serve_migrations_total")
_M_LOST = _REG.counter("repro_serve_requests_lost_total")


class WorkerDied(RuntimeError):
    """A tier worker stopped: watchdog verdict while serving, or the
    wrapper ``AsyncServer.run`` re-raises for unexpected worker
    exceptions (anything that is not an injected chaos fault)."""


class TierWorker:
    """One tier's engine + admission queue (thread-safe submission)."""

    def __init__(self, tier: Tier, cfg, max_len: int, seed: int = 0,
                 admission: str = "fcfs", on_too_long: str = "reject",
                 audit: bool = False, *, params=None, device=None):
        self.tier = tier
        self.engine = ServeEngine(cfg, tier.batch, max_len, seed=seed,
                                  quant=tier.spec, on_too_long=on_too_long,
                                  audit=audit, params=params, device=device)
        self.scheduler = Scheduler(admission, max_len=max_len,
                                   on_too_long=on_too_long)
        self.finished: List[ServeRequest] = []
        self.next_free = 0.0        # virtual-mode: when this worker can step
        self.step_time = 1e-9       # seconds per engine step (est. or EWMA)
        self.cv = threading.Condition()
        self.alive = True
        self.error: Optional[BaseException] = None
        self.pumps = 0              # completed steps this run (chaos @sN)
        self.slow_factor = 1.0      # chaos "slow" fault multiplier
        self.death_done = True      # death drain completed (realtime sync)
        self.measured = False       # a clean realtime step was timed

    def revive(self) -> None:
        """Reset liveness for a fresh ``run`` (the engine, its plans of
        the shared param tree and its decode state are reused)."""
        self.alive = True
        self.error = None
        self.pumps = 0
        self.slow_factor = 1.0
        self.next_free = 0.0
        self.death_done = True
        self.measured = False
        self.finished.clear()

    def submit(self, req: ServeRequest, now: float) -> bool:
        """Enqueue for admission.  False when the scheduler rejected the
        request (it is then terminal) or when this worker is no longer
        alive (the request is untouched; the caller must re-route —
        a dead worker's queue is never pumped or drained again)."""
        with self.cv:
            if not self.alive:
                return False
            ok = self.scheduler.submit(req, now)
            self.cv.notify()
        return ok

    def has_work(self) -> bool:
        with self.cv:
            return self.engine.has_work(self.scheduler)

    def loads(self):
        """(backlog tokens, slots) for the router's queueing estimate."""
        with self.cv:
            return (self.scheduler.queued_tokens()
                    + self.engine.slots.backlog_tokens(), self.tier.batch)

    def pump(self, now: float, t_end: Optional[float] = None
             ) -> List[ServeRequest]:
        """Admit + one engine step.  ``t_end`` is the clock value at which
        the step's tokens exist (virtual mode passes now + step_time)."""
        with self.cv:
            self.engine.admit_from(self.scheduler, now)
        finished = self.engine.step(now=now if t_end is None else t_end)
        if finished:
            with self.cv:
                self.finished.extend(finished)
        return finished

    def drain(self, snapshots: bool = False) -> List[ServeRequest]:
        """Evict in-flight requests and drain the queue (death path).
        Order is deterministic: slot order, then submission order —
        which is also the order they re-enter the router.

        ``snapshots=True`` (restore-mode failover): every in-flight
        request with at least one committed token gets a decode snapshot
        attached before eviction, so a surviving same-spec tier can
        restore it bit-exactly.  A request still in PREFILL (zero
        committed tokens) takes the plain restart path — there is
        nothing worth snapshotting and an empty snapshot artifact would
        only be dead weight.  A migrated request still teacher-forcing
        its re-prefill (committed tokens but cursor mid-prefix) is *not*
        snapshotted either: its pos/cursor violate the restore
        invariant, so it keeps its tokens via re-prefill on the next
        tier instead."""
        with self.cv:
            if snapshots:
                for slot, req in self.engine.slots.bound():
                    if req.out and not req.terminal and \
                            self.engine.slots.decode_ready(slot):
                        try:
                            req.snapshot = self.engine.snapshot_slot(slot)
                        except Exception:   # noqa: BLE001 — re-prefill
                            # still preserves the tokens; a failed
                            # snapshot must not escalate the death
                            req.snapshot = None
            return (self.engine.slots.evict_all()
                    + self.scheduler.drain())


class AsyncServer:
    """Routes a request load across QuantSpec-tiered ServeEngine workers."""

    def __init__(self, cfg, tiers: Optional[Sequence[Tier]] = None,
                 max_len: int = 32, seed: int = 0, admission: str = "fcfs",
                 router: str = "slo", on_too_long: str = "reject",
                 design: str = "tpu", step_time_scale: float = 1.0,
                 audit: bool = False, retry_budget: int = 2,
                 retry_backoff: float = 0.0,
                 chaos: Optional[object] = None,
                 brownout: Optional[BrownoutPolicy] = None,
                 watchdog_miss_limit: int = 3,
                 failover: str = "restore",
                 journal: Optional[object] = None, *, params=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if failover not in FAILOVER_MODES:
            raise ValueError(f"failover must be one of {FAILOVER_MODES}, "
                             f"got {failover!r}")
        self.failover = failover
        if isinstance(journal, str):
            journal = RequestJournal(journal)
        self._journal: Optional[RequestJournal] = journal
        self.tiers = tuple(tiers if tiers is not None else default_tiers(2))
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got "
                             f"{retry_budget}")
        if retry_backoff < 0:
            raise ValueError(f"retry_backoff must be >= 0, got "
                             f"{retry_backoff}")
        if params is None:
            from repro_torch.models.api import get_api
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = get_api(cfg).init(gen, cfg, self.device)
        self.params = params
        self.workers: Dict[str, TierWorker] = {
            t.name: TierWorker(t, cfg, max_len, seed=seed,
                               admission=admission, on_too_long=on_too_long,
                               audit=audit, params=params,
                               device=self.device)
            for t in self.tiers}
        per_step = {}
        for t in self.tiers:
            # schedule-aware estimate: each worker just planned its
            # weights, so its measured plane-block density prices the
            # digit-plane sparsity the kernels actually elide
            density = self.workers[t.name].engine.plan_density
            est = max(estimate_step_time(cfg, t.batch, t.spec, design,
                                         density=density, shards=t.shards)
                      * step_time_scale, 1e-9)
            per_step[t.name] = est
            self.workers[t.name].step_time = est
        # cost-model predictions at init time: the realtime worker loop
        # pairs these with measured step times for CostCalibrator
        self._initial_per_step = dict(per_step)
        self.router = TierRouter(self.tiers, per_step, router,
                                 brownout=brownout)
        self.metrics = ServerMetrics()
        self.retry_budget = retry_budget
        self.retry_backoff = retry_backoff
        if isinstance(chaos, str):
            chaos = FaultPlan.parse(chaos)
        self._chaos = chaos           # explicit plan (None -> env-installed)
        self._plan: Optional[FaultPlan] = None   # resolved per run
        self._watchdog = WorkerWatchdog(names,
                                        miss_limit=watchdog_miss_limit)
        self._lock = threading.Lock()
        self._fail = {"worker_deaths": 0, "retries": 0, "migrations": 0,
                      "lost": 0}
        self._brown = {"transitions": 0, "max_level": 0}
        self._retries: List[tuple] = []   # heap of (due, seq, request)
        self._rseq = 0

    @property
    def chaos(self) -> Optional[FaultPlan]:
        """The explicit fault plan (None = whatever plan is installed
        process-wide via ``repro_torch.chaos.install`` / ``REPRO_CHAOS``)."""
        return self._chaos

    @chaos.setter
    def chaos(self, plan) -> None:
        if isinstance(plan, str):
            plan = FaultPlan.parse(plan)
        self._chaos = plan

    @property
    def journal(self) -> Optional[RequestJournal]:
        """The write-ahead request journal (None = not journaling)."""
        return self._journal

    @journal.setter
    def journal(self, j) -> None:
        if isinstance(j, str):
            j = RequestJournal(j)
        self._journal = j

    # -- routing -------------------------------------------------------------

    def _route_and_submit(self, req: ServeRequest, now: float) -> bool:
        while True:
            with self._lock:
                live = {n: w for n, w in self.workers.items() if w.alive}
                if not live:
                    self._reject_lost(req, now, "no live tiers remain")
                    return False
                loads = {n: w.loads() for n, w in live.items()}
                tier = self.router.route(req, now, loads)
            if self.workers[tier.name].submit(req, now):
                if self._journal is not None:
                    self._journal.admit(req, now)
                return True
            if req.terminal:
                return False    # the scheduler rejected it (too long)
            # the tier died between route and submit (submit refuses on a
            # dead worker, whose queue would never drain) — route again

    def _sample(self, now: float = 0.0) -> None:
        live = {n: w for n, w in self.workers.items() if w.alive}
        self.metrics.sample(
            sum(w.scheduler.queue_depth for w in live.values()),
            {n: w.engine.slots.occupancy for n, w in live.items()})
        if self.router.brownout is not None and live:
            backlog = sum(w.loads()[0] for w in live.values())
            slots = sum(w.tier.batch for w in live.values())
            prev = self.router.brownout_level
            level = self.router.note_pressure(backlog / max(slots, 1), now)
            if level != prev:
                self._brown["transitions"] += 1
                self._brown["max_level"] = max(self._brown["max_level"],
                                               level)

    # -- failover ------------------------------------------------------------

    def _reject_lost(self, req: ServeRequest, now: float, why: str) -> None:
        if req.terminal:
            return
        req.requeue(now)     # lost means lost: tokens + snapshot discarded
        req.error = why
        req.to(REJECTED, now)
        self._fail["lost"] += 1
        _M_LOST.inc()
        if self._journal is not None:
            self._journal.drop(req, why, now)

    def _requeue_or_reject(self, req: ServeRequest, now: float,
                           dead_tier: str) -> None:
        """One drained victim of a worker death: migrate to a surviving
        tier (keeping committed tokens + snapshot in restore mode,
        restarting from the prompt in restart mode), or reject when the
        retry budget is spent."""
        if req.terminal:
            return
        if req.retries >= self.retry_budget:
            self._reject_lost(
                req, now, f"retry budget ({self.retry_budget}) exhausted "
                          f"after tier {dead_tier!r} died")
            return
        req.requeue(now, keep_tokens=self.failover == "restore")
        if self._journal is not None and self.failover != "restore":
            self._journal.retract(req, now)
        req.retries += 1
        req.migrations += 1
        self._fail["retries"] += 1
        self._fail["migrations"] += 1
        _M_RETRIES.inc()
        _M_MIGRATIONS.inc()
        delay = (0.0 if self.retry_backoff == 0.0
                 else self.retry_backoff * 2.0 ** (req.retries - 1))
        self._rseq += 1
        heapq.heappush(self._retries, (now + delay, self._rseq, req))

    def _on_worker_death(self, worker: TierWorker, now: float,
                         exc: BaseException) -> None:
        """Declare ``worker`` DEAD and hand its requests back to the
        router.  Idempotent; safe from worker threads."""
        with self._lock:
            if not worker.alive and worker.death_done:
                return
            worker.alive = False
            worker.death_done = False
            worker.error = worker.error if worker.error is not None else exc
            self._fail["worker_deaths"] += 1
            _M_WORKER_DEATHS.labels(tier=worker.tier.name).inc()
            if obs_trace.enabled():
                obs_trace.instant("serve.worker_death", cat="serve",
                                  tier=worker.tier.name,
                                  error=str(worker.error))
            self.router.mark_dead(worker.tier.name)
            if self._journal is not None:
                self._journal.death(worker.tier.name, now)
            for req in worker.drain(snapshots=self.failover == "restore"):
                self._requeue_or_reject(req, now, worker.tier.name)
            worker.death_done = True

    def _strand(self, pending: Sequence[ServeRequest], now: float) -> None:
        """No live tier remains: everything still owed is lost."""
        while self._retries:
            _, _, req = heapq.heappop(self._retries)
            self._reject_lost(req, now, "no live tiers remain")
        for req in pending:
            self._reject_lost(req, max(now, req.arrival),
                              "no live tiers remain")

    def _apply_worker_faults(self, worker: TierWorker, now: float) -> bool:
        """Fire due chaos faults for one worker; returns True when it was
        killed (the caller must not pump it)."""
        for f in self._plan.poll("serve.worker", target=worker.tier.name,
                                 now=now, step=worker.pumps):
            if f.kind == "kill":
                self._on_worker_death(worker, now, WorkerKilled(
                    f"injected kill of tier {worker.tier.name!r}"))
                return True
            if f.kind == "stall":
                worker.next_free = max(worker.next_free, now + f.duration)
            elif f.kind == "slow":
                worker.slow_factor = max(float(f.factor), 1.0)
        return False

    def _maybe_crash(self, now: float) -> None:
        """Poll the whole-process crash fault (site ``serve.server``).
        ``crash_server`` is the ``kill -9`` analogue: the run raises
        immediately — no drain, no failover — and recovery happens on
        the next process via the request journal (``--resume``)."""
        step = sum(w.pumps for w in self.workers.values())
        for f in self._plan.poll("serve.server", now=now, step=step):
            if f.kind == "crash_server":
                raise ServerCrashed(
                    f"injected server crash at t={now:.6g} (step {step})"
                    f"; restart with --resume to replay the journal")

    def _journal_sync(self, worker: TierWorker,
                      finished: Sequence[ServeRequest],
                      now: float) -> None:
        """Write-ahead commit after one pump: append every token the
        step committed (and completion records) before the clock moves
        on — a crash after this point can always be replayed up to and
        including this step's tokens."""
        with worker.cv:
            reqs = [r for _, r in worker.engine.slots.bound()]
        for req in reqs:
            self._journal.commit(req, now)
        for req in finished:
            self._journal.commit(req, now)

    def revive_tier(self, name: str, now: float = 0.0) -> None:
        """Bring a dead tier back mid-run (or between runs).

        A returning tier must *re-measure*, not trust pre-death state:
        the watchdog's stale EWMA is forgotten (else the first slow step
        after a long gap reads as an instant heartbeat miss), and the
        worker's step-time estimate and the router's cost entry are reset
        to the init-time cost-model prediction, with ``measured`` cleared
        so the first clean realtime step re-feeds ``obs.CostCalibrator``
        exactly like a fresh start."""
        if name not in self.workers:
            raise ValueError(f"unknown tier {name!r}")
        w = self.workers[name]
        with self._lock:
            if w.alive:
                return
            w.alive = True
            w.error = None
            w.slow_factor = 1.0
            w.next_free = now
            w.death_done = True
            w.measured = False
            w.step_time = self._initial_per_step[name]
            self._watchdog.forget(name)
            self.router.per_step[name] = self._initial_per_step[name]
            self.router.revive(name)
        if obs_trace.enabled():
            obs_trace.instant("serve.worker_revive", cat="serve",
                              tier=name)

    # -- drive modes ---------------------------------------------------------

    def run(self, requests: Sequence[ServeRequest], realtime: bool = False,
            time_scale: float = 1.0) -> dict:
        """Serve the load to completion; returns the metrics summary.

        Re-runnable: each call starts a fresh clock, metrics collector,
        and fault schedule (worker engines and their plans are
        reused; dead workers are revived; an installed chaos plan is
        re-armed so repeats are deterministic).
        """
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        steps_before = {n: w.engine.steps for n, w in self.workers.items()}
        ckpt_before = {n: dict(w.engine.ckpt_stats)
                       for n, w in self.workers.items()}
        for n, w in self.workers.items():
            if not w.alive:
                # a tier that died last run must re-measure: reset its
                # cost state to the init-time prediction (a pre-death
                # EWMA would mis-route until a clean step lands)
                w.step_time = self._initial_per_step[n]
                self.router.per_step[n] = self._initial_per_step[n]
            w.revive()
            self._watchdog.forget(n)
        self.router.revive_all()
        self._plan = self._chaos if self._chaos is not None \
            else active_plan()
        if self._plan is not None:
            self._plan.reset()
        self._fail = {"worker_deaths": 0, "retries": 0, "migrations": 0,
                      "lost": 0}
        self._brown = {"transitions": 0, "max_level": 0}
        self._retries = []
        self._rseq = 0
        self.metrics = ServerMetrics()
        t_host = time.perf_counter()
        sim_s = (self._run_realtime(reqs, time_scale) if realtime
                 else self._run_virtual(reqs))
        wall_s = time.perf_counter() - t_host
        self.metrics.engine_steps = sum(
            w.engine.steps - steps_before[n]
            for n, w in self.workers.items())
        fatal = [(n, w.error) for n, w in self.workers.items()
                 if w.error is not None
                 and not isinstance(w.error, (InjectedFault, WorkerDied))]
        if fatal:
            name, err = fatal[0]
            raise WorkerDied(f"tier worker {name!r} died unexpectedly: "
                             f"{err!r}") from err
        if obs_trace.enabled():
            for r in reqs:
                emit_request_trace(r)
        stats = self.metrics.summary(reqs, wall_s, sim_s)
        stats["mode"] = "realtime" if realtime else "virtual"
        stats["router_policy"] = self.router.policy
        stats["tiers"] = {t.name: (str(t.spec) if t.spec else None)
                          for t in self.tiers}
        stats["per_step_s"] = {n: round(v, 9)
                               for n, v in self.router.per_step.items()}
        for key in ("snapshots", "restored", "reprefilled",
                    "tokens_recovered", "tokens_reprefilled"):
            self._fail[key] = sum(
                w.engine.ckpt_stats[key] - ckpt_before[n][key]
                for n, w in self.workers.items())
        stats["failover"] = dict(self._fail, mode=self.failover)
        stats["brownout"] = dict(self._brown)
        stats["chaos"] = (self._plan.summary() if self._plan is not None
                          else None)
        return stats

    def _run_virtual(self, reqs: List[ServeRequest]) -> float:
        """Discrete-event simulation on the estimated step times."""
        now, i, eps = 0.0, 0, 1e-12
        while True:
            while i < len(reqs) and reqs[i].arrival <= now + eps:
                self._route_and_submit(reqs[i], now)
                i += 1
            while self._retries and self._retries[0][0] <= now + eps:
                _, _, req = heapq.heappop(self._retries)
                self._route_and_submit(req, now)
            live = [w for w in self.workers.values() if w.alive]
            if not live:
                self._strand(reqs[i:], now)
                return now
            if self._plan is not None:
                self._maybe_crash(now)
                for w in live:
                    if w.alive:
                        self._apply_worker_faults(w, now)
                live = [w for w in self.workers.values() if w.alive]
                if not live:
                    self._strand(reqs[i:], now)
                    return now
                if self._retries and self._retries[0][0] <= now + eps:
                    continue      # a kill requeued work due immediately
            busy = [w for w in live if w.has_work()]
            if not busy:
                times = []
                if i < len(reqs):
                    times.append(reqs[i].arrival)
                if self._retries:
                    times.append(self._retries[0][0])
                if not times:
                    return now
                now = max(min(times), now)   # idle: jump to the next event
                continue
            ready = [w for w in busy if w.next_free <= now + eps]
            if not ready:
                times = [w.next_free for w in busy]
                if i < len(reqs):
                    times.append(reqs[i].arrival)
                if self._retries:
                    times.append(self._retries[0][0])
                # a stalled worker's heartbeat deadline is an event too:
                # that is when the watchdog declares it dead
                times += [self._watchdog.deadline(w.tier.name)
                          for w in busy]
                if self._plan is not None:
                    times += [f.at for f in self._plan.pending()
                              if f.at is not None and f.at > now + eps]
                # clamp: a watchdog deadline can already be in the past
                # (a long-idle worker that just received work and a stall
                # in the same round) — the clock must never run backwards;
                # an overdue deadline is simply handled at the current now
                now = max(min(times), now)
                for w in busy:
                    if w.alive and w.next_free > now + eps and \
                            self._watchdog.overdue(w.tier.name, now):
                        self._on_worker_death(w, now, WorkerDied(
                            f"tier {w.tier.name!r} missed its heartbeat "
                            f"deadline"))
                continue
            for w in ready:               # deterministic: tier order
                if not w.alive:
                    continue
                step_t = w.step_time * w.slow_factor
                t_end = now + step_t
                try:
                    fin = w.pump(now, t_end=t_end)
                except Exception as e:    # noqa: BLE001 — failover seam
                    self._on_worker_death(w, now, e)
                    continue
                w.pumps += 1
                w.next_free = t_end
                if self._journal is not None:
                    self._journal_sync(w, fin, t_end)
                self._watchdog.beat(w.tier.name, t_end, step_t)
            self._sample(now)

    def _run_realtime(self, reqs: List[ServeRequest],
                      time_scale: float) -> float:
        """Threaded mode: one thread per tier worker, arrivals replayed on
        the wall clock stretched by ``time_scale``.  The clock handed to
        workers and lifecycle stamps is mapped back into the *load's* time
        domain (wall / time_scale), so TTFT/latency/deadline comparisons
        stay consistent with the unscaled arrival and deadline fields."""
        if time_scale <= 0:
            raise ValueError(f"time_scale must be positive, got "
                             f"{time_scale}")
        for w in self.workers.values():
            w.engine.warm()
        t0 = time.perf_counter()

        def clock() -> float:
            return (time.perf_counter() - t0) / time_scale

        stop = threading.Event()
        threads = [threading.Thread(
            target=self._worker_main, args=(w, clock, stop, time_scale),
            daemon=True) for w in self.workers.values()]
        for t in threads:
            t.start()
        try:
            for req in reqs:
                wait = (req.arrival - clock()) * time_scale
                if wait > 0:
                    time.sleep(wait)
                self._route_and_submit(req, clock())
            while True:
                now = clock()
                if self._plan is not None:
                    self._maybe_crash(now)
                self._release_due_retries(now)
                live = [w for w in self.workers.values() if w.alive]
                # a dying worker drains on its own thread; wait for it
                unsettled = any(not w.alive and not w.death_done
                                for w in self.workers.values())
                if not live:
                    if unsettled:
                        time.sleep(0.005)
                        continue
                    with self._lock:
                        self._strand([], now)
                    break
                busy = any(w.has_work() for w in live)
                with self._lock:
                    pending = bool(self._retries)
                if not busy and not pending and not unsettled:
                    break
                for w in live:
                    if w.has_work() and \
                            self._watchdog.overdue(w.tier.name, now):
                        # _lock serializes with _on_worker_death: either
                        # the worker's thread already declared the death
                        # (alive is False -> skip) or it has not, in
                        # which case clearing death_done arms the drain
                        # guard so the externally-declared death still
                        # drains when its thread picks the poison up
                        with self._lock:
                            if not w.alive:
                                continue
                            with w.cv:    # poison; its thread drains
                                w.alive = False
                                w.death_done = False
                                w.error = WorkerDied(
                                    f"tier {w.tier.name!r} missed its "
                                    f"heartbeat deadline")
                                w.cv.notify_all()
                self._sample(now)
                time.sleep(0.01)
        finally:
            stop.set()
            for w in self.workers.values():
                with w.cv:
                    w.cv.notify_all()
            for t in threads:
                t.join()
        return clock()

    def _release_due_retries(self, now: float) -> None:
        while True:
            with self._lock:
                if not self._retries or self._retries[0][0] > now + 1e-12:
                    return
                _, _, req = heapq.heappop(self._retries)
            self._route_and_submit(req, now)

    def _worker_main(self, worker: TierWorker, clock, stop,
                     time_scale: float = 1.0) -> None:
        while True:
            with worker.cv:
                while worker.alive and \
                        not worker.engine.has_work(worker.scheduler):
                    if stop.is_set():
                        return
                    worker.cv.wait(0.05)
            if not worker.alive:      # poisoned by the watchdog monitor
                self._on_worker_death(
                    worker, clock(), worker.error if worker.error
                    is not None else WorkerDied(
                        f"tier {worker.tier.name!r} stopped"))
                return
            if self._plan is not None:
                now = clock()
                killed = False
                for f in self._plan.poll("serve.worker",
                                         target=worker.tier.name,
                                         now=now, step=worker.pumps):
                    if f.kind == "kill":
                        self._on_worker_death(worker, now, WorkerKilled(
                            f"injected kill of tier "
                            f"{worker.tier.name!r}"))
                        killed = True
                        break
                    if f.kind == "stall":
                        time.sleep(f.duration * time_scale)
                    elif f.kind == "slow":
                        worker.slow_factor = max(float(f.factor), 1.0)
                if killed:
                    return
            t_step = clock()
            try:
                fin = worker.pump(t_step)
            except Exception as e:        # noqa: BLE001 — never die silent
                self._on_worker_death(worker, clock(), e)
                return
            worker.pumps += 1
            if self._journal is not None:
                self._journal_sync(worker, fin, clock())
            dt = max(clock() - t_step, 1e-9)
            if worker.slow_factor > 1.0:  # emulate a slowed device
                time.sleep(dt * (worker.slow_factor - 1.0) * time_scale)
                dt *= worker.slow_factor
            # EWMA of measured step time feeds the router's SLO estimates
            worker.step_time = dt if not worker.measured else \
                0.8 * worker.step_time + 0.2 * dt
            if not worker.measured and worker.tier.spec is not None:
                # first clean measurement vs the cost-model estimate the
                # router started from -> calibration drift sample (a
                # revived tier re-enters here: revive_tier cleared
                # ``measured`` so it re-feeds the calibrator too)
                get_calibrator().record(
                    worker.tier.spec.impl,
                    self._initial_per_step[worker.tier.name], dt,
                    shape=None, source="realtime")
            worker.measured = True
            self.router.per_step[worker.tier.name] = worker.step_time
            self._watchdog.beat(worker.tier.name, clock(), dt)
