"""repro_torch.chaos — deterministic fault injection for the serving stack.

A ``FaultPlan`` is a seeded list of faults, each scheduled against either
a *clock* (``at`` seconds — the virtual simulation clock in the async
server's default mode, the scaled wall clock in realtime mode) or a
*step count* (``after_steps`` — the target worker's Nth pump), so a fault
schedule replays bit-identically under the virtual-time discrete-event
drive: same plan -> same kill point -> same failover trace.

Fault kinds and the sites that poll them:

    kind           site              effect
    -------------  ----------------  -------------------------------------
    kill           serve.worker      the tier worker dies (WorkerKilled);
                                     the server drains + re-routes its
                                     queued and in-flight requests
    stall          serve.worker      the worker freezes for ``duration``
                                     seconds (the step-time watchdog may
                                     then declare it DEAD)
    slow           serve.worker      the worker's step time is multiplied
                                     by ``factor`` from the fire point on
    crash_server   serve.server      the whole AsyncServer run raises
                                     ServerCrashed (a ``kill -9``: no
                                     drain/failover; recovery is the
                                     request journal's ``--resume``)
    drop_shard     parallel.shard    (parsed; the port has no sharded
                                     apply to raise ShardLost in yet)
    kernel_raise   kernel.dispatch   ``ops.planned_dense_apply`` raises
                                     InjectedFault at the dispatch seam
    corrupt_cache  autotune.load     the next ``AutotuneCache`` read sees
                                     a (seed-deterministically) corrupted
                                     payload -- exercises the fallback to
                                     the static block table

Zero-cost contract (same as ``repro_torch.obs``): with ``REPRO_CHAOS`` unset
and no plan installed, ``enabled()`` is a module-bool check — every
instrumented hot path pays one branch and allocates nothing, and a run
fires zero faults.  ``REPRO_CHAOS`` is read once at import: set it to a
plan spec string (see ``FaultPlan.parse``) to arm a process-wide plan,
e.g. ``REPRO_CHAOS="kill:fast@s3"`` (kill tier ``fast`` before its 4th
pump) or ``REPRO_CHAOS="kill:fast@0.01;slow:quality@0.02x3"``.
"""
from __future__ import annotations

import dataclasses
import os
import random
import re
import threading
from typing import List, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["ENV_CHAOS", "InjectedFault", "WorkerKilled", "ShardLost",
           "ServerCrashed", "Fault", "FaultPlan", "FAULT_KINDS",
           "FAULT_SITES", "enabled", "install", "uninstall", "active_plan",
           "plan_from_env", "maybe_raise", "corrupt_if_due"]

ENV_CHAOS = "REPRO_CHAOS"

_FALSY = ("", "0", "false", "off", "no", "none")


class InjectedFault(RuntimeError):
    """An error raised by the chaos layer (never by real code paths)."""


class WorkerKilled(InjectedFault):
    """A ``kill`` fault terminated a tier worker."""


class ShardLost(InjectedFault):
    """A ``drop_shard`` fault removed a mesh shard from a sharded apply."""


class ServerCrashed(InjectedFault):
    """A ``crash_server`` fault killed the whole serving process mid-run
    (the ``kill -9`` analogue): no drain, no failover — recovery happens
    on restart via the write-ahead request journal (``--resume``)."""


#: kind -> the site whose hook polls it
FAULT_SITES = {
    "kill": "serve.worker",
    "stall": "serve.worker",
    "slow": "serve.worker",
    "crash_server": "serve.server",
    "drop_shard": "parallel.shard",
    "kernel_raise": "kernel.dispatch",
    "corrupt_cache": "autotune.load",
}
FAULT_KINDS = tuple(FAULT_SITES)

_M_INJECTED = obs_metrics.get_registry().counter(
    "repro_chaos_faults_injected_total")


@dataclasses.dataclass
class Fault:
    """One scheduled fault.  ``at`` is a clock value in whatever domain
    the polling site passes (virtual seconds in the simulator, load-time
    seconds in realtime mode); ``after_steps`` counts the target worker's
    pumps.  A fault with neither fires the first time its site polls.
    Each fault fires at most once per arming (see ``FaultPlan.reset``)."""
    kind: str
    target: Optional[str] = None
    at: Optional[float] = None
    after_steps: Optional[int] = None
    duration: float = 0.0        # stall: seconds frozen
    factor: float = 1.0          # slow: step-time multiplier
    fired: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        if self.kind not in FAULT_SITES:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of "
                             f"{FAULT_KINDS}")

    @property
    def site(self) -> str:
        return FAULT_SITES[self.kind]

    def due(self, now: Optional[float], step: Optional[int]) -> bool:
        if self.at is None and self.after_steps is None:
            return True                       # fire on first poll
        if self.at is not None and now is not None and self.at <= now:
            return True
        return (self.after_steps is not None and step is not None
                and step >= self.after_steps)


# one ;-separated fault of the FaultPlan.parse grammar, anchored:
#   kind[:target][@when[xFACTOR][+DURATION]]
# The x/+ suffixes live inside the @ clause so targets may contain
# either character, and a scientific-notation when ("@1e+3") keeps its
# '+'; numbers are validated by the pattern, not by a blind float().
_NUM = r"(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?"
_SPEC_RE = re.compile(
    r"^(?P<kind>[A-Za-z_]\w*)"
    r"(?::(?P<target>[^@]+))?"
    rf"(?:@(?P<when>s\d+|{_NUM})"
    rf"(?:x(?P<factor>{_NUM}))?"
    rf"(?:\+(?P<duration>{_NUM}))?"
    r")?$")


class FaultPlan:
    """A seeded, replayable fault schedule.

    Thread-safe: realtime tier-worker threads poll concurrently.  The
    ``seed`` drives every random choice the plan ever makes (payload
    corruption offsets, ``FaultPlan.random`` schedules), so one plan is
    one reproducible chaos scenario.
    """

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.seed = int(seed)
        self.faults: List[Fault] = list(faults)
        self._lock = threading.Lock()

    def add(self, kind: str, *, target: Optional[str] = None,
            at: Optional[float] = None, after_steps: Optional[int] = None,
            duration: float = 0.0, factor: float = 1.0) -> "FaultPlan":
        """Append a fault; returns ``self`` for chaining."""
        self.faults.append(Fault(kind, target=target, at=at,
                                 after_steps=after_steps,
                                 duration=duration, factor=factor))
        return self

    # -- firing --------------------------------------------------------------

    def poll(self, site: str, *, target: Optional[str] = None,
             now: Optional[float] = None,
             step: Optional[int] = None) -> List[Fault]:
        """Fire (once) and return every fault due at ``site``.

        ``target=None`` at a site hook matches any fault; a fault with
        ``target=None`` matches any hook target.
        """
        fired: List[Fault] = []
        with self._lock:
            for f in self.faults:
                if f.fired or f.site != site:
                    continue
                if f.target is not None and target is not None \
                        and f.target != target:
                    continue
                if f.due(now, step):
                    f.fired = True
                    fired.append(f)
        for f in fired:
            _M_INJECTED.labels(kind=f.kind).inc()
            if obs_trace.enabled():
                obs_trace.instant(f"chaos.{f.kind}", cat="chaos",
                                  target=f.target, at=f.at,
                                  after_steps=f.after_steps)
        return fired

    def pending(self) -> List[Fault]:
        """The faults not yet fired (the simulator uses their ``at``
        times as next-event candidates)."""
        with self._lock:
            return [f for f in self.faults if not f.fired]

    def reset(self) -> None:
        """Re-arm every fault (each ``AsyncServer.run`` replays the full
        schedule, so repeated runs are deterministic by construction)."""
        with self._lock:
            for f in self.faults:
                f.fired = False

    def summary(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "faults": len(self.faults),
                    "fired": sum(f.fired for f in self.faults),
                    "kinds": sorted({f.kind for f in self.faults})}

    # -- construction --------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse a plan spec string (the ``--chaos`` / ``REPRO_CHAOS``
        grammar): ``;``-separated faults, each

            kind[:target][@when[xFACTOR][+DURATION]]

        where ``when`` is either seconds (``@0.25``, scientific notation
        allowed) or a pump count (``@s12`` — fire before the target's
        13th pump).  The ``x``/``+`` suffixes attach to the ``@`` clause,
        so a target is free to contain those characters
        (``kill:xlarge``).  Examples: ``kill:fast@s3``,
        ``slow:quality@0.1x4``, ``stall:fast@0.2+0.5``,
        ``corrupt_cache``, ``kernel_raise:sparse``.
        """
        plan = cls(seed=seed)
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            m = _SPEC_RE.match(part)
            if m is None:
                raise ValueError(
                    f"malformed fault spec {part!r}; expected "
                    f"kind[:target][@when[xFACTOR][+DURATION]]")
            at = after_steps = None
            when = m.group("when")
            if when is not None:
                if when.startswith("s"):
                    after_steps = int(when[1:])
                else:
                    at = float(when)
            plan.add(m.group("kind"),
                     target=(m.group("target") or "").strip() or None,
                     at=at, after_steps=after_steps,
                     duration=float(m.group("duration") or 0.0),
                     factor=float(m.group("factor") or 1.0))
        return plan

    @classmethod
    def random(cls, targets: Sequence[str], n: int = 1,
               horizon: float = 1.0, seed: int = 0,
               kinds: Sequence[str] = ("kill",)) -> "FaultPlan":
        """``n`` random faults over ``targets`` within ``horizon`` seconds
        — a seeded chaos scenario generator for soak/property tests."""
        rng = random.Random(seed)
        plan = cls(seed=seed)
        for _ in range(n):
            plan.add(rng.choice(list(kinds)),
                     target=rng.choice(list(targets)),
                     at=rng.uniform(0.0, horizon))
        return plan

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, faults={self.faults!r})"


# ---------------------------------------------------------------------------
# Process-wide plan (the REPRO_CHAOS env flag)
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def enabled() -> bool:
    """True when a fault plan is armed (the hot-path guard — one branch)."""
    return _PLAN is not None


def install(plan) -> FaultPlan:
    """Arm a process-wide plan (a ``FaultPlan`` or a spec string)."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"install expects a FaultPlan or spec string, "
                        f"got {type(plan).__name__}")
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def plan_from_env() -> Optional[FaultPlan]:
    """The plan ``REPRO_CHAOS`` names, or None (falsy values disarm)."""
    spec = os.environ.get(ENV_CHAOS)
    if spec is None or spec.strip().lower() in _FALSY:
        return None
    return FaultPlan.parse(spec)


# -- site hooks (call only under an ``enabled()`` guard) ---------------------

def maybe_raise(site: str, *, target: Optional[str] = None,
                now: Optional[float] = None) -> None:
    """Raise for any due fault at ``site`` (the raising-site hook)."""
    if _PLAN is None:
        return
    for f in _PLAN.poll(site, target=target, now=now):
        exc = ShardLost if f.kind == "drop_shard" else InjectedFault
        raise exc(f"injected {f.kind} at {site}"
                  + (f" (target {f.target})" if f.target else ""))


# REPRO_CHAOS is read once, at import (same lifecycle as REPRO_TRACE).
_env_plan = plan_from_env()
if _env_plan is not None:
    _PLAN = _env_plan
del _env_plan


def corrupt_if_due(site: str, text: str) -> str:
    """Return ``text`` corrupted if a ``corrupt_cache`` fault is due --
    truncated at a seed-deterministic offset, mimicking a partial write."""
    if _PLAN is None or not _PLAN.poll(site):
        return text
    cut = random.Random(_PLAN.seed).randrange(max(len(text) // 2, 1))
    return text[:cut]
