"""Quant tiers and cost-driven tier routing (``repro.serving.tiers``).

A ``Tier`` names one QuantSpec an engine worker is baked with.  The paper's
knob — digit-plane budget per GEMM — becomes a serving-level policy here:
fewer planes means fewer plane passes per matmul (``GemmEngine.cost``), so a
low-plane tier is a *fast* tier and a full-plane tier a *quality* tier.

``estimate_step_time`` turns the registry's per-GEMM cost model into a
per-decode-step service-time estimate (seconds) on a ``core.hwmodel``
array design: integer MACs of one decode step across the model's dense
GEMMs, divided by the design's peak throughput, plus the HBM round-trip
the engine's epilogue placement implies.  The designs are the
reference's: the router needs relative prices, and realtime mode
replaces them with measured step times.  ``TierRouter`` uses those
estimates to assign each request a tier:

    quality     -- always the highest-quality tier
    fastest     -- always the cheapest tier
    round_robin -- cycle tiers (load spreading)
    slo         -- deadline-aware: the highest-quality tier whose estimated
                   completion (queue backlog + own service time) meets the
                   request's deadline; deadline-less requests get quality,
                   infeasible deadlines fall back to the fastest tier
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import hwmodel as hw
from repro_torch.engine import QuantSpec, get_engine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .request import ServeRequest

__all__ = ["Tier", "default_tiers", "decode_step_gemms", "step_cost",
           "estimate_step_time", "TierRouter", "ROUTER_POLICIES",
           "BrownoutPolicy"]

_M_BROWNOUT_TRANSITIONS = obs_metrics.get_registry().counter(
    "repro_serve_brownout_transitions_total")
_M_BROWNOUT_LEVEL = obs_metrics.get_registry().gauge(
    "repro_serve_brownout_level")

# nominal pricing bandwidths live on the engine registry now (the single
# pricing seam shared with GemmEngine.predict_seconds / obs.calibrate);
# the old names stay as aliases
from repro_torch.engine.registry import (NOMINAL_HBM_BPS as _NOMINAL_HBM_BPS,
                                   NOMINAL_ICI_BPS as _NOMINAL_ICI_BPS)


@dataclasses.dataclass(frozen=True)
class Tier:
    """One serving tier: a name, the QuantSpec its worker is baked with
    (None = unquantized bf16), the worker's decode-slot count, and the
    mesh shard grid ``(s_data, s_model)`` its weights are partitioned
    over ((1, 1) = single device)."""
    name: str
    spec: Optional[QuantSpec]
    batch: int = 4
    shards: Tuple[int, int] = (1, 1)

    def quality_rank(self) -> Tuple[int, int, int]:
        """Orderable quality: unquantized > more planes > more bits."""
        if self.spec is None:
            return (1, 0, 0)
        return (0, self.spec.planes, self.spec.bits)


def default_tiers(n: int = 2, batch: int = 4,
                  impl: str = "pallas_fused") -> Tuple[Tier, ...]:
    """The default tier ladder: fast (2 planes) -> balanced (3) ->
    quality (4 planes).  ``n`` selects the ladder's endpoints first.

    act_quant is per_token: a per-tensor act scale is a max over the whole
    batch, which would make a request's tokens depend on its batch-mates —
    per-token scales keep continuous-batching outputs deterministic per
    request (and bit-identical to a standalone run under the same spec).
    """
    def spec(planes):
        return QuantSpec(planes=planes, impl=impl, act_quant="per_token")
    fast = Tier("fast", spec(2), batch)
    balanced = Tier("balanced", spec(3), batch)
    quality = Tier("quality", spec(4), batch)
    ladder = {1: (quality,), 2: (fast, quality),
              3: (fast, balanced, quality)}
    try:
        return ladder[n]
    except KeyError:
        raise ValueError(f"--tiers supports 1..3 default tiers, got {n}") \
            from None


def decode_step_gemms(cfg, batch: int) -> List[Tuple[int, int, int]]:
    """Coarse (m, k, n) list of the dense GEMMs one decode step runs:
    4 mixer matmuls + 2 FFN matmuls per block, plus the LM head."""
    d, f = cfg.d_model, cfg.d_ff
    per_block = [(batch, d, d)] * 4 + [(batch, d, f), (batch, f, d)]
    n_blocks = cfg.n_layers + getattr(cfg, "n_encoder_layers", 0)
    return per_block * n_blocks + [(batch, d, cfg.padded_vocab)]


def step_cost(cfg, batch: int, spec: Optional[QuantSpec],
              density: Optional[float] = None,
              shards: Optional[Tuple[int, int]] = None) -> Dict[str, int]:
    """Aggregate GemmEngine.cost over one decode step's GEMMs.

    density: measured plane-block density of the worker's planned weights
    (``ServeEngine`` exposes it as ``plan_density``); None keeps the
    pre-sparsity upper bound of the engine's default estimate.

    shards: ``Tier.shards`` — the (s_data, s_model) mesh grid the tier's
    weights are partitioned over.  Counters then describe one device's
    per-shard work plus the ``collective_bytes`` its K-axis ``psum``
    moves (see ``GemmEngine.cost``).
    """
    total = {"int_macs": 0, "mxu_passes": 0, "acc_hbm_bytes": 0,
             "grid_steps": 0, "dma_bytes": 0, "b_dma_elided": 0,
             "collective_bytes": 0}
    engine = get_engine(spec.impl) if spec is not None else None
    if engine is None:
        from repro_torch.engine._collectives import (gemm_collective_bytes,
                                                normalize_shards)
        s_data, s_model = normalize_shards(shards)
    for m, k, n in decode_step_gemms(cfg, batch):
        if engine is None:       # unquantized: one pass, fused epilogue
            ks, ns = -(-k // s_data), -(-n // s_model)
            c = {"int_macs": m * ks * ns, "mxu_passes": 1,
                 "acc_hbm_bytes": 0, "grid_steps": 0,
                 "dma_bytes": m * ks + ks * ns + 4 * m * ns,
                 "b_dma_elided": 0,
                 "collective_bytes": gemm_collective_bytes(
                     m, n, s_data, s_model, acc_bytes=2)}  # bf16 partials
        else:
            c = engine.cost(m, k, n, spec, density=density, shards=shards)
        for key in total:
            total[key] += c[key]
    return total


def estimate_step_time(cfg, batch: int, spec: Optional[QuantSpec],
                       design: str = "tpu",
                       density: Optional[float] = None,
                       shards: Optional[Tuple[int, int]] = None,
                       correction: float = 1.0) -> float:
    """Estimated seconds per decode step on a core.hwmodel array design.

    The compute term prices the integer MACs *actually executed*: the
    schedule-aware cost model scales them by the measured plane-block
    density when one is given, so a tier whose plans have sparse high
    planes is correctly estimated as cheaper than its plane budget alone
    implies.  The memory term prices the accumulator round-trip of the
    engine's epilogue placement (the kernels' full DMA block traffic is
    reported in ``step_cost['dma_bytes']``; folding it in here would
    swamp the smoke-scale models the serving tests drive, where padded
    block DMA dwarfs the useful work).  Sharded tiers (``shards``) pay a
    third term: the per-device collective traffic over a nominal ICI
    link — so the router sees both the per-shard MAC savings *and* the
    reduce it buys them with.

    correction: multiplicative calibration factor mapping the nominal
    estimate onto a measured timeline — typically
    ``obs.get_calibrator().correction(spec.impl)`` (1.0 = uncorrected).
    """
    d = hw.TABLE7[design]
    cost = step_cost(cfg, batch, spec, density=density, shards=shards)
    ops_per_s = hw.peak_tops(d) * 1e12
    return (2.0 * cost["int_macs"] / ops_per_s
            + cost["acc_hbm_bytes"] / _NOMINAL_HBM_BPS
            + cost["collective_bytes"] / _NOMINAL_ICI_BPS) * correction


ROUTER_POLICIES = ("quality", "fastest", "round_robin", "slo")


@dataclasses.dataclass
class BrownoutPolicy:
    """Hysteresis controller for graceful degradation.

    ``update`` maps a scalar *pressure* (the server passes backlog tokens
    per decode slot across live tiers) to a degradation **level**: 0 =
    healthy, each further level demotes routed requests one rung down the
    live quality ladder.  Enter and exit thresholds differ (``enter`` >
    ``exit``) and transitions are rate-limited by ``dwell`` seconds on
    the server's clock, so the level cannot flap on a noisy backlog.
    """
    enter: float = 48.0      # pressure above which to degrade one level
    exit: float = 12.0       # pressure below which to recover one level
    dwell: float = 0.0       # min seconds between transitions
    max_level: int = 8

    def __post_init__(self):
        if self.enter <= self.exit:
            raise ValueError(f"brownout enter threshold ({self.enter}) must "
                             f"exceed exit threshold ({self.exit})")
        self.level = 0
        self._last_change = -float("inf")

    def update(self, pressure: float, now: float, n_levels: int) -> int:
        """Advance the controller; returns the (possibly new) level.
        ``n_levels`` caps the useful range (len of the live ladder)."""
        cap = min(self.max_level, max(n_levels - 1, 0))
        if self.level > cap:
            self.level = cap            # a tier died under us
        if now - self._last_change < self.dwell:
            return self.level
        if pressure > self.enter and self.level < cap:
            self.level += 1
            self._last_change = now
        elif pressure < self.exit and self.level > 0:
            self.level -= 1
            self._last_change = now
        return self.level

    def reset(self) -> None:
        self.level = 0
        self._last_change = -float("inf")


class TierRouter:
    """Assigns each request a tier from per-tier service-time estimates.

    ``per_step`` maps tier name -> estimated seconds per engine step (one
    token per active slot); the async server builds it from
    ``estimate_step_time`` (scaled into its clock domain) and may refresh
    it with measured step times in realtime mode.

    Failover: ``mark_dead(name)`` removes a tier from routing (the server
    calls it when a worker dies); ``revive_all`` restores the full set at
    the start of a fresh run.  Brownout: with a ``BrownoutPolicy``
    attached, ``note_pressure`` drives the degradation level and ``route``
    demotes its pick that many rungs down the live quality ladder.
    """

    def __init__(self, tiers, per_step: Dict[str, float],
                 policy: str = "slo",
                 brownout: Optional[BrownoutPolicy] = None):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"one of {ROUTER_POLICIES}")
        self.tiers = tuple(tiers)
        if not self.tiers:
            raise ValueError("router needs at least one tier")
        self.per_step = dict(per_step)
        self.policy = policy
        self.brownout = brownout
        self._rr = 0
        self._dead: set = set()
        self._recompute()

    # -- liveness ------------------------------------------------------------

    def _recompute(self) -> None:
        live = self.live_tiers()
        if not live:
            self._fastest = self._quality = None
            self._ladder = ()
            return
        self._fastest = min(live,
                            key=lambda t: (self.per_step[t.name], t.name))
        self._quality = max(live,
                            key=lambda t: (t.quality_rank(), t.name))
        # quality ladder, best first — brownout demotes down this list
        self._ladder = tuple(sorted(live, key=lambda t: t.quality_rank(),
                                    reverse=True))

    def live_tiers(self) -> Tuple[Tier, ...]:
        return tuple(t for t in self.tiers if t.name not in self._dead)

    def mark_dead(self, name: str) -> None:
        """Remove ``name`` from routing (its worker died)."""
        if name not in {t.name for t in self.tiers}:
            raise ValueError(f"unknown tier {name!r}")
        self._dead.add(name)
        self._recompute()

    def revive(self, name: str) -> None:
        """Restore one tier to routing (its worker came back — the
        server resets the cost estimate; see ``AsyncServer.revive_tier``
        for the re-measurement contract)."""
        if name not in {t.name for t in self.tiers}:
            raise ValueError(f"unknown tier {name!r}")
        self._dead.discard(name)
        self._recompute()

    def revive_all(self) -> None:
        """Restore every tier (fresh run) and reset the brownout level."""
        self._dead.clear()
        self._recompute()
        if self.brownout is not None:
            self.brownout.reset()

    # -- brownout ------------------------------------------------------------

    @property
    def brownout_level(self) -> int:
        return self.brownout.level if self.brownout is not None else 0

    def note_pressure(self, pressure: float, now: float = 0.0) -> int:
        """Feed the brownout controller one pressure sample; emits a
        transition metric + trace instant when the level changes."""
        if self.brownout is None:
            return 0
        prev = self.brownout.level
        level = self.brownout.update(pressure, now, len(self._ladder))
        if level != prev:
            direction = "down" if level > prev else "up"
            _M_BROWNOUT_TRANSITIONS.labels(direction=direction).inc()
            _M_BROWNOUT_LEVEL.set(float(level))
            if obs_trace.enabled():
                obs_trace.instant("serve.brownout", cat="serve",
                                  level=level, prev=prev,
                                  pressure=round(pressure, 3))
        return level

    def _demote(self, tier: Tier) -> Tier:
        """Demote ``tier`` ``brownout_level`` rungs down the live quality
        ladder (saturating at the fastest live tier)."""
        level = self.brownout_level
        if level == 0 or len(self._ladder) <= 1:
            return tier
        try:
            i = self._ladder.index(tier)
        except ValueError:              # tier died since it was picked
            return self._ladder[-1]
        return self._ladder[min(i + level, len(self._ladder) - 1)]

    # -- routing -------------------------------------------------------------

    def route(self, req: ServeRequest, now: float = 0.0,
              loads: Optional[Dict[str, Tuple[int, int]]] = None) -> Tier:
        """Pick a live tier; ``loads`` maps tier name -> (backlog_tokens,
        n_slots) for the queueing term of the SLO estimate."""
        if self._fastest is None:
            raise RuntimeError("no live tiers to route to")
        if self.policy == "quality":
            tier = self._quality
        elif self.policy == "fastest":
            tier = self._fastest
        elif self.policy == "round_robin":
            live = self.live_tiers()     # declaration order, not the ladder
            tier = live[self._rr % len(live)]
            self._rr += 1
        else:                            # slo
            tier = self._route_slo(req, now, loads or {})
        tier = self._demote(tier)
        req.tier = tier.name
        return tier

    def apply_calibration(self, calibrator) -> Dict[str, float]:
        """Scale ``per_step`` by measured cost-model drift per tier.

        ``calibrator`` is an ``obs.CostCalibrator``; each tier's
        estimate is multiplied by ``correction(impl)`` for its spec's
        impl (unquantized tiers and impls with no samples keep 1.0).
        Returns the factors applied, the hook for background
        retuning.  Idempotence is the
        caller's concern: apply to freshly estimated values, or track
        the previous factors.
        """
        applied = {}
        for tier in self.tiers:
            factor = (calibrator.correction(tier.spec.impl)
                      if tier.spec is not None else 1.0)
            self.per_step[tier.name] *= factor
            applied[tier.name] = factor
        self._recompute()
        return applied

    def _route_slo(self, req, now, loads) -> Tier:
        if req.deadline is None:
            return self._quality
        work = len(req.prompt) + req.max_tokens
        best = None
        for tier in self._ladder:
            per = self.per_step[tier.name]
            backlog, slots = loads.get(tier.name, (0, tier.batch))
            eta = now + (backlog / max(slots, 1) + work) * per
            if eta <= req.deadline:
                best = tier
                break
        return best or self._fastest
