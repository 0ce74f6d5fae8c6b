"""repro_torch.serving — asynchronous continuous-batching serving subsystem.

The serving-level realization of the paper's thesis: the bit-weight /
digit-plane budget of a quantized GEMM is a tunable cost knob, so a server
can trade latency against quantization quality *per request* by routing
traffic across engine workers baked with different ``QuantSpec`` tiers.

Layers (each its own module):

    request   -- ServeRequest lifecycle (QUEUED -> PREFILL -> DECODE ->
                 DONE, REJECTED) with arrival/deadline/priority + timing
    slots     -- SlotAllocator: decode-slot + KV-position bookkeeping,
                 decoupled from the engine's batch arrays
    scheduler -- admission Scheduler with pluggable policies (fcfs,
                 priority, deadline/EDF) and prompt-length validation
    tiers     -- Tier ladder + TierRouter (service-time estimates from
                 GemmEngine.cost / core.hwmodel)
    engine    -- ServeEngine: the fixed-batch decode engine with a
                 stepping surface (admit_from / step), the snapshot/
                 restore seam (snapshot_slot / restore_slot), and the
                 blocking run()
    ckpt      -- DecodeSnapshot: one slot's decode state (KV rows,
                 tokens, cursor, stamps) in the reference's checksummed
                 RPCKPT v1 bytes
    journal   -- RequestJournal: write-ahead admission + committed-token
                 log with corruption-truncating replay (--resume)
    server    -- AsyncServer: one TierWorker per tier, virtual-time
                 (deterministic discrete-event) and realtime (threaded)
                 drive modes; restore-mode failover migrates committed
                 tokens (bit-exact on a same-QuantSpec tier)
    metrics   -- per-request TTFT/TPOT, queue depth, occupancy, tier
                 histogram; validate_summary pins the dict shape
    loadgen   -- Poisson / burst / uniform synthetic request loads

``repro_torch.launch.serve`` is a thin CLI over this package.
"""
from .request import (ServeRequest, Request, QUEUED, PREFILL,  # noqa: F401
                      DECODE, DONE, REJECTED, LIFECYCLE)
from .slots import SlotAllocator, SlotEvent                    # noqa: F401
from .scheduler import (Scheduler, AdmissionPolicy, POLICIES,  # noqa: F401
                        make_policy)
from .tiers import (Tier, default_tiers, TierRouter,           # noqa: F401
                    ROUTER_POLICIES, BrownoutPolicy,
                    estimate_step_time, step_cost, decode_step_gemms)
from .engine import (ServeEngine, RESET_STATE_FAMILIES,      # noqa: F401
                     KERNEL_IMPLS)
from .ckpt import (DecodeSnapshot, SnapshotError,              # noqa: F401
                   SnapshotMismatch, CKPT_VERSION)
from .journal import (RequestJournal, JournalReplay,           # noqa: F401
                      replay as replay_journal, resume_split)
from .server import (AsyncServer, TierWorker, WorkerDied,      # noqa: F401
                     FAILOVER_MODES)
from .metrics import (ServerMetrics, validate_summary,         # noqa: F401
                      SUMMARY_KEYS, dist)
from . import loadgen                                          # noqa: F401

__all__ = [
    "ServeRequest", "Request", "QUEUED", "PREFILL", "DECODE", "DONE",
    "REJECTED", "LIFECYCLE",
    "SlotAllocator", "SlotEvent",
    "Scheduler", "AdmissionPolicy", "POLICIES", "make_policy",
    "Tier", "default_tiers", "TierRouter", "ROUTER_POLICIES",
    "BrownoutPolicy",
    "estimate_step_time", "step_cost", "decode_step_gemms",
    "ServeEngine", "RESET_STATE_FAMILIES", "KERNEL_IMPLS",
    "DecodeSnapshot", "SnapshotError", "SnapshotMismatch", "CKPT_VERSION",
    "RequestJournal", "JournalReplay", "replay_journal", "resume_split",
    "AsyncServer", "TierWorker", "WorkerDied", "FAILOVER_MODES",
    "ServerMetrics", "validate_summary", "SUMMARY_KEYS", "dist",
    "loadgen",
]
