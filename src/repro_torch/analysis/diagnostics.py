"""Diagnostic records and reports for the static-analysis passes.

Every analyzer in ``repro_torch.analysis`` reports problems as
:class:`Diagnostic` values carrying a stable machine-readable ``code`` (the
reference's codes, key for key, so a finding means the same in both
packages), a severity, and an optional machine-actionable ``suggestion``
(e.g. the shared-memory pass's block clamp).  A :class:`Report` aggregates
them across passes; ``raise_if_errors`` turns error-severity findings into
an :class:`AnalysisError` at the execution seams (``plan_for(verify=...)``
/ ``planned_dense_apply``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

__all__ = ["Diagnostic", "Report", "AnalysisError", "CODES",
           "ERROR", "WARNING", "INFO"]

ERROR = "error"
WARNING = "warning"
INFO = "info"

# Stable diagnostic codes -> one-line meaning: the reference's keys (the
# mutation tests hold each schedule corruption to the same code in both
# packages).  The Diagnostic constructor rejects unknown codes, so the table
# cannot rot.
CODES = {
    # schedule verifier (analysis.schedule)
    "SCHED_BAD_SHAPE": "schedule array is not int [L, 6|9] / mask mismatch",
    "SCHED_OUT_OF_RANGE": "entry's plane/row/k-block index outside the mask",
    "SCHED_MISSING_VISIT": "non-zero plane-block never visited (wrong sums)",
    "SCHED_DUPLICATE_VISIT": "plane-block visited twice (double-counted)",
    "SCHED_PHANTOM_VISIT": "visit to a plane-block the mask says is empty",
    "SCHED_BAD_WEIGHT": "entry weight differs from radix**plane",
    "SCHED_BAD_FIRST": "row's FIRST flag absent, misplaced, or repeated",
    "SCHED_BAD_LAST": "row's LAST flag absent, misplaced, or row revisited "
                      "after its flush",
    "SCHED_BAD_SENTINEL": "empty output row without a zero-weight sentinel "
                          "(row never written)",
    "SCHED_BAD_PADDING": "zero-weight entry that is neither a sentinel nor "
                         "clean scan padding",
    "SCHED_ORDER_VIOLATION": "visit order breaks the claimed m_major/"
                             "k_major contract (v2 accumulation illegal)",
    "SCHED_BAD_BFETCH": "B_FETCH bit disagrees with the k-block residency "
                        "walk (missing or spurious fetch)",
    # the schedule's slot columns (analysis.dma)
    "DMA_WAR_HAZARD": "DMA copy targets a buffer slot the current step "
                      "still reads (write-after-read race)",
    "DMA_STALE_READ": "step consumes a slot whose resident block is not the "
                      "one the schedule promises",
    "DMA_SEM_UNBALANCED": "semaphore signal/wait counts diverge (hang or "
                          "leak into the next grid iteration)",
    # shared-memory budget pass (analysis.vmem; the TPU's VMEM in the
    # reference)
    "VMEM_OVER_BUDGET": "a CTA's shared-memory footprint exceeds the "
                        "budget, or the kernel refuses the block shape",
    # sharded-plan verification (analysis.verify_sharded_plan)
    "SHARD_BAD_SHAPE": "sharded plan's schedule table / mask shapes "
                       "disagree with its shard grid",
    "SHARD_BAD_PARTITION": "per-shard schedules do not exactly partition "
                           "the global occupancy mask (missing, duplicate "
                           "or phantom plane-block visit)",
    # decode-snapshot audit (analysis.ckpt)
    "SNAP_BAD_ARTIFACT": "snapshot bytes/file failed to parse (bad magic, "
                         "version, truncation, or checksum)",
    "SNAP_BAD_STATE": "snapshot's token/cursor/position bookkeeping breaks "
                      "the slot-restore invariants",
    "SNAP_NO_HEADROOM": "snapshot position leaves no room to generate "
                        "within max_len",
    "SNAP_SPEC_MISMATCH": "snapshot incompatible with the target engine "
                          "(restore falls back to re-prefill)",
    # cost-model cross-check (analysis.cost)
    "COST_MODEL_DRIFT": "GemmEngine.cost() counters diverge from the "
                        "schedule's symbolic walk",
    # artifact audits (analysis.__main__)
    "AUDIT_BAD_ARTIFACT": "checked-in artifact (autotune cache / config "
                          "registry entry) failed to parse or validate",
}


class AnalysisError(ValueError):
    """A static-analysis pass found error-severity diagnostics."""

    def __init__(self, report: "Report"):
        self.report = report
        lines = [str(d) for d in report.errors]
        super().__init__(
            "static analysis failed with "
            f"{len(report.errors)} error(s):\n  " + "\n  ".join(lines))


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of a static-analysis pass."""

    code: str                 # stable key into CODES
    message: str              # human-readable, names the offending values
    severity: str = ERROR
    step: Optional[int] = None          # schedule step index, when stepwise
    where: str = ""                     # free-form location (row, cache key)
    suggestion: Optional[dict] = None   # machine-actionable fix (clamps)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered diagnostic code {self.code!r}; "
                             f"add it to repro_torch.analysis.diagnostics.CODES")
        if self.severity not in (ERROR, WARNING, INFO):
            raise ValueError(f"bad severity {self.severity!r}")

    def __str__(self) -> str:
        loc = ""
        if self.step is not None:
            loc += f" step {self.step}"
        if self.where:
            loc += f" ({self.where})"
        tail = f" -> suggest {self.suggestion}" if self.suggestion else ""
        return f"[{self.code}]{loc}: {self.message}{tail}"


class Report:
    """Accumulated diagnostics across one or more analysis passes."""

    def __init__(self, context: str = ""):
        self.context = context
        self.diagnostics: List[Diagnostic] = []

    def add(self, code: str, message: str, *, severity: str = ERROR,
            step: Optional[int] = None, where: str = "",
            suggestion: Optional[dict] = None) -> Diagnostic:
        d = Diagnostic(code, message, severity=severity, step=step,
                       where=where, suggestion=suggestion)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "Report") -> "Report":
        self.diagnostics.extend(other.diagnostics)
        return self

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No error-severity findings (warnings/info allowed)."""
        return not self.errors

    def codes(self, severity: Optional[str] = None) -> Set[str]:
        return {d.code for d in self.diagnostics
                if severity is None or d.severity == severity}

    def raise_if_errors(self) -> "Report":
        if not self.ok:
            raise AnalysisError(self)
        return self

    def summary(self) -> str:
        head = self.context or "analysis"
        if not self.diagnostics:
            return f"{head}: clean"
        return (f"{head}: {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s), "
                f"{len(self.diagnostics)} finding(s) total")

    def __str__(self) -> str:
        return "\n".join([self.summary()] +
                         [f"  {d}" for d in self.diagnostics])

    def __repr__(self) -> str:
        return (f"<Report {self.context!r} errors={len(self.errors)} "
                f"warnings={len(self.warnings)}>")
