"""Cost-model calibration: measured kernel/step time vs predicted.

``GemmEngine.cost()`` is a static model — exact on its own terms (the
analysis cost cross-check re-derives every counter from the schedule)
but priced with *nominal* throughput constants on the reference's
``core.hwmodel`` designs, so its absolute seconds drift from any real
device (the port's card included), and the achieved fraction of peak
varies per impl.  The ``CostCalibrator`` closes that loop:

* every measured timing (autotuner candidate measurements, realtime
  EWMA step times from ``AsyncServer``, bench lanes) is paired with the
  cost-model prediction for the same (shape, spec, density, shards) key;
* per-impl **drift ratios** (geometric mean of measured/predicted) are
  maintained and exported as the ``repro_cost_drift_ratio`` gauge;
* a drift beyond ``drift_threshold`` raises a
  ``CostModelDriftWarning`` tagged ``COST_MODEL_MISCALIBRATED``;
* ``correction(impl)`` returns the multiplicative factor that maps a
  prediction onto the measured timeline — ``TierRouter`` /
  ``estimate_step_time`` consume it optionally (the precursor to the
  background-retuning hook).

Drift is tracked in log space: timing ratios are multiplicative, and a
geometric mean keeps one outlier measurement from dominating.
"""
from __future__ import annotations

import math
import threading
import warnings
from collections import deque
from typing import Dict, NamedTuple, Optional, Tuple

from . import metrics as _metrics

__all__ = ["COST_MODEL_MISCALIBRATED", "CostModelDriftWarning",
           "CalibrationSample", "CostCalibrator", "predict_gemm_seconds",
           "get_calibrator", "reset_calibrator"]

#: Diagnostic code carried by the drift warning (grep-able in CI logs,
#: same style as the repro_torch.analysis schedule-verifier codes).
COST_MODEL_MISCALIBRATED = "COST_MODEL_MISCALIBRATED"


class CostModelDriftWarning(UserWarning):
    """Measured timings drift from GemmEngine.cost beyond threshold."""


class CalibrationSample(NamedTuple):
    impl: str
    predicted_s: float
    measured_s: float
    ratio: float
    shape: Optional[Tuple[int, int, int]]
    density: Optional[float]
    shards: Optional[Tuple[int, int]]
    source: str


def predict_gemm_seconds(impl: str, m: int, k: int, n: int, spec, *,
                         density: Optional[float] = None, plan=None,
                         shards=None, design: str = "tpu") -> float:
    """Cost-model seconds for one GEMM on a ``core.hwmodel`` design.

    Convenience wrapper over ``GemmEngine.predict_seconds`` that takes
    the impl name (the key calibration samples are grouped by)."""
    from repro_torch.engine import get_engine
    return get_engine(impl).predict_seconds(
        m, k, n, spec, density=density, plan=plan, shards=shards,
        design=design)


class CostCalibrator:
    """Pairs measured timings with cost-model predictions per impl.

    drift_threshold: warn when the per-impl geometric-mean ratio leaves
    ``[1/t, t]`` — the *relative spread* that breaks tier routing, not
    the absolute scale (a device uniformly slower than the priced
    design is exactly what ``correction()`` absorbs).  ``check()`` therefore compares each
    impl's drift against the *median* drift across impls.
    """

    def __init__(self, drift_threshold: float = 4.0,
                 min_samples: int = 3, max_samples: int = 512):
        if drift_threshold <= 1.0:
            raise ValueError("drift_threshold must be > 1")
        self.drift_threshold = float(drift_threshold)
        self.min_samples = int(min_samples)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._log_ratios: Dict[str, deque] = {}
        self._sources: Dict[str, Dict[str, int]] = {}
        self._last: Dict[str, CalibrationSample] = {}
        self._warned: set = set()

    def record(self, impl: str, predicted_s: float, measured_s: float, *,
               shape: Optional[Tuple[int, int, int]] = None,
               density: Optional[float] = None,
               shards: Optional[Tuple[int, int]] = None,
               source: str = "autotune") -> float:
        """Add one (predicted, measured) pair; returns the ratio."""
        if predicted_s <= 0 or measured_s <= 0:
            raise ValueError(
                f"calibration needs positive timings, got predicted="
                f"{predicted_s!r} measured={measured_s!r}")
        ratio = measured_s / predicted_s
        sample = CalibrationSample(impl, predicted_s, measured_s, ratio,
                                   shape, density, shards, source)
        with self._lock:
            dq = self._log_ratios.get(impl)
            if dq is None:
                dq = self._log_ratios[impl] = deque(
                    maxlen=self.max_samples)
            dq.append(math.log(ratio))
            srcs = self._sources.setdefault(impl, {})
            srcs[source] = srcs.get(source, 0) + 1
            self._last[impl] = sample
        _metrics.get_registry().gauge(
            "repro_cost_drift_ratio").labels(impl=impl).set(
            self.drift(impl))
        return ratio

    def drift(self, impl: str) -> Optional[float]:
        """Geometric-mean measured/predicted ratio for an impl."""
        dq = self._log_ratios.get(impl)
        if not dq:
            return None
        return math.exp(sum(dq) / len(dq))

    def correction(self, impl: str) -> float:
        """Factor mapping a prediction onto the measured timeline
        (1.0 when the impl has no samples yet)."""
        d = self.drift(impl)
        return d if d is not None else 1.0

    def samples(self, impl: str) -> int:
        dq = self._log_ratios.get(impl)
        return len(dq) if dq else 0

    def report(self) -> dict:
        """Per-impl drift summary (the ``python -m repro_torch.obs`` view)."""
        out = {}
        for impl in sorted(self._log_ratios):
            dq = self._log_ratios[impl]
            n = len(dq)
            mean = sum(dq) / n
            var = sum((x - mean) ** 2 for x in dq) / n
            last = self._last.get(impl)
            out[impl] = {
                "samples": n,
                "drift": math.exp(mean),
                "log_stdev": math.sqrt(var),
                "sources": dict(sorted(self._sources[impl].items())),
                "last": {"predicted_s": last.predicted_s,
                         "measured_s": last.measured_s,
                         "shape": list(last.shape) if last.shape
                         else None} if last else None,
            }
        return out

    def check(self, warn: bool = True) -> Dict[str, float]:
        """Impls whose drift leaves the cross-impl consensus band.

        Each impl's drift is divided by the median drift over all impls
        with enough samples (removing the uniform host-speed scale);
        a relative drift outside ``[1/threshold, threshold]`` is
        miscalibrated.  Returns ``{impl: relative_drift}`` and (when
        ``warn``) emits one ``CostModelDriftWarning`` per impl."""
        drifts = {impl: self.drift(impl) for impl in self._log_ratios
                  if self.samples(impl) >= self.min_samples}
        if not drifts:
            return {}
        ordered = sorted(drifts.values())
        median = ordered[len(ordered) // 2]
        bad = {}
        for impl, d in sorted(drifts.items()):
            rel = d / median
            if rel > self.drift_threshold or \
                    rel < 1.0 / self.drift_threshold:
                bad[impl] = rel
                if warn and impl not in self._warned:
                    self._warned.add(impl)
                    warnings.warn(
                        f"{COST_MODEL_MISCALIBRATED}: impl {impl!r} "
                        f"drift {d:.3g} is {rel:.2f}x the cross-impl "
                        f"median {median:.3g} (threshold "
                        f"{self.drift_threshold}x, "
                        f"{self.samples(impl)} samples) — "
                        f"GemmEngine.cost underprices or overprices "
                        f"this impl relative to the others",
                        CostModelDriftWarning, stacklevel=2)
        return bad

    def corrections(self) -> Dict[str, float]:
        return {impl: self.correction(impl)
                for impl in sorted(self._log_ratios)}

    def reset(self) -> None:
        with self._lock:
            self._log_ratios.clear()
            self._sources.clear()
            self._last.clear()
            self._warned.clear()


_default = CostCalibrator()


def get_calibrator() -> CostCalibrator:
    return _default


def reset_calibrator() -> None:
    _default.reset()
