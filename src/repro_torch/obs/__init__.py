"""repro_torch.obs — unified observability: tracing, metrics, calibration.

Three pillars (see the README "Observability" section):

* ``trace``     -- span API + Chrome/Perfetto trace-event JSON export;
                   enabled by ``REPRO_TRACE`` (near-zero-cost when off).
* ``metrics``   -- typed Counter/Gauge/Histogram registry with fixed
                   bucket edges (deterministic snapshots in virtual-time
                   mode), JSON + Prometheus exposition.
* ``calibrate`` -- CostCalibrator pairing measured kernel/step timings
                   with ``GemmEngine.cost()`` predictions; per-impl
                   drift ratios + correction factors for tier routing.

``python -m repro_torch.obs`` renders/diffs metric snapshots.
"""
from . import calibrate, metrics, trace  # noqa: F401
from .calibrate import (COST_MODEL_MISCALIBRATED,  # noqa: F401
                        CalibrationSample, CostCalibrator,
                        CostModelDriftWarning, get_calibrator,
                        predict_gemm_seconds, reset_calibrator)
from .metrics import (GLOSSARY, MetricsRegistry,  # noqa: F401
                      diff_snapshots, get_registry, load_snapshot,
                      prometheus_text, reset_metrics, snapshot)
from .trace import (ENV_TRACE, NULL_SPAN, PID_RUNTIME,  # noqa: F401
                    PID_SERVER, complete_event, disable, enable, enabled,
                    instant, save, span, to_chrome)
from .trace import clear as clear_trace  # noqa: F401
from .trace import events as trace_events  # noqa: F401
