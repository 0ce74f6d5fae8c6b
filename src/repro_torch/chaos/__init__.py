"""repro_torch.chaos — deterministic fault injection for the serving
stack (see ``chaos.inject`` and the README "Fault tolerance &
degradation" section).

Off by default and zero-cost when off: every hook site guards on
``chaos.enabled()`` (one module-bool branch), so a run with
``REPRO_CHAOS`` unset fires zero faults and allocates nothing.
"""
from .inject import (ENV_CHAOS, FAULT_KINDS, FAULT_SITES,  # noqa: F401
                     Fault, FaultPlan, InjectedFault, ServerCrashed,
                     ShardLost, WorkerKilled, active_plan, corrupt_if_due,
                     enabled, install, maybe_raise, plan_from_env,
                     uninstall)

__all__ = [
    "ENV_CHAOS", "FAULT_KINDS", "FAULT_SITES", "Fault", "FaultPlan",
    "InjectedFault", "ServerCrashed", "ShardLost", "WorkerKilled",
    "active_plan", "corrupt_if_due", "enabled", "install", "maybe_raise",
    "plan_from_env", "uninstall",
]
