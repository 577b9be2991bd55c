"""Deterministic fault injection (counterpart of the ``faults`` part of
``paddle_tpu.distributed.resilience``)."""

from .faults import (FaultInjector, FaultPlan, FaultRule, InjectedFault,
                     KNOWN_SITES, active_plan, clear, fault_point, install,
                     install_from_env, should_drop)

__all__ = ["FaultPlan", "FaultRule", "FaultInjector", "InjectedFault",
           "KNOWN_SITES", "fault_point", "should_drop", "install",
           "install_from_env", "active_plan", "clear"]
