"""Deterministic fault injection and the retry policy (counterpart of
the ``faults`` and ``retry`` parts of ``paddle_tpu.distributed.
resilience``)."""

from .faults import (FaultInjector, FaultPlan, FaultRule, InjectedFault,
                     KNOWN_SITES, active_plan, clear, fault_point, install,
                     install_from_env, should_drop)
from .retry import (RetryExhausted, reset_retry_stats, retry_call,
                    retry_stats, retryable)

__all__ = ["FaultPlan", "FaultRule", "FaultInjector", "InjectedFault",
           "KNOWN_SITES", "fault_point", "should_drop", "install",
           "install_from_env", "active_plan", "clear", "RetryExhausted",
           "retry_call", "retry_stats", "reset_retry_stats", "retryable"]
