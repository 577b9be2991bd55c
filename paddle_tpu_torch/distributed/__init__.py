"""paddle_tpu_torch.distributed — the part of ``paddle_tpu.distributed``
that the port has: fault injection (``resilience.faults``), which the
serving router consults.  The launcher, collectives and the rest of
``resilience/`` wait for ROADMAP.md queue A, item A11."""

from . import resilience  # noqa: F401

__all__ = ["resilience"]
