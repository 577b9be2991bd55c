"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port lives beside the JAX package and mirrors its module paths, so
each module here has a counterpart of the same name there.  It imports
``torch``, ``numpy`` and the standard library only.  Kernels that the
JAX package wrote in Pallas are hand-written CUDA C++ for Hopper
(``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use into the
git-ignored ``_build/`` directory (``_build.py``).

Device rule: entry points run on the card unless the caller asks for
the CPU.  :func:`resolve_device` is the one place that rule lives.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises:
    the port never carries on on the CPU unless ``device="cpu"`` was
    asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
