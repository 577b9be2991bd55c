"""``amp.auto_cast`` (counterpart of ``paddle_tpu/amp/auto_cast.py``).

The JAX package casts inside every primitive through one hook.  The
port has no primitive layer: its own layers and functions call
:func:`cast_inputs` with their op name, and that reads the one
module-level state :func:`auto_cast` sets.  The rule is the JAX one:

- **O2**: an op on the black list (or the custom black list, unless
  also custom white) gets its floating inputs in fp32; every other op
  gets them in the target dtype.
- **O1**: an op on the white list (or custom white, unless custom
  black) gets them in the target dtype, one on the black list (or
  custom black) in fp32; the rest are left as they are.

The ``Tensor``-level forms of the catalogue (``ops/_primitive.py``)
cast once, by their ``OP_TABLE`` name, with the casts below off inside.
Ops that call :func:`cast_inputs` in the port: the convolutions (the
1-D and 3-D transposes by their own names, which the white list lacks,
as in the JAX package), ``linear``, ``bilinear``, the norms, the pools,
the activations, ``flatten``, ``split``, ``reshape``, ``transpose``,
``expand``, ``pad``, ``unfold``, ``fold``, the rearranging and sampling
functions, ``interpolate``, ``box_iou``.  Python
operators in model code (``out + identity``) are torch's own and
promote instead (``ROADMAP.md``, non-comparable by design).
"""

from __future__ import annotations

import contextlib
from typing import Set

import torch

# ops that benefit from low precision (tensor-core ops)
WHITE_LIST: Set[str] = {
    "matmul", "bmm", "mm", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "linear", "einsum",
    "scaled_dot_product_attention", "flash_attention",
}
# numerically sensitive: keep fp32
BLACK_LIST: Set[str] = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum",
    "cos_sim", "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "layer_norm", "rms_norm", "batch_norm_train",
    "batch_norm_eval", "group_norm", "instance_norm", "norm",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "mse_loss", "l1_loss", "nll_loss", "kl_div", "logsumexp", "erf",
    "erfinv", "pow", "cumsum", "cumprod",
}

white_list = WHITE_LIST
black_list = BLACK_LIST

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, torch.bfloat16: torch.bfloat16,
           torch.float16: torch.float16, torch.float32: torch.float32}

_amp_state = {"enabled": False, "dtype": None, "level": "O1",
              "custom_white": frozenset(), "custom_black": frozenset()}


def amp_state() -> dict:
    """A copy of the state the port's ops read."""
    return dict(_amp_state)


def _target(opname):
    """The dtype ``opname``'s floating inputs take under the current
    state, or None to leave them as they are."""
    if not _amp_state["enabled"]:
        return None
    cw, cb = _amp_state["custom_white"], _amp_state["custom_black"]
    if _amp_state["level"] == "O2":
        if opname in (BLACK_LIST | cb) - cw:
            return torch.float32
        return _amp_state["dtype"]
    if opname in (WHITE_LIST | cw) - cb:
        return _amp_state["dtype"]
    if opname in BLACK_LIST | cb:
        return torch.float32
    return None


def cast_inputs(opname, *values):
    """``values`` as ``opname`` takes them under the current state: each
    floating tensor cast to the rule's dtype, everything else (None,
    integers, non-tensors) as it is.  Returns a tuple."""
    dt = _target(opname)
    if dt is None:
        return values
    return tuple(v.to(dt) if isinstance(v, torch.Tensor)
                 and v.is_floating_point() and v.dtype != dt else v
                 for v in values)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "float16", use_promote: bool = True):
    """``paddle.amp.auto_cast``: inside the block the port's ops cast
    their inputs by the O1/O2 rule (module docstring).  ``dtype`` is
    "float16" (the default, as Paddle's) or "bfloat16"; ``level`` "O1"
    or "O2".  The previous state comes back on exit, also on an
    error."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported amp dtype {dtype!r}")
    prev = dict(_amp_state)
    if enable:
        _amp_state.update(
            enabled=True, dtype=_DTYPES[dtype], level=level,
            custom_white=frozenset(custom_white_list or ()),
            custom_black=frozenset(custom_black_list or ()))
    try:
        yield
    finally:
        _amp_state.clear()
        _amp_state.update(prev)


# Paddle's other names of the context
autocast = auto_cast
amp_guard = auto_cast
