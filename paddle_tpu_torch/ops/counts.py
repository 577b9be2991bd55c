"""Every launch count of the training path's kernel wrappers as one
flat table: ``launches``, ``tc_launches`` and ``plain_calls`` of each
function in ``flash_attention_kernel.COUNTED`` and
``lmce_kernel.COUNTED``, and the fused flash backward's
``helper_launches``.

A CUDA graph runs the wrappers' Python once, while it is captured, and
their kernels at every replay.  The fold engine (``framework/
dispatch.py``) therefore reads this table before and after a capture,
puts the values back, and adds the capture's change once per replay,
so that a count still says how many times its kernel ran.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import flash_attention_kernel as _fk
from . import lmce_kernel as _lk

_FIELDS = ("launches", "tc_launches", "plain_calls")
_HELPERS = "helper_launches"

Key = Tuple[object, str, str]


def read() -> Dict[Key, int]:
    """``{(function, field, kernel): count}``; ``kernel`` is empty but
    for the helper launches."""
    out = {}
    for fn in _fk.COUNTED + _lk.COUNTED:
        for field in _FIELDS:
            if hasattr(fn, field):
                out[(fn, field, "")] = getattr(fn, field)
        for name, n in getattr(fn, _HELPERS, {}).items():
            out[(fn, _HELPERS, name)] = n
    return out


def write(counts: Dict[Key, int]) -> None:
    """Set the counts ``counts`` names (as :func:`read` keys them)."""
    for (fn, field, name), n in counts.items():
        if field == _HELPERS:
            getattr(fn, _HELPERS)[name] = n
        else:
            setattr(fn, field, n)
