"""Mixed-precision numerics debugging (counterpart of
``paddle_tpu/amp/debugging.py``, upstream
``python/paddle/amp/debugging.py``): ``collect_operator_stats`` (calls
per operator and compute dtype), ``check_numerics`` (an explicit
inf/NaN probe), ``TensorCheckerConfig`` with ``enable_tensor_checker``
(every operator's outputs scanned for inf/NaN) and
``compare_accuracy`` (two collected runs diffed).

The JAX package observes its one primitive wrapper; the port observes
PyTorch's dispatcher with a ``TorchDispatchMode``, so the counts are of
ATen operators (``mm``, ``add``, ``native_layer_norm``, ...), each
call bucketed by its lowest-precision floating input (FP16 < BF16 <
FP32 < OTHER), as the JAX package buckets its calls.  Both modes run
eagerly and read every output of the tensor checker on the host: they
are for debugging runs, not for a captured step.
"""

from __future__ import annotations

import contextlib
import json
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = [
    "collect_operator_stats", "enable_operator_stats_collection",
    "disable_operator_stats_collection", "check_numerics",
    "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "compare_accuracy",
]

_BUCKETS = ("FP16", "BF16", "FP32", "OTHER")
_ORDER = {"FP16": 0, "BF16": 1, "FP32": 2, "OTHER": 3}
_NAMES = {torch.float16: "FP16", torch.bfloat16: "BF16",
          torch.float32: "FP32"}


def _bucket(dtype) -> str:
    return _NAMES.get(dtype, "OTHER")


class _OperatorStats(TorchDispatchMode):
    """Counts each ATen call into ``stats[op][bucket]``."""

    def __init__(self):
        super().__init__()
        self.stats: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        rec = self.stats.setdefault(name, {b: 0 for b in _BUCKETS})
        seen = None
        for v in tree_flatten((args, kwargs))[0]:
            if isinstance(v, torch.Tensor):
                b = _bucket(v.dtype)
                if seen is None or _ORDER[b] < _ORDER[seen]:
                    seen = b
        rec[seen or "OTHER"] += 1
        return func(*args, **kwargs)


class _TensorChecker(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first operator whose
    floating output holds an inf or a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for i, t in enumerate(tree_flatten(out)[0]):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"tensor checker: operator {func} output {i} has "
                    f"{int(torch.isnan(t).sum())} NaN and "
                    f"{int(torch.isinf(t).sum())} Inf values (shape "
                    f"{tuple(t.shape)}, dtype {t.dtype})")
        return out


_stats: Optional[_OperatorStats] = None
_checker: Optional[_TensorChecker] = None


def enable_operator_stats_collection() -> None:
    """Start counting operator calls per compute dtype."""
    global _stats
    if _stats is not None:
        raise RuntimeError(
            "operator stats collection is already enabled; nested "
            "collect_operator_stats would silently discard the outer "
            "scope's counts")
    _stats = _OperatorStats()
    _stats.__enter__()


def disable_operator_stats_collection() -> Dict[str, Dict[str, int]]:
    """Stop collecting, print the table (as upstream does) and return
    the counts."""
    global _stats
    if _stats is None:
        return {}
    mode, _stats = _stats, None
    mode.__exit__(None, None, None)
    _print_table(mode.stats)
    return mode.stats


def _print_table(stats: Dict[str, Dict[str, int]]) -> None:
    print("<------------------------------ op list "
          "------------------------------->")
    print(f"{'op':<28}" + "".join(f"{b:>8}" for b in _BUCKETS))
    for op in sorted(stats):
        row = stats[op]
        print(f"{op:<28}" + "".join(f"{row[b]:>8}" for b in _BUCKETS))
    print("<----------------------------------- end "
          "----------------------------->")


@contextlib.contextmanager
def collect_operator_stats():
    """Context form: prints the operator/dtype table on exit."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode=None):
    """``(num_nan, num_inf)`` of ``tensor`` as int64 tensors; raises
    ``FloatingPointError`` naming ``op_type`` and ``var_name`` when
    either is nonzero (a host read, skipped while a CUDA graph
    captures)."""
    t = torch.as_tensor(tensor)
    if not (t.is_floating_point() or t.is_complex()):
        z = torch.zeros((), dtype=torch.int64, device=t.device)
        return z, z.clone()
    num_nan = torch.isnan(t).sum().to(torch.int64)
    num_inf = torch.isinf(t).sum().to(torch.int64)
    capturing = t.is_cuda and torch.cuda.is_current_stream_capturing()
    if not capturing:
        n_nan, n_inf = int(num_nan), int(num_inf)
        if n_nan or n_inf:
            raise FloatingPointError(
                f"check_numerics: op={op_type!r} var={var_name!r} has "
                f"{n_nan} NaN and {n_inf} Inf values "
                f"(shape {tuple(t.shape)}, dtype {t.dtype})")
    return num_nan, num_inf


class TensorCheckerConfig:
    """``enable`` turns the per-operator inf/NaN scan on;
    ``debug_mode`` and ``output_dir`` are accepted for scripts' sake."""

    def __init__(self, enable: bool = True, debug_mode=None,
                 output_dir: Optional[str] = None, **kwargs):
        self.enable = bool(enable)
        self.debug_mode = debug_mode
        self.output_dir = output_dir


def enable_tensor_checker(config: TensorCheckerConfig) -> None:
    """Scan every operator's outputs for inf/NaN until
    :func:`disable_tensor_checker` (if ``config.enable``)."""
    global _checker
    disable_tensor_checker()
    if config.enable:
        _checker = _TensorChecker()
        _checker.__enter__()


def disable_tensor_checker() -> None:
    global _checker
    if _checker is not None:
        mode, _checker = _checker, None
        mode.__exit__(None, None, None)


def compare_accuracy(run_a, run_b, output_filename: Optional[str] = None,
                     atol: int = 0) -> Dict[str, Dict]:
    """The operators whose calls per dtype differ by more than ``atol``
    between two collections (the dicts
    :func:`disable_operator_stats_collection` returns, or paths to JSON
    dumps of them): ``{op: {"a": counts, "b": counts}}``, written as JSON
    to ``output_filename`` if given."""
    def _load(r):
        if isinstance(r, str):
            with open(r) as f:
                return json.load(f)
        return r

    a, b = _load(run_a), _load(run_b)
    diff = {}
    for op in sorted(set(a) | set(b)):
        ra = a.get(op, {k: 0 for k in _BUCKETS})
        rb = b.get(op, {k: 0 for k in _BUCKETS})
        if any(abs(ra.get(k, 0) - rb.get(k, 0)) > atol for k in _BUCKETS):
            diff[op] = {"a": ra, "b": rb}
    if output_filename:
        with open(output_filename, "w") as f:
            json.dump(diff, f, indent=1, sort_keys=True)
    return diff
