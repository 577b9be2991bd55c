"""Registry of every ``PADDLE_TORCH_*`` environment knob the port reads
(counterpart of ``paddle_tpu/framework/env_knobs.py``, of which it keeps
its own copy: it imports nothing of the JAX package).

One table owns each knob's name, default, kind and one-line doc; a read
of an unregistered name raises ``KeyError``, and only knobs that the
port reads are registered.  Print the table with ``python -c "from
paddle_tpu_torch.framework import env_knobs; print(env_knobs.
render_table())"``.

Booleans parse strictly: ``1``, ``true``, ``yes`` and ``on`` (any case)
are on, anything else is off.  (The JAX package reads its flash flags
with ``get_raw``, so there any non-empty value, even ``"0"``, is on.)
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional

PREFIX = "PADDLE_TORCH_"


class Knob(NamedTuple):
    name: str      # full variable name, PADDLE_TORCH_ prefix included
    default: str   # documented default
    kind: str      # bool | int | float | str — how consumers parse it
    doc: str       # one line


KNOBS: Dict[str, Knob] = {}


def _k(name: str, default: str, kind: str, doc: str) -> None:
    assert name.startswith(PREFIX), name
    assert name not in KNOBS, name
    KNOBS[name] = Knob(name, default, kind, doc)


# -- flash attention (nn/functional/flash_attention.py) ---------------------
_k("PADDLE_TORCH_FLASH_NO_PACKED", "off", "bool",
   "Run flash attention on contiguous [B*H, S, D] copies instead of the "
   "strided [B, S, H, D] views (PADDLE_TPU_FLASH_NO_PACKED).")
_k("PADDLE_TORCH_FLASH_HEADPACK", "1", "int",
   "Under NO_PACKED: heads per CTA of the forward (flash_fwd_hpack) when "
   "> 1, B*H divides by it, head dim <= 64 and no segment ids.")
_k("PADDLE_TORCH_FLASH_FUSED_BWD", "off", "bool",
   "Under NO_PACKED: the single-sweep backward (flash_bwd_fused) instead "
   "of the split dq and dk/dv kernels.")

# -- step folding (framework/dispatch.py) ------------------------------------
_k("PADDLE_TORCH_FOLD_MAX", "32", "int",
   "Upper bound on the fold factor K that fit's auto-tuner picks "
   "(PADDLE_TPU_FOLD_MAX).")
_k("PADDLE_TORCH_FOLD_OVERHEAD_TARGET", "0.05", "float",
   "Host time a step may take, as a share of its device time, before "
   "the auto-tuner folds more steps a group (PADDLE_TPU_FOLD_OVERHEAD_"
   "TARGET).")
_k("PADDLE_TORCH_FOLD_CALIB_GROUPS", "3", "int",
   "Groups the auto-tuner measures at K=1, after the first, before it "
   "decides (PADDLE_TPU_FOLD_CALIB_GROUPS).")

# -- serving (inference/serving/engine.py) -----------------------------------
_k("PADDLE_TORCH_PREFILL_CHUNK", "unset", "int",
   "DecodeEngine's default prefill_chunk: admit prompts longer than this "
   "many tokens (a block multiple) one chunk per engine step; unset, "
   "blank or <= 0 is off (PADDLE_TPU_PREFILL_CHUNK).")
_k("PADDLE_TORCH_PREFIX_CACHE", "off", "bool",
   "DecodeEngine's default prefix_cache: share the K/V of full prompt "
   "blocks between requests (PADDLE_TPU_PREFIX_CACHE).")
_k("PADDLE_TORCH_SERVING_POLL_TARGET", "0.05", "float",
   "The auto-tuned done-poll cadence's bound on a poll's cost as a share "
   "of the dispatches it spans (PADDLE_TPU_SERVING_POLL_TARGET).")
_k("PADDLE_TORCH_SERVING_POLL_MAX", "64", "int",
   "Largest done-poll interval, in decode dispatches, the auto-tuner "
   "picks (PADDLE_TPU_SERVING_POLL_MAX).")
_k("PADDLE_TORCH_SERVING_POLL_CALIB", "3", "int",
   "Polls the done-poll auto-tuner measures, after the first, before it "
   "decides (PADDLE_TPU_SERVING_POLL_CALIB).")
_k("PADDLE_TORCH_SPEC_K", "4", "int",
   "DecodeEngine's default spec_k: draft tokens proposed per speculative "
   "decode dispatch, used only when the engine is given a draft "
   "(PADDLE_TPU_SPEC_K).")

# -- observability (observability/) ------------------------------------------
_k("PADDLE_TORCH_TRACE", "off", "bool",
   "Arm the span recorder when paddle_tpu_torch.observability is imported "
   "(PADDLE_TPU_TRACE).")
_k("PADDLE_TORCH_TRACE_CAPACITY", "65536", "int",
   "Events the span recorder's ring keeps when PADDLE_TORCH_TRACE arms "
   "it; <= 0 keeps the default (PADDLE_TPU_TRACE_CAPACITY).")
_k("PADDLE_TORCH_EVENTS_CAPACITY", "256", "int",
   "Control-loop decisions the event ring keeps; <= 0 keeps the default "
   "(PADDLE_TPU_EVENTS_CAPACITY).")

# -- fault injection (distributed/resilience/faults.py) ----------------------
_k("PADDLE_TORCH_FAULT_PLAN", "unset", "str",
   "A fault plan as JSON, or @path to a JSON file, installed the first "
   "time a fault site is consulted (PADDLE_FAULT_PLAN).")

_TRUTHY = ("1", "true", "yes", "on")


def get_raw(name: str, default=None, env=None) -> Optional[str]:
    """The raw value of a registered knob, or ``default``.  ``env`` is
    an optional mapping standing in for ``os.environ``.  Unregistered
    names raise ``KeyError``."""
    if name not in KNOBS:
        raise KeyError(f"{name} is not a registered {PREFIX}* knob; add it "
                       "to paddle_tpu_torch/framework/env_knobs.py")
    src = os.environ if env is None else env
    val = src.get(name)
    return default if val is None else val


def get_bool(name: str, default: bool = False, env=None) -> bool:
    """Strict truthy parse: {1, true, yes, on} (case-insensitive); unset
    or blank gives ``default``."""
    raw = get_raw(name, env=env)
    if raw is None or not str(raw).strip():
        return default
    return str(raw).strip().lower() in _TRUTHY


def get_int(name: str, default: int = 0, env=None) -> int:
    """Integer value; unset, blank or malformed gives ``default``."""
    try:
        return int(get_raw(name, env=env) or default)
    except ValueError:
        return default


def get_float(name: str, default: float = 0.0, env=None) -> float:
    """Float value; unset, blank or malformed gives ``default``."""
    try:
        return float(get_raw(name, env=env) or default)
    except ValueError:
        return default


def render_table() -> str:
    """The knobs as a markdown table."""
    rows = ["| Variable | Default | Description |",
            "| --- | --- | --- |"]
    for knob in KNOBS.values():
        rows.append(f"| `{knob.name}` | {knob.default} | {knob.doc} |")
    return "\n".join(rows) + "\n"
