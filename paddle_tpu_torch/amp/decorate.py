"""``amp.decorate`` (counterpart of ``paddle_tpu/amp/decorate.py``).

Level O2 casts the model's floating parameters to bf16 (or fp16) in
place, except those of LayerNorm/BatchNorm layers and of
``excluded_layers``, and switches the optimizers to fp32 master
weights.  Level O1 changes nothing here, as in the JAX package (O1 is
``auto_cast``'s per-op casting, not ported yet).
"""

from __future__ import annotations

import torch

from ..nn.norm import LayerNorm

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}
_KEEP_FP32 = (LayerNorm, torch.nn.LayerNorm,
              torch.nn.modules.batchnorm._BatchNorm)


def decorate(models, optimizers=None, level="O1", dtype="float16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        if dtype not in _DTYPES:
            raise ValueError(f"O2 dtype must be bfloat16 or float16, got "
                             f"{dtype!r}")
        target = _DTYPES[dtype]
        excluded = set()
        exc = excluded_layers or []
        exc = exc if isinstance(exc, (list, tuple)) else [exc]
        for e in exc:
            if isinstance(e, type):
                excluded |= {id(m) for model in model_list
                             for m in model.modules() if isinstance(m, e)}
            else:
                excluded.add(id(e))
        for model in model_list:
            for m in model.modules():
                if isinstance(m, _KEEP_FP32) or id(m) in excluded:
                    continue
                for p in m.parameters(recurse=False):
                    if p.is_floating_point():
                        p.data = p.data.to(target)
        if optimizers is not None:
            opt_list = (list(optimizers)
                        if isinstance(optimizers, (list, tuple))
                        else [optimizers])
            for o in opt_list:
                o._multi_precision = (True if master_weight is None
                                      else bool(master_weight))
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers

