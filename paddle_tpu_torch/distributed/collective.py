"""The registry of the hybrid groups and ``split`` (counterpart of
``paddle_tpu/distributed/collective.py``).

The JAX package registers one ``jax.sharding.Mesh``; the port registers
the ``HybridCommunicateGroup`` that ``fleet.init`` built (its process
group per axis slice), under the same names: ``set_mesh`` /
``get_mesh``.  ``AXIS_ORDER`` is the JAX mesh's axis order; the
topology's row-major rank layout follows it (``data, pipe, sharding,
sep, model``; ``model`` innermost).
"""

from __future__ import annotations

from typing import Optional

AXIS_ORDER = ("pp", "dp", "sharding", "sep", "mp")

_GLOBAL_MESH = None


def set_mesh(mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh() -> Optional[object]:
    return _GLOBAL_MESH


def model_parallel_degree() -> int:
    """The mp degree of the registered groups (1 without them)."""
    hcg = _GLOBAL_MESH
    return hcg.get_model_parallel_world_size() if hcg is not None else 1


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split``: a Megatron parallel linear or
    embedding layer built on the mp group and applied to ``x``."""
    from .fleet.meta_parallel import (ColumnParallelLinear,
                                      RowParallelLinear,
                                      VocabParallelEmbedding)
    device = x.device if hasattr(x, "device") else None
    if operation == "linear":
        if axis == 0:
            return RowParallelLinear(size[0], size[1],
                                     weight_attr=weight_attr,
                                     has_bias=bias_attr is not False,
                                     device=device)(x)
        return ColumnParallelLinear(size[0], size[1],
                                    weight_attr=weight_attr,
                                    gather_output=gather_out,
                                    has_bias=bias_attr is not False,
                                    device=device)(x)
    if operation == "embedding":
        return VocabParallelEmbedding(size[0], size[1],
                                      weight_attr=weight_attr,
                                      device=device)(x)
    raise ValueError(f"unknown operation {operation}")
