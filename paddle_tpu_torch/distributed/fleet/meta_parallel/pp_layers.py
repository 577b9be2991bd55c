"""Pipeline layer description (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``; upstream
``fleet/meta_parallel/parallel_layers/pp_layers.py``: ``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer``).

The segmentation is the JAX package's, bound for bound
(``segment_parts``): ``seg_method="layer:<name>"`` splits the items
whose class name holds ``<name>`` evenly over the stages, ``"uniform"``
cuts the item list into ``ceil(n / stages)`` runs.  Where the JAX layer
builds every item in its one process, a rank of the port builds only
its own stage's items: under a registered topology whose pipe degree is
``num_stages`` this rank's stage (``hcg.get_stage_id()``), else every
item (one process, or pp 1).  A 1.3B model is never whole on a rank.

The items of other stages stay ``None`` in ``run_function``.  Built
layers sit in ``_layers_list`` under their index among the built items
of the whole list (the JAX ``LayerList`` index), so a stage's parameter
names are those of the JAX model's state dict.

Weights shared between stages (a ``SharedLayerDesc`` key on two stages,
or a tie a model registers with :meth:`PipelineLayer._register_tie`)
live once per holding stage; the pipeline engine starts the copies from
the first holder and sums their gradients each step
(``pipeline_parallel.PipelineParallel``).

``forward`` is the inline run of every item (pp 1), with
``recompute_interval``.  ``num_virtual_pipeline_stages`` is accepted and
not stored, as in the JAX layer: the interleaved schedule is the
function ``pipeline_parallel.pipeline_spmd_interleaved``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ....nn.layer import Layer


class LayerDesc:
    def __init__(self, layer_func: Callable, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self) -> Layer:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({getattr(self.layer_func, '__name__', '?')})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _item_name(d) -> Optional[str]:
    """The class name the ``layer:`` segmentation matches (None for a
    plain callable, which the JAX segmentation never matches)."""
    if isinstance(d, LayerDesc):
        f = d.layer_func
        return f.__name__ if isinstance(f, type) else \
            getattr(f, "__name__", None)
    if isinstance(d, torch.nn.Module):
        return type(d).__name__
    return None


def segment_bounds(names, num_stages: int, seg_method: str):
    """The JAX ``PipelineLayer._segment`` on the items' class names
    (``None`` for a plain callable)."""
    n = len(names)
    P = num_stages
    if seg_method.startswith("layer:"):
        pat = seg_method.split("layer:", 1)[1]
        idx = [i for i, name in enumerate(names)
               if name is not None and pat in name]
        per = max(len(idx) // P, 1)
        bounds = [0]
        for s in range(1, P):
            k = min(s * per, len(idx) - 1)
            bounds.append(idx[k] if k < len(idx) else n)
        bounds.append(n)
    else:
        per = (n + P - 1) // P
        bounds = [min(i * per, n) for i in range(P)] + [n]
    return bounds


def _pipe_stage(num_stages: int) -> Optional[int]:
    """This rank's stage under the registered topology, or None when this
    process builds every item."""
    if num_stages <= 1:
        return None
    from ... import collective as coll
    hcg = coll.get_mesh()
    if hcg is None or hcg.get_pipe_parallel_world_size() == 1:
        return None
    if hcg.get_pipe_parallel_world_size() != num_stages:
        raise ValueError(
            f"PipelineLayer(num_stages={num_stages}) under a topology with "
            f"pp degree {hcg.get_pipe_parallel_world_size()}")
    return hcg.get_stage_id()


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._topology = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._seg_method = seg_method
        self._descs = list(layers)
        self._segment()
        self._stage = _pipe_stage(self._num_stages)
        lo, hi = self.stage_range()

        built: List[Optional[Layer]] = []
        self._funcs: List[Optional[Callable]] = []
        self._layers_list = torch.nn.ModuleDict()
        shared = {}
        self._ties = {}
        index = 0
        for i, d in enumerate(self._descs):
            mine = lo <= i < hi
            if isinstance(d, (LayerDesc, torch.nn.Module)):
                layer = None
                if mine:
                    if isinstance(d, SharedLayerDesc):
                        if d.layer_name not in shared:
                            shared[d.layer_name] = d.build_layer()
                        layer = shared[d.layer_name]
                    elif isinstance(d, LayerDesc):
                        layer = d.build_layer()
                    else:
                        layer = d
                    self._layers_list[str(index)] = layer
                built.append(layer)
                self._funcs.append(d.forward_func
                                   if isinstance(d, SharedLayerDesc)
                                   else None)
                index += 1
            else:  # a plain callable (e.g. a reshape)
                built.append(None)
                self._funcs.append(d)
        self.run_function = built
        self._shared_ties(shared)

    # -- segmentation --------------------------------------------------------
    def _segment(self):
        names = [_item_name(d) for d in self._descs]
        self.segment_parts = segment_bounds(names, self._num_stages,
                                            self._seg_method)

    def stage_of(self, i: int) -> int:
        """The stage that runs item ``i``."""
        for s in range(self._num_stages):
            if self.segment_parts[s] <= i < self.segment_parts[s + 1]:
                return s
        raise IndexError(i)

    def stage_range(self):
        """``[lo, hi)`` of the items this process built."""
        if self._stage is None:
            return 0, len(self._descs)
        return (self.segment_parts[self._stage],
                self.segment_parts[self._stage + 1])

    def get_stage_layers(self, stage_id: int):
        lo, hi = self.segment_parts[stage_id], \
            self.segment_parts[stage_id + 1]
        return list(zip(self.run_function[lo:hi], self._funcs[lo:hi]))

    # -- weights shared between stages ----------------------------------------
    def _shared_ties(self, shared):
        if self._stage is None:
            return
        stages = {}
        for i, d in enumerate(self._descs):
            if isinstance(d, SharedLayerDesc):
                stages.setdefault(d.layer_name, (d, set()))[1].add(
                    self.stage_of(i))
        for key, (d, where) in stages.items():
            if len(where) > 1:
                layer = shared.get(key)
                self._register_tie(key, sorted(where), None if layer is None
                                   else getattr(layer, d.shared_weight_attr))

    def _register_tie(self, key, stages, param):
        """Weight ``key`` lives on each stage of ``stages``; ``param`` is
        this rank's copy (None where this rank holds none)."""
        self._ties[key] = (list(stages), param)

    def tied_weights(self):
        """``{key: (stages, this rank's copy or None)}``."""
        return dict(self._ties)

    # -- the inline run ------------------------------------------------------
    def _run_items(self, x, lo, hi, interval=0):
        for i in range(lo, hi):
            layer, fn = self.run_function[i], self._funcs[i]
            item = layer if layer is not None else fn
            if interval > 0 and layer is not None and i % interval == 0:
                from ..recompute import recompute
                x = recompute(item, x) if not isinstance(x, tuple) \
                    else recompute(item, *x)
            elif fn is not None and layer is not None:
                x = fn(layer, x)
            elif layer is not None:
                x = layer(x) if not isinstance(x, tuple) else layer(*x)
            else:
                x = fn(x) if not isinstance(x, tuple) else fn(*x)
        return x

    def forward(self, x):
        """Inline execution of every item (pp 1)."""
        if self._stage is not None:
            raise RuntimeError(
                "this rank holds one pipeline stage; run the model through "
                "fleet.distributed_model(...).train_batch / eval_batch")
        return self._run_items(x, 0, len(self._descs),
                               self._recompute_interval)
