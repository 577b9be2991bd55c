"""``paddle.summary`` and ``paddle.flops`` (counterpart of
``paddle_tpu/hapi/summary.py``): the parameter table and count, and a
multiply-add count of the port's ``Conv2D`` and ``Linear`` layers taken
by forward hooks.  Both return the JAX package's integers."""

from __future__ import annotations

import numpy as np
import torch


def summary(net: torch.nn.Module, input_size=None, dtypes=None, input=None):
    """Print the parameters (name, shape, count) and return
    ``{"total_params", "trainable_params"}``; a parameter is trainable
    when it requires a gradient."""
    total_params = 0
    trainable = 0
    rows = []
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total_params += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    print("-" * (width + 30))
    print(f"{'Param':<{width}}{'Shape':<20}{'Count':>10}")
    print("-" * (width + 30))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<20}{n:>10}")
    print("-" * (width + 30))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total_params - trainable:,}")
    return {"total_params": total_params, "trainable_params": trainable}


def flops(net: torch.nn.Module, input_size, custom_ops=None,
          print_detail=False) -> int:
    """Multiply-adds of one forward of a zero input of ``input_size``
    (in eval mode, on the network's device): a ``Conv2D`` counts its
    weight's elements times its output positions, a ``Linear`` its
    weight's elements times its output rows.  ``custom_ops`` maps layer
    classes to ``fn(layer, inputs, output) -> count``, and wins over the
    built-in counts."""
    from .. import nn

    custom_ops = custom_ops or {}
    counts = {"total": 0}
    hooks = []

    def conv_hook(layer, inputs, output):
        out_elems = int(np.prod(output.shape[2:])) * output.shape[0]
        counts["total"] += int(np.prod(layer.weight.shape)) * out_elems

    def linear_hook(layer, inputs, output):
        batch = int(np.prod(output.shape[:-1]))
        counts["total"] += int(np.prod(layer.weight.shape)) * batch

    def custom_hook(fn):
        def hook(layer, inputs, output):
            counts["total"] += int(fn(layer, inputs, output))
        return hook

    for layer in net.modules():
        fn = next((f for cls, f in custom_ops.items()
                   if isinstance(layer, cls)), None)
        if fn is not None:
            hooks.append(layer.register_forward_hook(custom_hook(fn)))
        elif isinstance(layer, nn.Conv2D):
            hooks.append(layer.register_forward_hook(conv_hook))
        elif isinstance(layer, nn.Linear):
            hooks.append(layer.register_forward_hook(linear_hook))
    was_training = net.training
    net.eval()
    try:
        device = next(net.parameters()).device
        with torch.no_grad():
            net(torch.zeros(input_size, dtype=torch.float32, device=device))
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()
    total = counts["total"]
    if print_detail:
        print(f"Total FLOPs: {total}")
    return total
