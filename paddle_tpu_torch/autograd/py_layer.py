"""``PyLayer``: autograd ops written in Python (counterpart of
``paddle_tpu/autograd/py_layer.py``), over ``torch.autograd.Function``.

A subclass defines static ``forward(ctx, *args)`` and ``backward(ctx,
*grads)`` on ``Tensor`` s; ``backward`` returns one gradient for each
tensor argument of ``forward``, in order (None for one that needs
none).  ``apply`` runs ``forward`` inside a ``torch.autograd.Function``
(so with recording off, as the tape runs it atomically) and calls the
user's ``backward`` from the Function's.
"""

from __future__ import annotations

import torch

from ..tensor import _wrap, unwrap


class PyLayerContext:
    def __init__(self):
        self._saved = []
        self.non_differentiable = []
        self.needs_input_grad = ()

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved

    def mark_non_differentiable(self, *tensors):
        self.non_differentiable.extend(tensors)


class _PyLayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cls, kwargs, *vals):
        pctx = PyLayerContext()
        ctx.pctx, ctx.cls = pctx, cls
        ctx.is_tensor = [isinstance(v, torch.Tensor) for v in vals]
        args = [_wrap(v) if isinstance(v, torch.Tensor) else v for v in vals]
        outs = cls.forward(pctx, *args, **kwargs)
        ctx.multi = isinstance(outs, (tuple, list))
        raw = [unwrap(o) for o in (outs if ctx.multi else (outs,))]
        nd = [unwrap(t) for t in pctx.non_differentiable]
        if nd:
            ctx.mark_non_differentiable(*nd)
        return tuple(raw) if ctx.multi else raw[0]

    @staticmethod
    def backward(ctx, *grads):
        gs = [None if g is None else _wrap(g) for g in grads]
        res = ctx.cls.backward(ctx.pctx, *gs)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        res = list(res)
        out = [None, None]
        for is_t in ctx.is_tensor:
            r = res.pop(0) if is_t and res else None
            out.append(None if r is None or not is_t else unwrap(r))
        return tuple(out)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        vals = [unwrap(a) for a in args]
        out = _PyLayerFunction.apply(cls, kwargs, *vals)
        if isinstance(out, tuple):
            return tuple(_wrap(o) if isinstance(o, torch.Tensor) else o
                         for o in out)
        return _wrap(out)


__all__ = ["PyLayer", "PyLayerContext"]
