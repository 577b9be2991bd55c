"""Operators of the port: the kernels whose TPU form was a Pallas kernel
(flash attention, the fused lm-head cross-entropy), and the op catalogue
(counterpart of ``paddle_tpu/ops/__init__.py``).

The catalogue: ``creation``, ``math``, ``manipulation``, ``logic``,
``linalg``, ``array_ops``, the activations and the ``nn_ops`` functions
the JAX package exports at its top level.  Their modules hold torch
functions; ``OP_TABLE`` holds each one's ``Tensor``-level form
(``_primitive``), and this package exports those under the op names
(``ops.add``, ``ops.reshape``, ...), as the top level does.  Tensor
methods (``x.sum()``, ``x.reshape(...)``) are attached here, with the
in-place ``op_`` forms, as the JAX package attaches them.
"""

from . import (_primitive, activation, array_ops, creation, linalg, logic,
               manipulation, math, nn_ops)
from ._primitive import (OP_TABLE, apply_closure, boundary,  # noqa: F401
                         primitive, unwrap)
from .array_ops import (TensorArray, array_length, array_read,  # noqa: F401
                        array_write, create_array)
from .flash_attention_kernel import (FlashAttnFunc, flash_attention_reference,
                                     flash_bwd_dkv, flash_bwd_dq,
                                     flash_bwd_fused, flash_fwd,
                                     flash_fwd_hpack)
from .lmce_kernel import (FusedLinearCrossEntropy, fused_linear_cross_entropy,
                          lmce_bwd_dh, lmce_bwd_dw, lmce_fwd, lmce_reference)
from .. import tensor as _tensor

# the nn functions the JAX package's ops export at its top level
NN_OPS = (
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "affine_grid", "avg_pool1d", "avg_pool2d", "avg_pool3d", "bilinear",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "channel_shuffle", "conv1d", "conv1d_transpose", "conv2d",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "cosine_similarity",
    "cross_entropy", "ctc_loss", "embedding", "fold", "gaussian_nll_loss",
    "grid_sample", "group_norm", "hinge_embedding_loss", "huber_loss",
    "instance_norm", "interpolate", "kl_div", "l1_loss", "layer_norm",
    "linear", "local_response_norm", "margin_ranking_loss", "max_pool1d",
    "max_pool2d", "max_pool3d", "max_unpool1d", "max_unpool2d",
    "max_unpool3d", "mse_loss", "multi_label_soft_margin_loss",
    "multi_margin_loss", "nll_loss", "pairwise_distance", "pixel_shuffle",
    "pixel_unshuffle", "poisson_nll_loss", "rms_norm",
    "scaled_dot_product_attention", "smooth_l1_loss", "soft_margin_loss",
    "square_error_cost", "temporal_shift", "triplet_margin_loss",
    "dropout", "alpha_dropout", "dropout2d", "dropout3d",
    "cosine_embedding_loss", "softmax_with_cross_entropy",
    "triplet_margin_with_distance_loss", "upsample")
for _n in activation.TOP_LEVEL:
    primitive(getattr(activation, _n), name=_n)
for _n in NN_OPS:
    primitive(getattr(nn_ops, _n), name=_n)

globals().update(OP_TABLE)
_tensor._OPS.update(OP_TABLE)
broadcast_shape = manipulation.broadcast_shape
tolist = manipulation.tolist

# ---------------------------------------------------------------------------
# Tensor methods (the JAX package's list)
# ---------------------------------------------------------------------------
_METHOD_OPS = [
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "maximum", "minimum", "abs", "neg", "sign", "sqrt",
    "rsqrt", "square", "exp", "log", "log2", "log10", "log1p", "sin",
    "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "floor",
    "ceil", "round", "trunc", "reciprocal", "erf", "clip", "lerp",
    "scale", "increment",
    # reductions
    "sum", "mean", "max", "min", "prod", "std", "var", "argmax", "argmin",
    "cumsum", "cumprod", "logsumexp", "all", "any", "median", "topk",
    "sort", "argsort", "count_nonzero", "nansum", "nanmean", "kthvalue",
    # manipulation
    "reshape", "transpose", "flatten", "squeeze", "unsqueeze", "tile",
    "expand", "expand_as", "broadcast_to", "flip", "roll", "gather",
    "gather_nd", "scatter", "index_select", "masked_fill", "split",
    "chunk", "unbind", "repeat_interleave", "take_along_axis",
    "put_along_axis", "moveaxis", "swapaxes", "pad", "unique", "nonzero",
    "masked_select", "tolist", "diagonal", "tril", "triu",
    # linalg
    "matmul", "mm", "bmm", "dot", "norm", "dist", "trace", "inverse",
    "cholesky", "t",
    # logic
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "allclose", "isclose", "equal_all", "isnan", "isinf",
    "isfinite",
    # creation-ish
    "zeros_like", "ones_like", "full_like",
    # round-5 widening
    "sgn", "sinc", "gammaln", "digamma", "lgamma", "i0", "i1", "i0e",
    "i1e", "positive", "isreal", "isneginf", "isposinf", "pdist",
    "view_as", "slice_scatter", "select_scatter", "diagonal_scatter",
    "hsplit", "vsplit", "dsplit",
    # method-parity batch
    "addmm", "amax", "amin", "angle", "bincount", "bucketize", "conj",
    "copysign", "corrcoef", "cov", "cross", "cummax", "cummin",
    "deg2rad", "diff", "erfinv", "expm1", "frac", "frexp", "gcd",
    "heaviside", "histogram", "hypot", "imag", "index_add",
    "index_fill", "index_put", "inner", "kron", "lcm", "ldexp",
    "logaddexp", "logcumsumexp", "logit", "masked_scatter", "mode",
    "multigammaln", "nanmedian", "nanquantile", "nextafter", "outer",
    "quantile", "rad2deg", "real", "renorm", "searchsorted", "vander",
    "where",
]

for _name in _METHOD_OPS:
    if _name in OP_TABLE and not hasattr(_tensor.Tensor, _name):
        setattr(_tensor.Tensor, _name, OP_TABLE[_name])

# in-place forms: the op out of place, then the buffer swap
_INPLACE_OPS = ["add", "subtract", "multiply", "divide", "clip", "scale",
                "floor", "ceil", "exp", "sqrt", "rsqrt", "reciprocal",
                "round", "remainder", "tanh", "squeeze", "unsqueeze",
                "reshape", "flatten"]


def _make_inplace(op_name):
    fn = OP_TABLE[op_name]

    def method(self, *args, **kwargs):
        self._swap(fn(self, *args, **kwargs)._value)
        return self

    method.__name__ = op_name + "_"
    return method


for _name in _INPLACE_OPS:
    setattr(_tensor.Tensor, _name + "_", _make_inplace(_name))


def _uniform_(self, min=-1.0, max=1.0, seed=0):
    v = self._value
    gen = None
    if seed:
        import torch
        gen = torch.Generator(device=v.device)
        gen.manual_seed(int(seed))
    else:
        from ..framework.random import default_generator
        gen = default_generator(v.device)
    self._swap(v.detach().clone().uniform_(float(min), float(max),
                                           generator=gen))
    return self


def _normal_(self, mean=0.0, std=1.0):
    from ..framework.random import default_generator
    v = self._value
    self._swap(v.detach().clone().normal_(float(mean), float(std),
                                          generator=default_generator(
                                              v.device)))
    return self


_tensor.Tensor.uniform_ = _uniform_
_tensor.Tensor.normal_ = _normal_

__all__ = ["FlashAttnFunc", "flash_attention_reference", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_hpack",
           "flash_bwd_fused", "FusedLinearCrossEntropy",
           "fused_linear_cross_entropy", "lmce_reference", "lmce_fwd",
           "lmce_bwd_dh", "lmce_bwd_dw", "OP_TABLE", "TensorArray",
           "create_array", "array_write", "array_read", "array_length"]
