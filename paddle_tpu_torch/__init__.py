"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port lives beside the JAX package and mirrors its module paths, so
each module here has a counterpart of the same name there.  It imports
``torch``, ``numpy`` and the standard library only.  Kernels that the
JAX package wrote in Pallas are hand-written CUDA C++ for Hopper
(``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use into the
git-ignored ``_build/`` directory (``_build.py``).

Device rule: entry points run on the card unless the caller asks for
the CPU.  :func:`resolve_device` is the one place that rule lives.

Training (``hapi.Model.fit``)::

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny)
    paddle.seed(0)
    net = GPTForCausalLM(gpt_tiny(), device="cuda")
    opt = paddle.optimizer.AdamW(1e-4, parameters=net.parameters())
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, GPTPretrainingCriterion())
    model.fit(batches, epochs=1, verbose=1)   # batches: [(ids, labels)]

Vision (``vision.models``: ResNet-50 ImageNet training as ``bench.py``
runs it, bf16 O2 with fp32 masters, Momentum, BatchNorm)::

    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=1000)                 # on the card
    opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=net.parameters(),
                                    multi_precision=True)
    paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    model = paddle.Model(net)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    model.fit(batches, epochs=1)   # batches: [(images [64, 3, 224, 224],
                                   #            labels [64])]

LeNet on MNIST with metrics, evaluation and checkpoints
(``BASELINE.json:7``; the datasets fall back to synthetic digits)::

    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    loader = DataLoader(MNIST(mode="train"), batch_size=64, shuffle=True,
                        drop_last=True, num_workers=4)
    model = paddle.Model(LeNet())
    model.prepare(paddle.optimizer.Adam(1e-3,
                                        parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), Accuracy())
    model.fit(loader, epochs=1, verbose=0)
    print(model.evaluate(MNIST(mode="test"), batch_size=64, verbose=0))
    model.save("ckpt/lenet")          # lenet.pdparams, lenet.pdopt
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "Model", "seed", "LazyGuard", "amp",
           "optimizer",
           "regularizer", "nn",
           "io", "vision", "metric", "callbacks", "save", "load",
           "summary", "flops", "SelectedRows"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the current place (``set_device``): ``"cuda"``
    unless ``set_device("cpu")`` asked for the CPU.  A CUDA device
    without a card raises: the port never carries on on the CPU unless
    the CPU was asked for explicitly."""
    if device is None:
        from .places import _expected_place
        device = ("cpu" if _expected_place().is_cpu_place()
                  else f"cuda:{_expected_place().get_device_id()}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# submodules import resolve_device, so they load after it is defined
from . import (amp, callbacks, io, metric, nn, optimizer,  # noqa: E402
               regularizer, vision)
from .framework.io import load, save  # noqa: E402
from .framework.random import seed  # noqa: E402
from .framework.selected_rows import SelectedRows  # noqa: E402
from .hapi import Model  # noqa: E402
from .hapi.summary import flops, summary  # noqa: E402
from .nn.layer import LazyGuard  # noqa: E402

# -- the Paddle Tensor, the op catalogue and dygraph autograd ----------------
from . import autograd, device, linalg, ops  # noqa: E402
from .autograd import (PyLayer, enable_grad, grad,  # noqa: E402
                       is_grad_enabled, no_grad, set_grad_enabled)
from .framework.dtype import (DType, finfo, get_default_dtype,  # noqa: E402
                              iinfo, set_default_dtype)
from .framework.dtype import bool_ as bool  # noqa: E402,A001
from .framework.dtype import (bfloat16, complex64, complex128,  # noqa: E402
                              float8_e4m3fn, float8_e5m2, float16, float32,
                              float64, int8, int16, int32, int64, uint8)
from .nn.param_attr import ParamAttr  # noqa: E402
from .ops._primitive import OP_TABLE, get_flags, set_flags  # noqa: E402
from .ops.array_ops import (TensorArray, array_length,  # noqa: E402
                            array_read, array_write, create_array)
from .places import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: E402
                     CustomPlace, TPUPlace, XPUPlace, device_count,
                     get_device, is_compiled_with_cuda,
                     is_compiled_with_rocm, is_compiled_with_tpu,
                     is_compiled_with_xpu, set_device)
from .tensor import Parameter, Tensor, is_tensor, to_tensor  # noqa: E402

# -- the process world, collectives and Fleet (distributed/) -------------------
from . import distributed  # noqa: E402
from .distributed import DataParallel  # noqa: E402

# every op of the catalogue is also a paddle.* function
globals().update(OP_TABLE)
broadcast_shape = ops.broadcast_shape
tolist = ops.tolist


from .framework.random import (get_cuda_rng_state,  # noqa: E402
                               get_rng_state, set_cuda_rng_state,
                               set_rng_state)
from .ops._primitive import apply_closure, primitive, unwrap  # noqa: E402


def in_dynamic_mode() -> bool:
    """The port has the dygraph mode only (static graphs: ROADMAP A12)."""
    return True


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return True


def disable_signal_handler():
    """Paddle detaches its C++ signal handlers; the port installs none."""


def batch(reader, batch_size, drop_last=False):
    """The legacy ``paddle.batch`` reader decorator: a sample reader
    grouped into batches of ``batch_size``."""
    if int(batch_size) <= 0:
        raise ValueError(
            f"batch_size should be a positive integer, got {batch_size}")

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


__all__ += ["Tensor", "Parameter", "to_tensor", "is_tensor", "autograd",
            "device", "linalg", "ops", "no_grad", "enable_grad", "grad",
            "is_grad_enabled", "set_grad_enabled", "PyLayer", "DType",
            "set_default_dtype", "get_default_dtype", "finfo", "iinfo",
            "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
            "XPUPlace", "CustomPlace", "set_device", "get_device",
            "device_count", "is_compiled_with_cuda", "set_flags",
            "get_flags", "OP_TABLE", "TensorArray", "ParamAttr",
            "in_dynamic_mode", "is_compiled_with_cinn",
            "is_compiled_with_distribute", "disable_signal_handler",
            "batch", "get_rng_state", "set_rng_state",
            "get_cuda_rng_state", "set_cuda_rng_state", "primitive",
            "apply_closure", "unwrap", "distributed",
            "DataParallel"] + sorted(OP_TABLE)
