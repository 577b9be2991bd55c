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

__all__ = ["resolve_device", "Model", "seed", "amp", "optimizer", "nn",
           "io", "vision", "metric", "callbacks", "save", "load",
           "summary", "flops"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises:
    the port never carries on on the CPU unless ``device="cpu"`` was
    asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
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
from . import amp, io, metric, nn, optimizer, vision  # noqa: E402
from .framework.io import load, save  # noqa: E402
from .framework.random import seed  # noqa: E402
from .hapi import Model, callbacks  # noqa: E402
from .hapi.summary import flops, summary  # noqa: E402
