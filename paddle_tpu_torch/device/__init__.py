"""``paddle.device`` (counterpart of ``paddle_tpu/device/__init__.py``)
over ``torch.cuda``."""

import torch

from ..places import (device_count, get_device,  # noqa: F401
                      is_compiled_with_cuda, is_compiled_with_xpu,
                      set_device)


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_available_device():
    return ["cpu"] + [f"gpu:{i}" for i in range(torch.cuda.device_count())]


class cuda:
    """``paddle.device.cuda`` over ``torch.cuda``."""

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def max_memory_allocated(device=None):
        return torch.cuda.max_memory_allocated(device)

    @staticmethod
    def memory_allocated(device=None):
        return torch.cuda.memory_allocated(device)

    @staticmethod
    def empty_cache():
        torch.cuda.empty_cache()

    @staticmethod
    def synchronize(device=None):
        torch.cuda.synchronize(device)


def synchronize(device=None):
    """Wait for every kernel queued on the card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


Stream = torch.cuda.Stream
Event = torch.cuda.Event


def current_stream(device=None):
    return torch.cuda.current_stream(device)


def stream_guard(stream):
    return torch.cuda.stream(stream)
