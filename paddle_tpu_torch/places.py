"""Places (counterpart of ``paddle_tpu/places.py``).

A Paddle ``Place`` says where a tensor lives; in the port it stands for
a ``torch.device`` (:meth:`Place.torch_device`): ``CUDAPlace(i)`` is
``cuda:i``, ``CPUPlace()`` the host.  The default place is the card,
``CUDAPlace(0)``, whether or not one is present: a tensor made there
without a card raises (through ``resolve_device``), so nothing quietly
runs on the CPU unless ``set_device("cpu")`` or ``place=CPUPlace()``
asked for it.  ``get_device()`` says ``"gpu:0"`` by default, Paddle's
own name on a GPU (the JAX package says ``"tpu:0"`` on its chip).
"""

from __future__ import annotations

from typing import Union

import torch


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.torch_device_type() == other.torch_device_type()
                and (self.torch_device_type() == "cpu"
                     or self._device_id == other._device_id))

    def __hash__(self):
        return hash((self.torch_device_type(), self._device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self._device_id})"

    def torch_device_type(self) -> str:
        return "cpu" if self.device_type == "cpu" else "cuda"

    def is_cpu_place(self) -> bool:
        return self.torch_device_type() == "cpu"

    def is_gpu_place(self) -> bool:
        return self.torch_device_type() == "cuda"

    def torch_device(self) -> torch.device:
        """The ``torch.device``; a CUDA place without a card raises."""
        from . import resolve_device
        if self.torch_device_type() == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self._device_id}")


class CPUPlace(Place):
    device_type = "cpu"

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace(Place):
    device_type = "gpu"


# Paddle's other accelerator names stand for the card here
class TPUPlace(CUDAPlace):
    device_type = "gpu"


class XPUPlace(CUDAPlace):
    device_type = "gpu"


class CUDAPinnedPlace(CPUPlace):
    pass


class CustomPlace(CUDAPlace):
    def __init__(self, dev_type: str = "gpu", device_id: int = 0):
        super().__init__(device_id)


_current_place = [CUDAPlace(0)]


def place_of(device) -> Place:
    """The Place of a ``torch.device`` (or a device string)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPUPlace()
    return CUDAPlace(dev.index or 0)


def to_place(device) -> Place:
    """A Place from a Place, a ``torch.device`` or Paddle's device
    string (``"cpu"``, ``"gpu"``, ``"gpu:1"``; ``"cuda"``, ``"tpu"`` and
    ``"xpu"`` name the card too)."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return place_of(device)
    dev = str(device).lower()
    kind, _, idx = dev.partition(":")
    idx = int(idx) if idx else 0
    if kind == "cpu":
        return CPUPlace()
    if kind in ("gpu", "cuda", "tpu", "xpu", "npu"):
        return CUDAPlace(idx)
    raise ValueError(f"unsupported device {device!r}")


def get_device() -> str:
    """``"cpu"`` or ``"gpu:<id>"``: where new tensors go."""
    p = _current_place[0]
    return "cpu" if p.is_cpu_place() else f"gpu:{p.get_device_id()}"


def set_device(device: Union[str, Place]) -> Place:
    """``paddle.set_device("gpu:0" | "gpu" | "cpu")``: the place new
    tensors go to (a tensor made on a GPU place without a card
    raises)."""
    place = to_place(device)
    _current_place[0] = place
    return place


def _expected_place() -> Place:
    return _current_place[0]


def expected_device() -> torch.device:
    """The ``torch.device`` of the current place (raises for the card
    when there is none)."""
    return _current_place[0].torch_device()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()
