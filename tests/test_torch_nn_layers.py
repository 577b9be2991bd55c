"""The port's layers follow its device rule: built without a device they
go to the card (``resolve_device(None)``), so on a machine without one
they raise; ``device="cpu"`` builds them on the CPU."""

import pytest
import torch

from paddle_tpu_torch import nn
from torch_parity_helpers import torch_one_thread  # noqa: F401

LAYERS = {
    "Linear": lambda **kw: nn.Linear(4, 3, init_std=0.02, **kw),
    "Embedding": lambda **kw: nn.Embedding(10, 4, init_std=0.02, **kw),
    "LayerNorm": lambda **kw: nn.LayerNorm(4, **kw),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_without_a_device_means_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LAYERS[name]()
    layer = LAYERS[name](device="cpu")
    assert {p.device.type for p in layer.parameters()} == {"cpu"}
