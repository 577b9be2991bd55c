"""The vision zoo of the PyTorch port against the JAX package, part B:
ShuffleNetV2, DenseNet and SqueezeNet (``test_torch_vision_zoo_a.py``
states the method and the tolerance)."""

import numpy as np
import pytest

from test_torch_vision_zoo_a import _forward_both, check_family
from torch_parity_helpers import torch_one_thread  # noqa: F401


@pytest.mark.parametrize("name,size", [
    ("shufflenet_v2_x0_25", 64),
    ("shufflenet_v2_swish", 64),
    ("densenet121", 64),
    ("squeezenet1_0", 96),
    ("squeezenet1_1", 96),
])
def test_family_forward_matches_jax(name, size):
    check_family(name, size)


def test_densenet161_variant_channels():
    """densenet161 switches to growth 48 and a 96-channel stem."""
    jout, out, net = _forward_both("densenet161", 64)
    assert tuple(out.shape) == (1, 10)
    assert tuple(net.conv1.weight.shape) == (96, 3, 7, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()),
                               rtol=0, atol=1e-5 * max(
                                   float(np.abs(jout.numpy()).max()), 1.0))
