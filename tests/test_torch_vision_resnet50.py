"""ResNet-50 of the PyTorch port against the JAX package: the checks of
``tests/test_torch_vision_resnet.py`` (its docstring states shapes and
tolerances) on the bottleneck family, the north-star's model.

One change to the carried weights, made in both packages alike: every
bottleneck's last BatchNorm weight (``bn3.weight``) is 0.1 instead of
Paddle's 1 (Goyal et al.'s small-gamma start of a residual branch).  At
Paddle's start ResNet-50 in training mode is ill-conditioned in fp32
itself: the port in fp32 against the port in float64 differs by 1e-4
of the largest logit and 10% of the largest gradient at B=2, 64x64 (2%
at 128x128 or 224x224), so no two fp32 implementations agree to 1e-4.
With 0.1 the same measurement reads 1e-6 on both.
"""

import pytest
import torch

from test_torch_vision_resnet import (  # noqa: F401  (tests run here too)
    build, o2_pair, test_bf16_o2_fit_matches_jax,
    test_bf16_o2_fit_moves_every_parameter_as_jax_does,
    test_bf16_o2_keeps_fp32_masters_norms_and_the_amp_key,
    test_carry_over_keeps_names_layouts_and_buffers,
    test_logits_every_gradient_and_running_stats_match_jax,
    test_three_momentum_fit_steps_match_jax)
from torch_parity_helpers import torch_one_thread  # noqa: F401



@pytest.fixture(autouse=True, scope="module")
def two_threads(torch_one_thread):  # noqa: F811
    """Two threads here, not one.  On one thread PyTorch sends the 33
    stride-1 1x1 convolutions (batch < 16) to its own im2col + GEMM
    (``thnn_conv2d``) instead of oneDNN; both are accurate alone (5e-7
    against float64), but the other rounding lands one ReLU input of
    ``layer4.1`` (-3.2e-6 in float64) at +1.0e-7, and that one kink
    moves conv1's weight gradient by 2.9e-3 of its largest against
    float64 (8.1e-5 on two threads, where only the ``layer2.0`` kink
    that both routes share flips).  A ReLU at a rounding's distance
    from 0, not a sum's accuracy."""
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    return build("resnet50", last_gamma=0.1)
