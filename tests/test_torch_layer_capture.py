"""What only the card can check of ``nn.Layer`` in training: a captured
step reads the storage of the parameters it was captured with, so a
parameter replaced between two fits must drop the model's graphs and
reach the optimizer, and the replayed run must then end bit-equal to
the eager route through the same replacement.  ``cuda``-marked (they
skip without a card); this file imports no JAX."""

import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from torch_parity_helpers import torch_one_thread  # noqa: F401


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graph capture has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run(fold, replace):
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = nn.Sequential(nn.Linear(4, 8, device="cuda", generator=gen),
                        nn.ReLU(),
                        nn.Linear(8, 3, device="cuda", generator=gen))
    model = paddle.Model(net, device="cuda")
    model.prepare(paddle.optimizer.Adam(1e-2, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    x = torch.linspace(-1, 1, 24).reshape(6, 4)
    batch = (x, torch.tensor([[0], [1], [2], [0], [1], [2]]))
    model.fit([batch] * 2, epochs=1, verbose=0, steps_per_dispatch=fold)
    before = model.compile_stats()
    if replace:
        net[2].weight = nn.Parameter(torch.full((8, 3), 0.1, device="cuda"))
    model.fit([batch] * 2, epochs=1, verbose=0, steps_per_dispatch=fold)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    after = model.compile_stats()
    model.release_graphs()
    return state, before, after, net


@pytest.mark.cuda
def test_replaced_parameter_drops_the_graphs(card):
    rep, before, after, net = _run(1, True)
    eager, *_ = _run(0, True)
    kept, _, kept_after, _ = _run(1, False)
    assert before == {"graphs": 1, "captures": 1}
    # the graphs were dropped at the replacement and one captured anew
    assert after == {"graphs": 1, "captures": 1}
    assert kept_after == before
    assert not torch.equal(rep["2.weight"],
                           torch.full((8, 3), 0.1, device="cuda"))
    for k in rep:
        assert torch.equal(rep[k], eager[k]), k
    assert any(not torch.equal(rep[k], kept[k]) for k in rep)
