"""The slice as a whole: the classic Paddle dygraph loop on the port.

``gpt_tiny`` (2 layers, hidden 64, 4 heads, vocab 256, 256 positions),
dropout 0, fp32, is trained three steps with AdamW by the loop a Paddle
user writes::

    loss = crit(net(paddle.to_tensor(x)), paddle.to_tensor(y))
    loss.backward(); opt.step(); opt.clear_grad(); float(loss)

in the JAX package (its Tensor, its tape's ``backward()``) and in the
port, whose weights come from the JAX model by ``state_dict_from_jax``.
The bounds are those of the earlier GPT parity gates
(``tests/test_torch_training.py``): losses within 2e-5 relative, and
after the three steps every weight within 2e-6 on 99.5% of the elements
and within 1e-3 on all (Adam divides by each moment's own RMS, so an
element whose gradient is rounding noise in both packages moves up to
~lr a step in a direction the noise sets).

The port's loop on ``Tensor`` s and the same loop on raw torch tensors
give bit-equal losses and weights: the wrapper adds no arithmetic.

``nn.functional.flash_attention`` on Tensors with
``stop_gradient=False`` and ``paddle.grad`` over q, k and v matches the
JAX function (its Pallas kernels in interpret mode) at the flash bounds:
2e-4 relative / 2e-5 absolute on the output, 5e-4 / 5e-5 on gradients.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny, state_dict_from_jax)
from torch_parity_helpers import torch_one_thread  # noqa: F401

TOL = 2e-5
PARAM_TOL = 2e-6
PARAM_BULK = 0.995
ADAM_NOISE_TOL = 1e-3
B, S, STEPS, LR = 2, 128, 3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tpaddle.get_device()
    tpaddle.set_device("cpu")
    yield
    tpaddle.set_device(prev)


def _batches():
    """One batch, taken every step, so the loss must fall."""
    x = np.random.default_rng(10).integers(0, 256, (B, S)).astype(np.int64)
    return [(x, np.roll(x, -1, 1))] * STEPS


def _jax_net():
    jpaddle.seed(0)
    return JGPTForCausalLM(jgpt_tiny(max_position_embeddings=256))


def _port_net(jnet):
    cfg = gpt_tiny(max_position_embeddings=256)
    net = GPTForCausalLM(cfg)
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net.load_state_dict(state_dict_from_jax(state, cfg))
    return net


def _dygraph(P, net, crit, opt, data, wrap=True):
    losses = []
    for x, y in data:
        if wrap:
            xs, ys = P.to_tensor(x), P.to_tensor(y)
        else:
            xs, ys = torch.from_numpy(x), torch.from_numpy(y)
        loss = crit(net(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, loss


def test_dygraph_loop_matches_jax():
    data = _batches()
    jnet = _jax_net()
    net = _port_net(jnet)
    jopt = joptimizer.AdamW(learning_rate=LR, parameters=jnet.parameters(),
                            weight_decay=0.01)
    topt = tpaddle.optimizer.AdamW(learning_rate=LR,
                                   parameters=net.parameters(),
                                   weight_decay=0.01)
    jl, _ = _dygraph(jpaddle, jnet, JGPTPretrainingCriterion(), jopt, data)
    tl, tloss = _dygraph(tpaddle, net, GPTPretrainingCriterion(), topt, data)
    assert isinstance(tloss, tpaddle.Tensor) and tloss.shape == []
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    jstate = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    tstate = net.state_dict()
    assert set(tstate) == set(jstate)
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in tstate.items()])
    assert (diffs <= PARAM_TOL).mean() >= PARAM_BULK
    assert diffs.max() <= ADAM_NOISE_TOL
    for p in net.parameters():
        assert p.grad is None            # clear_grad emptied every slot


def test_tensor_loop_bit_equal_to_the_raw_torch_loop():
    data = _batches()
    jnet = _jax_net()
    runs = []
    for wrap in (True, False):
        net = _port_net(jnet)
        opt = tpaddle.optimizer.AdamW(learning_rate=LR,
                                      parameters=net.parameters(),
                                      weight_decay=0.01)
        losses, loss = _dygraph(tpaddle, net, GPTPretrainingCriterion(),
                                opt, data, wrap=wrap)
        assert isinstance(loss, tpaddle.Tensor) == wrap
        runs.append((losses, net.state_dict()))
    (la, sa), (lb, sb) = runs
    assert la == lb
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_flash_attention_on_tensors_matches_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(3)
    q, k, v = ((rng.standard_normal((2, 128, 4, 64)) * 0.5).astype(
        np.float32) for _ in range(3))
    g = rng.standard_normal((2, 128, 4, 64)).astype(np.float32)
    res = []
    for P in (jpaddle, tpaddle):
        ts = [P.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
        out, _ = P.nn.functional.flash_attention(*ts, causal=True)
        grads = P.grad([out], ts, grad_outputs=[P.to_tensor(g)])
        res.append([np.asarray(t.numpy()) for t in [out] + list(grads)])
        assert not out.stop_gradient
    (jo, *jg), (to, *tg) = res
    np.testing.assert_allclose(to, jo, rtol=2e-4, atol=2e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)
