"""End to end on the PyTorch port: LeNet on (synthetic) MNIST, the
first configuration of ``BASELINE.json:7``.  Mirrors
``tests/test_lenet_e2e.py`` with ``paddle_tpu_torch`` and
``device="cpu"``: the raw loop, ``Model.fit`` with ``Accuracy``,
``evaluate``, ``save`` and ``load`` into a second model, the eager and
folded routes, and ``predict_batch``."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

pytestmark = pytest.mark.slow


@pytest.fixture
def mnist_loader(monkeypatch):
    # the JAX test's size: tests/conftest.py sets PADDLE_TPU_SYNTH_N
    monkeypatch.setenv("PADDLE_TORCH_SYNTH_N", "512")
    ds = MNIST(mode="train")
    return DataLoader(ds, batch_size=64, shuffle=True, drop_last=True,
                      generator=torch.Generator().manual_seed(0))


def test_lenet_raw_loop(mnist_loader):
    paddle.seed(0)
    model = LeNet(device="cpu")
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()
    losses = []
    it = iter(mnist_loader)
    for step in range(8):
        img, label = next(it)
        loss = loss_fn(model(img), label)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], f"loss did not drop: {losses}"


def test_lenet_model_fit(mnist_loader, tmp_path):
    paddle.seed(0)
    from paddle_tpu_torch.metric import Accuracy
    model = paddle.Model(LeNet(device="cpu"), device="cpu")
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    model.prepare(opt, nn.CrossEntropyLoss(), Accuracy())
    model.fit(mnist_loader, epochs=1, verbose=0, num_iters=10)
    res = model.evaluate(mnist_loader, verbose=0, num_iters=4)
    assert "loss" in res and "acc" in res
    # after 10 steps on the separable synthetic set, acc must beat chance
    assert res["acc"] > 0.2, res

    path = str(tmp_path / "lenet")
    model.save(path)
    model2 = paddle.Model(LeNet(device="cpu"), device="cpu")
    opt2 = optimizer.Adam(learning_rate=1e-3,
                          parameters=model2.parameters())
    model2.prepare(opt2, nn.CrossEntropyLoss(), Accuracy())
    model2.load(path)
    w1 = model.network.state_dict()["features.0.weight"].numpy()
    w2 = model2.network.state_dict()["features.0.weight"].numpy()
    np.testing.assert_array_equal(w1, w2)


def test_lenet_folded_vs_eager_parity(mnist_loader):
    """The folded route and the eager route (``jit=False``) give the same
    first-step loss and update (same weights, same data)."""
    img, label = next(iter(mnist_loader))

    def first_step(jit):
        paddle.seed(0)
        m = paddle.Model(LeNet(device="cpu"), device="cpu")
        opt = optimizer.Momentum(learning_rate=0.1, momentum=0.0,
                                 parameters=m.parameters())
        m.prepare(opt, nn.CrossEntropyLoss(), jit=jit)
        rec = []

        class Rec(paddle.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                rec.append(float(logs["loss"][0]))

        m.fit([(img, label)], epochs=1, verbose=0, callbacks=[Rec()],
              steps_per_dispatch=1)
        return rec[0], m.network.state_dict()["features.0.weight"].numpy()

    loss_jit, w1 = first_step(True)
    loss_eager, w2 = first_step(False)
    np.testing.assert_allclose(loss_jit, loss_eager, rtol=1e-4)
    np.testing.assert_allclose(w1, w2, rtol=1e-3, atol=1e-5)


def test_predict(mnist_loader):
    model = paddle.Model(LeNet(device="cpu"), device="cpu")
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    model.prepare(opt, nn.CrossEntropyLoss())
    img, label = next(iter(mnist_loader))
    out = model.predict_batch([img])
    assert out[0].shape == (64, 10)
