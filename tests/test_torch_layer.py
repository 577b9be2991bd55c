"""``nn.Layer`` and its containers in the PyTorch port
(``paddle_tpu_torch/nn/layer.py``, ``container.py``,
``functional_call.py``), and ``Embedding``'s Paddle signature, against
the JAX package.

The ``test_nn`` mirrors hold the port to the JAX tests' own checks;
``functional_call`` and the ``Embedding`` lookup take the same numpy
inputs in both packages (fp32: forward within 1e-6, the lookup bit for
bit); the fit after a replaced parameter compares every parameter
after Adam steps within 1e-5 x max(|ref|, 1) (lr 1e-3, two steps of
one sample batch: well above the fp32 noise Adam amplifies to its step
size, well below the steps themselves).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.nn import functional_call as jfc
from paddle_tpu.tensor import Parameter as JParameter

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional_call as tfc
from paddle_tpu_torch.nn.layer import Layer, structure_version
from torch_parity_helpers import torch_one_thread  # noqa: F401

CPU = "cpu"


def _mlp(device=CPU):
    return tnn.Sequential(tnn.Linear(4, 8, device=device), tnn.ReLU(),
                          tnn.Linear(8, 2, device=device))


def _jax_state(jlayer):
    return {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}


def _from_jax(jlayer, layer):
    missing, unexpected = layer.set_state_dict(_jax_state(jlayer))
    assert not missing and not unexpected, (missing, unexpected)
    return layer


# -- mirrors of tests/test_nn.py ----------------------------------------------


def test_state_dict_roundtrip():
    net = _mlp()
    sd = net.state_dict()
    assert "0.weight" in sd and "2.bias" in sd
    net2 = _mlp()
    net2.set_state_dict(sd)
    np.testing.assert_array_equal(net2.state_dict()["0.weight"].numpy(),
                                  sd["0.weight"].numpy())
    x = torch.randn(2, 4)
    np.testing.assert_allclose(net(x).detach().numpy(),
                               net2(x).detach().numpy(), rtol=1e-6)


def test_named_parameters_unique():
    net = tnn.Sequential(tnn.Linear(4, 4, device=CPU),
                         tnn.Linear(4, 4, device=CPU))
    names = [n for n, _ in net.named_parameters()]
    assert len(names) == len(set(names)) == 4


def test_layer_train_eval_propagates():
    net = tnn.Sequential(tnn.Linear(2, 2, device=CPU), tnn.Dropout(0.5))
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training


def test_layer_to_dtype():
    net = tnn.Linear(2, 2, device=CPU)
    net.to(dtype="float16")
    assert net.weight.dtype == torch.float16
    net.astype("float32")
    assert net.weight.dtype == torch.float32
    assert net.to(device=None, dtype=None) is net


def test_hooks():
    calls = []
    net = tnn.Linear(2, 2, device=CPU)
    h = net.register_forward_post_hook(
        lambda layer, inp, out: calls.append(1))
    net(torch.randn(1, 2))
    assert calls == [1]
    h.remove()
    net(torch.randn(1, 2))
    assert calls == [1]
    h = net.register_forward_pre_hook(lambda layer, inp: (inp[0] * 0,))
    assert not net(torch.ones(1, 2)).sub(net.bias).any()
    h.remove()


def test_lazy_guard_defers_then_applies_init():
    tpaddle.seed(0)
    with tpaddle.LazyGuard():
        net = tnn.Sequential(tnn.Linear(16, 32, device=CPU), tnn.ReLU(),
                             tnn.Linear(32, 4, device=CPU))
    for p in net.parameters():
        assert float(p.detach().abs().sum()) == 0.0
    assert net.apply_deferred_init() == 4
    assert float(net[0].weight.detach().abs().sum()) > 0
    lin = tnn.Linear(8, 8, device=CPU)
    assert getattr(lin.weight, "_deferred_init", None) is None
    assert float(lin.weight.detach().abs().sum()) > 0
    opt = tpaddle.optimizer.SGD(learning_rate=0.1,
                                parameters=net.parameters())
    loss = tnn.MSELoss()(net(torch.ones(4, 16)), torch.zeros(4, 4))
    loss.backward()
    opt.step()
    assert np.isfinite(float(loss.detach()))


# -- the Layer API ------------------------------------------------------------


def test_layer_api():
    class Net(Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([3, 2], device=CPU)
            self.b = self.create_parameter([2], is_bias=True)
            self.register_buffer("steps", torch.zeros(()), persistable=False)
            self.add_sublayer("fc", tnn.Linear(2, 2, device=CPU))

        def forward(self, x):
            return self.fc(x @ self.w + self.b)

    net = Net()
    assert isinstance(net.parameters(), list)
    assert next(net.parameters()) is net.w
    assert [n for n, _ in net.named_parameters()] == [
        "w", "b", "fc.weight", "fc.bias"]
    assert list(net.state_dict()) == ["w", "b", "fc.weight", "fc.bias"]
    assert list(net.state_dict(include_sublayers=False)) == ["w", "b"]
    assert [n for n, _ in net.named_buffers()] == ["steps"]
    assert net.sublayers() == [net.fc]
    assert net.sublayers(include_self=True) == [net, net.fc]
    assert net.full_name() == "net"
    net(torch.ones(1, 3)).sum().backward()
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    missing, unexpected = net.set_state_dict(
        {"w": np.ones((3, 2), np.float32), "extra": np.zeros(1)})
    assert missing == ["b", "fc.weight", "fc.bias"] and unexpected == ["extra"]
    assert float(net.w.detach().sum()) == 6.0
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"w": np.ones((2, 2), np.float32)})
    by_name = {net.b.name: np.full(2, 3.0, np.float32)}
    net.set_state_dict(by_name, use_structured_name=False)
    assert float(net.b.detach().sum()) == 6.0
    v = structure_version()
    net.fc = tnn.Linear(2, 2, device=CPU)
    assert structure_version() > v


def test_parameter_list_and_layer_dict():
    pl = tnn.ParameterList([tnn.Parameter(torch.ones(2)),
                            tnn.Parameter(torch.zeros(3))])
    pl.append(tnn.Parameter(torch.ones(4)))
    assert len(pl) == 3 and pl[2].shape == (4,)
    assert [n for n, _ in pl.named_parameters()] == ["0", "1", "2"]
    assert [tuple(p.shape) for p in pl] == [(2,), (3,), (4,)]
    ld = tnn.LayerDict({"a": tnn.Linear(2, 2, device=CPU)})
    ld["b"] = tnn.ReLU()
    ld.update([("c", tnn.Linear(2, 1, device=CPU))])
    assert list(ld.keys()) == ["a", "b", "c"] and "b" in ld and len(ld) == 3
    assert list(ld.state_dict()) == ["a.weight", "a.bias", "c.weight",
                                     "c.bias"]
    del ld["b"]
    assert list(ld) == ["a", "c"]
    jld = jnn.LayerDict({"a": jnn.Linear(2, 2)})
    jld["c"] = jnn.Linear(2, 1)
    assert list(jld.state_dict()) == list(ld.state_dict())


# -- functional_call against the JAX one --------------------------------------


def test_functional_call_matches_jax():
    jpaddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 3))
    net = _from_jax(jnet, tnn.Sequential(
        tnn.Linear(4, 8, device=CPU), tnn.ReLU(),
        tnn.Linear(8, 3, device=CPU)))
    rng = np.random.default_rng(0)
    other = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in _jax_state(jnet).items()}
    x = rng.standard_normal((5, 4)).astype(np.float32)
    jout, _ = jfc.functional_call(
        jnet, {k: jpaddle.to_tensor(v)._value for k, v in other.items()},
        {}, [jpaddle.to_tensor(x)])
    params = {k: torch.tensor(v) for k, v in other.items()}
    out, bufs = tfc.functional_call(net, params, {}, [torch.tensor(x)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.numpy()),
                               rtol=0, atol=1e-6)
    assert bufs == {}
    # the layer's own values are back
    own = net(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(own, np.asarray(jnet(jpaddle.to_tensor(
        x)).numpy()), rtol=0, atol=1e-6)
    assert set(tfc.param_dict(net)) == set(jfc.param_dict(jnet))
    with tfc.bind(net, params) as holder:
        np.testing.assert_array_equal(net(torch.tensor(x)).detach().numpy(),
                                      out.detach().numpy())
    assert holder["buffers"] == {}


def test_functional_call_returns_written_buffers():
    bn = tnn.BatchNorm1D(3, device=CPU)
    bufs = {k: v.clone() for k, v in tfc.buffer_dict(bn).items()}
    x = torch.randn(8, 3)
    _, new = tfc.functional_call(bn, tfc.param_dict(bn), bufs, [x])
    assert not torch.equal(new["_mean"], torch.zeros(3))
    assert torch.equal(bn._mean, torch.zeros(3))


# -- Embedding with Paddle's signature (ROADMAP C8) ---------------------------


@pytest.mark.parametrize("padding_idx", [0, -1])
def test_embedding_padding_idx_matches_jax(padding_idx):
    rng = np.random.default_rng(5)
    V, D = 11, 6
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (3, 7))
    ids[0, :3] = padding_idx % V
    jemb = jnn.Embedding(V, D, padding_idx=padding_idx)
    emb = tnn.Embedding(V, D, padding_idx=padding_idx, device=CPU)
    pad = padding_idx % V
    # the initial padding row is 0 in both; the rest from Normal(0, 1)
    assert not np.asarray(jemb.weight.numpy())[pad].any()
    assert not emb.weight.detach()[pad].any()
    assert 0.5 < float(emb.weight.detach().std()) < 1.5
    jemb.set_state_dict({"weight": table})
    emb.set_state_dict({"weight": table})
    jout = jemb(jpaddle.to_tensor(ids))
    out = emb(torch.tensor(ids))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jout.numpy()))
    assert not out.detach().numpy()[0, :3].any()
    g = rng.standard_normal(out.shape).astype(np.float32)
    (jout * jpaddle.to_tensor(g)).sum().backward()
    (out * torch.tensor(g)).sum().backward()
    jgrad = np.asarray(jemb.weight.grad.numpy())
    assert not jgrad[pad].any() and not emb.weight.grad[pad].any()
    np.testing.assert_allclose(emb.weight.grad.numpy(), jgrad, rtol=0,
                               atol=1e-6)


def test_embedding_signature():
    emb = tnn.Embedding(10, 4, 0, device=CPU)
    assert emb._padding_idx == 0 and not emb.weight.detach()[0].any()
    assert tnn.Embedding(10, 4, sparse=True, device=CPU)._sparse
    init = tnn.initializer.Constant(0.5)
    emb = tnn.Embedding(10, 4, weight_attr=init, device=CPU)
    assert float(emb.weight.detach().sum()) == 20.0
    emb = tnn.Embedding(10, 4, init_std=0.02, device=CPU)
    assert float(emb.weight.detach().std()) < 0.1


def test_dropout_signature_matches_jax():
    """``F.dropout(x, p, axis, training, mode)`` positionally, as Paddle
    code calls it: both packages zero about ``p`` of the elements and
    scale the rest by ``1 / (1 - p)`` while training, pass ``x`` through
    otherwise; ``axis`` shares one draw along the other dims and
    ``downscale_in_infer`` scales by ``1 - p`` outside training."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF
    x = np.random.default_rng(3).uniform(1.0, 2.0, (64, 64)).astype(
        np.float32)
    jpaddle.seed(0)
    jout = np.asarray(JF.dropout(jpaddle.to_tensor(x), 0.25, None,
                                 True).numpy())
    tout = TF.dropout(torch.from_numpy(x), 0.25, None, True).numpy()
    for out in (jout, tout):
        kept = out != 0
        np.testing.assert_allclose(out[kept], x[kept] / 0.75, rtol=1e-6)
        assert abs(float(kept.mean()) - 0.75) < 0.03, float(kept.mean())
    for training in (False, True):
        p = 0.0 if training else 0.25
        np.testing.assert_array_equal(
            TF.dropout(torch.from_numpy(x), p, None, training).numpy(),
            np.asarray(JF.dropout(jpaddle.to_tensor(x), p, None,
                                  training).numpy()))
    # axis: one draw along the dims not in axis; downscale_in_infer keeps
    # the kept elements as they are and scales by 1 - p outside training
    for kw in (dict(axis=0), dict(mode="downscale_in_infer")):
        jpaddle.seed(1)
        outs = (np.asarray(JF.dropout(jpaddle.to_tensor(x), 0.25,
                                      **kw).numpy()),
                TF.dropout(torch.from_numpy(x), 0.25, **kw).numpy())
        for out in outs:
            kept = out != 0
            scale = 1.0 if kw.get("mode") else 1 / 0.75
            np.testing.assert_allclose(out[kept], x[kept] * scale,
                                       rtol=1e-6)
            if "axis" in kw:
                assert (kept == kept[:, :1]).all()
        layer = tnn.Dropout(0.25, **kw)
        layer.eval()
        want = x * 0.75 if kw.get("mode") else x
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   want, rtol=1e-6)
    drop = tnn.Dropout(0.25, None, "upscale_in_train", "drop")
    drop.eval()
    assert torch.equal(drop(torch.from_numpy(x)), torch.from_numpy(x))


# -- Model.fit after a parameter is replaced ----------------------------------


def test_fit_after_a_parameter_is_replaced_matches_jax():
    """``net[2].weight = Parameter(...)`` between two fits: the next step
    trains the new parameter (fresh Adam state) in both packages."""
    jpaddle.seed(1)
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 3))
    net = _from_jax(jnet, tnn.Sequential(
        tnn.Linear(4, 8, device=CPU), tnn.ReLU(),
        tnn.Linear(8, 3, device=CPU)))
    rng = np.random.default_rng(2)
    batch = (rng.standard_normal((6, 4)).astype(np.float32),
             rng.integers(0, 3, (6, 1)))
    jm = jpaddle.Model(jnet)
    jm.prepare(joptimizer.Adam(1e-3, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss())
    tm = tpaddle.Model(net, device=CPU)
    tm.prepare(tpaddle.optimizer.Adam(1e-3, parameters=net.parameters()),
               tnn.CrossEntropyLoss())
    for m in (jm, tm):
        m.fit([batch] * 2, epochs=1, verbose=0)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    jnet[2].weight = JParameter(jpaddle.to_tensor(w)._value)
    net[2].weight = tnn.Parameter(torch.tensor(w))
    old = net[2].weight.detach().clone()
    for m in (jm, tm):
        m.fit([batch] * 2, epochs=1, verbose=0)
    assert not torch.equal(net[2].weight.detach(), old)
    assert any(p is net[2].weight for p in tm._optimizer.parameters())
    jstate = _jax_state(jnet)
    for k, v in net.state_dict().items():
        ref = jstate[k]
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(v.numpy(), ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


def test_two_input_layer_through_fit_evaluate_predict():
    """A Layer taking (source, target-in), with target-out as the label,
    as the translation model runs."""

    class Pair(Layer):
        def __init__(self):
            super().__init__()
            self.emb = tnn.Embedding(7, 4, padding_idx=0, device=CPU)
            self.out = tnn.Linear(4, 7, device=CPU)

        def forward(self, src, tgt):
            return self.out(self.emb(tgt) + self.emb(src).mean(1,
                                                               keepdim=True))

    class SeqLoss(Layer):
        def forward(self, logits, label):
            return tnn.functional.cross_entropy(logits, label)

    tpaddle.seed(0)
    net = Pair()
    m = tpaddle.Model(net, device=CPU)
    m.prepare(tpaddle.optimizer.Adam(1e-2, parameters=net.parameters()),
              SeqLoss())
    rng = np.random.default_rng(0)
    data = [(rng.integers(1, 7, (2, 5)), rng.integers(1, 7, (2, 3)),
             rng.integers(1, 7, (2, 3))) for _ in range(3)]
    m.fit(data, epochs=2, verbose=0)
    logs = m.evaluate(data, verbose=0)
    assert np.isfinite(float(logs["loss"][0]))
    (out,) = m.predict(data, verbose=0, stack_outputs=True)
    assert out.shape == (6, 3, 7)
