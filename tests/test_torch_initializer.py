"""``nn.initializer`` of the PyTorch port against the JAX package.

The initializers that draw nothing (``Constant``, ``Assign``, ``Dirac``,
``Bilinear``) and ``calculate_gain`` must equal the JAX ones exactly.
``set_global_initializer`` must give, across the layer families
(Linear, the convolutions, Embedding with its padding row, the norms,
the RNNs, PReLU, Bilinear), exactly the values the JAX layers get, with
a ``ParamAttr`` initializer winning over it, as the JAX
``Layer.create_parameter`` orders them.  The random ones draw from
another generator (Philox against threefry, ROADMAP C), so
``XavierUniform``, ``KaimingNormal`` and ``Orthogonal`` are held by
their bounds, moments (within 5% at 60000 draws) and orthogonality
(``W^T W = gain^2 I`` within 1e-5 in the JAX layout, which the JAX
initializer is checked to share).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import initializer as JI

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as TI
from torch_parity_helpers import CPU
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture
def global_init():
    """Set both packages' global initializers; reset them after."""
    def set_both(w, b):
        JI.set_global_initializer(getattr(JI, w[0])(*w[1:]) if w else None,
                                  getattr(JI, b[0])(*b[1:]) if b else None)
        TI.set_global_initializer(getattr(TI, w[0])(*w[1:]) if w else None,
                                  getattr(TI, b[0])(*b[1:]) if b else None)
    yield set_both
    JI.set_global_initializer(None, None)
    TI.set_global_initializer(None, None)


def _exact(tval, jval, what=""):
    np.testing.assert_array_equal(tval.detach().cpu().numpy(),
                                  np.asarray(jval, np.float32), what)


def test_assign_dirac_bilinear_equal_jax_exactly():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3, 4)).astype(np.float32)
    for value in (v, v.tolist(), torch.from_numpy(v)):
        _exact(TI.Assign(value)((3, 4), CPU), JI.Assign(v)((3, 4), "float32"))
    with pytest.raises(ValueError, match="shape"):
        TI.Assign(v)((4, 3), CPU)
    for shape, groups in (((4, 2, 3, 3), 1), ((6, 2, 3, 3), 2),
                          ((5, 3, 4), 1), ((2, 4, 3, 3, 3), 1),
                          ((3, 5, 1, 1), 1)):
        _exact(TI.Dirac(groups)(shape, CPU),
               JI.Dirac(groups)(shape, "float32"), f"Dirac {shape}")
    for shape in ((4, 1, 4, 4), (2, 3, 3, 3), (3, 3, 5, 5)):
        _exact(TI.Bilinear()(shape, CPU), JI.Bilinear()(shape, "float32"),
               f"Bilinear {shape}")
    with pytest.raises(ValueError, match="4-D"):
        TI.Bilinear()((3, 3, 3), CPU)


def test_calculate_gain_and_the_aliases_equal_jax():
    for name in ("tanh", "relu", "leaky_relu", "selu", "sigmoid", "linear",
                 "conv2d"):
        assert TI.calculate_gain(name) == JI.calculate_gain(name), name
    assert TI.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)
    assert (TI.constant, TI.normal, TI.uniform) == \
        (TI.Constant, TI.Normal, TI.Uniform)
    public = {n for n in dir(JI) if not n.startswith("_")
              and n[0].isupper() or n in ("constant", "normal", "uniform",
                                          "calculate_gain",
                                          "set_global_initializer")}
    public -= {"Optional", "Sequence"}
    assert public <= set(dir(TI)), sorted(public - set(dir(TI)))
    _exact(TI.constant(0.25)((2, 3), CPU),
           JI.constant(0.25)((2, 3), "float32"))


LAYERS = {
    "Linear": lambda nn, **kw: nn.Linear(3, 4, **kw),
    "Linear with attr": lambda nn, **kw: nn.Linear(
        3, 4, weight_attr=nn.ParamAttr(
            initializer=nn.initializer.Constant(-2.0)), **kw),
    "Conv1D": lambda nn, **kw: nn.Conv1D(2, 3, 3, **kw),
    "Conv2D": lambda nn, **kw: nn.Conv2D(2, 3, 3, **kw),
    "Conv3D": lambda nn, **kw: nn.Conv3D(2, 3, 2, **kw),
    "Conv2DTranspose": lambda nn, **kw: nn.Conv2DTranspose(2, 3, 3, **kw),
    "Embedding": lambda nn, **kw: nn.Embedding(6, 3, padding_idx=1, **kw),
    "BatchNorm2D": lambda nn, **kw: nn.BatchNorm2D(3, **kw),
    "LayerNorm": lambda nn, **kw: nn.LayerNorm(4, **kw),
    "GroupNorm": lambda nn, **kw: nn.GroupNorm(2, 4, **kw),
    "InstanceNorm2D": lambda nn, **kw: nn.InstanceNorm2D(3, **kw),
    "RMSNorm": lambda nn, **kw: nn.RMSNorm(4, **kw),
    "LSTM": lambda nn, **kw: nn.LSTM(4, 5, **kw),
    "GRU": lambda nn, **kw: nn.GRU(3, 2, **kw),
    "SimpleRNN": lambda nn, **kw: nn.SimpleRNN(3, 2, **kw),
    "PReLU": lambda nn, **kw: nn.PReLU(3, **kw),
    "Bilinear": lambda nn, **kw: nn.Bilinear(2, 3, 4, **kw),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_global_initializer_across_layers_equals_jax(name, global_init):
    """Every parameter (and buffer) of each layer equal to the JAX
    layer's under ``set_global_initializer(Constant(0.5),
    Constant(-0.75))``: weights 0.5 and biases -0.75 where the JAX layer
    takes the global default, its own values where it does not (the
    padding row 0, a ``ParamAttr`` initializer's -2)."""
    global_init(("Constant", 0.5), ("Constant", -0.75))
    jl = LAYERS[name](jnn)
    tl = LAYERS[name](tnn, device=CPU)
    js = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    ts = tl.state_dict()
    assert set(ts) == set(js), (sorted(ts), sorted(js))
    for k, v in ts.items():
        _exact(v, js[k], f"{name}.{k}")
    values = {float(x) for k, v in ts.items() if k in
              dict(tl.named_parameters()) for x in v.unique()}
    assert values & {0.5, -0.75, -2.0}, (name, values)


def test_global_weight_only_leaves_biases_to_the_layer(global_init):
    global_init(("Constant", 0.5), None)
    for name in ("Linear", "Conv2D", "LayerNorm"):
        jl, tl = LAYERS[name](jnn), LAYERS[name](tnn, device=CPU)
        for k, v in tl.state_dict().items():
            _exact(v, jl.state_dict()[k].numpy(), f"{name}.{k}")
    global_init(None, None)
    tl = tnn.Linear(30, 40, device=CPU)
    assert float(tl.weight.detach().std()) < 0.5


def test_random_initializers_by_distribution():
    g = torch.Generator().manual_seed(0)
    fi, fo = 200, 300
    w = TI.XavierUniform()((fi, fo), CPU, g)
    limit = np.sqrt(6.0 / (fi + fo))
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) / (limit / np.sqrt(3)) - 1) < 0.05
    w = TI.XavierUniform(gain=2.0, fan_in=10, fan_out=20)((fi, fo), CPU, g)
    assert float(w.abs().max()) <= 2.0 * np.sqrt(6.0 / 30)
    w = TI.KaimingNormal()((fi, fo), CPU, g)
    assert abs(float(w.std()) / (np.sqrt(2.0) / np.sqrt(fi)) - 1) < 0.05
    assert abs(float(w.mean())) < 0.05 * float(w.std())
    w = TI.KaimingNormal(negative_slope=0.2, nonlinearity="leaky_relu")(
        (40, 3, 5, 5), CPU, g)
    assert abs(float(w.std()) / (np.sqrt(2.0 / 1.04) / np.sqrt(75)) - 1) < \
        0.05
    w = TI.KaimingNormal(nonlinearity="tanh")((fi, fo), CPU, g)
    assert abs(float(w.std()) * np.sqrt(fi) - 1) < 0.05


@pytest.mark.parametrize("shape,gain", [((30, 50), 1.0), ((50, 30), 2.0),
                                        ((8, 4, 3, 3), 1.0), ((6, 40), 0.5)])
def test_orthogonal_is_orthogonal_in_the_jax_layout(shape, gain):
    """The last axis is the columns, the rest the rows, in both packages:
    the columns are orthonormal (times ``gain``) when there are at least
    as many rows, else the rows."""
    t = TI.Orthogonal(gain)(shape, CPU, torch.Generator().manual_seed(1))
    jpaddle.seed(1)
    j = np.asarray(JI.Orthogonal(gain)(shape, "float32"))
    assert tuple(t.shape) == shape
    for m in (t.double().numpy(), j.astype(np.float64)):
        m = m.reshape(-1, shape[-1])
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(gram, gain ** 2 * np.eye(len(gram)),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="two dims"):
        TI.Orthogonal()((5,), CPU)


def test_layers_draw_from_the_new_initializers_through_param_attr():
    attr = tnn.ParamAttr(initializer=TI.Orthogonal())
    lin = tnn.Linear(8, 8, weight_attr=attr, device=CPU)
    w = lin.weight.detach().double()
    np.testing.assert_allclose((w.T @ w).numpy(), np.eye(8), atol=1e-5)
    conv = tnn.Conv2D(3, 3, 3, weight_attr=tnn.ParamAttr(
        initializer=TI.Dirac()), bias_attr=False, device=CPU)
    x = torch.randn(1, 3, 5, 5)
    torch.testing.assert_close(conv(x), x[:, :, 1:-1, 1:-1])
