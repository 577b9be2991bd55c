"""ResNet-18 of the PyTorch port against the JAX package (ResNet-50:
``tests/test_torch_vision_resnet50.py``, which runs these tests on it).

The model is built once per module in the JAX package (``paddle.seed(0)``,
10 classes) and its weights and BatchNorm buffers carried to the port
through ``vision_state_dict_from_jax``; both see the same numpy images
(B=2, 3x64x64) and labels.  Checked, in training mode (BatchNorm on the
batch's statistics): the logits, every parameter's gradient and the
running statistics; three ``Model.fit`` steps with ``Momentum(LR, 0.9)``
and ``CrossEntropyLoss`` (parameters and BN buffers); and the bf16 O2
path (``amp.decorate`` O2, fp32 masters, ``prepare(amp_configs=O2)``).

Tolerances: fp32 logits 1e-5 relative, gradients, parameters and buffers
1e-4 x max(|ref|, 1) (the same sums in another order).  bf16 O2: 5e-2 x
max(|ref|, 1).  The JAX package casts a Python-operator add (``out +
identity``) to bf16 under O2, while torch promotes it to fp32 and the
next layer rounds once (``ROADMAP.md``, non-comparable by design), so O2
agrees to bf16's precision, not bit for bit.

The shapes keep the comparison well posed in fp32, measured against the
port in float64: at 32x32 ``layer4`` is 1x1, its BatchNorm normalises
two values a channel, and fp32 rounding alone moves the logits by 1e-2
of their largest; at 64x64 it sees eight (fp32 vs fp64: 3e-6 on the
logits, 6e-6 on the gradients).  The learning rate is 0.003, not the
benchmark's 0.1: at B=2 the loss landscape is sharp enough that lr 0.1
turns 1e-8 differences after one step into 5e-3 after three, in fp32
against fp32 (losses still equal to 1e-6), while 0.003 keeps the three
steps within 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.vision import models as TM
from torch_parity_helpers import session_shared
from torch_parity_helpers import torch_one_thread  # noqa: F401

FWD_TOL = 1e-5
TOL = 1e-4
O2_TOL = 5e-2
O2_MOVE_RATIO = 4 / 3     # per parameter, either way
O2_MOVE_COS = 0.7
B, SIZE, CLASSES = 2, 64, 10
LR = 0.003
MODEL = "resnet18"


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t,
                      dtype=np.float32)


def build(name, last_gamma=None):
    """The JAX model ``name`` and its initial state (numpy); with
    ``last_gamma`` every ``bn3.weight`` (a bottleneck's last BatchNorm)
    set to it in the model and the state."""
    jpaddle.seed(0)
    jnet = getattr(JM, name)(num_classes=CLASSES)
    state = {k: np.array(v.numpy()) for k, v in jnet.state_dict().items()}
    if last_gamma is not None:
        for k in state:
            if k.endswith("bn3.weight"):
                state[k][:] = last_gamma
        jnet.set_state_dict(state)
    return name, jnet, state


@pytest.fixture(scope="module")
def built():
    return build(MODEL)


def _pair(built):
    """The JAX model reset to its initial state, and a port model of the
    same constructor carrying that state."""
    name, jnet, state = built
    jnet.set_state_dict(state)
    net = getattr(TM, name)(num_classes=CLASSES, device="cpu")
    net.load_state_dict(TM.vision_state_dict_from_jax(state, net))
    return jnet, net


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, 3, SIZE, SIZE)).astype(np.float32),
             rng.integers(0, CLASSES, (B,)).astype(np.int64))
            for _ in range(n)]


def test_carry_over_keeps_names_layouts_and_buffers(built):
    jnet, net = _pair(built)
    jstate, tstate = jnet.state_dict(), net.state_dict()
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].numpy(), _np(v), err_msg=k)
    assert len(list(net.parameters())) == len(list(jnet.parameters()))
    assert sum(k.endswith("._mean") for k in tstate) == \
        sum(k.endswith("._variance") for k in tstate) > 10
    assert tuple(net.fc.weight.shape) == tuple(jnet.fc.weight.shape)
    with pytest.raises(KeyError):
        TM.vision_state_dict_from_jax({}, net)
    # the JAX layer itself is a source too
    direct = TM.vision_state_dict_from_jax(jnet, net)
    assert torch.equal(direct["conv1.weight"], tstate["conv1.weight"])


def test_logits_every_gradient_and_running_stats_match_jax(built):
    jnet, net = _pair(built)
    (x, y), = _batches(1, seed=1)
    jnet.train()
    net.train()
    jout = jnet(JTensor(x))
    jloss = jnn.CrossEntropyLoss()(jout, JTensor(y))
    jloss.backward()
    out = net(torch.from_numpy(x))
    loss = tpaddle.nn.CrossEntropyLoss()(out, torch.from_numpy(y))
    loss.backward()
    _close(out.detach().numpy(), _np(jout), FWD_TOL, "logits")
    _close(loss.item(), float(_np(jloss)), FWD_TOL, "loss")
    jparams = dict(jnet.named_parameters())
    tparams = dict(net.named_parameters())
    assert set(jparams) == set(tparams)
    for k, p in tparams.items():
        _close(p.grad.numpy(), _np(jparams[k].grad), TOL, f"grad {k}")
    jbufs = dict(jnet.named_buffers())
    for k, b in net.named_buffers():
        _close(b.numpy(), _np(jbufs[k]), FWD_TOL, k)
    jnet.clear_gradients()


def _fit(model, batches, steps_per_dispatch=None):
    losses = []

    class Keep(tpaddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"][0]))

    model.fit(batches, epochs=1, verbose=0, callbacks=[Keep()],
              steps_per_dispatch=steps_per_dispatch)
    return losses


def _jax_fit(model, batches):
    losses = []

    class Keep(jpaddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(np.asarray(logs["loss"][0])))

    model.fit(batches, epochs=1, verbose=0, callbacks=[Keep()])
    return losses


def test_three_momentum_fit_steps_match_jax(built):
    jnet, net = _pair(built)
    batches = _batches(3, seed=2)
    jmodel = jpaddle.Model(jnet)
    jmodel.prepare(joptimizer.Momentum(LR, 0.9,
                                       parameters=jnet.parameters()),
                   jnn.CrossEntropyLoss())
    jlosses = _jax_fit(jmodel, batches)
    model = tpaddle.Model(net, device="cpu")
    model.prepare(tpaddle.optimizer.Momentum(LR, 0.9,
                                             parameters=net.parameters()),
                  tpaddle.nn.CrossEntropyLoss())
    losses = _fit(model, batches)
    assert len(losses) == len(jlosses) == 3
    _close(losses, jlosses, TOL, "losses")
    jstate = jnet.state_dict()
    for k, v in net.state_dict().items():
        _close(v.numpy(), _np(jstate[k]), TOL, k)
    assert not np.allclose(net.bn1._mean.numpy(), 0)


def _states(jnet, net):
    """Both models' state as fp32 numpy, by name, with their dtypes."""
    return ({k: (str(v._value.dtype), _np(v.astype("float32")))
             for k, v in jnet.state_dict().items()},
            {k: (str(v.dtype).replace("torch.", ""),
                 v.float().numpy().copy())
             for k, v in net.state_dict().items()})


@pytest.fixture(scope="module")
def o2_pair(built, tmp_path_factory):
    """:func:`_o2_run` once a session for the model, whichever workers run
    the three tests that read it (``session_shared``)."""
    return session_shared(tmp_path_factory, f"o2_pair-{built[0]}",
                          lambda: _o2_run(built))


def _o2_run(built):
    """A fresh JAX model (O2 changes its dtypes for good) and the port's
    through three bf16 O2 fit steps, as one fit of one step and one of
    two: the states after the first step and after the third, each
    parameter's move, and what the O2 setup left on the port's model
    (its dtypes, the optimizer's masters, the graph key, the amp state),
    all as plain values."""
    name, _, state = built
    jpaddle.seed(0)
    jnet = getattr(JM, name)(num_classes=CLASSES)
    jnet.set_state_dict(state)
    net = getattr(TM, name)(num_classes=CLASSES, device="cpu")
    net.load_state_dict(TM.vision_state_dict_from_jax(state, net))
    batches = _batches(3, seed=3)
    jopt = joptimizer.Momentum(LR, 0.9, parameters=jnet.parameters(),
                               multi_precision=True)
    jamp.decorate(jnet, jopt, level="O2", dtype="bfloat16")
    jmodel = jpaddle.Model(jnet)
    jmodel.prepare(jopt, jnn.CrossEntropyLoss(),
                   amp_configs={"level": "O2", "dtype": "bfloat16"})
    opt = tpaddle.optimizer.Momentum(LR, 0.9, parameters=net.parameters(),
                                     multi_precision=True)
    tpaddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    model = tpaddle.Model(net, device="cpu")
    model.prepare(opt, tpaddle.nn.CrossEntropyLoss(),
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    fc_in = set()
    hook = net.fc.register_forward_hook(
        lambda mod, args, out: fc_in.add(args[0].dtype))
    jlosses = _jax_fit(jmodel, batches[:1])
    losses = _fit(model, batches[:1])
    first = _states(jnet, net)
    jlosses += _jax_fit(jmodel, batches[1:])
    losses += _fit(model, batches[1:])
    hook.remove()
    masters = [(st["master_weight"].dtype, st["velocity"].dtype)
               for st in model._optimizer._state.values()
               if "master_weight" in st]
    return dict(losses=(losses, jlosses), first=first,
                third=_states(jnet, net),
                moved=_moved(state, jnet, jopt, net, opt), fc_in=fc_in,
                dtypes={k: v.dtype for k, v in net.state_dict().items()},
                masters=masters, graph_keys=list(model._graphs),
                amp_enabled=tpaddle.amp.amp_state()["enabled"])


def _moved(init, jnet, jopt, net, opt):
    """Each parameter's change over the fit, the fp32 value the update
    runs on (a bf16 parameter's master, BatchNorm's own value) less the
    initial one, in both packages, by name; and each bf16 parameter
    with its master."""
    jsd = jopt.state_dict()
    jmoved = {}
    for k, p in jnet.named_parameters():
        v = jsd.get(f"{p.name}.master_weight", p)
        jmoved[k] = _np(v.astype("float32") if hasattr(v, "astype")
                        else v) - init[k]
    names = [k for k, _ in net.named_parameters()]
    tmoved, pairs = {}, {}
    for i, (k, p) in enumerate(net.named_parameters()):
        master = opt._state[i].get("master_weight")
        v = p.detach().float() if master is None else master
        tmoved[k] = v.numpy() - init[k]
        if master is not None:
            pairs[k] = (p.detach(), master)
    assert names == list(jmoved)
    return tmoved, jmoved, pairs


def test_bf16_o2_fit_matches_jax(o2_pair):
    """Losses, and parameters (bf16, BatchNorm's fp32) after the first and
    the third step within 5e-2 x max(|ref|, 1); the running statistics
    after the first step within that too, after the third within 1e-1:
    one O2 forward already moves a batch statistic by up to 1e-2 of its
    largest between the two packages (the rounding points differ, module
    docstring), and three steps of both parameters and statistics
    compound it (measured 6.4e-2 on one element of
    ``layer1.0.bn1._mean``)."""
    losses, jlosses = o2_pair["losses"]
    assert len(losses) == len(jlosses) == 3
    _close(losses, jlosses, O2_TOL, "losses")
    for when in ("first", "third"):
        jstate, tstate = o2_pair[when]
        assert set(jstate) == set(tstate)
        for k, (dtype, value) in tstate.items():
            assert dtype == jstate[k][0], k
            stat = k.endswith(("._mean", "._variance"))
            tol = 2 * O2_TOL if stat and when == "third" else O2_TOL
            _close(value, jstate[k][1], tol, f"{k} after the {when} step")


def test_bf16_o2_fit_moves_every_parameter_as_jax_does(o2_pair):
    """The update itself, which the value tolerances above cannot see
    (three steps at lr 0.003 move a weight far less than 5e-2 of its
    largest): each parameter's change over the three steps, on its fp32
    master (BatchNorm's on the value), has the size of the JAX change
    within O2_MOVE_RATIO (measured 0.86-1.12), and all the changes
    together point the JAX way, cosine at least O2_MOVE_COS (measured
    0.84; the JAX O2 change against the fp32 one: 0.85, bf16 gradients
    at B=2 being that noisy).  So a frozen, skipped or shrunk update
    fails.  Each bf16 parameter is its master rounded to bf16, so the
    step was copied back."""
    tmoved, jmoved, pairs = o2_pair["moved"]
    dot = sq_t = sq_j = 0.0
    for k, ref in jmoved.items():
        got = tmoved[k].astype(np.float64)
        ref = ref.astype(np.float64)
        ratio = float(np.linalg.norm(got)) / float(np.linalg.norm(ref))
        assert 1 / O2_MOVE_RATIO <= ratio <= O2_MOVE_RATIO, \
            f"{k}: moved {ratio:.3f} x the JAX change"
        dot += float(np.sum(got * ref))
        sq_t += float(np.sum(got * got))
        sq_j += float(np.sum(ref * ref))
    cos = dot / (sq_t * sq_j) ** 0.5
    assert cos >= O2_MOVE_COS, f"cosine {cos:.3f} to the JAX change"
    assert pairs
    for k, (value, master) in pairs.items():
        assert value.dtype == torch.bfloat16, k
        assert torch.equal(value, master.to(torch.bfloat16)), k


def test_bf16_o2_keeps_fp32_masters_norms_and_the_amp_key(o2_pair):
    dtypes = o2_pair["dtypes"]
    assert dtypes["conv1.weight"] == dtypes["fc.weight"] == torch.bfloat16
    assert dtypes["bn1.weight"] == dtypes["bn1._mean"] == torch.float32
    masters = o2_pair["masters"]
    assert masters and all(m == v == torch.float32 for m, v in masters)
    (key,) = o2_pair["graph_keys"]
    assert key[-2:] == ("O2", "bfloat16")
    # the forward ran under auto_cast (without it the fp32 images meet
    # the bf16 stem and every activation after it is fp32) and left no
    # state behind
    assert o2_pair["fc_in"] == {torch.bfloat16}
    assert not o2_pair["amp_enabled"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's convolutions and the "
                    "captured step have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _fit_steps(device, init, batches, fold, velocity=None, steps_done=0):
    """Momentum(LR, 0.9) steps of ResNet-18 from ``init`` (and
    ``velocity``, by parameter index, after ``steps_done`` steps) through
    ``fit(steps_per_dispatch=fold)``: the model, and its parameters, BN
    buffers and velocities (on the CPU) after each step as its callback
    sees them."""
    net = TM.resnet18(num_classes=CLASSES, device=device)
    net.load_state_dict(init)
    opt = tpaddle.optimizer.Momentum(LR, 0.9, parameters=net.parameters())
    for i, v in (velocity or {}).items():
        opt._state[i] = {"velocity": v.to(device).clone(),
                         "steps": steps_done}
    model = tpaddle.Model(net, device=device)
    model.prepare(opt, tpaddle.nn.CrossEntropyLoss())
    names = [k for k, _ in net.named_parameters()]
    after = []

    class Keep(tpaddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            state = {k: v.detach().cpu().clone()
                     for k, v in net.state_dict().items()}
            state.update({f"{names[i]}.velocity": st["velocity"].cpu().clone()
                          for i, st in opt._state.items()})
            after.append(state)

    model.fit(batches, epochs=1, verbose=0, callbacks=[Keep()],
              steps_per_dispatch=fold)
    return model, after


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [1, 4, 0])
def test_cuda_fit_matches_the_cpu(cuda_device, fold):
    """Three Momentum steps of ResNet-18 on the card through cuDNN, the
    main path's route, with its deterministic algorithms (K=1 and K=4
    replay a captured step, 0 is the eager route).  K=1 and eager: each
    step, from the card's state before it, against one CPU step from
    that state; K=4, whose callbacks see only its group's end, against
    the eager run on the card; every parameter, velocity and BN buffer
    within 1e-4 x max(|ref|, 1).  Three steps running free are not held
    to the CPU's: a ReLU input within fp32 rounding of 0 may take the
    other sign on the card and send one element's gradient the other
    way (``chip_smoke.py``'s ``[train resnet parity]`` counts them)."""
    batches = [tuple(torch.from_numpy(a) for a in b)
               for b in _batches(3, seed=4)]
    init = TM.resnet18(num_classes=CLASSES, device="cpu",
                       generator=torch.Generator().manual_seed(0)
                       ).state_dict()
    names = [k for k, _ in TM.resnet18(num_classes=CLASSES,
                                       device="cpu").named_parameters()]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        model, after = _fit_steps(cuda_device, init, batches, fold)
        want = ({"graphs": 0, "captures": 0} if fold == 0 else
                {"graphs": 1, "captures": 1})
        assert model.compile_stats() == want
        assert len(after) == len(batches)
        if fold == 4:
            _, eager = _fit_steps(cuda_device, init, batches, 0)
            refs = [(after[-1], eager[-1])]
        else:
            refs = []
            for i, batch in enumerate(batches):
                before = after[i - 1] if i else init
                sd = {k: v for k, v in before.items()
                      if not k.endswith(".velocity")}
                vel = {j: before[f"{k}.velocity"]
                       for j, k in enumerate(names)
                       if f"{k}.velocity" in before}
                _, one = _fit_steps("cpu", sd, [batch], 0, vel, i)
                refs.append((after[i], one[0]))
    for got, ref in refs:
        assert set(got) == set(ref)
        for k, v in ref.items():
            _close(got[k].numpy(), v.numpy(), TOL, k)
