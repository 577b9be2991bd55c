"""``Model`` with metrics, evaluation, prediction, gradient
accumulation, checkpoints and summaries in the PyTorch port
(``paddle_tpu_torch/hapi``, ``framework/io.py``), against the JAX
package and against the port's own eager route.

LeNet on 256 rows of the JAX package's synthetic digits
(``_synthetic_mnist``), B=16, ``shuffle=False`` so both packages see one
batch order, JAX weights carried over by ``vision_state_dict_from_jax``.
Across packages the tolerances are those of
``tests/test_torch_training.py`` (fp32): losses within 2e-5 relative,
parameters within 2e-6 on 99.5% of elements and 1e-3 on all, logits
within 1e-5 x max(|ref|, 1); metric counts equal.

The step-folding tests mirror those of ``tests/test_step_folding.py``
that need metric accumulators and ``accumulate_grad_batches``, each as
the port's contract on the CPU: every K, trailing partial groups and
the eager route (``steps_per_dispatch=0``) end bit-identical, metric
accumulators included.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.io import DataLoader as JDataLoader
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.vision.datasets.mnist import _synthetic_mnist
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu.vision.models import resnet18 as jresnet18

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.hapi.callbacks import Callback, EarlyStopping
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.vision.models import LeNet, resnet18
from paddle_tpu_torch.vision.models import vision_state_dict_from_jax

TOL = 2e-5
PARAM_TOL = 2e-6
PARAM_BULK = 0.995
ADAM_NOISE_TOL = 1e-3
LOGIT_TOL = 1e-5
B = 16


def _rows(n=256, seed=0):
    images, labels = _synthetic_mnist(n, seed)
    return images[:, None], labels[:, None]


def _jax_lenet(seed=0):
    jpaddle.seed(seed)
    return JLeNet()


def _port_lenet(jnet):
    net = LeNet(device="cpu")
    net.load_state_dict(vision_state_dict_from_jax(jnet, net))
    return net


def _jax_model(jnet, metrics=True):
    m = jpaddle.Model(jnet)
    m.prepare(joptimizer.Adam(1e-3, parameters=jnet.parameters()),
              jnn.CrossEntropyLoss(),
              jpaddle.metric.Accuracy() if metrics else None)
    return m


def _port_model(net, metrics=True, lr=1e-3, **kw):
    m = tpaddle.Model(net, device="cpu")
    m.prepare(tpaddle.optimizer.Adam(lr, parameters=net.parameters()),
              tnn.CrossEntropyLoss(),
              tmetric.Accuracy() if metrics else None, **kw)
    return m


class _JRec(JCallback):
    def __init__(self):
        super().__init__()
        self.losses, self.accs = [], []

    def on_train_batch_end(self, step, logs=None):
        if "loss" in logs:
            self.losses.append(float(logs["loss"][0]))
        if "acc" in logs:
            self.accs.append(float(logs["acc"]))


class _Rec(Callback):
    def __init__(self):
        super().__init__()
        self.begins, self.ends, self.losses, self.accs = [], [], [], []

    def on_train_batch_begin(self, step, logs=None):
        self.begins.append(step)

    def on_train_batch_end(self, step, logs=None):
        self.ends.append(step)
        if "loss" in logs:
            self.losses.append(float(logs["loss"][0]))
        if "acc" in logs:
            self.accs.append(float(logs["acc"]))


def _assert_params_close(tnet, jnet):
    jstate = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    diffs = np.concatenate([np.abs(v.detach().numpy() - jstate[k]).ravel()
                            for k, v in tnet.state_dict().items()])
    assert (diffs <= PARAM_TOL).mean() >= PARAM_BULK
    assert diffs.max() <= ADAM_NOISE_TOL


# -- LeNet through fit, evaluate and predict, against JAX ------------------


def test_lenet_fit_evaluate_predict_match_jax():
    x, y = _rows()
    ex, ey = _rows(64, seed=1)
    jnet = _jax_lenet()
    net = _port_lenet(jnet)
    jm, tm = _jax_model(jnet), _port_model(net)
    jrec, trec = _JRec(), _Rec()
    jm.fit(JDataLoader(JTensorDataset([x, y]), batch_size=B), epochs=1,
           verbose=0, num_iters=8, callbacks=[jrec])
    tm.fit(DataLoader(TensorDataset([x, y]), batch_size=B), epochs=1,
           verbose=0, num_iters=8, callbacks=[trec])
    assert len(trec.losses) == len(jrec.losses) == 8
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=TOL)
    assert trec.accs == jrec.accs
    assert tm._metrics[0].accumulate() == jm._metrics[0].accumulate()
    _assert_params_close(net, jnet)

    jres = jm.evaluate(JTensorDataset([ex, ey]), batch_size=B, verbose=0)
    tres = tm.evaluate(TensorDataset([ex, ey]), batch_size=B, verbose=0)
    assert set(tres) == set(jres) == {"loss", "acc"}
    np.testing.assert_allclose(float(tres["loss"][0]),
                               float(jres["loss"][0]), rtol=TOL)
    assert tres["acc"] == jres["acc"]

    jout = jm.predict(JTensorDataset([ex[:32], ey[:32]]), batch_size=B,
                      stack_outputs=True)
    tout = tm.predict(TensorDataset([ex[:32], ey[:32]]), batch_size=B,
                      stack_outputs=True)
    ref = np.asarray(jout[0])
    assert isinstance(tout[0], np.ndarray) and tout[0].shape == (32, 10)
    np.testing.assert_allclose(tout[0], ref, rtol=0,
                               atol=LOGIT_TOL * max(np.abs(ref).max(), 1))


def test_accumulate_grad_batches_matches_jax_and_drops_the_tail():
    """Nine batches at k=2: four steps on two concatenated batches, the
    ninth dropped with a warning, in both packages."""
    x, y = _rows(9 * B)
    jnet = _jax_lenet()
    net = _port_lenet(jnet)
    jm, tm = _jax_model(jnet), _port_model(net)
    jrec, trec = _JRec(), _Rec()
    with pytest.warns(UserWarning, match="dropping trailing group of 1"):
        jm.fit(JDataLoader(JTensorDataset([x, y]), batch_size=B),
               epochs=1, verbose=0, accumulate_grad_batches=2,
               callbacks=[jrec])
    with pytest.warns(UserWarning, match="dropping trailing group of 1"):
        tm.fit(DataLoader(TensorDataset([x, y]), batch_size=B), epochs=1,
               verbose=0, accumulate_grad_batches=2, callbacks=[trec])
    assert trec.ends == list(range(9))
    assert tm._optimizer._global_step == 4
    # an intermediate batch's logs keep the last step's loss, in both
    assert len(trec.losses) == len(jrec.losses) == 8
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=TOL)
    _assert_params_close(net, jnet)


# -- step folding with metrics (port's own contract) ------------------------


def _state(model, metric=None):
    out = {f"param/{n}": p.detach().numpy().copy()
           for n, p in model.network.named_parameters()}
    for i, st in model._optimizer._state.items():
        for k, v in st.items():
            out[f"{i}/{k}"] = np.asarray(v if k == "steps" else v.numpy())
    out["global_step"] = np.asarray(model._optimizer._global_step)
    if metric is not None:
        out["metric"] = np.asarray(metric._device_stat_sum())
    return out


def _assert_bit_identical(a, b):
    assert set(a) == set(b) and len(a) > 10
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _lenet_batches(n, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    return [[torch.from_numpy(rng.rand(bs, 1, 28, 28).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, (bs,)).astype(np.int64))]
            for _ in range(n)]


def _fit_lenet(fold, batches, epochs=2, **kw):
    torch.manual_seed(0)
    net = LeNet(device="cpu", generator=torch.Generator().manual_seed(0))
    model = _port_model(net)
    model.fit(batches, epochs=epochs, verbose=0, steps_per_dispatch=fold,
              **kw)
    acc = model._metrics[0]
    return model, _state(model, acc), acc.accumulate()


@pytest.mark.parametrize("fold", [8, 0])
def test_lenet_fold_bit_identical_to_fold1(fold):
    """Mirrors ``test_lenet_fold8_bit_identical_to_fold1``: parameters,
    moments, beta powers, step counts and the Accuracy accumulator."""
    batches = _lenet_batches(8)
    m1, s1, a1 = _fit_lenet(1, batches)
    mk, sk, ak = _fit_lenet(fold, batches)
    assert a1 == ak
    _assert_bit_identical(s1, sk)
    assert mk.compile_stats() == ({"graphs": 0, "captures": 0} if fold == 0
                                  else {"graphs": 1, "captures": 1})


def _mlp():
    gen = torch.Generator().manual_seed(0)
    return tnn.Sequential(tnn.Linear(4, 8, device="cpu", generator=gen),
                          tnn.ReLU(),
                          tnn.Linear(8, 3, device="cpu", generator=gen))


def _mlp_batches(n, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    return [[torch.from_numpy(rng.rand(bs, 4).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 3, (bs,)).astype(np.int64))]
            for _ in range(n)]


def _mlp_model(metric=None, lr=1e-2):
    return _port_model(_mlp(), lr=lr) if metric is None else \
        _prepared(metric, lr)


def _prepared(metric, lr=1e-2):
    net = _mlp()
    m = tpaddle.Model(net, device="cpu")
    m.prepare(tpaddle.optimizer.Adam(lr, parameters=net.parameters()),
              tnn.CrossEntropyLoss(), metric)
    return m


def test_callbacks_fire_per_logical_step_with_metric_logs():
    """Mirrors ``test_callbacks_fire_per_logical_step_under_folding``."""
    rec = _Rec()
    _mlp_model().fit(_mlp_batches(10), epochs=1, verbose=0, callbacks=[rec],
                     steps_per_dispatch=4)
    assert rec.begins == rec.ends == list(range(10))
    assert len(rec.accs) == 10 and all(0.0 <= v <= 1.0 for v in rec.accs)
    rec1 = _Rec()
    _mlp_model().fit(_mlp_batches(10), epochs=1, verbose=0,
                     callbacks=[rec1], steps_per_dispatch=1)
    assert rec.losses == rec1.losses and rec.accs == rec1.accs


@pytest.mark.parametrize("fold", [8, 0])
def test_early_stopping_reads_evaluation(fold):
    """Mirrors ``test_early_stopping_under_folding``: ``eval_data`` runs
    after each epoch and EarlyStopping reads its logs."""
    m = _mlp_model()
    es = EarlyStopping(monitor="loss", patience=0, save_best_model=False)
    m.fit(_mlp_batches(8), eval_data=_mlp_batches(8, seed=1), epochs=4,
          verbose=0, callbacks=[es], steps_per_dispatch=fold)
    assert es.best is not None and m._optimizer._global_step >= 8


def test_host_only_metric_turns_folding_off_with_a_warning():
    """Mirrors ``test_host_only_metric_disables_folding``; in the port the
    warning is given whatever was requested, since folding never turns
    off silently."""

    class HostMetric(tmetric.Metric):
        def __init__(self):
            self.vals = []

        def compute(self, pred, label):
            return torch.zeros(())

        def update(self, x):
            self.vals.append(float(x))
            return 0.0

        def reset(self):
            self.vals = []

        def accumulate(self):
            return float(len(self.vals))

        def name(self):
            return "host"

    for requested in (8, None):
        metric = HostMetric()
        m = _prepared(metric)
        with pytest.warns(UserWarning, match="device-side accumulation"):
            m.fit(_mlp_batches(8), epochs=1, verbose=0,
                  steps_per_dispatch=requested)
        assert m._fold == 0 and len(metric.vals) == 8
        assert m.compile_stats() == {"graphs": 0, "captures": 0}


def test_fold_composes_with_accumulate_grad_batches():
    """Mirrors ``test_fold_composes_with_accumulate_grad_batches``, with
    the eager route as a third run."""
    states = {}
    for fold in (1, 4, 0):
        m = _prepared(tmetric.Accuracy())
        m.fit(_mlp_batches(16), epochs=2, verbose=0,
              accumulate_grad_batches=2, steps_per_dispatch=fold)
        states[fold] = _state(m, m._metrics[0])
        if fold == 4:
            assert m.compile_stats() == {"graphs": 1, "captures": 1}
    _assert_bit_identical(states[1], states[4])
    _assert_bit_identical(states[1], states[0])


def _binary_net():
    gen = torch.Generator().manual_seed(3)
    return tnn.Sequential(tnn.Linear(4, 8, device="cpu", generator=gen),
                          tnn.ReLU(),
                          tnn.Linear(8, 1, device="cpu", generator=gen),
                          tnn.Sigmoid())


def _mse(pred, label):
    return ((pred - label.to(pred.dtype)) ** 2).mean()


@pytest.mark.parametrize("make", [
    lambda: tmetric.Precision(), lambda: tmetric.Recall(),
    lambda: tmetric.Auc(num_thresholds=255)],
    ids=["precision", "recall", "auc"])
def test_threshold_metrics_fold_matches_host_path(make):
    """Mirrors ``test_threshold_metrics_fold_matches_host_path``: the
    folded run's device accumulators against the numpy update of every
    batch's pre-step predictions in an identical eager run."""
    rng = np.random.RandomState(0)
    batches = [[torch.from_numpy(rng.rand(32, 4).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 2, (32, 1)).astype(np.int64))]
               for _ in range(8)]
    dev_metric = make()
    net = _binary_net()
    m = tpaddle.Model(net, device="cpu")
    m.prepare(tpaddle.optimizer.Adam(1e-2, parameters=net.parameters()),
              _mse, dev_metric)
    m.fit(batches, epochs=1, verbose=0, steps_per_dispatch=8)
    host_metric = make()
    ref_net = _binary_net()
    ref = tpaddle.Model(ref_net, device="cpu")
    ref.prepare(tpaddle.optimizer.Adam(1e-2, parameters=ref_net.parameters()),
                _mse)
    for x, y in batches:
        with torch.no_grad():
            host_metric.update(ref_net(x).numpy(), y.numpy())
        ref.train_batch([x], [y])
    assert dev_metric.accumulate() == host_metric.accumulate()


def test_accuracy_carry_agrees_with_the_pending_path():
    """Mirrors ``test_accuracy_carry_agrees_with_legacy_pending_path``:
    11 batches at K=4 (groups of 4, 4 and 3), K=1 and the eager route."""
    results = []
    for fold in (4, 1, 0):
        acc = tmetric.Accuracy()
        _prepared(acc).fit(_mlp_batches(11), epochs=1, verbose=0,
                           steps_per_dispatch=fold)
        results.append(acc.accumulate())
        assert (acc._dev_acc is None) == (fold == 0)
    assert results[0] == results[1] == results[2]


def test_fold_through_dataloader():
    """Mirrors ``test_fold_through_dataloader``: the loader's fold hint
    is set while fit runs and reset after."""
    rng = np.random.RandomState(0)
    ds = TensorDataset([rng.rand(64, 4).astype(np.float32),
                        rng.randint(0, 3, (64,)).astype(np.int64)])
    seen = []

    class Hint(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            seen.append(loader._fold_hint)

    m = _prepared(tmetric.Accuracy())
    loader = DataLoader(ds, batch_size=8, shuffle=False)
    m.fit(loader, epochs=2, verbose=0, steps_per_dispatch=4,
          callbacks=[Hint()])
    assert seen == [4, 4] and loader._fold_hint == 1
    assert loader._stage_device is None
    assert m.compile_stats() == {"graphs": 1, "captures": 1}


def test_uneven_trailing_batch_splits_the_group():
    """Mirrors ``test_uneven_trailing_batch_splits_the_group``."""
    batches = _mlp_batches(5) + _mlp_batches(1, bs=3, seed=7)
    m = _prepared(tmetric.Accuracy())
    m.fit(batches, epochs=2, verbose=0, steps_per_dispatch=5)
    assert m.compile_stats() == {"graphs": 2, "captures": 2}
    m1 = _prepared(tmetric.Accuracy())
    m1.fit(batches, epochs=2, verbose=0, steps_per_dispatch=1)
    _assert_bit_identical(_state(m, m._metrics[0]),
                          _state(m1, m1._metrics[0]))


def test_fold_accumulate_callbacks_stay_in_step_order():
    """Mirrors ``test_fold_accumulate_callbacks_stay_in_step_order``."""
    order = []

    class Rec(Callback):
        def on_train_batch_end(self, step, logs=None):
            order.append(step)

    _prepared(tmetric.Accuracy()).fit(
        _mlp_batches(8), epochs=1, verbose=0, accumulate_grad_batches=2,
        steps_per_dispatch=2, callbacks=[Rec()])
    assert order == list(range(8))


def test_visualdl_and_progbar_log_train_and_eval(tmp_path, capsys):
    """``VisualDL`` writes JSON lines with the JAX package's tags;
    ``ProgBarLogger`` prints the metric and the evaluation."""
    import json
    from paddle_tpu_torch.hapi.callbacks import VisualDL
    vdl = VisualDL(log_dir=str(tmp_path), log_freq=2)
    m = _prepared(tmetric.Accuracy())
    m.fit(_mlp_batches(4), eval_data=_mlp_batches(2, seed=1), epochs=1,
          verbose=2, log_freq=2, callbacks=[vdl])
    (path,) = list(tmp_path.iterdir())
    tags = {json.loads(line)["tag"] for line in path.read_text().splitlines()}
    assert {"train/loss", "train/acc", "eval/loss", "eval/acc"} <= tags
    out = capsys.readouterr().out
    assert "acc:" in out and "Eval - loss:" in out


def test_jit_false_and_eval_batch_take_the_eager_route():
    m = _prepared(tmetric.Accuracy())
    m.prepare(m._optimizer, tnn.CrossEntropyLoss(), tmetric.Accuracy(),
              jit=False)
    m.fit(_mlp_batches(4), epochs=1, verbose=0, steps_per_dispatch=4)
    assert m._fold == 0 and m.compile_stats() == {"graphs": 0, "captures": 0}
    x, y = _mlp_batches(1)[0]
    loss, (acc,) = m.eval_batch([x], [y])
    assert np.isfinite(float(loss[0])) and 0.0 <= float(acc) <= 1.0


# -- checkpoints ----------------------------------------------------------


def _one_step_both(jm, tm, batch):
    x, y = batch
    jl, _ = jm.train_batch([x], [y])
    tl, _ = tm.train_batch([torch.from_numpy(x)], [torch.from_numpy(y)])
    return float(np.asarray(jl[0])), float(tl[0])


def test_jax_checkpoint_loads_into_the_port_and_steps_alike(tmp_path):
    x, y = _rows(3 * B)
    jnet = _jax_lenet()
    jm = _jax_model(jnet)
    jm.fit(JDataLoader(JTensorDataset([x[:2 * B], y[:2 * B]]),
                       batch_size=B), epochs=1, verbose=0)
    path = str(tmp_path / "jax")
    jm.save(path)
    tm = _port_model(LeNet(device="cpu"))
    tm.load(path)
    assert tm._optimizer._global_step == 2
    jl, tl = _one_step_both(jm, tm, (x[2 * B:], y[2 * B:]))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    _assert_params_close(tm.network, jnet)


def test_port_checkpoint_loads_into_jax_and_steps_alike(tmp_path):
    x, y = _rows(3 * B)
    jnet = _jax_lenet()
    tm = _port_model(_port_lenet(jnet))
    tm.fit(DataLoader(TensorDataset([x[:2 * B], y[:2 * B]]), batch_size=B),
           epochs=1, verbose=0)
    path = str(tmp_path / "port")
    tm.save(path)
    sd = jpaddle.load(path + ".pdopt")
    assert sd["global_step"] == 2 and "fc.0.bias.beta1_pow" in sd
    assert not any(k.endswith(".steps") for k in sd)
    jm = _jax_model(_jax_lenet(seed=1))
    jm.load(path)
    jl, tl = _one_step_both(jm, tm, (x[2 * B:], y[2 * B:]))
    np.testing.assert_allclose(jl, tl, rtol=TOL)
    _assert_params_close(tm.network, jm.network)


def test_upstream_pdopt_imports_by_position(tmp_path):
    """An upstream Paddle ``.pdopt`` (``linear_0.w_0_moment1_0`` keys,
    shape-[1] beta powers) lands on the parameters in creation order."""
    m = _prepared(tmetric.Accuracy())
    params = m._optimizer.parameters()
    rng = np.random.RandomState(0)
    sd, want = {}, []
    for i, p in enumerate(params):
        up = f"linear_{i // 2}.{'w' if i % 2 == 0 else 'b'}_0"
        m1 = rng.rand(*p.shape).astype(np.float32)
        sd[f"{up}_moment1_0"] = m1
        sd[f"{up}_moment2_0"] = rng.rand(*p.shape).astype(np.float32)
        sd[f"{up}_beta1_pow_acc_0"] = np.asarray([0.9 ** 3], np.float32)
        sd[f"{up}_beta2_pow_acc_0"] = np.asarray([0.999 ** 3], np.float32)
        want.append(m1)
    tpaddle.save(sd, str(tmp_path / "up.pdopt"))
    m._optimizer.set_state_dict(tpaddle.load(str(tmp_path / "up.pdopt")))
    for i, m1 in enumerate(want):
        st = m._optimizer._state[i]
        np.testing.assert_array_equal(st["moment1"].numpy(), m1)
        assert st["beta1_pow"].shape == () and st["steps"] == 3


def test_model_checkpoint_writes_each_epoch_and_final(tmp_path):
    m = _prepared(tmetric.Accuracy())
    m.fit(_mlp_batches(4), epochs=2, verbose=0, save_dir=str(tmp_path),
          save_freq=1)
    names = sorted(os.listdir(tmp_path))
    assert names == ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
                     "final.pdopt", "final.pdparams"]


def test_load_copies_in_place_and_reset_optimizer(tmp_path):
    """``load`` copies into the live tensors (a captured step keeps its
    addresses); ``reset_optimizer`` leaves the optimizer's state as it
    was."""
    src = _prepared(tmetric.Accuracy())
    src.fit(_mlp_batches(3), epochs=1, verbose=0, steps_per_dispatch=2)
    path = str(tmp_path / "ck")
    src.save(path)
    dst = _prepared(tmetric.Accuracy())
    dst.fit(_mlp_batches(2, seed=5), epochs=1, verbose=0,
            steps_per_dispatch=2)
    ptrs = [p.data_ptr() for p in dst.network.parameters()]
    states = [st["moment1"].data_ptr() for st in dst._optimizer._state.values()]
    before = {k: v.clone() for k, v in dst._optimizer._state[0].items()
              if k != "steps"}
    dst.load(path, reset_optimizer=True)
    assert [p.data_ptr() for p in dst.network.parameters()] == ptrs
    for (_, a), b in zip(src.network.state_dict().items(),
                         dst.network.state_dict().values()):
        assert torch.equal(a, b)
    for k, v in before.items():
        assert torch.equal(dst._optimizer._state[0][k], v)
    assert dst._optimizer._global_step == 2
    dst.load(path)
    assert dst._optimizer._global_step == 3
    assert [st["moment1"].data_ptr()
            for st in dst._optimizer._state.values()] == states
    _assert_bit_identical(_state(src), _state(dst))
    assert dst.compile_stats() == {"graphs": 1, "captures": 1}


def test_save_training_false_is_refused():
    with pytest.raises(NotImplementedError, match="item 12"):
        _prepared(tmetric.Accuracy()).save("unused", training=False)


# -- summary and flops ------------------------------------------------------


@pytest.mark.parametrize("arch", ["lenet", "resnet18"])
def test_summary_and_flops_equal_jax(arch, capsys):
    if arch == "lenet":
        jnet, size = _jax_lenet(), [1, 1, 28, 28]
        net = _port_lenet(jnet)
    else:
        jpaddle.seed(0)
        jnet, size = jresnet18(num_classes=10), [1, 3, 64, 64]
        net = resnet18(num_classes=10, device="cpu")
    want = jpaddle.summary(jnet, tuple(size))
    got = tpaddle.summary(net, tuple(size))
    assert got == want
    assert tpaddle.Model(net, device="cpu").summary() == want
    assert tpaddle.flops(net, size) == jpaddle.flops(jnet, size)
    assert "Total params" in capsys.readouterr().out
