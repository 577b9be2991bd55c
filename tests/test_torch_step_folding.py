"""Step folding in the PyTorch port: ``Model.fit(steps_per_dispatch=K)``
and ``paddle_tpu_torch/framework/dispatch.py``, against the port's own
eager route and against the JAX package.

Mirrors the single-chip half of ``tests/test_step_folding.py`` and the
auto-fold tests of ``tests/test_dispatch_engine.py``.  On the CPU the
fold engine runs the step body eagerly, one group at a time, so every
K (trailing partial groups included) and the eager route
(``steps_per_dispatch=0``) must end bit-identical: parameters, moments,
beta powers and step counts.  On the card each logical step of a
group is a replay of one captured CUDA graph; the ``cuda``-marked tests
at the end hold the replays to the same contract and skip here.

The fold tests that need metric accumulators carried through the fold
and ``accumulate_grad_batches`` markers are mirrored in
``tests/test_torch_hapi.py``: ``test_lenet_fold_bit_identical_to_fold1``,
``test_callbacks_fire_per_logical_step_with_metric_logs``,
``test_early_stopping_reads_evaluation``,
``test_host_only_metric_turns_folding_off_with_a_warning``,
``test_fold_composes_with_accumulate_grad_batches``,
``test_threshold_metrics_fold_matches_host_path``,
``test_accuracy_carry_agrees_with_the_pending_path``,
``test_fold_through_dataloader``,
``test_uneven_trailing_batch_splits_the_group`` and
``test_fold_accumulate_callbacks_stay_in_step_order``.  Still not
mirrored (ROADMAP queue A): by-step LR schedulers wait for item A8
(``optimizer/lr.py``), the mesh runner for A10 and the retrace sentinel
for A14.

Across packages the tolerances are those of ``tests/test_torch_
training.py::test_three_adamw_fit_steps_match_jax`` (fp32): losses 2e-5
relative, parameters 2e-6 on 99.5% of elements and 1e-3 on all.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.framework import dispatch
from paddle_tpu_torch.hapi.callbacks import Callback, ProgBarLogger
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny, state_dict_from_jax)
from paddle_tpu_torch.ops import flash_attention_kernel as fk

TOL = 2e-5
PARAM_TOL = 2e-6
PARAM_BULK = 0.995
ADAM_NOISE_TOL = 1e-3
S = 32


def _batches(n, b=2, s=S, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, 256, (b, s)).astype(np.int64)
        out.append((torch.from_numpy(x),
                    torch.from_numpy(np.roll(x, -1, axis=1))))
    return out


def _model(device="cpu", seed=0, lr=1e-3, dropout=0.0):
    cfg = gpt_tiny(hidden_dropout_prob=dropout,
                   attention_probs_dropout_prob=dropout)
    gen = torch.Generator(device=device).manual_seed(seed)
    net = GPTForCausalLM(cfg, device=device, generator=gen)
    opt = tpaddle.optimizer.AdamW(lr, parameters=net.parameters())
    model = tpaddle.Model(net, device=device)
    model.prepare(opt, GPTPretrainingCriterion())
    return model


class _Recorder(Callback):
    def __init__(self):
        super().__init__()
        self.begins, self.ends, self.losses = [], [], []

    def on_train_batch_begin(self, step, logs=None):
        self.begins.append(step)

    def on_train_batch_end(self, step, logs=None):
        self.ends.append(step)
        self.losses.append(float(logs["loss"][0]))


def _state(model):
    """Parameters, moments, beta powers and step counts, on the host."""
    out = {f"param/{n}": p.detach().cpu().numpy()
           for n, p in model.network.named_parameters()}
    opt = model._optimizer
    for i, st in opt._state.items():
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow",
                  "master_weight"):
            if k in st:
                out[f"{i}/{k}"] = st[k].detach().cpu().numpy()
        out[f"{i}/steps"] = np.asarray(st["steps"])
    out["global_step"] = np.asarray(opt._global_step)
    return out


def _assert_bit_identical(a, b):
    sa, sb = _state(a), _state(b)
    assert set(sa) == set(sb) and len(sa) > 10
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


# -- end state ------------------------------------------------------------


@pytest.mark.parametrize("fold", [1, 4, 8])
def test_every_fold_ends_bit_identical_to_the_eager_route(fold):
    """11 batches: at K=4 two full groups and a trailing group of 3, at
    K=8 one of 8 and one of 3; two epochs."""
    eager = _model()
    eager.fit(_batches(11), epochs=2, verbose=0, steps_per_dispatch=0)
    folded = _model()
    folded.fit(_batches(11), epochs=2, verbose=0, steps_per_dispatch=fold)
    assert folded._optimizer._global_step == 22
    _assert_bit_identical(eager, folded)
    assert folded.compile_stats() == {"graphs": 1, "captures": 1}
    assert eager.compile_stats() == {"graphs": 0, "captures": 0}


def test_uneven_last_batch_splits_the_group():
    """Five batches of 2 and one of 1 at K=5: a group of 5, then the
    odd batch alone under its own signature, every epoch."""
    data = _batches(5) + _batches(1, b=1, seed=7)
    folded = _model()
    folded.fit(data, epochs=2, verbose=0, steps_per_dispatch=5)
    assert folded.compile_stats() == {"graphs": 2, "captures": 2}
    eager = _model()
    eager.fit(data, epochs=2, verbose=0, steps_per_dispatch=0)
    _assert_bit_identical(eager, folded)


def test_one_capture_per_signature_whatever_the_fold():
    model = _model()
    model.fit(_batches(16), epochs=3, verbose=0, steps_per_dispatch=8)
    assert model.compile_stats() == {"graphs": 1, "captures": 1}
    for fold in (4, 3, 1, None):
        model.fit(_batches(16), epochs=1, verbose=0,
                  steps_per_dispatch=fold)
    assert model.compile_stats() == {"graphs": 1, "captures": 1}
    model.fit(_batches(2, s=16), epochs=1, verbose=0, steps_per_dispatch=2)
    assert model.compile_stats() == {"graphs": 2, "captures": 2}
    model.prepare(model._optimizer, model._loss)
    assert model.compile_stats() == {"graphs": 0, "captures": 0}


# -- callbacks ------------------------------------------------------------


def test_callbacks_fire_per_logical_step_in_order():
    rec = _Recorder()
    _model().fit(_batches(10), epochs=1, verbose=0, callbacks=[rec],
                 steps_per_dispatch=4)
    assert rec.begins == list(range(10)) and rec.ends == list(range(10))
    assert all(np.isfinite(rec.losses))
    assert len(set(rec.losses)) == 10        # one slot per step
    rec1 = _Recorder()
    _model().fit(_batches(10), epochs=1, verbose=0, callbacks=[rec1],
                 steps_per_dispatch=1)
    np.testing.assert_array_equal(rec.losses, rec1.losses)


def test_losses_of_a_group_are_lazy_views_of_one_stack():
    """The callbacks of a group get views of one ``[K]`` stack; the
    first read fetches it for all of them."""
    seen = []

    class Keep(Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(logs["loss"][0])

    _model().fit(_batches(4), epochs=1, verbose=0, callbacks=[Keep()],
                 steps_per_dispatch=4)
    stacks = {id(v._dev) for v in seen}
    assert len(seen) == 4 and len(stacks) == 1
    host = [float(v) for v in seen]
    assert seen[0]._dev is None and len(set(host)) == 4


class _StopAt(Callback):
    """Sets ``stop_training`` at the end of step ``step`` or, with
    ``epoch_end``, at the end of the first epoch."""

    def __init__(self, step=None, epoch_end=False):
        super().__init__()
        self.step, self.epoch_end = step, epoch_end
        self.ends = []

    def on_train_batch_end(self, step, logs=None):
        self.ends.append(step)
        if step == self.step:
            self.model.stop_training = True

    def on_epoch_end(self, epoch, logs=None):
        if self.epoch_end:
            self.model.stop_training = True


@pytest.mark.parametrize("fold", [0, 1, 4])
def test_early_stopping_takes_effect_at_a_group_boundary(fold):
    """As in the JAX package, ``stop_training`` is read at the end of an
    epoch: under folding that is after the epoch's last group, so a
    stop set in the middle of a group never cuts it, and a stop at an
    epoch's end ends the fit."""
    cb = _StopAt(epoch_end=True)
    model = _model()
    model.fit(_batches(6), epochs=3, verbose=0, callbacks=[cb],
              steps_per_dispatch=fold)
    assert cb.ends == list(range(6))
    assert model._optimizer._global_step == 6
    cb = _StopAt(step=5)
    model = _model()
    model.fit(_batches(10), epochs=2, verbose=0, callbacks=[cb],
              steps_per_dispatch=fold)
    assert cb.ends == list(range(10))
    assert model._optimizer._global_step == 10


def test_progbar_formats_folded_values(capsys):
    _model().fit(_batches(8), epochs=1, verbose=2, log_freq=2,
                 steps_per_dispatch=4)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [ln.split(" - ")[0] for ln in lines] == [
        "step 1/8", "step 3/8", "step 5/8", "step 7/8"]
    assert all("loss: " in ln for ln in lines)
    _model().fit(_batches(8), epochs=1, verbose=2, log_freq=2,
                 steps_per_dispatch=1)
    eager = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert lines == eager


# -- resolution of steps_per_dispatch ----------------------------------------


def test_fold_resolution():
    model = _model()
    # no per-step consumer: the tuner picks K, host-bound here
    model.fit(_batches(10), epochs=1, verbose=0)
    tuner = model._fold_tuner
    assert tuner is not None and tuner.decided
    assert 1 < model._fold <= tuner.max_fold
    assert model._fold == tuner.decision["fold"]
    # a verbose progress bar consumes per-step logs
    model.fit(_batches(2), epochs=1, verbose=2, log_freq=1)
    assert model._fold == 1 and model._fold_tuner is None
    # a quiet progress bar does not
    model.fit(_batches(2), epochs=1, verbose=0,
              callbacks=[ProgBarLogger(verbose=0)])
    assert model._fold_tuner is not None
    # any user batch hook does
    model.fit(_batches(2), epochs=1, verbose=0, callbacks=[_Recorder()])
    assert model._fold == 1 and model._fold_tuner is None
    # an explicit request wins, and 0 is the eager route
    model.fit(_batches(2), epochs=1, verbose=2, steps_per_dispatch=2)
    assert model._fold == 2 and model._fold_tuner is None
    model.fit(_batches(2), epochs=1, verbose=0, steps_per_dispatch=0)
    assert model._fold == 0 and model._fold_tuner is None


def test_auto_fold_respects_its_bound_end_to_end(monkeypatch):
    monkeypatch.setenv("PADDLE_TORCH_FOLD_MAX", "3")
    model = _model()
    model.fit(_batches(10), epochs=1, verbose=0)
    assert model._fold_tuner.decided and model._fold == 3
    eager = _model()
    eager.fit(_batches(10), epochs=1, verbose=0, steps_per_dispatch=0)
    _assert_bit_identical(eager, model)


# -- the tuner's decision ----------------------------------------------------


def _tuned(host_ms, device_ms):
    t = dispatch.AutoFoldTuner(target=0.05, max_fold=32, calib_groups=3)
    t.observe(1, 99.0, 99.0)        # warm-up and capture: discarded
    for _ in range(3):
        t.observe(1, host_ms * 1e-3, device_ms * 1e-3)
    assert t.decided
    return t


def test_auto_fold_picks_the_smallest_k_within_budget():
    t = _tuned(host_ms=1.0, device_ms=4.0)   # ceil(1 / (0.05 * 4)) = 5
    assert t.fold == 5 and t.decision["fold"] == 5
    assert t.decision["host_ms_per_step"] == 1.0
    assert t.decision["device_ms_per_step"] == 4.0


def test_auto_fold_device_bound_stays_at_1():
    assert _tuned(host_ms=0.01, device_ms=10.0).fold == 1


def test_auto_fold_host_bound_saturates_at_max():
    assert _tuned(host_ms=1.0, device_ms=0.0).fold == 32
    assert _tuned(host_ms=100.0, device_ms=0.1).fold == 32


def test_auto_fold_env_bounds(monkeypatch):
    monkeypatch.setenv("PADDLE_TORCH_FOLD_MAX", "4")
    monkeypatch.setenv("PADDLE_TORCH_FOLD_OVERHEAD_TARGET", "0.25")
    monkeypatch.setenv("PADDLE_TORCH_FOLD_CALIB_GROUPS", "2")
    t = dispatch.AutoFoldTuner()
    assert (t.max_fold, t.target, t.calib_groups) == (4, 0.25, 2)
    t.observe(1, 1.0, 1.0)
    for _ in range(2):
        t.observe(1, 1.0, 1e-9)      # host-bound
    assert t.decided and t.fold == 4


def test_group_dispatcher_splits_at_a_shape_change_and_flushes_the_tail():
    runs, emitted = [], []

    def run(groups):
        runs.append(len(groups))
        return "losses", []

    def emit(entries, losses, _m):
        emitted.extend(step for step, _, _ in entries)

    eng = dispatch.GroupDispatcher(run, emit, fold=4)
    a, b = np.zeros((2, 3)), np.zeros((1, 3))
    for step, x in enumerate([a] * 6 + [b] + [a] * 2):
        eng.feed(step, [x], [x])
    assert eng.pending
    eng.flush()
    assert runs == [4, 2, 1, 2] and emitted == list(range(9))
    assert not eng.pending


# -- the optimizer's device scalars ----------------------------------------


@pytest.mark.parametrize("opt_name,kw", [
    ("AdamW", dict(weight_decay=0.1)),
    ("Adam", dict(weight_decay=None)),
])
def test_beta_powers_are_device_scalars_matching_jax(opt_name, kw):
    """Ten steps on identical gradients: the beta powers are 0-d fp32
    tensors on the parameter's device, equal to the JAX package's
    float32 powers, and the weights agree as
    ``test_adam_update_matches_jax_on_identical_gradients`` holds them."""
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    jlin = jnn.Linear(4, 3, bias_attr=False)
    jlin.weight.set_value(w0)
    jopt = getattr(joptimizer, opt_name)(
        learning_rate=0.05, epsilon=1e-2, parameters=jlin.parameters(), **kw)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = getattr(tpaddle.optimizer, opt_name)(
        learning_rate=0.05, epsilon=1e-2, parameters=[tw], **kw)
    for step in range(10):
        g = rng.standard_normal((4, 3)).astype(np.float32) * 0.1 ** (step % 3)
        jlin.weight.grad = jpaddle.to_tensor(g)
        jopt.step()
        tw.grad = torch.from_numpy(g)
        topt.step()
    st = topt._state[0]
    jst = next(iter(jopt._state.values()))
    for k in ("beta1_pow", "beta2_pow"):
        assert isinstance(st[k], torch.Tensor) and st[k].dim() == 0
        assert st[k].dtype == torch.float32 and st[k].device == tw.device
        assert st[k].item() == float(np.asarray(jst[k], np.float32)), k
    assert st["steps"] == 10 and topt._global_step == 10
    np.testing.assert_allclose(tw.detach().numpy(),
                               np.asarray(jlin.weight.numpy()),
                               rtol=1e-6, atol=1e-6)
    _bf16_without_master_matches_jax(opt_name, kw)


def _bf16_without_master_matches_jax(opt_name, kw):
    """A bf16 64x64 weight with no fp32 master, 20 steps on identical bf16
    gradients: the moments are fp32, as the JAX package keeps them, and
    the update rounds into the weight once.  Judged by the share of
    weights equal to the reference's: a tolerance cannot see a rounding
    fault, which moves a weight by one bf16 ulp."""
    from paddle_tpu.tensor import Parameter as JParameter
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((64, 64)).astype(np.float32)
    jw = JParameter(w0.copy())
    jw._value = jw._value.astype("bfloat16")
    jopt = getattr(joptimizer, opt_name)(learning_rate=1e-3,
                                         parameters=[jw], **kw)
    tw = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    topt = getattr(tpaddle.optimizer, opt_name)(learning_rate=1e-3,
                                                parameters=[tw], **kw)
    for _ in range(20):
        g = rng.standard_normal((64, 64)).astype(np.float32)
        jw.grad = jpaddle.to_tensor(g).astype("bfloat16")
        jopt.step()
        tw.grad = torch.from_numpy(g).to(torch.bfloat16)
        topt.step()
    st = topt._state[0]
    assert "master_weight" not in st and tw.dtype == torch.bfloat16
    assert st["moment1"].dtype == st["moment2"].dtype == torch.float32
    jst = next(iter(jopt._state.values()))
    assert str(jst["moment1"].dtype) == "float32"
    ref = np.asarray(jw._value.astype("float32"))
    same = float((tw.detach().float().numpy() == ref).mean())
    assert same >= 0.99, same
    np.testing.assert_allclose(st["moment2"].numpy(),
                               np.asarray(jst["moment2"]), rtol=1e-6)


def test_learning_rate_is_a_device_scalar_refreshed_once_it_changes():
    tw = torch.nn.Parameter(torch.ones(3))
    opt = tpaddle.optimizer.AdamW(0.5, parameters=[tw])
    tw.grad = torch.ones(3)
    opt.step()
    lr = opt._lr_scalar(tw.device)
    assert lr.dim() == 0 and lr.dtype == torch.float32 and lr.item() == 0.5
    opt._learning_rate = 0.25
    opt.refresh_lr()
    assert opt._lr_scalar(tw.device) is lr and lr.item() == 0.25


# -- across packages -------------------------------------------------------


class _JLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def test_folded_fit_matches_jax_folded_fit():
    """Both packages' ``fit(steps_per_dispatch=4)`` on the same tiny GPT
    weights and six batches: a group of 4 and a trailing group of 2."""
    jpaddle.seed(0)
    jnet = JGPTForCausalLM(jgpt_tiny(max_position_embeddings=256))
    cfg = gpt_tiny(max_position_embeddings=256)
    net = GPTForCausalLM(cfg, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net.load_state_dict(state_dict_from_jax(state, cfg))
    rng = np.random.default_rng(2)
    data = []
    for _ in range(6):
        x = rng.integers(0, 256, (2, 128)).astype(np.int64)
        data.append((x, np.roll(x, -1, axis=1)))
    jmodel = jpaddle.Model(jnet)
    jmodel.prepare(joptimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                    parameters=jnet.parameters()),
                   JGPTPretrainingCriterion())
    jcb = _JLosses()
    jmodel.fit(data, epochs=1, verbose=0, callbacks=[jcb],
               steps_per_dispatch=4)
    tmodel = tpaddle.Model(net, device="cpu")
    tmodel.prepare(tpaddle.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=net.parameters()),
        GPTPretrainingCriterion())
    tcb = _Recorder()
    fk.reset_counts()
    tmodel.fit([(torch.from_numpy(a), torch.from_numpy(b))
                for a, b in data], epochs=1, verbose=0, callbacks=[tcb],
               steps_per_dispatch=4)
    assert jmodel._fold == 4 and tmodel._fold == 4
    assert len(tcb.losses) == len(jcb.losses) == 6
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=TOL)
    # six steps x two layers through the plain versions, no launch
    assert [f.plain_calls for f in fk.WRAPPERS] == [12, 12, 12]
    assert [f.launches for f in fk.WRAPPERS] == [0, 0, 0]
    jstate = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in net.state_dict().items()])
    assert (diffs <= PARAM_TOL).mean() >= PARAM_BULK
    assert diffs.max() <= ADAM_NOISE_TOL


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replays_end_bit_identical_for_every_fold(cuda_device):
    models = {}
    for fold in (1, 4):
        models[fold] = _model(device=cuda_device)
        models[fold].fit(_batches(11), epochs=1, verbose=0,
                         steps_per_dispatch=fold)
        assert models[fold].compile_stats() == {"graphs": 1, "captures": 1}
    _assert_bit_identical(models[1], models[4])
    eager = _model(device=cuda_device)
    eager.fit(_batches(11), epochs=1, verbose=0, steps_per_dispatch=0)
    a, b = _state(eager), _state(models[4])
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(a[k]).max()),
                                   err_msg=k)


@pytest.mark.cuda
def test_cuda_launch_counts_count_replays(cuda_device):
    fk.reset_counts()
    _model(device=cuda_device).fit(_batches(6), epochs=1, verbose=0,
                                   steps_per_dispatch=4)
    # six steps (one eager, five replays) x two layers
    assert [f.launches for f in fk.WRAPPERS] == [12, 12, 12]
    assert [f.plain_calls for f in fk.WRAPPERS] == [0, 0, 0]


@pytest.mark.cuda
def test_cuda_dropout_replays_advance_the_generator_as_eager_steps(
        cuda_device):
    from paddle_tpu_torch.framework import random as _random
    ends = {}
    for fold in (1, 4):
        _random.seed(3)
        model = _model(device=cuda_device, dropout=0.1)
        model.fit(_batches(6), epochs=1, verbose=0, steps_per_dispatch=fold)
        ends[fold] = (_state(model),
                      _random.default_generator(cuda_device).get_offset())
    _random.seed(3)
    eager = _model(device=cuda_device, dropout=0.1)
    eager.fit(_batches(6), epochs=1, verbose=0, steps_per_dispatch=0)
    offset = _random.default_generator(cuda_device).get_offset()
    assert ends[1][1] == ends[4][1] == offset
    a, b = ends[1][0], ends[4][0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
