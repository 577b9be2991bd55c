"""GPT training of the PyTorch port against the JAX package.

``gpt_tiny`` (2 layers, hidden 64, 4 heads, vocab 256) with dropout 0
and 256 positions is built in the JAX package; its weights carry over
to the port through ``state_dict_from_jax``, and both packages see the
same numpy tokens.  On the CPU the port's flash attention runs the
kernels' plain versions and the JAX package its composed form, so the
comparison holds the model, the loss, the gradients, AdamW and
``Model.fit`` to the reference.  Tolerances (fp32): the two compute
the same sums in another order (XLA vs ATen on the CPU), which moves
the last few bits of each value: 2e-5 on logits, loss and gradients
(fp32 epsilon times the depth of the sums, with a margin of ~10x).
AdamW is pinned twice: fed identical gradients, both optimizers agree
to 1e-6 over three steps; after three ``Model.fit`` steps the
parameters agree to 2e-6 on 99.5% of elements and to 1e-3 on all.
The wider bound is Adam's: it divides each moment by its own RMS, so
an element whose gradient is rounding noise in both packages (the key
bias, whose exact gradient is 0 because softmax ignores a shift shared
by all keys) moves up to ~lr per step in a direction set by the noise.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.hapi.callbacks import Callback as TCallback
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny, state_dict_from_jax)
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from torch_parity_helpers import torch_one_thread  # noqa: F401

TOL = 2e-5
PARAM_TOL = 2e-6
PARAM_BULK = 0.995
ADAM_NOISE_TOL = 1e-3
B, S = 2, 128


def _jax_model(seed=0):
    jpaddle.seed(seed)
    net = JGPTForCausalLM(jgpt_tiny(max_position_embeddings=256))
    return net


def _port_model(jnet):
    cfg = gpt_tiny(max_position_embeddings=256)
    net = GPTForCausalLM(cfg, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net.load_state_dict(state_dict_from_jax(state, cfg))
    return net


def _tokens(seed=0, b=B, s=S, vocab=256):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (b, s)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def test_carry_over_keeps_names_layout_and_the_tie():
    jnet = _jax_model()
    net = _port_model(jnet)
    jstate = jnet.state_dict()
    tstate = net.state_dict()
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].numpy(), _np(v))
    # one Parameter serves the embedding and the lm head
    assert net.lm_weight() is net.gpt.embeddings.word_embeddings.weight
    assert len(list(net.parameters())) == len(jstate)
    with pytest.raises(KeyError):
        state_dict_from_jax({}, gpt_tiny(max_position_embeddings=256))


def test_logits_match_jax():
    jnet = _jax_model()
    net = _port_model(jnet)
    x, _ = _tokens()
    ref = _np(jnet(jpaddle.to_tensor(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (B, S, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_loss_and_every_gradient_match_jax():
    jnet = _jax_model()
    net = _port_model(jnet)
    x, y = _tokens(1)
    y[0, :5] = -100                      # ignored positions
    jcrit = JGPTPretrainingCriterion()
    jloss = jcrit(jnet(jpaddle.to_tensor(x)), jpaddle.to_tensor(y))
    jloss.backward()
    loss = GPTPretrainingCriterion()(net(torch.from_numpy(x)),
                                     torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(_np(jloss)), rtol=TOL)
    jgrads = {n: _np(p.grad) for n, p in jnet.named_parameters()}
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], rtol=TOL, atol=TOL,
                                   err_msg=n)


class _JLosses(JCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


class _TLosses(TCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def _batches(n, seed=2):
    return [_tokens(seed + i) for i in range(n)]


def _fit_both(o2=False, steps=3, lr=1e-3):
    jnet = _jax_model()
    net = _port_model(jnet)
    jopt = joptimizer.AdamW(learning_rate=lr, parameters=jnet.parameters(),
                            weight_decay=0.01)
    topt = tpaddle.optimizer.AdamW(learning_rate=lr,
                                   parameters=net.parameters(),
                                   weight_decay=0.01)
    if o2:
        jamp.decorate(jnet, jopt, level="O2", dtype="bfloat16")
        tamp.decorate(net, topt, level="O2", dtype="bfloat16")
    data = _batches(steps)
    jmodel = jpaddle.Model(jnet)
    jmodel.prepare(jopt, JGPTPretrainingCriterion())
    jcb = _JLosses()
    jmodel.fit(data, epochs=1, verbose=0, callbacks=[jcb])
    tmodel = tpaddle.Model(net, device="cpu")
    tmodel.prepare(topt, GPTPretrainingCriterion())
    tcb = _TLosses()
    tmodel.fit([(torch.from_numpy(a), torch.from_numpy(b))
                for a, b in data], epochs=1, verbose=0, callbacks=[tcb])
    return jnet, net, jopt, topt, jcb.losses, tcb.losses


def test_three_adamw_fit_steps_match_jax():
    jnet, net, _, _, jl, tl = _fit_both()
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    jstate = {k: _np(v) for k, v in jnet.state_dict().items()}
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in net.state_dict().items()])
    assert (diffs <= PARAM_TOL).mean() >= PARAM_BULK
    assert diffs.max() <= ADAM_NOISE_TOL


@pytest.mark.parametrize("opt_name,kw", [
    ("AdamW", dict(weight_decay=0.1)),
    ("Adam", dict(weight_decay=None)),
])
def test_adam_update_matches_jax_on_identical_gradients(opt_name, kw):
    """Three steps from the same weights with the same gradients; a
    large epsilon and decay make their placement visible."""
    from paddle_tpu import nn as jnn
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) * s
             for s in (1.0, 1e-3, 0.1)]
    jlin = jnn.Linear(4, 3, bias_attr=False)
    jlin.weight.set_value(w0)
    jopt = getattr(joptimizer, opt_name)(
        learning_rate=0.05, epsilon=1e-2, parameters=jlin.parameters(), **kw)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = getattr(tpaddle.optimizer, opt_name)(
        learning_rate=0.05, epsilon=1e-2, parameters=[tw], **kw)
    for g in grads:
        jlin.weight.grad = jpaddle.to_tensor(g)
        jopt.step()
        tw.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tw.detach().numpy(),
                                   _np(jlin.weight), rtol=1e-6, atol=1e-6)
    assert not np.allclose(tw.detach().numpy(), w0)


def test_amp_o2_dtypes_master_weights_and_losses():
    """O2: Linear and embedding weights bf16, LayerNorm fp32, fp32
    master weights in the optimizer.  Losses within 1e-3 relative of
    the JAX package's O2 run: both round activations to bf16 at every
    matmul, but in different places inside the fused ops, so each
    token's loss may differ by a few bf16 roundings (~4e-3 relative);
    the loss is a mean over 256 tokens, which shrinks that ~16-fold."""
    jnet, net, jopt, topt, jl, tl = _fit_both(o2=True)
    dtypes = {n: p.dtype for n, p in net.named_parameters()}
    for n, dt in dtypes.items():
        norm = ".ln1." in n or ".ln2." in n or "final_norm" in n
        assert dt == (torch.float32 if norm else torch.bfloat16), n
        jdt = str(dict(jnet.named_parameters())[n].dtype)
        assert ("float32" in jdt) == norm, (n, jdt)
    masters = [st for st in topt._state.values() if "master_weight" in st]
    assert len(masters) == sum(dt == torch.bfloat16 for dt in dtypes.values())
    for st in masters:
        assert st["master_weight"].dtype == torch.float32
        assert st["moment1"].dtype == torch.float32
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert all(np.isfinite(tl))


def test_fit_on_cpu_makes_no_kernel_launch():
    fk.reset_counts()
    _, _, _, _, _, tl = _fit_both(steps=2)
    assert len(tl) == 2
    assert [f.launches for f in fk.WRAPPERS] == [0, 0, 0]
    # two steps x two layers, each through the wrappers' plain versions
    assert [f.plain_calls for f in fk.WRAPPERS] == [4, 4, 4]


def test_fit_refuses_what_is_not_ported():
    """``save(training=False)`` (``jit.save``, ROADMAP item 12) and
    ``AdamW(lr_ratio=)`` (which the JAX package applies nowhere) are
    refused; a learning rate that is neither a float nor a scheduler is
    a TypeError; metrics must be ``Metric`` instances; ``amp_configs``
    (``amp.auto_cast``), schedulers, gradient accumulation and
    ``Adam(lazy_mode=True)`` (sparse gradients) are ported and
    accepted."""
    net = GPTForCausalLM(gpt_tiny(), device="cpu")
    model = tpaddle.Model(net, device="cpu")
    opt = tpaddle.optimizer.AdamW(parameters=net.parameters())
    with pytest.raises(TypeError, match="Metric"):
        model.prepare(opt, GPTPretrainingCriterion(), metrics=["acc"])
    with pytest.raises(TypeError, match="LRScheduler"):
        tpaddle.optimizer.AdamW(learning_rate=object(),
                                parameters=net.parameters())
    assert tpaddle.optimizer.Adam(lazy_mode=True,
                                  parameters=net.parameters())._lazy_mode
    with pytest.raises(NotImplementedError, match="applies it nowhere"):
        tpaddle.optimizer.AdamW(lr_ratio=lambda p: 1.0,
                                parameters=net.parameters())
    tpaddle.optimizer.AdamW(
        learning_rate=tpaddle.optimizer.lr.StepDecay(1e-3, 2),
        parameters=net.parameters())
    model.prepare(opt, GPTPretrainingCriterion(),
                  amp_configs={"level": "O1"})
    assert (model._amp_level, model._amp_dtype) == ("O1", "bfloat16")
    with pytest.raises(NotImplementedError, match="item 12"):
        model.save("unused", training=False)
    x = torch.zeros((2, 16), dtype=torch.int64)
    model.fit([(x, x)] * 2, accumulate_grad_batches=2, verbose=0)
    assert opt._global_step == 1


def test_model_and_gpt_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GPTForCausalLM(gpt_tiny())
    net = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tpaddle.Model(net)
    assert tpaddle.Model(net, device="cpu").device == torch.device("cpu")


def test_dataloader_batches_shuffles_from_its_generator_and_drops_last():
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    x = np.arange(10, dtype=np.int64).reshape(10, 1)
    ds = TensorDataset([x, x * 2])
    plain = [b[0][:, 0].tolist() for b in DataLoader(ds, batch_size=4)]
    assert plain == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True,
                        generator=torch.Generator().manual_seed(3))
    assert len(loader) == 2
    first = [b[0][:, 0].tolist() for b in loader]
    again = [b[0][:, 0].tolist() for b in DataLoader(
        ds, batch_size=4, shuffle=True, drop_last=True,
        generator=torch.Generator().manual_seed(3))]
    assert first == again and len(first) == 2
    assert sorted(sum(first, [])) != list(range(8))   # shuffled
    for xb, yb in loader:
        assert torch.equal(yb, xb * 2) and xb.dtype == torch.int64


def test_fit_takes_a_dataset_and_num_iters():
    from paddle_tpu_torch.io import TensorDataset
    net = GPTForCausalLM(gpt_tiny(), device="cpu")
    model = tpaddle.Model(net, device="cpu")
    model.prepare(tpaddle.optimizer.AdamW(1e-3, parameters=net.parameters()),
                  GPTPretrainingCriterion())
    x = np.random.default_rng(0).integers(0, 256, (6, 32)).astype(np.int64)
    cb = _TLosses()
    model.fit(TensorDataset([x, np.roll(x, -1, 1)]), batch_size=2,
              epochs=2, num_iters=2, verbose=0, callbacks=[cb])
    assert len(cb.losses) == 4 and all(np.isfinite(cb.losses))
