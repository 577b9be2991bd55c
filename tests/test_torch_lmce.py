"""Fused lm-head cross-entropy of the PyTorch port against the JAX
package.

The port's wrappers on CPU tensors run their plain versions; the JAX
side runs its Pallas kernels in interpret mode
(``PADDLE_TPU_PALLAS_INTERPRET=1``, as ``tests/test_pallas_lmce.py``
does).  Inputs are numpy arrays from a seed.  Tolerances are the JAX
package's own for its kernels against the composed form: 2e-5 on the
loss and lse, 2e-4 on dh and dW (fp32; blockwise online softmax vs
whole-row sums), 3e-2 with bf16 operands (bf16 inputs and outputs).
At the model level (``gpt_tiny`` with JAX weights carried over by
``state_dict_from_jax``, the fused path on in both packages) the loss
and every gradient agree within ``test_torch_training.py``'s 2e-5, and
three AdamW ``Model.fit`` steps under its Adam-noise rule.  The CUDA
kernels are held against the same plain versions on the card by the
``cuda``-marked test, which skips without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.models.gpt import enable_fused_lmce as jenable_fused_lmce
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.ops import pallas_lmce as L

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import _build
from paddle_tpu_torch.hapi.callbacks import Callback as TCallback
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     enable_fused_lmce, gpt_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from paddle_tpu_torch.ops import lmce_kernel as lk
from torch_parity_helpers import torch_one_thread  # noqa: F401

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
MODEL_TOL = 2e-5
PARAM_TOL = 2e-6
PARAM_BULK = 0.995
ADAM_NOISE_TOL = 1e-3
B, S = 2, 128


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(n, v, d, seed, ignore=False):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(v, d) * 0.05).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    if ignore:
        labels[::4] = -100
        labels[1] = -1
    g = rng.rand(n).astype(np.float32)
    return h, w, labels, g


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _jax_fwd(h, w, labels):
    loss, lse = L._call_fwd(jnp.asarray(h), jnp.asarray(w),
                            jnp.asarray(labels))
    return np.asarray(loss), np.asarray(lse)


def _jax_bwd(h, w, labels, g):
    jh, jw, jl = jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels)
    _, lse = L._call_fwd(jh, jw, jl)
    dh, dw = L._call_bwd(jh, jw, jl, lse, jnp.asarray(g))
    return np.asarray(dh), np.asarray(dw)


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,v,d", [
    (256, 512, 128),          # exact blocks
    (100, 1000, 128),         # row pad + vocab mask
    (384, 786, 256),          # odd-ish vocab
])
def test_forward_matches_jax_kernel(n, v, d):
    h, w, labels, _ = _inputs(n, v, d, 0)
    jloss, jlse = _jax_fwd(h, w, labels)
    lk.reset_counts()
    loss, lse = lk.lmce_fwd(*_t(h, w, labels))
    assert lk.lmce_fwd.plain_calls == 1 and lk.lmce_fwd.launches == 0
    assert loss.dtype == lse.dtype == torch.float32
    assert loss.shape == lse.shape == (n,)
    np.testing.assert_allclose(loss.numpy(), jloss, **LOSS_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse[:n, 0], **LOSS_TOL)


@pytest.mark.parametrize("n,v,d", [
    (256, 512, 128), (100, 1000, 128), (384, 786, 256), (200, 700, 128),
])
def test_backward_matches_jax_kernel(n, v, d):
    h, w, labels, g = _inputs(n, v, d, 1)
    jdh, jdw = _jax_bwd(h, w, labels, g)
    th, tw, tl, tg = _t(h, w, labels, g)
    _, lse = lk.lmce_fwd(th, tw, tl)
    dh = lk.lmce_bwd_dh(th, tw, tl, lse, tg)
    dw = lk.lmce_bwd_dw(th, tw, tl, lse, tg)
    assert dh.shape == (n, d) and dw.shape == (v, d)
    np.testing.assert_allclose(dh.numpy(), jdh, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, **GRAD_TOL)


def test_bf16_operands_match_jax_kernel():
    h, w, labels, g = _inputs(128, 256, 128, 3)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    jl = jnp.asarray(labels)
    jloss, jlse = L._call_fwd(jh, jw, jl)
    jdh, jdw = L._call_bwd(jh, jw, jl, jlse, jnp.asarray(g))
    assert jdh.dtype == jnp.bfloat16
    th, tw = [t.bfloat16() for t in _t(h, w)]
    tl, tg = _t(labels, g)
    loss, lse = lk.lmce_fwd(th, tw, tl)
    dh = lk.lmce_bwd_dh(th, tw, tl, lse, tg)
    dw = lk.lmce_bwd_dw(th, tw, tl, lse, tg)
    assert loss.dtype == torch.float32
    assert dh.dtype == dw.dtype == torch.bfloat16
    assert dh.shape == (128, 128) and dw.shape == (256, 128)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **BF16_TOL)
    np.testing.assert_allclose(dh.float().numpy(),
                               np.asarray(jdh.astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(jdw.astype(jnp.float32)),
                               **BF16_TOL)


def test_ignored_labels_give_exact_zeros_as_in_jax():
    """Every negative label (-100 and -1 alike) gives 0 loss and a 0 dh
    row, in both packages; the unfused ``cross_entropy`` ignores only
    ``ignore_index``."""
    h, w, labels, g = _inputs(128, 256, 128, 4, ignore=True)
    ignored = labels < 0
    jloss, _ = _jax_fwd(h, w, labels)
    jdh, _ = _jax_bwd(h, w, labels, g)
    th, tw, tl, tg = _t(h, w, labels, g)
    loss, lse = lk.lmce_fwd(th, tw, tl)
    dh = lk.lmce_bwd_dh(th, tw, tl, lse, tg)
    for got, ref in ((loss.numpy(), jloss), (dh.numpy(), jdh)):
        assert (got[ignored] == 0).all() and (ref[ignored] == 0).all()
    assert (loss.numpy()[~ignored] > 0).all()
    np.testing.assert_allclose(loss.numpy(), jloss, **LOSS_TOL)


def test_autograd_function_matches_jax_value_and_grad():
    n, v, d = 128, 384, 128
    h, w, labels, _ = _inputs(n, v, d, 2)
    jl = jnp.asarray(labels)

    def mean_loss(h_, w_):
        return L.fused_linear_cross_entropy(h_, w_, jl).mean()

    jval, (jdh, jdw) = jax.value_and_grad(mean_loss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = [t.requires_grad_() for t in _t(h, w)]
    lk.reset_counts()
    val = lk.FusedLinearCrossEntropy.apply(th, tw,
                                           torch.from_numpy(labels)).mean()
    val.backward()
    assert [f.plain_calls for f in lk.WRAPPERS] == [1, 1, 1]
    assert [f.launches for f in lk.WRAPPERS] == [0, 0, 0]
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **GRAD_TOL)


def test_plain_versions_equal_autograd_of_the_reference():
    """The backward plain versions are the vjp of ``lmce_reference``."""
    h, w, labels, g = _t(*_inputs(64, 200, 64, 6, ignore=True))
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    loss, lse = lk.lmce_reference(hh, ww, labels)
    rdh, rdw = torch.autograd.grad(loss, [hh, ww], g)
    dh = lk.lmce_bwd_dh_reference(h, w, labels, lse.detach(), g)
    dw = lk.lmce_bwd_dw_reference(h, w, labels, lse.detach(), g)
    torch.testing.assert_close(dh, rdh, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-6)


def test_bad_calls_raise():
    h, w, labels, g = _t(*_inputs(16, 40, 64, 7))
    with pytest.raises(ValueError):
        lk.lmce_fwd(h, w[:, :32], labels)
    with pytest.raises(ValueError):
        lk.lmce_fwd(h, w, labels[:8])
    with pytest.raises(TypeError):
        lk.lmce_fwd(h, w.double(), labels)
    with pytest.raises(TypeError):
        lk.lmce_fwd(h, w, labels.float())
    with pytest.raises(ValueError):
        lk.lmce_bwd_dh(h, w, labels, g[:4], g)


def test_cuda_wrapper_propagates_a_build_failure(monkeypatch):
    """A CUDA tensor never falls back to the plain version: a kernel
    that cannot be built raises KernelBuildError out of the wrapper."""
    def broken(name):
        raise _build.KernelBuildError("nvcc refused the source")
    monkeypatch.setattr(lk, "_lib", None)
    monkeypatch.setattr(_build, "load", broken)
    h, w, labels, _ = _t(*_inputs(16, 40, 64, 8))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    before = lk.lmce_fwd.plain_calls
    with pytest.raises(_build.KernelBuildError):
        lk.lmce_fwd(h, w, labels)
    assert lk.lmce_fwd.plain_calls == before


@pytest.mark.parametrize("d,dtype,exc", [
    (60, torch.float32, NotImplementedError),
    (64, torch.float64, TypeError),
])
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(monkeypatch, d,
                                                          dtype, exc):
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    h = torch.zeros((4, d), dtype=dtype)
    with pytest.raises(exc):
        lk.lmce_fwd(h, torch.zeros((8, d), dtype=dtype),
                    torch.zeros(4, dtype=torch.int32))


def test_kernel_work_counts_every_tile():
    N, V, D = 8192, 50304, 768
    flops, nbytes = lk.kernel_work("lmce_fwd", N, V, D, 2)
    assert flops == 2 * N * V * D
    assert nbytes == (N + V) * D * 2 + 12 * N
    assert lk.kernel_work("lmce_bwd_dh", N, V, D, 2)[0] == 2 * flops
    assert lk.kernel_work("lmce_bwd_dw", N, V, D, 2)[1] == \
        (N + 2 * V) * D * 2 + 12 * N
    with pytest.raises(ValueError):
        lk.kernel_work("lmce", N, V, D, 2)


# ---------------------------------------------------------------------------
# the GPT model with the fused path on, against the JAX package
# ---------------------------------------------------------------------------
def _models(seed=0):
    jpaddle.seed(seed)
    jnet = JGPTForCausalLM(jgpt_tiny(max_position_embeddings=256))
    cfg = gpt_tiny(max_position_embeddings=256)
    net = GPTForCausalLM(cfg, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net.load_state_dict(state_dict_from_jax(state, cfg))
    return jnet, net


def _tokens(seed=0, b=B, s=S, vocab=256):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (b, s)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_loss_and_every_gradient_match_jax(masked):
    jnet, net = _models()
    jcrit = JGPTPretrainingCriterion()
    crit = GPTPretrainingCriterion()
    jenable_fused_lmce(jnet, jcrit)
    assert enable_fused_lmce(net, crit) == (net, crit)
    x, y = _tokens(1)
    y[0, :5] = -100                      # ignored positions
    mask = (np.arange(S)[None, :] % 3 != 0).astype(np.float32).repeat(B, 0)
    jmask = jpaddle.to_tensor(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    jloss = jcrit(jnet(jpaddle.to_tensor(x)), jpaddle.to_tensor(y), jmask)
    jloss.backward()
    lk.reset_counts()
    hidden = net(torch.from_numpy(x))
    assert hidden.shape == (B, S, 64)
    loss = crit(hidden, torch.from_numpy(y), tmask)
    loss.backward()
    assert [f.plain_calls for f in lk.WRAPPERS] == [1, 1, 1]
    assert [f.launches for f in lk.WRAPPERS] == [0, 0, 0]
    np.testing.assert_allclose(loss.item(), float(_np(jloss)),
                               rtol=MODEL_TOL)
    jgrads = {n: _np(p.grad) for n, p in jnet.named_parameters()}
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(grads) == set(jgrads)
    assert "gpt.embeddings.word_embeddings.weight" in grads
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=n)


def test_fused_matches_unfused_within_the_port():
    _, net = _models()
    x, y = _tokens(2)
    crit = GPTPretrainingCriterion()
    base = crit(net(torch.from_numpy(x)), torch.from_numpy(y))
    base.backward()
    base_grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad()
    enable_fused_lmce(net, crit)
    lk.reset_counts()
    fused = crit(net(torch.from_numpy(x)), torch.from_numpy(y))
    fused.backward()
    assert [f.plain_calls for f in lk.WRAPPERS] == [1, 1, 1]
    np.testing.assert_allclose(fused.item(), base.item(), rtol=1e-5)
    for n, p in net.named_parameters():
        torch.testing.assert_close(p.grad, base_grads[n], rtol=1e-5,
                                   atol=1e-7, msg=n)


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


def test_three_fused_adamw_fit_steps_match_jax():
    jnet, net = _models()
    jopt = joptimizer.AdamW(learning_rate=1e-3, parameters=jnet.parameters(),
                            weight_decay=0.01)
    topt = tpaddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=net.parameters(),
                                   weight_decay=0.01)
    jcrit, crit = JGPTPretrainingCriterion(), GPTPretrainingCriterion()
    jenable_fused_lmce(jnet, jcrit)
    enable_fused_lmce(net, crit)
    data = [_tokens(3)] * 3              # one batch, so the loss falls
    jmodel = jpaddle.Model(jnet)
    jmodel.prepare(jopt, jcrit)
    jcb = _JLosses()
    jmodel.fit(data, epochs=1, verbose=0, callbacks=[jcb])
    model = tpaddle.Model(net, device="cpu")
    model.prepare(topt, crit)
    tcb = _TLosses()
    lk.reset_counts()
    fk.reset_counts()
    model.fit([(torch.from_numpy(a), torch.from_numpy(b)) for a, b in data],
              epochs=1, verbose=0, callbacks=[tcb])
    # a CPU run launches nothing: three steps through the plain versions
    assert [f.launches for f in lk.WRAPPERS] == [0, 0, 0]
    assert [f.plain_calls for f in lk.WRAPPERS] == [3, 3, 3]
    assert [f.launches for f in fk.WRAPPERS] == [0, 0, 0]
    assert len(tcb.losses) == len(jcb.losses) == 3
    np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=MODEL_TOL)
    assert tcb.losses[-1] < tcb.losses[0]
    jstate = {k: _np(v) for k, v in jnet.state_dict().items()}
    diffs = np.concatenate([np.abs(v.numpy() - jstate[k]).ravel()
                            for k, v in net.state_dict().items()])
    assert (diffs <= PARAM_TOL).mean() >= PARAM_BULK
    assert diffs.max() <= ADAM_NOISE_TOL


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the lmce kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,v,d", [(1000, 786, 64), (300, 1000, 2048)])
def test_cuda_kernels_match_plain(cuda_device, dtype, tol, n, v, d):
    h, w, labels, g = [t.to(cuda_device)
                       for t in _t(*_inputs(n, v, d, 9, ignore=True))]
    h, w = h.to(dtype), w.to(dtype)
    lk.reset_counts()
    loss, lse = lk.lmce_fwd(h, w, labels)
    dh = lk.lmce_bwd_dh(h, w, labels, lse, g)
    dw = lk.lmce_bwd_dw(h, w, labels, lse, g)
    assert [f.launches for f in lk.WRAPPERS] == [1, 1, 1]
    rloss, rlse = lk.lmce_reference(h, w, labels)
    rdh = lk.lmce_bwd_dh_reference(h, w, labels, lse, g)
    rdw = lk.lmce_bwd_dw_reference(h, w, labels, lse, g)
    torch.cuda.synchronize()
    for got, ref in ((loss, rloss), (lse, rlse), (dh, rdh), (dw, rdw)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * max(1.0, ref.float().abs().max().item()), err
