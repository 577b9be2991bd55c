"""GPT's and BERT's own pieces under ``amp.auto_cast`` in the PyTorch
port against the JAX package: flash attention (the JAX primitive
``"flash_attention"``, on the white list), GELU (``"gelu"``) and the
tied heads (``"matmul"``) read the rule and the custom lists, and the
fused lm-head cross-entropy stays uncast (the JAX ``apply_closure``
reads no rule).

A 2-layer GPT (``gpt_tiny``: hidden 64, 4 heads, vocab 256) and a
2-layer BERT (hidden 64, 4 heads, vocab 256) are built in the JAX
package and carried to the port by name.  Each runs a forward under
``auto_cast`` (bf16) at O1 (fp32 weights) and O2 (``decorate``d bf16
weights), without a custom list and with ``custom_black_list=
{"flash_attention"}`` or ``{"gelu"}``, the loss outside the block, as
``Model`` computes it.  Each package records the dtype every op's
floating inputs have after the rule (the JAX package's AMP hook; the
port's ``cast_inputs`` in each module that calls it), and the dtypes
of the watched ops must agree; the loss must agree within 5e-2 x
max(|ref|, 1) (``BF16_TOL``: both round to bf16 at every listed op,
in places that differ inside the fused ops).  The port's backward runs
and gives finite gradients.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu.models import bert as jbert
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCrit
from paddle_tpu.models.gpt import enable_fused_lmce as jenable_fused_lmce
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     enable_fused_lmce, gpt_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from torch_parity_helpers import BF16_TOL, close
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

# the modules (the packages' ``amp.auto_cast`` is the function)
jauto_cast = importlib.import_module("paddle_tpu.amp.auto_cast")
tauto_cast = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
B, S, V = 2, 64, 256
WATCH = ("flash_attention", "gelu", "matmul", "linear", "layer_norm")
LISTS = {"none": None, "black flash": {"flash_attention"},
         "black gelu": {"gelu"}}


def _name(dt):
    return str(dt).replace("torch.", "").replace("paddle.", "")


@pytest.fixture
def recorder(monkeypatch):
    """``{package: {op: set of dtype names}}`` of the floating inputs of
    each op after the AMP rule."""
    seen = {"jax": {}, "port": {}}

    def note(side, op, vals):
        for v in vals:
            dt = getattr(v, "dtype", None)
            if dt is not None and "float" in _name(dt):
                seen[side].setdefault(op, set()).add(_name(dt))

    make = jauto_cast._make_hook

    def make_recording():
        hook = make()

        def rec(op, vals):
            out = hook(op, vals)
            note("jax", op, out)
            return out
        return rec

    monkeypatch.setattr(jauto_cast, "_make_hook", make_recording)
    real = tauto_cast.cast_inputs

    def cast(op, *values):
        out = real(op, *values)
        if tauto_cast._amp_state["enabled"]:
            note("port", op, out)
        return out

    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("paddle_tpu_torch")
                and getattr(mod, "cast_inputs", None) is real):
            monkeypatch.setattr(mod, "cast_inputs", cast)
    return seen


def _gpt(o2):
    jpaddle.seed(0)
    jnet = JGPT(jgpt_tiny(max_position_embeddings=S))
    cfg = gpt_tiny(max_position_embeddings=S)
    net = GPTForCausalLM(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()},
        cfg))
    if o2:
        jamp.decorate(jnet, level="O2", dtype="bfloat16")
        tamp.decorate(net, level="O2", dtype="bfloat16")
    rng = np.random.default_rng(1)
    x = rng.integers(0, V, (B, S)).astype(np.int64)
    return (jnet, net, (x,), (np.roll(x, -1, axis=1),), JCrit(),
            GPTPretrainingCriterion())


def _bert(o2):
    cfg = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=S, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    jpaddle.seed(0)
    jnet = jbert.BertForPretraining(jbert.BertConfig(**cfg))
    net = tbert.BertForPretraining(tbert.BertConfig(**cfg), device="cpu")
    net.load_state_dict(tbert.bert_state_dict_from_jax(
        {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()},
        net))
    if o2:
        jamp.decorate(jnet, level="O2", dtype="bfloat16")
        tamp.decorate(net, level="O2", dtype="bfloat16")
    rng = np.random.default_rng(2)
    x = rng.integers(0, V, (B, S)).astype(np.int64)
    labels = np.where(rng.random((B, S)) < 0.15, x, -100).astype(np.int64)
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return (jnet, net, (x,), (labels, nsp), jbert.BertPretrainingCriterion(V),
            tbert.BertPretrainingCriterion(V))


@pytest.mark.parametrize("lists", list(LISTS))
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_op_dtypes_and_loss_match_jax(model, level, lists, recorder):
    jnet, net, ins, lbs, jcrit, tcrit = (_gpt if model == "gpt" else
                                         _bert)(level == "O2")
    black = LISTS[lists]
    with jamp.auto_cast(level=level, dtype="bfloat16",
                        custom_black_list=black):
        jout = jnet(*[jpaddle.to_tensor(a) for a in ins])
    jouts = jout if isinstance(jout, (list, tuple)) else [jout]
    jloss = jcrit(*jouts, *[jpaddle.to_tensor(a) for a in lbs])
    with tamp.auto_cast(level=level, dtype="bfloat16",
                        custom_black_list=black):
        tout = net(*[torch.from_numpy(a) for a in ins])
    touts = tout if isinstance(tout, (list, tuple)) else [tout]
    tloss = tcrit(*touts, *[torch.from_numpy(a) for a in lbs])
    close(float(tloss.detach()), float(np.asarray(jloss.numpy())), BF16_TOL,
          "loss")
    jseen, tseen = recorder["jax"], recorder["port"]
    for op in ("flash_attention", "gelu"):
        want = {"float32"} if black and op in black else {"bfloat16"}
        if op == "gelu" and level == "O1" and not black:
            want = {"bfloat16"}     # fc1's (linear's) bf16 output, uncast
        assert jseen.get(op) == want, (op, jseen.get(op))
        assert tseen.get(op) == want, (op, tseen.get(op))
    for op in WATCH:
        if op in jseen and op in tseen:
            assert tseen[op] == jseen[op], (op, tseen[op], jseen[op])
    assert "matmul" in tseen and tseen["matmul"] == {"bfloat16"}
    tloss.backward()
    for n, p in net.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad.float()).all(), n


def test_flash_black_list_runs_the_kernel_on_fp32_inputs(monkeypatch):
    """Under ``custom_black_list={"flash_attention"}`` the flash wrapper
    gets fp32 q, k and v (on the card: the CUDA-core kernel), and its
    output goes on in fp32."""
    _, net, ins, _, _, _ = _gpt(False)
    seen = []
    real = fk.flash_fwd

    def spy(q, k, v, *rest):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, *rest)

    spy.__dict__.update(real.__dict__)     # the wrapper's counters
    monkeypatch.setattr(fk, "flash_fwd", spy)
    for black, dt in ((None, torch.bfloat16),
                      ({"flash_attention"}, torch.float32)):
        seen.clear()
        with tamp.auto_cast(level="O1", dtype="bfloat16",
                            custom_black_list=black):
            net(torch.from_numpy(ins[0]))
        assert seen and all(s == (dt,) * 3 for s in seen), seen


def test_fused_lmce_stays_uncast(recorder):
    """The fused lm-head cross-entropy is outside the rule in both
    packages: its hidden states and weight reach it as the criterion
    gets them (the JAX ``apply_closure`` reads no rule)."""
    jnet, net, ins, lbs, jcrit, tcrit = _gpt(False)
    jenable_fused_lmce(jnet, jcrit)
    enable_fused_lmce(net, tcrit)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        jh = jnet(jpaddle.to_tensor(ins[0]))
        jloss = jcrit(jh, jpaddle.to_tensor(lbs[0]))
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        th = net(torch.from_numpy(ins[0]))
        tloss = tcrit(th, torch.from_numpy(lbs[0]))
    assert "fused_lmce" not in recorder["jax"]
    assert "fused_lmce" not in recorder["port"]
    assert th.dtype == torch.float32 == net.lm_weight().dtype
    close(float(tloss.detach()), float(np.asarray(jloss.numpy())), BF16_TOL,
          "fused loss")


def test_amp_aliases():
    assert tamp.autocast is tamp.auto_cast and tamp.amp_guard is \
        tamp.auto_cast
    assert tamp.amp_decorate is tamp.decorate
    for name in ("autocast", "amp_guard", "amp_decorate"):
        assert hasattr(jamp, name) and name in tamp.__all__
    lin = tpaddle.nn.Linear(4, 4, device="cpu")
    with tamp.amp_guard(level="O1", dtype="bfloat16"):
        assert lin(torch.ones(2, 4)).dtype == torch.bfloat16
    tamp.amp_decorate(lin, level="O2", dtype="bfloat16")
    assert lin.weight.dtype == torch.bfloat16
