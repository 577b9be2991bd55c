"""GPT family (counterpart of ``paddle_tpu/models/gpt.py``).

The training model: ``GPTForCausalLM`` (embeddings, pre-norm decoder
layers whose attention is the flash kernel, final norm, and an lm head
tied to the word embedding) and ``GPTPretrainingCriterion``.  Weights
keep Paddle's layout (``Linear`` weights ``[in, out]``) and Paddle's
parameter names, so :func:`state_dict_from_jax` carries a JAX
``GPTForCausalLM.state_dict()`` over key for key.

The serving path consumes weights as a plain numpy tree (the layout of
``paddle_tpu``'s ``extract_decode_params``), loaded through
``inference.serving.decode_model.params_from_numpy``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn as tnn

from .. import resolve_device
from .. import nn
from ..framework import random as _random
from ..nn.functional import cross_entropy, flash_attention
from ..ops.flash_attention_kernel import flash_attention_reference
from ..ops.lmce_kernel import fused_linear_cross_entropy


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_flash_attention: bool = True
    recompute: bool = False
    tensor_parallel_degree: int = 1
    context_parallel: str = "ring"


def gpt_tiny(**kw):
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    return GPTConfig(**base)


def gpt2_small(**kw):
    return GPTConfig(**kw)


def gpt3_1p3b(**kw):
    base = dict(vocab_size=50304, hidden_size=2048,
                num_hidden_layers=24, num_attention_heads=16,
                intermediate_size=8192, max_position_embeddings=2048)
    base.update(kw)
    return GPTConfig(**base)


def init_decode_weights_numpy(cfg: GPTConfig, seed: int = 0,
                              dtype=np.float32) -> dict:
    """Random decode-weight tree with the GPT initializer: Normal(0,
    ``initializer_range``) matrices and embeddings, zero biases, unit
    LayerNorm scales.  Keys and ``[in, out]`` orientation are those of
    ``extract_decode_params``; drawn from ``numpy.random.default_rng(
    seed)``, so a seed names one set of weights on any machine."""
    rng = np.random.default_rng(seed)
    std = cfg.initializer_range
    D, F = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std)).astype(dtype)

    def const(value, n):
        return np.full((n,), value, dtype=dtype)

    tree = {"wte": normal(cfg.vocab_size, D),
            "wpe": normal(cfg.max_position_embeddings, D),
            "lnf_w": const(1.0, D), "lnf_b": const(0.0, D),
            "layers": []}
    for _ in range(cfg.num_hidden_layers):
        tree["layers"].append({
            "ln1_w": const(1.0, D), "ln1_b": const(0.0, D),
            "wqkv": normal(D, 3 * D), "bqkv": const(0.0, 3 * D),
            "wo": normal(D, D), "bo": const(0.0, D),
            "ln2_w": const(1.0, D), "ln2_b": const(0.0, D),
            "w1": normal(D, F), "b1": const(0.0, F),
            "w2": normal(F, D), "b2": const(0.0, D),
        })
    return tree


# ---------------------------------------------------------------------------
# training model
# ---------------------------------------------------------------------------
def _layer_kw(config, device, generator):
    return dict(init_std=config.initializer_range, device=device,
                generator=generator)


class GPTEmbeddings(tnn.Module):
    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = _layer_kw(config, device, generator)
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            b, s = input_ids.shape
            position_ids = torch.arange(
                s, device=input_ids.device).unsqueeze(0).expand(b, s)
        emb = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        return self.dropout(emb)


class GPTAttention(tnn.Module):
    """Causal self-attention.  q, k and v are strided ``[B, S, H, D]``
    views of the fused qkv projection (no transpose copy); the flash
    kernels read them in place."""

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.use_flash = config.use_flash_attention
        self.attn_drop = config.attention_probs_dropout_prob
        kw = _layer_kw(config, device, generator)
        self.qkv_proj = nn.Linear(config.hidden_size,
                                  3 * config.hidden_size, **kw)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size,
                                  **kw)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.use_flash:
            out, _ = flash_attention(q, k, v, causal=True,
                                     dropout=self.attn_drop,
                                     training=self.training)
        else:
            drop = self.attn_drop if self.training else 0.0
            out, _ = flash_attention_reference(
                q, k, v, True, dropout_p=drop,
                generator=_random.default_generator(x.device))
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(tnn.Module):
    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = _layer_kw(config, device, generator)
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             **kw)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             **kw)

    def forward(self, x):
        return self.fc2(torch.nn.functional.gelu(self.fc1(x),
                                                 approximate="tanh"))


class GPTDecoderLayer(tnn.Module):
    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if config.recompute:
            raise NotImplementedError(
                "GPTConfig(recompute=True) needs fleet recompute, not "
                "ported yet (ROADMAP queue A, item 8)")
        eps = config.layer_norm_epsilon
        self.ln1 = nn.LayerNorm(config.hidden_size, epsilon=eps,
                                device=device)
        self.attn = GPTAttention(config, device, generator)
        self.ln2 = nn.LayerNorm(config.hidden_size, epsilon=eps,
                                device=device)
        self.mlp = GPTMLP(config, device, generator)
        self.dropout1 = nn.Dropout(config.hidden_dropout_prob)
        self.dropout2 = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        x = x + self.dropout1(self.attn(self.ln1(x)))
        x = x + self.dropout2(self.mlp(self.ln2(x)))
        return x


class GPTModel(tnn.Module):
    """``device=None`` means the card, as for :class:`GPTForCausalLM`."""

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embeddings = GPTEmbeddings(config, device, generator)
        self.layers = tnn.ModuleList(
            [GPTDecoderLayer(config, device, generator)
             for _ in range(config.num_hidden_layers)])
        self.final_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_epsilon,
                                       device=device)

    def forward(self, input_ids, position_ids=None):
        x = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


class GPTForCausalLM(tnn.Module):
    """GPT with the lm head tied to the word embedding: the logits are
    ``hidden @ word_embeddings.weight^T``, one ``Parameter`` whose
    gradient sums both uses.  ``device=None`` means the card and raises
    without one; pass ``device="cpu"`` for the CPU.  Weights are drawn
    from ``generator`` (default: the port's generator of the device) in
    construction order.

    ``skip_lm_head=True`` (set by :func:`enable_fused_lmce`) returns the
    final hidden states instead of the logits; the criterion then folds
    the vocabulary product into the fused lm-head cross-entropy kernels,
    so the ``[B, S, V]`` logits never reach device memory."""

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config, device, generator)
        self.skip_lm_head = False

    def lm_weight(self):
        return self.gpt.embeddings.word_embeddings.weight

    def forward(self, input_ids, position_ids=None):
        hidden = self.gpt(input_ids, position_ids)
        if self.skip_lm_head:
            return hidden
        return torch.matmul(hidden, self.lm_weight().t())


class GPTPretrainingCriterion(tnn.Module):
    """Causal LM loss: per-token cross-entropy (fp32, ``ignore_index``
    -100) averaged over all tokens, or over ``loss_mask`` when given.
    Labels come already shifted by one.

    ``lm_weight_fn`` turns on the fused lm-head path: ``forward`` then
    takes the final hidden states ``[B, S, D]`` (the model must set
    ``skip_lm_head``) and computes the loss with
    :func:`~paddle_tpu_torch.ops.fused_linear_cross_entropy` against
    ``lm_weight_fn()``, which ignores every negative label (the JAX
    package's fused path does the same).  :func:`enable_fused_lmce`
    sets both sides."""

    def __init__(self, config: Optional[GPTConfig] = None,
                 lm_weight_fn=None):
        super().__init__()
        self._lm_weight_fn = lm_weight_fn

    def forward(self, logits, labels, loss_mask=None):
        if self._lm_weight_fn is not None:
            loss = self._fused_loss(logits, labels)
        else:
            loss = cross_entropy(logits, labels, ignore_index=-100,
                                 reduction="none")
        if loss_mask is not None:
            loss_mask = loss_mask.to(loss.dtype)
            return (loss * loss_mask).sum() / loss_mask.sum().clamp_min(1e-9)
        return loss.mean()

    def _fused_loss(self, hidden, labels):
        b, s, d = hidden.shape
        per_tok = fused_linear_cross_entropy(
            hidden.reshape(b * s, d), self._lm_weight_fn(),
            labels.reshape(b * s))
        return per_tok.reshape(b, s)


def enable_fused_lmce(model: GPTForCausalLM,
                      criterion: GPTPretrainingCriterion):
    """Switch the (model, criterion) pair to the fused lm-head
    cross-entropy path (the JAX package's ``PADDLE_TPU_FUSED_LMCE``
    configuration).  The kernel's ``dw`` reaches the tied embedding
    ``Parameter`` through autograd, beside the lookup's gradient."""
    model.skip_lm_head = True
    criterion._lm_weight_fn = model.lm_weight
    return model, criterion


def state_dict_from_jax(numpy_state, cfg: GPTConfig) -> dict:
    """The port's ``GPTForCausalLM`` state dict from the JAX package's
    ``GPTForCausalLM.state_dict()`` with each value as a numpy array.
    Names and layouts are the same in both packages: ``Linear`` weights
    stay ``[in, out]``, embeddings ``[num, dim]``, norms and biases
    ``[dim]``.  The lm head is the word embedding in both, so there is
    no separate head entry and the tie survives ``load_state_dict``.
    Raises on a missing, extra or misshapen entry; ``load_state_dict``
    then copies each value to the model's device."""
    expected = _expected_shapes(cfg)
    got = set(numpy_state)
    if got != set(expected):
        raise KeyError(f"state mismatch: missing "
                       f"{sorted(set(expected) - got)}, unexpected "
                       f"{sorted(got - set(expected))}")
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(numpy_state[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != {shape}")
        out[name] = torch.as_tensor(arr)
    return out


def _expected_shapes(cfg: GPTConfig) -> dict:
    D, F = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "gpt.embeddings.word_embeddings.weight": (cfg.vocab_size, D),
        "gpt.embeddings.position_embeddings.weight":
            (cfg.max_position_embeddings, D),
        "gpt.final_norm.weight": (D,), "gpt.final_norm.bias": (D,),
    }
    for i in range(cfg.num_hidden_layers):
        p = f"gpt.layers.{i}."
        shapes.update({
            p + "ln1.weight": (D,), p + "ln1.bias": (D,),
            p + "attn.qkv_proj.weight": (D, 3 * D),
            p + "attn.qkv_proj.bias": (3 * D,),
            p + "attn.out_proj.weight": (D, D), p + "attn.out_proj.bias": (D,),
            p + "ln2.weight": (D,), p + "ln2.bias": (D,),
            p + "mlp.fc1.weight": (D, F), p + "mlp.fc1.bias": (F,),
            p + "mlp.fc2.weight": (F, D), p + "mlp.fc2.bias": (D,),
        })
    return shapes
