"""BERT / ERNIE family (counterpart of ``paddle_tpu/models/bert.py``).

ERNIE-3.0-base shares BERT's architecture at this layer (its
differences are pretraining tasks and data); the MLM and NSP heads are
those the pretraining benchmark runs.  Post-LN encoder layers, exact
(erf) GELU, LayerNorm epsilon 1e-12.  Self-attention is the port's
``flash_attention``, non-causal, when there is no attention mask, and
the composed masked attention (``ops.nn_ops.scaled_dot_product_
attention``) when there is one, as in the JAX package.

Weights keep Paddle's layout (``Linear`` ``[in, out]``) and the JAX
package's parameter names, so :func:`bert_state_dict_from_jax` carries
a JAX ``state_dict()`` over key for key; the JAX package's
``ColumnParallelLinear``/``RowParallelLinear``/``VocabParallelEmbedding``
at degree 1 are the port's ``nn.Linear``/``nn.Embedding``.  Random
weights follow the JAX initializers: Normal(0, ``initializer_range``)
for the embeddings and the encoder's matrices, Xavier-normal for the
plain ``Linear`` layers (pooler, MLM transform, NSP and classifier
heads), zero biases, unit LayerNorm scales.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn as tnn

from .. import nn, resolve_device
from ..framework import random as _random
from ..nn.functional import cross_entropy, flash_attention
from ..ops.nn_ops import scaled_dot_product_attention


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    use_flash_attention: bool = True


def bert_tiny(**kw):
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    base.update(kw)
    return BertConfig(**base)


def bert_base(**kw):
    return BertConfig(**kw)


def ernie_3_base(**kw):
    return BertConfig(**{"vocab_size": 40000, **kw})


_ACTS = {"gelu": torch.nn.functional.gelu,      # exact erf, as ops.gelu
         "relu": torch.nn.functional.relu,
         "tanh": torch.tanh}


def _act(name):
    if name not in _ACTS:
        raise NotImplementedError(f"hidden_act {name!r} is not ported; the "
                                  f"port has {sorted(_ACTS)}")
    return _ACTS[name]


def _kw(config, device, generator):
    return dict(init_std=config.initializer_range, device=device,
                generator=generator)


def _xavier_linear(n_in, n_out, device, generator):
    """The JAX package's plain ``nn.Linear``: Xavier-normal weight."""
    return nn.Linear(n_in, n_out, init_std=math.sqrt(2.0 / (n_in + n_out)),
                     device=device, generator=generator)


class BertEmbeddings(tnn.Module):
    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = _kw(config, device, generator)
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **kw)
        self.layer_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                       device=device)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device).unsqueeze(0).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertSelfAttention(tnn.Module):
    """Fused qkv projection; q, k and v are strided ``[B, S, H, D]``
    views of it.  No mask: the flash kernels, non-causal.  A mask: the
    composed masked attention."""

    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.use_flash = config.use_flash_attention
        self.attn_drop = config.attention_probs_dropout_prob
        kw = _kw(config, device, generator)
        self.qkv = nn.Linear(config.hidden_size, 3 * config.hidden_size, **kw)
        self.out = nn.Linear(config.hidden_size, config.hidden_size, **kw)

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.use_flash and attn_mask is None:
            out, _ = flash_attention(q, k, v, causal=False,
                                     dropout=self.attn_drop,
                                     training=self.training)
        else:
            out = scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.attn_drop,
                training=self.training,
                generator=_random.default_generator(x.device))
        return self.out(out.reshape(b, s, h))


class BertLayer(tnn.Module):
    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = _kw(config, device, generator)
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(config, device, generator)
        self.ln1 = nn.LayerNorm(h, epsilon=eps, device=device)
        self.fc1 = nn.Linear(h, config.intermediate_size, **kw)
        self.fc2 = nn.Linear(config.intermediate_size, h, **kw)
        self.ln2 = nn.LayerNorm(h, epsilon=eps, device=device)
        self.dropout1 = nn.Dropout(config.hidden_dropout_prob)
        self.dropout2 = nn.Dropout(config.hidden_dropout_prob)
        self.act = _act(config.hidden_act)

    def forward(self, x, attn_mask=None):
        # post-LN (BERT convention)
        x = self.ln1(x + self.dropout1(self.attention(x, attn_mask)))
        return self.ln2(x + self.dropout2(self.fc2(self.act(self.fc1(x)))))


class BertPooler(tnn.Module):
    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.dense = _xavier_linear(config.hidden_size, config.hidden_size,
                                    device, generator)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(tnn.Module):
    """Embeddings, the encoder and the pooler; returns ``(sequence
    output, pooled)``.  A 2-D ``attention_mask`` (1 = token, 0 =
    padding) becomes the additive ``[B, 1, 1, S]`` mask of -1e4.
    ``device=None`` means the card and raises without one."""

    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embeddings = BertEmbeddings(config, device, generator)
        self.encoder = tnn.ModuleList(
            [BertLayer(config, device, generator)
             for _ in range(config.num_hidden_layers)])
        self.pooler = BertPooler(config, device, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            attention_mask = ((1.0 - attention_mask.float()) * -1e4)[
                :, None, None, :]
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        return x, self.pooler(x)


class BertForPretraining(tnn.Module):
    """MLM over the tied word embedding plus ``mlm_bias``, and NSP.
    Returns ``(mlm_logits [B, S, V], nsp_logits [B, 2])``."""

    def __init__(self, config: BertConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        h = config.hidden_size
        self.bert = BertModel(config, device, generator)
        self.config = config
        self.transform = _xavier_linear(h, h, device, generator)
        self.transform_ln = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                         device=device)
        self.mlm_bias = tnn.Parameter(torch.zeros(config.vocab_size,
                                                  device=device))
        self.nsp = _xavier_linear(h, 2, device, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        h = self.transform_ln(torch.nn.functional.gelu(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        mlm_logits = torch.matmul(h, w.t()) + self.mlm_bias
        return mlm_logits, self.nsp(pooled)


class BertPretrainingCriterion(tnn.Module):
    """Mean MLM cross-entropy over the positions whose label is not
    -100, plus the mean NSP cross-entropy when NSP labels are given
    (both fp32)."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, mlm_logits, nsp_logits, masked_labels,
                next_sentence_labels=None):
        loss = cross_entropy(mlm_logits.reshape(-1, self.vocab_size),
                             masked_labels.reshape(-1), ignore_index=-100,
                             reduction="mean")
        if next_sentence_labels is not None:
            loss = loss + cross_entropy(nsp_logits,
                                        next_sentence_labels.reshape(-1),
                                        reduction="mean")
        return loss


class BertForSequenceClassification(tnn.Module):
    """Pooled-output classification head (the fine-tuning surface of
    the BERT/ERNIE family)."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 dropout: Optional[float] = None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(config, device, generator)
        self.dropout = nn.Dropout(dropout if dropout is not None
                                  else config.hidden_dropout_prob)
        self.classifier = _xavier_linear(config.hidden_size, num_classes,
                                         device, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


def bert_state_dict_from_jax(numpy_state, model: tnn.Module) -> dict:
    """A state dict for ``model`` (any model of this module) from the
    JAX package's ``state_dict()`` of the same class and config, each
    value a numpy array.  Names and layouts are the same in both
    packages (``Linear`` weights ``[in, out]``, embeddings ``[num,
    dim]``); the MLM head is the word embedding in both, so the tie
    survives ``load_state_dict``.  Raises on a missing, extra or
    misshapen entry."""
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
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


# ERNIE-3.0 aliases: the same architecture under ERNIE's names.
ErnieConfig = BertConfig
ErnieModel = BertModel
ErnieForPretraining = BertForPretraining
ErniePretrainingCriterion = BertPretrainingCriterion
ErnieForSequenceClassification = BertForSequenceClassification
