"""GPT family (counterpart of ``paddle_tpu/models/gpt.py``).

The training model: ``GPTForCausalLM`` (embeddings, pre-norm decoder
layers whose attention is the flash kernel, final norm, and an lm head
tied to the word embedding) and ``GPTPretrainingCriterion``.  Weights
keep Paddle's layout (``Linear`` weights ``[in, out]``) and Paddle's
parameter names, so :func:`state_dict_from_jax` carries a JAX
``GPTForCausalLM.state_dict()`` over key for key.

The layers are the tensor-parallel ones, as in the JAX model
(``VocabParallelEmbedding``, ``ColumnParallelLinear`` /
``RowParallelLinear``, ``ParallelCrossEntropy``).  Built after
``fleet.init`` with ``mp_degree`` > 1, each rank holds its shard: its
``num_attention_heads / mp`` heads (q, k and v of those heads in the
qkv projection), its slice of the MLP and of the vocabulary, and the lm
head computes that slice of the logits.  At mp 1 they are the plain
layers, with the same names, layouts and initial draws.
:func:`state_dict_from_jax` cuts a JAX state dict into a rank's shard,
:func:`merge_mp_states` joins the shards again.
``GPTConfig(recompute=True)`` recomputes each decoder layer in backward
while training (``distributed.fleet.recompute``).  Built under a
topology with sep > 1, the attention is the ring or the Ulysses
attention over the sep group and the embedding's positions are global.

``GPTForCausalLMPipe`` is the model as pipeline items (the JAX
``GPTForCausalLMPipe``); a rank under pp > 1 builds its stage only.
``state_dict_from_jax`` cuts a JAX pipe state into a rank's stage and
mp shard too, and ``merge_mp_states`` joins the stages again;
:func:`pipe_state_from_causal` / :func:`causal_state_from_pipe` rename
between the two models' states.

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
from ..amp.auto_cast import cast_inputs
from ..distributed import collective as _coll
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               ParallelCrossEntropy,
                                               RowParallelLinear,
                                               VocabParallelEmbedding)
from ..distributed.fleet.meta_parallel.context_parallel import (
    ring_flash_attention, ulysses_attention)
from ..distributed.fleet.meta_parallel.mp_ops import (c_identity,
                                                      vocab_parallel_lmce)
from ..distributed.fleet.meta_parallel.pp_layers import (LayerDesc,
                                                         PipelineLayer)
from ..distributed.fleet.recompute import recompute
from ..framework import random as _random
from ..nn.functional import flash_attention
from ..nn.layer import Layer
from ..ops import activation as _activation
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
def _sep_group():
    """The registered topology's sep group when its degree is above 1."""
    hcg = _coll.get_mesh()
    if hcg is None or hcg.get_sep_parallel_world_size() <= 1:
        return None
    return hcg.get_sep_parallel_group()


def _layer_kw(config, device, generator):
    return dict(init_std=config.initializer_range, device=device,
                generator=generator)


class GPTEmbeddings(Layer):
    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = _layer_kw(config, device, generator)
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        # under sep > 1 a rank holds rows sep_rank * S/sep .. of the
        # sequence: its positions are global
        sep = _sep_group()
        self._pos_offset_rank = sep.rank if sep is not None else 0

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            b, s = input_ids.shape
            start = self._pos_offset_rank * s
            position_ids = torch.arange(
                start, start + s,
                device=input_ids.device).unsqueeze(0).expand(b, s)
        emb = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        return self.dropout(emb)


class GPTAttention(Layer):
    """Causal self-attention.  q, k and v are strided ``[B, S, H, D]``
    views of the fused qkv projection (no transpose copy); the flash
    kernels read them in place.  Under mp, ``H`` is this rank's heads.
    Built under sep > 1 (the registered topology's sep group), ``S`` is
    this rank's slice of the sequence and the attention is the ring or
    the Ulysses attention over the sep group, by
    ``config.context_parallel``; attention dropout is refused there, as
    in the JAX model."""

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        mp = _coll.model_parallel_degree()
        if config.num_attention_heads % mp:
            raise ValueError(f"{config.num_attention_heads} heads do not "
                             f"split over mp degree {mp}")
        self.num_heads = config.num_attention_heads // mp
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.hidden_size = self.num_heads * self.head_dim
        self.use_flash = config.use_flash_attention
        self.attn_drop = config.attention_probs_dropout_prob
        self.context_parallel = config.context_parallel
        self._sep_group = _sep_group()
        kw = _layer_kw(config, device, generator)
        self.qkv_proj = ColumnParallelLinear(
            config.hidden_size, 3 * config.hidden_size, gather_output=False,
            **kw)
        # a rank's columns are its heads of q, of k and of v: the whole
        # tensor's last dim, viewed (3, heads, head_dim), splits on heads
        for p in (self.qkv_proj.weight, self.qkv_proj.bias):
            p.split_view = (3, config.num_attention_heads, self.head_dim)
            p.split_view_axis = 1
        self.out_proj = RowParallelLinear(
            config.hidden_size, config.hidden_size, input_is_parallel=True,
            **kw)

    def forward(self, x):
        b, s, _ = x.shape
        h = self.hidden_size
        qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self._sep_group is not None:
            if self.attn_drop > 0.0 and self.training:
                raise ValueError(
                    "context-parallel attention does not support "
                    "attention dropout; set "
                    "attention_probs_dropout_prob=0.0 when sep_degree>1")
            cp = (ulysses_attention if self.context_parallel == "ulysses"
                  else ring_flash_attention)
            out = cp.raw(q, k, v, causal=True, group=self._sep_group)
        elif self.use_flash:
            out, _ = flash_attention(q, k, v, causal=True,
                                     dropout=self.attn_drop,
                                     training=self.training)
        else:
            drop = self.attn_drop if self.training else 0.0
            out, _ = flash_attention_reference(
                q, k, v, True, dropout_p=drop,
                generator=_random.default_generator(x.device))
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = _layer_kw(config, device, generator)
        self.fc1 = ColumnParallelLinear(
            config.hidden_size, config.intermediate_size,
            gather_output=False, **kw)
        self.fc2 = RowParallelLinear(
            config.intermediate_size, config.hidden_size,
            input_is_parallel=True, **kw)

    def forward(self, x):
        return self.fc2(_activation.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(Layer):
    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._recompute = config.recompute
        eps = config.layer_norm_epsilon
        self.ln1 = nn.LayerNorm(config.hidden_size, epsilon=eps,
                                device=device)
        self.attn = GPTAttention(config, device, generator)
        self.ln2 = nn.LayerNorm(config.hidden_size, epsilon=eps,
                                device=device)
        self.mlp = GPTMLP(config, device, generator)
        self.dropout1 = nn.Dropout(config.hidden_dropout_prob)
        self.dropout2 = nn.Dropout(config.hidden_dropout_prob)

    def _block(self, x):
        x = x + self.dropout1(self.attn(self.ln1(x)))
        x = x + self.dropout2(self.mlp(self.ln2(x)))
        return x

    def forward(self, x):
        if self._recompute and self.training:
            return recompute(self._block, x)
        return self._block(x)


class GPTModel(Layer):
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


class GPTForCausalLM(Layer):
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
        emb = self.gpt.embeddings.word_embeddings
        if emb._group is not None:
            # this rank's vocabulary slice of the logits
            hidden = c_identity(hidden, emb._group)
        # the JAX head is ``ops.matmul``, which auto_cast casts
        hidden, w = cast_inputs("matmul", hidden, self.lm_weight())
        return torch.matmul(hidden, w.t())


class GPTPretrainingCriterion(Layer):
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
        self.loss_fn = ParallelCrossEntropy()
        self._lm_weight_fn = lm_weight_fn

    def forward(self, logits, labels, loss_mask=None):
        if self._lm_weight_fn is not None:
            loss = self._fused_loss(logits, labels)
        else:
            loss = self.loss_fn(logits, labels)
        if loss_mask is not None:
            loss_mask = loss_mask.to(loss.dtype)
            return (loss * loss_mask).sum() / loss_mask.sum().clamp_min(1e-9)
        return loss.mean()

    def _fused_loss(self, hidden, labels):
        b, s, d = hidden.shape
        w = self._lm_weight_fn()
        if hidden.dtype != w.dtype:
            # the head's matmul operands, as auto_cast would cast them
            # (O2's final LayerNorm hands fp32 states to a bf16 weight)
            hidden = hidden.to(w.dtype)
        group = getattr(self, "_vocab_group", None)
        if group is not None:
            per_tok = vocab_parallel_lmce(
                c_identity(hidden, group).reshape(b * s, d), w,
                labels.reshape(b * s), group)
        else:
            per_tok = fused_linear_cross_entropy(
                hidden.reshape(b * s, d), w, labels.reshape(b * s))
        return per_tok.reshape(b, s)


def enable_fused_lmce(model: GPTForCausalLM,
                      criterion: GPTPretrainingCriterion):
    """Switch the (model, criterion) pair to the fused lm-head
    cross-entropy path (the JAX package's ``PADDLE_TPU_FUSED_LMCE``
    configuration).  The kernel's ``dw`` reaches the tied embedding
    ``Parameter`` through autograd, beside the lookup's gradient.  Under
    mp > 1 each rank runs the kernels on its vocabulary shard of the
    tied weight (``mp_ops.vocab_parallel_lmce``), the hidden states
    entering through ``c_identity`` as the unfused head takes them: the
    loss is the one over the whole vocabulary, and no rank gathers the
    weight."""
    model.skip_lm_head = True
    criterion._lm_weight_fn = model.lm_weight
    criterion._vocab_group = model.gpt.embeddings.word_embeddings._group
    return model, criterion


# ---------------------------------------------------------------------------
# the pipeline model
# ---------------------------------------------------------------------------
class _EmbeddingPipe(GPTEmbeddings):
    """The embedding as the first pipeline item (the JAX name)."""


class _NormLogitsPipe(Layer):
    """Final norm + the tied-weight logits, the last pipeline item.
    ``lm_weight`` is bound by :class:`GPTForCausalLMPipe`: the word
    embedding itself where one rank holds both, else this stage's copy
    of the same vocabulary shard."""

    def __init__(self, config: GPTConfig, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.final_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_epsilon,
                                       device=device)
        self.lm_weight = None
        group = _coll.get_mesh()
        self._group = group.get_model_parallel_group() \
            if group is not None and \
            group.get_model_parallel_world_size() > 1 else None

    def forward(self, x):
        x = self.final_norm(x)
        if self._group is not None:
            x = c_identity(x, self._group)
        x, w = cast_inputs("matmul", x, self.lm_weight)
        return torch.matmul(x, w.t())


class GPTForCausalLMPipe(PipelineLayer):
    """GPT as pipeline items (the JAX ``GPTForCausalLMPipe``): the
    embedding, the decoder layers, the final norm with the tied head,
    segmented ``layer:GPTDecoderLayer`` and trained with
    ``GPTPretrainingCriterion``.  Under a topology with pp ``num_stages``
    a rank builds its stage only; the head on the last stage then holds a
    copy of the first stage's vocabulary shard, which the pipeline engine
    starts from the embedding and keeps equal to it (the tie
    ``"word_embeddings"``)."""

    def __init__(self, config: GPTConfig, num_stages=1, topology=None,
                 recompute_interval=0, device=None, generator=None):
        self.config = config
        kw = dict(device=device, generator=generator)
        descs = [LayerDesc(_EmbeddingPipe, config, **kw)]
        for _ in range(config.num_hidden_layers):
            descs.append(LayerDesc(GPTDecoderLayer, config, **kw))
        descs.append(LayerDesc(_NormLogitsPipe, config, **kw))
        super().__init__(descs, num_stages=num_stages, topology=topology,
                         loss_fn=GPTPretrainingCriterion(config),
                         seg_method="layer:GPTDecoderLayer",
                         recompute_interval=recompute_interval)
        emb, head = self.run_function[0], self.run_function[-1]
        if emb is not None and head is not None:
            head.lm_weight = emb.word_embeddings.weight
            return
        if head is not None:
            w = head.final_norm.weight
            rows = config.vocab_size // _coll.model_parallel_degree()
            head.lm_weight = torch.nn.Parameter(torch.zeros(
                rows, config.hidden_size, device=w.device, dtype=w.dtype))
            head.lm_weight.is_distributed = head._group is not None
        mine = emb.word_embeddings.weight if emb is not None else \
            (head.lm_weight if head is not None else None)
        self._register_tie("word_embeddings", [0, self._num_stages - 1],
                           mine)


def pipe_names(cfg: GPTConfig) -> dict:
    """``{GPTForCausalLM name: GPTForCausalLMPipe name}``; the head's
    ``_layers_list.{L+1}.lm_weight`` is the word embedding's twin."""
    L = cfg.num_hidden_layers
    out = {}
    for name in _expected_shapes(cfg):
        if name.startswith("gpt.embeddings."):
            out[name] = "_layers_list.0." + name[len("gpt.embeddings."):]
        elif name.startswith("gpt.layers."):
            i, rest = name[len("gpt.layers."):].split(".", 1)
            out[name] = f"_layers_list.{int(i) + 1}.{rest}"
        else:
            out[name] = f"_layers_list.{L + 1}." + name[len("gpt."):]
    return out


def pipe_state_from_causal(state: dict, cfg: GPTConfig) -> dict:
    """A ``GPTForCausalLM`` state under ``GPTForCausalLMPipe``'s names
    (the JAX pipe model's state dict: the head's ``lm_weight`` entry is
    the word embedding)."""
    names = pipe_names(cfg)
    out = {names[k]: v for k, v in state.items()}
    out[f"_layers_list.{cfg.num_hidden_layers + 1}.lm_weight"] = \
        state["gpt.embeddings.word_embeddings.weight"]
    return out


def causal_state_from_pipe(state: dict, cfg: GPTConfig) -> dict:
    """The reverse of :func:`pipe_state_from_causal`."""
    return {k: state[v] for k, v in pipe_names(cfg).items()}


def _pipe_stage_of(name: str, cfg: GPTConfig, pp_degree: int) -> int:
    """The stage that holds pipe entry ``name`` (the segmentation of
    ``GPTForCausalLMPipe``)."""
    from ..distributed.fleet.meta_parallel.pp_layers import segment_bounds
    L = cfg.num_hidden_layers
    names = ["_EmbeddingPipe"] + ["GPTDecoderLayer"] * L + ["_NormLogitsPipe"]
    bounds = segment_bounds(names, pp_degree, "layer:GPTDecoderLayer")
    i = int(name.split(".")[1])
    return max(s for s in range(pp_degree) if bounds[s] <= i)


def _mp_kind(name: str):
    """How the tensor ``name`` splits over mp: ``"vocab"`` / ``"row"``
    on dim 0, ``"col"`` on its last dim, ``"qkv"`` on the heads of each
    of q, k and v, None when replicated."""
    if name.endswith(("word_embeddings.weight", ".lm_weight")):
        return "vocab"
    if ".attn.qkv_proj." in name:
        return "qkv"
    if name.endswith(".mlp.fc1.weight") or name.endswith(".mlp.fc1.bias"):
        return "col"
    if name.endswith(".attn.out_proj.weight") or \
            name.endswith(".mlp.fc2.weight"):
        return "row"
    return None


def _mp_slice(name, arr, rank, degree, heads):
    kind = _mp_kind(name)
    if kind is None or degree == 1:
        return arr
    if kind in ("vocab", "row"):
        n = arr.shape[0] // degree
        return arr[rank * n:(rank + 1) * n]
    if kind == "col":
        n = arr.shape[-1] // degree
        return arr[..., rank * n:(rank + 1) * n]
    lead = arr.shape[:-1]
    hd = arr.shape[-1] // (3 * heads)
    per = heads // degree
    view = arr.reshape(lead + (3, heads, hd))
    return view[..., rank * per:(rank + 1) * per, :].reshape(
        lead + (3 * per * hd,))


def merge_mp_states(states, cfg: GPTConfig, pp_degree: int = 1) -> dict:
    """One state (numpy arrays, or torch tensors) from the shards of the
    mp ranks ``states[0..mp-1]`` (the reverse of
    :func:`state_dict_from_jax`'s cut); replicated entries are rank 0's.
    The gradients of the shards join the same way.  With ``pp_degree``
    above 1, ``states`` are the pipe model's stages' shards in rank
    order (stage-major: stage ``s``, mp rank ``r`` at ``s * mp + r``);
    the stages' joined states are united (the head's copy of the
    embedding from the last stage)."""
    if pp_degree > 1:
        mp = len(states) // pp_degree
        out = {}
        for s in range(pp_degree):
            out.update(merge_mp_states(states[s * mp:(s + 1) * mp], cfg))
        return out
    degree = len(states)
    heads = cfg.num_attention_heads
    out = {}
    for name in states[0]:
        parts = [np.asarray(st[name].detach().float().cpu().numpy()
                            if isinstance(st[name], torch.Tensor)
                            else st[name]) for st in states]
        kind = _mp_kind(name)
        if kind is None or degree == 1:
            out[name] = parts[0]
        elif kind in ("vocab", "row"):
            out[name] = np.concatenate(parts, axis=0)
        elif kind == "col":
            out[name] = np.concatenate(parts, axis=-1)
        else:
            lead = parts[0].shape[:-1]
            per = heads // degree
            hd = parts[0].shape[-1] // (3 * per)
            out[name] = np.concatenate(
                [p.reshape(lead + (3, per, hd)) for p in parts],
                axis=-2).reshape(lead + (3 * heads * hd,))
    return out


def state_dict_from_jax(numpy_state, cfg: GPTConfig, mp_rank: int = 0,
                        mp_degree: int = 1, pp_rank: int = 0,
                        pp_degree: int = 1) -> dict:
    """The port's ``GPTForCausalLM`` state dict from the JAX package's
    ``GPTForCausalLM.state_dict()`` with each value as a numpy array.
    Names and layouts are the same in both packages: ``Linear`` weights
    stay ``[in, out]``, embeddings ``[num, dim]``, norms and biases
    ``[dim]``.  The lm head is the word embedding in both, so there is
    no separate head entry and the tie survives ``load_state_dict``.

    With ``mp_degree`` > 1 the JAX package's full arrays are cut into
    rank ``mp_rank``'s shard: the word embedding on its vocabulary rows,
    the column-parallel weights and biases (``qkv_proj`` by heads: the
    rank's heads of q, of k and of v; ``fc1``) on their output columns,
    the row-parallel weights (``out_proj``, ``fc2``) on their input
    rows; everything else whole.  At mp 1 it is the whole state.

    A JAX ``GPTForCausalLMPipe`` state (names ``_layers_list.<i>.``) gives
    ``GPTForCausalLMPipe``'s: the entries of stage ``pp_rank`` of
    ``pp_degree`` (the model's segmentation), each cut for ``mp_rank``;
    the head's ``lm_weight`` takes the embedding's vocabulary shard.  At
    pp 1 that is the whole pipe state.
    Raises on a missing, extra or misshapen entry; ``load_state_dict``
    then copies each value to the model's device."""
    pipe = any(k.startswith("_layers_list.") for k in numpy_state)
    expected = _expected_shapes(cfg, pipe)
    if not pipe and pp_degree != 1:
        raise ValueError("a pipe stage comes from a GPTForCausalLMPipe "
                         "state (names _layers_list.<i>.)")
    if pipe:
        expected = {k: v for k, v in expected.items()
                    if _pipe_stage_of(k, cfg, pp_degree) == pp_rank}
        numpy_state = {k: v for k, v in numpy_state.items()
                       if not k.startswith("_layers_list.")
                       or _pipe_stage_of(k, cfg, pp_degree) == pp_rank}
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
        part = _mp_slice(name, arr, mp_rank, mp_degree,
                         cfg.num_attention_heads)
        out[name] = torch.as_tensor(np.ascontiguousarray(part))
    return out


def _expected_shapes(cfg: GPTConfig, pipe: bool = False) -> dict:
    if pipe:
        names = pipe_names(cfg)
        out = {names[k]: v for k, v in _expected_shapes(cfg).items()}
        out[f"_layers_list.{cfg.num_hidden_layers + 1}.lm_weight"] = \
            (cfg.vocab_size, cfg.hidden_size)
        return out
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
