"""Transformer layers (counterpart of ``paddle_tpu/nn/transformer.py``):
``MultiHeadAttention`` with ``kdim``/``vdim`` and its ``Cache``, the
encoder and decoder layers and stacks, and ``Transformer``.

Attention is the composed masked form, ``ops/nn_ops.py::
scaled_dot_product_attention`` (fp32 arithmetic; a bool mask keeps
where True, a float mask is added, so a -inf causal mask and a -1e9
padding bias compose), as the JAX layer calls the composed
``ops.scaled_dot_product_attention`` and not a Pallas kernel.  Dropout
draws from the port's generator of the device, which a captured step
registers, so each replay draws fresh bits.

What the JAX layers take and leave is kept: the decoder layer's
attentions and linears get no ``weight_attr``/``bias_attr``;
``Transformer`` passes none to its layers.  What the JAX layers take
and never read is refused (``nn_ops.ignored_by_reference``):
``MultiHeadAttention(need_weights=True)``, and a ``cache=`` other than
None on the encoder and decoder layers and stacks
(``MultiHeadAttention``'s own ``cache=`` is read, in both packages).
The stacks' cloned layers are redrawn from Normal(0, sqrt(2 / (fan_in
+ fan_out))) on every parameter of two dims or more (``_clone_layer``),
from the port's generator, so they differ from the JAX package's draws;
weights carry across by name (``Layer.set_state_dict``).

Every layer takes ``device=`` (None: the card) and ``generator=`` (the
initial weights' ``torch.Generator``; None: the port's of the device),
keyword only.
"""

from __future__ import annotations

import copy
import math

import torch

from .. import resolve_device
from ..framework import random as _random
from ..ops import activation as _act
from ..ops import manipulation as M
from ..ops import nn_ops
from .common import Dropout, Linear
from .container import LayerList
from .layer import Layer
from .norm import LayerNorm
from .param_attr import auto_name


def _no_cache(layer, cache):
    if cache is not None:
        nn_ops.ignored_by_reference(f"{type(layer).__name__}(cache=...)")


class MultiHeadAttention(Layer):
    """Attention over ``[B, S, embed_dim]`` with ``num_heads`` heads:
    q/k/v/out projections (``kdim``/``vdim`` the key's and value's
    widths), ``attn_mask`` ``[S_q, S_k]`` or ``[B, 1|H, S_q, S_k]``
    (bool or additive float).  With ``cache`` (a :class:`Cache` of the
    keys and values so far, ``[B, S_past, H, D]``) the new keys and
    values are appended to it and ``(out, Cache(k, v))`` is returned."""

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if need_weights:
            nn_ops.ignored_by_reference(
                "MultiHeadAttention(need_weights=True)")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return M.reshape(x, [b, s, self.num_heads, self.head_dim])

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if cache is not None:
            k = M.concat([cache.k, k], axis=1)
            v = M.concat([cache.v, v], axis=1)
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask, device=q.device)
        out = nn_ops.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training,
            generator=_random.default_generator(q.device))
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(M.reshape(out, [b, s, self.embed_dim]))
        if cache is not None:
            return out, type(cache)(k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        """An empty :class:`Cache` (``[B, 0, H, D]`` fp32 keys and values)
        for incremental decoding."""
        b = key.shape[0]
        shape = (b, 0, self.num_heads, self.head_dim)
        z = torch.zeros(shape, dtype=torch.float32, device=key.device)
        return MultiHeadAttention.Cache(z, z.clone())


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each residual, with the
    LayerNorm before (``normalize_before``) or after each."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(_act, activation)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(self, cache)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` encoder layers (the given one, then redrawn clones:
    :func:`_clone_layer`) and an optional final ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer if i == 0 else
                                 _clone_layer(encoder_layer)
                                 for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(self, cache)
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    """Masked self-attention, attention over the encoder's ``memory`` and
    a feed-forward block, each residual.  As in the JAX layer, only the
    dropouts, the activation and the norms' epsilon are configurable;
    ``weight_attr``/``bias_attr`` are taken and not passed on."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(_act, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        _no_cache(self, cache)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    """``num_layers`` decoder layers (clones as in
    :class:`TransformerEncoder`) and an optional final ``norm``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer if i == 0 else
                                 _clone_layer(decoder_layer)
                                 for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        _no_cache(self, cache)
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """The encoder-decoder of Vaswani et al. (``paddle.nn.Transformer``):
    ``forward(src, tgt, src_mask, tgt_mask, memory_mask)`` over
    embedded ``[B, S, d_model]`` inputs.  With ``normalize_before`` each
    stack ends in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **kw)
            enc_norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **kw)
            dec_norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` fp32: 0 on and below the diagonal, -inf
        above (each position sees itself and the past)."""
        mask = torch.full((length, length), float("-inf"),
                          device=resolve_device(device))
        return torch.triu(mask, diagonal=1)


@torch.no_grad()
def _clone_layer(layer):
    """A deep copy of ``layer`` whose parameters of two dims or more are
    redrawn from Normal(0, sqrt(2 / (fan_in + fan_out))), ``fan_in`` the
    product of all dims but the last, from the port's generator of
    their device (the JAX function's rule); every parameter gets a name
    of its own."""
    new = copy.deepcopy(layer)
    for _, p in new.named_parameters():
        if hasattr(p, "_name"):
            p.name = auto_name("param")
        if p.ndim >= 2:
            fan_in = math.prod(p.shape[:-1])
            std = math.sqrt(2.0 / (fan_in + p.shape[-1]))
            draw = torch.empty(p.shape, dtype=torch.float32,
                               device=p.device)
            draw.normal_(0.0, std,
                         generator=_random.default_generator(p.device))
            p.copy_(draw.to(p.dtype))
    return new
