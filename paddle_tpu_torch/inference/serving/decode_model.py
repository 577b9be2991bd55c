"""GPT prefill/decode over a weight module (counterpart of
``paddle_tpu/inference/serving/decode_model.py``).

- :func:`params_from_numpy` — the numpy tree of ``paddle_tpu``'s
  ``extract_decode_params`` → :class:`GPTDecodeWeights` on a device.
- :func:`extract_decode_params` — the port's training
  ``GPTForCausalLM`` → :class:`GPTDecodeWeights` (same layout);
  :func:`copy_decode_params_` refreshes weights in place.
- :func:`prefill_group_forward` — one same-bucket prefill group:
  per-layer K/V for the page writes plus the first token.
- :func:`chunk_prefill_forward` — one prefill chunk against the context
  already in the pool (chunked prefill, prefix-cache hits); writes its
  pages in place.
- :func:`decode_forward` — ONE token per request across the batch
  against the paged pool; the pool is appended in place and attention
  runs through the paged-attention seam (the CUDA kernel on the card).
- :func:`spec_score_forward` — a speculative window's ``k+1`` positions
  per request in ONE :func:`decode_forward`, the window flattened into
  the batch axis.
- :func:`reference_decode` — slow per-request sequential decode with a
  dense cache; the exactness oracle, not a serving path.

Numerics follow the JAX package: LayerNorm statistics in f32,
tanh-approximate GELU, attention scale ``1/sqrt(Dh)``, the fused qkv
projection split in ``[3, H, Dh]`` feature-major order, weights in the
JAX ``[in, out]`` orientation (``h @ w``), and the tied lm-head
``x @ wte.T``.  The large products are ``torch.matmul``, as XLA
computes them outside any kernel in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layer import Layer
from .kv_cache import (SCRATCH_BLOCK, gather_pages, paged_append,
                       write_prompt_pages)
from .ragged_attention import (causal_prefill_attention,
                               chunked_prefill_attention,
                               paged_decode_attention,
                               ragged_decode_attention)
from .sampling import sample_tokens, sample_tokens_host


@dataclass(frozen=True)
class ServingModelConfig:
    """Static model geometry of the serving steps."""
    num_layers: int
    num_heads: int
    head_dim: int
    hidden_size: int
    vocab_size: int
    max_position: int
    ln_epsilon: float = 1e-5

    @classmethod
    def from_gpt_config(cls, cfg) -> "ServingModelConfig":
        return cls(num_layers=cfg.num_hidden_layers,
                   num_heads=cfg.num_attention_heads,
                   head_dim=cfg.hidden_size // cfg.num_attention_heads,
                   hidden_size=cfg.hidden_size,
                   vocab_size=cfg.vocab_size,
                   max_position=cfg.max_position_embeddings,
                   ln_epsilon=cfg.layer_norm_epsilon)


_LAYER_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wo", "bo", "ln2_w",
               "ln2_b", "w1", "b1", "w2", "b2")


class GPTDecodeLayerWeights(Layer):
    """One decoder layer's weights, JAX ``[in, out]`` orientation."""

    def __init__(self, arrays: dict, *, device, dtype):
        super().__init__()
        for key in _LAYER_KEYS:
            setattr(self, key, _param(arrays[key], device, dtype))


class GPTDecodeWeights(Layer):
    """Serving weights: ``wte [V, D]``, ``wpe [P, D]``, final LayerNorm
    and ``layers``.  Inference only (``requires_grad=False``)."""

    def __init__(self, tree: dict, *, device, dtype):
        super().__init__()
        for key in ("wte", "wpe", "lnf_w", "lnf_b"):
            setattr(self, key, _param(tree[key], device, dtype))
        self.layers = nn.ModuleList(
            GPTDecodeLayerWeights(lp, device=device, dtype=dtype)
            for lp in tree["layers"])


def _param(array, device, dtype):
    if isinstance(array, torch.Tensor):
        t = array.detach().to(device=device, dtype=dtype, copy=True)
    else:
        t = torch.tensor(np.asarray(array, dtype=np.float32)).to(
            device=device, dtype=dtype)
    return nn.Parameter(t, requires_grad=False)


def params_from_numpy(tree: dict, *, device,
                      dtype=torch.float32) -> GPTDecodeWeights:
    """The dict ``extract_decode_params`` returns, as numpy arrays →
    :class:`GPTDecodeWeights` on ``device`` in ``dtype``.  Orientation
    is kept as given (``[in, out]``); the fused qkv keeps its
    ``[3, H, Dh]`` feature-major column order."""
    return GPTDecodeWeights(tree, device=torch.device(device), dtype=dtype)


def extract_decode_params(network, device=None) -> GPTDecodeWeights:
    """The port's ``GPTForCausalLM`` → :class:`GPTDecodeWeights` on
    ``device`` (default: where the network's weights are), in the dtype
    of its word embedding: a copy of the live values, in the layout of
    the JAX package's ``extract_decode_params`` (``gpt.embeddings``,
    ``gpt.layers[i].ln1`` / ``attn.qkv_proj`` / ``attn.out_proj`` /
    ``ln2`` / ``mlp.fc1`` / ``mlp.fc2``, ``gpt.final_norm``; ``Linear``
    weights ``[in, out]`` in both).  Raises ``TypeError`` for a network
    of another shape."""
    gpt = getattr(network, "gpt", None)
    if gpt is None:
        raise TypeError(
            f"serving decode expects a GPTForCausalLM-shaped network "
            f"(got {type(network).__name__}); wrap custom models in the "
            "same .gpt/.embeddings/.layers layout")
    emb = gpt.embeddings
    wte = emb.word_embeddings.weight
    tree = {"wte": wte, "wpe": emb.position_embeddings.weight,
            "lnf_w": gpt.final_norm.weight, "lnf_b": gpt.final_norm.bias,
            "layers": [{
                "ln1_w": layer.ln1.weight, "ln1_b": layer.ln1.bias,
                "wqkv": layer.attn.qkv_proj.weight,
                "bqkv": layer.attn.qkv_proj.bias,
                "wo": layer.attn.out_proj.weight,
                "bo": layer.attn.out_proj.bias,
                "ln2_w": layer.ln2.weight, "ln2_b": layer.ln2.bias,
                "w1": layer.mlp.fc1.weight, "b1": layer.mlp.fc1.bias,
                "w2": layer.mlp.fc2.weight, "b2": layer.mlp.fc2.bias,
            } for layer in gpt.layers]}
    device = wte.device if device is None else torch.device(device)
    return GPTDecodeWeights(tree, device=device, dtype=wte.dtype)


def copy_decode_params_(dst: GPTDecodeWeights,
                        src: GPTDecodeWeights) -> None:
    """Copy ``src``'s values into ``dst`` IN PLACE (a captured decode
    step holds ``dst``'s addresses, so its next replay reads the new
    values).  Raises ``ValueError`` unless every tensor's name, shape
    and dtype agree."""
    want = {n: (tuple(p.shape), p.dtype) for n, p in dst.named_parameters()}
    got = {n: (tuple(p.shape), p.dtype) for n, p in src.named_parameters()}
    if want != got:
        bad = sorted(n for n in set(want) | set(got)
                     if want.get(n) != got.get(n))
        raise ValueError(
            f"new weights do not match the served ones (shape or dtype) "
            f"at {bad[:4]}: refresh keeps the geometry and dtype")
    with torch.no_grad():
        srcs = dict(src.named_parameters())
        for n, p in dst.named_parameters():
            p.copy_(srcs[n])


def _ln(x, w, b, eps):
    """f32-statistics LayerNorm (``_ln`` of the JAX package)."""
    orig = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * w.float() + b.float()
    return out.to(orig)


def _split_qkv(qkv, num_heads, head_dim):
    """Fused projection output → (q, k, v), each ``[..., H, Dh]``."""
    qkv = qkv.reshape(*qkv.shape[:-1], 3, num_heads, head_dim)
    return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]


def _mlp(x, lp, eps):
    h = _ln(x, lp.ln2_w, lp.ln2_b, eps)
    h = F.gelu(h @ lp.w1 + lp.b1, approximate="tanh")
    return h @ lp.w2 + lp.b2


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _on_device(x, dtype, device) -> torch.Tensor:
    """A prefill input as a tensor: a tensor passes as it is (a captured
    prefill's static buffer), a host value or sequence is staged to
    ``device`` from a private copy, without waiting for the device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=dtype).reshape(-1)).to(
        device, non_blocking=True)


def _seeds_on_device(seed, device) -> torch.Tensor:
    """Seeds as :func:`_on_device` gives them, host values reduced to
    their uint32 bits first."""
    if isinstance(seed, torch.Tensor):
        return seed
    return _on_device(np.asarray(seed, dtype=np.int64) & 0xFFFFFFFF,
                      np.int64, device)


def prefill_group_forward(params, cfg: ServingModelConfig, ids, lengths,
                          temperature, top_k, top_p, seed):
    """Batched same-bucket prefill.

    ``ids`` ``[G, Lb]`` int tensor (prompts right-padded to the shared
    bucket) on the weights' device; ``lengths``, ``temperature``,
    ``top_k``, ``top_p``, ``seed``: ``[G]`` tensors on that device (the
    seeds as uint32 bits in any integer dtype), or host sequences,
    which are staged first.  Every device input is read on the device,
    so the engine's captured prefill holds this body whole: the last
    position is a gather at ``lengths - 1``, and the first token is
    sampled by :func:`~.sampling.sample_tokens` at the prompt length.
    Returns ``(kv [L, 2, G, Lb, H, Dh], first_tokens [G] int32,
    last_logits [G, V])``.  Padded group rows (length 0) emit garbage
    the engine ignores.
    """
    G, Lb = ids.shape
    dev = ids.device
    lengths = _on_device(lengths, np.int32, dev)
    pos = torch.arange(Lb, device=dev)
    x = params.wte[ids.long()] + params.wpe[pos][None]
    kvs = []
    for lp in params.layers:
        h = _ln(x, lp.ln1_w, lp.ln1_b, cfg.ln_epsilon)
        q, k, v = _split_qkv(h @ lp.wqkv + lp.bqkv, cfg.num_heads,
                             cfg.head_dim)
        kvs.append(torch.stack([k, v]))            # [2, G, Lb, H, Dh]
        attn = causal_prefill_attention(q, k, v)
        x = x + attn.reshape(G, Lb, cfg.hidden_size) @ lp.wo + lp.bo
        x = x + _mlp(x, lp, cfg.ln_epsilon)
    x = _ln(x, params.lnf_w, params.lnf_b, cfg.ln_epsilon)
    last_ix = (lengths.long() - 1).clamp(min=0)
    last = torch.take_along_dim(x, last_ix[:, None, None], dim=1)[:, 0]
    logits = last @ params.wte.T                   # [G, V]
    first = sample_tokens(logits, _on_device(temperature, np.float32, dev),
                          _on_device(top_k, np.int32, dev),
                          _on_device(top_p, np.float32, dev),
                          _seeds_on_device(seed, dev), lengths)
    return torch.stack(kvs), first, logits


def prefill_forward(params, cfg: ServingModelConfig, ids, length):
    """Single-request greedy prefill.  ``ids`` ``[1, Lb]``; ``length``
    the real prompt length.  Returns ``(kv [L, 2, Lb, H, Dh],
    first_token, last_logits [V])``."""
    kv, toks, logits = prefill_group_forward(
        params, cfg, ids, [int(length)], [0.0], [0], [1.0], [0])
    return kv[:, :, 0], toks[0], logits[0]


def chunk_prefill_forward(params, cfg: ServingModelConfig, pool, ctx_table,
                          ctx_len, ids, chunk_len, chunk_blocks,
                          temperature, top_k, top_p, seed):
    """One prefill *chunk* against the paged pool: the chunk's K/V,
    attending to the context already cached (prefix-cache hits and
    earlier chunks), are written into the chunk's pages IN PLACE, and
    the chunk's last real position gives the next token.

    ``ctx_table`` ``[1, NBctx]`` int32 tensor: the page-table slice
    covering the context (the engine pads it to a context-extent
    bucket; columns past ``ctx_len`` are masked); ``ctx_len``: cached
    tokens; ``ids`` ``[1, Cb]`` int tensor: the chunk's tokens
    right-padded to ``Cb`` (a block multiple); ``chunk_len``: its real
    tokens; ``chunk_blocks`` ``[Cb // BS]`` int tensor: its pages (tail
    entries SCRATCH_BLOCK).  ``ctx_len``, ``chunk_len`` and the four
    sampling values are ``[1]`` tensors on the pool's device (as the
    engine's captured chunk holds them) or host scalars, which are
    staged first.  The token is sampled at position ``ctx_len +
    chunk_len`` (only a prompt's last chunk's token is used).  Returns
    ``(token, last_logits [V])``.
    """
    B, Cb = ids.shape
    dev = ids.device
    ctx_len = _on_device(ctx_len, np.int32, dev)
    chunk_len = _on_device(chunk_len, np.int32, dev)
    pos = (ctx_len + torch.arange(Cb, device=dev)).clamp(
        max=cfg.max_position - 1)
    x = params.wte[ids.long()] + params.wpe[pos][None]
    kvs = []
    for li, lp in enumerate(params.layers):
        h = _ln(x, lp.ln1_w, lp.ln1_b, cfg.ln_epsilon)
        q, k, v = _split_qkv(h @ lp.wqkv + lp.bqkv, cfg.num_heads,
                             cfg.head_dim)
        kvs.append(torch.stack([k[0], v[0]]))      # [2, Cb, H, Dh]
        k_ctx, v_ctx = gather_pages(pool, li, ctx_table)
        attn = chunked_prefill_attention(q, k_ctx, v_ctx, ctx_len, k, v)
        del k_ctx, v_ctx
        x = x + attn.reshape(B, Cb, cfg.hidden_size) @ lp.wo + lp.bo
        x = x + _mlp(x, lp, cfg.ln_epsilon)
    write_prompt_pages(pool, torch.stack(kvs), chunk_blocks)
    x = _ln(x, params.lnf_w, params.lnf_b, cfg.ln_epsilon)
    last = x[0].index_select(0, (chunk_len.long() - 1).clamp(min=0))
    logits = last @ params.wte.T                   # [1, V]
    tok = sample_tokens(logits, _on_device(temperature, np.float32, dev),
                        _on_device(top_k, np.int32, dev),
                        _on_device(top_p, np.float32, dev),
                        _seeds_on_device(seed, dev), ctx_len + chunk_len)
    return tok[0], logits[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def decode_forward(params, cfg: ServingModelConfig, pool, page_table,
                   lengths, tokens, write_ok):
    """ONE decode token per request over the paged pool.

    ``pool`` ``[L, 2, NB, BS, H, Dh]`` (appended IN PLACE);
    ``page_table`` ``[B, MAXNB]`` int32; ``lengths`` ``[B]`` int32 —
    tokens already in cache per request (the new token's position);
    ``tokens`` ``[B]`` int32 — the input token per request;
    ``write_ok`` ``[B]`` bool — rows with ``False`` write to the
    scratch block and their output is garbage the engine masks.
    Returns ``logits [B, V]``.
    """
    L, _, NB, BS, H, Dh = pool.shape
    B, MAXNB = page_table.shape
    lengths = lengths.to(torch.int32)
    # clamps as in the reference: JAX clamps out-of-range indices
    # silently, torch would raise
    pos = lengths.clamp(max=cfg.max_position - 1).long()
    write_pos = lengths.clamp(max=MAXNB * BS - 1)
    blk_slot = torch.div(write_pos, BS, rounding_mode="floor").clamp(
        max=MAXNB - 1)
    block_ids = torch.gather(page_table, 1, blk_slot[:, None].long())[:, 0]
    block_ids = torch.where(write_ok, block_ids,
                            torch.full_like(block_ids, SCRATCH_BLOCK))
    offsets = write_pos % BS
    attn_len = (lengths + 1).to(torch.int32)   # includes the new token
    x = params.wte[tokens.long()] + params.wpe[pos]          # [B, D]
    for li, lp in enumerate(params.layers):
        h = _ln(x, lp.ln1_w, lp.ln1_b, cfg.ln_epsilon)
        q, k, v = _split_qkv(h @ lp.wqkv + lp.bqkv, cfg.num_heads,
                             cfg.head_dim)
        paged_append(pool, li, k, v, block_ids, offsets)
        attn = paged_decode_attention(pool, li, page_table, attn_len, q)
        x = x + attn.reshape(B, cfg.hidden_size) @ lp.wo + lp.bo
        x = x + _mlp(x, lp, cfg.ln_epsilon)
    x = _ln(x, params.lnf_w, params.lnf_b, cfg.ln_epsilon)
    return x @ params.wte.T                                  # [B, V]


def spec_score_forward(params, cfg: ServingModelConfig, pool, page_table,
                       lengths, tokens, write_ok):
    """Score all ``S = k+1`` positions of a speculative window in ONE
    :func:`decode_forward`.

    ``tokens`` ``[B, S]`` int32: the incoming token and the draft's
    ``k`` proposals per request; ``lengths`` ``[B]``: cache tokens
    before the window.  Window slot ``(b, i)`` becomes row ``b*S + i``
    with the page table of ``b`` and length ``n_b + i``; since
    :func:`decode_forward` appends a layer's K/V for every row before
    that layer's attention reads, row ``(b, i)`` attends positions
    ``0..n_b+i``, its own window's rows included: causal over the
    proposals, and the verify's K/V overwrite the draft's.  A row whose
    position lies past the table's reach (``n_b + i >= MAXNB*BS``)
    writes to the scratch block; clamped, it would overwrite the last
    real slot.  Returns ``logits [B, S, V]``.
    """
    BS = pool.shape[3]
    B, MAXNB = page_table.shape
    S = tokens.shape[1]
    offs = torch.arange(S, dtype=torch.int32, device=lengths.device)
    flat_len = (lengths.to(torch.int32)[:, None] + offs[None]).reshape(-1)
    flat_ok = (write_ok[:, None].expand(B, S).reshape(-1)
               & (flat_len < MAXNB * BS))
    flat_table = page_table[:, None, :].expand(B, S, MAXNB).reshape(
        B * S, MAXNB)
    logits = decode_forward(params, cfg, pool, flat_table, flat_len,
                            tokens.reshape(-1), flat_ok)
    return logits.reshape(B, S, -1)


# ---------------------------------------------------------------------------
# sequential oracle
# ---------------------------------------------------------------------------
@torch.no_grad()
def reference_decode(params, cfg: ServingModelConfig, prompt_ids,
                     num_tokens, temperature=0.0, top_k=0, top_p=1.0,
                     seed=0):
    """Per-request sequential decode with a dense cache (greedy by
    default; sampled when ``temperature > 0``).  Unbatched, unpaged:
    the exactness oracle the batched paged path is held against.
    Returns ``(tokens [num_tokens] int32, logits [num_tokens, V])`` on
    the weights' device."""
    dev = params.wte.device

    def _pick(lg, position):
        return sample_tokens_host(lg[None], [temperature], [top_k],
                                  [top_p], [seed], [position])[0]

    ids = torch.as_tensor(list(prompt_ids), dtype=torch.int32,
                          device=dev)[None]
    Lp = ids.shape[1]
    kv, _, logits = prefill_forward(params, cfg, ids, Lp)
    tok = _pick(logits, Lp)
    caches = [(kv[li, 0], kv[li, 1]) for li in range(cfg.num_layers)]
    out_toks, out_logits = [tok], [logits]
    for step in range(1, int(num_tokens)):
        pos = min(Lp + step - 1, cfg.max_position - 1)
        x = (params.wte[tok.long()] + params.wpe[pos])[None]  # [1, D]
        new_caches = []
        for li, lp in enumerate(params.layers):
            h = _ln(x, lp.ln1_w, lp.ln1_b, cfg.ln_epsilon)
            q, k, v = _split_qkv(h @ lp.wqkv + lp.bqkv, cfg.num_heads,
                                 cfg.head_dim)
            ck = torch.cat([caches[li][0], k], dim=0)
            cv = torch.cat([caches[li][1], v], dim=0)
            new_caches.append((ck, cv))
            attn = ragged_decode_attention(
                q, ck[None], cv[None],
                torch.full((1,), ck.shape[0], dtype=torch.int32,
                           device=dev))
            x = x + attn.reshape(1, cfg.hidden_size) @ lp.wo + lp.bo
            x = x + _mlp(x, lp, cfg.ln_epsilon)
        caches = new_caches
        x = _ln(x, params.lnf_w, params.lnf_b, cfg.ln_epsilon)
        lg = (x @ params.wte.T)[0]
        tok = _pick(lg, Lp + step)
        out_toks.append(tok)
        out_logits.append(lg)
    return torch.stack(out_toks), torch.stack(out_logits)
