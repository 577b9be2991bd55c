"""GPT prefill/decode over a weight module (counterpart of
``paddle_tpu/inference/serving/decode_model.py``).

- :func:`params_from_numpy` — the numpy tree of ``paddle_tpu``'s
  ``extract_decode_params`` → :class:`GPTDecodeWeights` on a device.
- :func:`prefill_group_forward` — one same-bucket prefill group:
  per-layer K/V for the page writes plus the first token.
- :func:`decode_forward` — ONE token per request across the batch
  against the paged pool; the pool is appended in place and attention
  runs through the paged-attention seam (the CUDA kernel on the card).
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

from .kv_cache import SCRATCH_BLOCK, paged_append
from .ragged_attention import (causal_prefill_attention,
                               paged_decode_attention,
                               ragged_decode_attention)
from .sampling import sample_tokens


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


class GPTDecodeLayerWeights(nn.Module):
    """One decoder layer's weights, JAX ``[in, out]`` orientation."""

    def __init__(self, arrays: dict, *, device, dtype):
        super().__init__()
        for key in _LAYER_KEYS:
            setattr(self, key, _param(arrays[key], device, dtype))


class GPTDecodeWeights(nn.Module):
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
    t = torch.tensor(np.asarray(array, dtype=np.float32))
    return nn.Parameter(t.to(device=device, dtype=dtype),
                        requires_grad=False)


def params_from_numpy(tree: dict, *, device,
                      dtype=torch.float32) -> GPTDecodeWeights:
    """The dict ``extract_decode_params`` returns, as numpy arrays →
    :class:`GPTDecodeWeights` on ``device`` in ``dtype``.  Orientation
    is kept as given (``[in, out]``); the fused qkv keeps its
    ``[3, H, Dh]`` feature-major column order."""
    return GPTDecodeWeights(tree, device=torch.device(device), dtype=dtype)


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
def prefill_group_forward(params, cfg: ServingModelConfig, ids, lengths,
                          temperature, top_k, top_p, seed):
    """Batched same-bucket prefill.

    ``ids`` ``[G, Lb]`` int tensor (prompts right-padded to the shared
    bucket) on the weights' device; ``lengths``, ``temperature``,
    ``top_k``, ``top_p``, ``seed``: host arrays ``[G]`` (the first
    token's sampling position is the prompt length).  Returns
    ``(kv [L, 2, G, Lb, H, Dh], first_tokens [G] int32, last_logits
    [G, V])``.  Padded group rows (length 0) emit garbage the engine
    ignores.
    """
    G, Lb = ids.shape
    dev = ids.device
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
    lengths = np.asarray(lengths, dtype=np.int64)
    last_ix = torch.as_tensor(np.maximum(lengths - 1, 0), device=dev)
    last = x[torch.arange(G, device=dev), last_ix]  # [G, D]
    logits = last @ params.wte.T                   # [G, V]
    first = sample_tokens(logits, temperature, top_k, top_p, seed,
                          lengths)
    return torch.stack(kvs), first, logits


def prefill_forward(params, cfg: ServingModelConfig, ids, length):
    """Single-request greedy prefill.  ``ids`` ``[1, Lb]``; ``length``
    the real prompt length.  Returns ``(kv [L, 2, Lb, H, Dh],
    first_token, last_logits [V])``."""
    kv, toks, logits = prefill_group_forward(
        params, cfg, ids, [int(length)], [0.0], [0], [1.0], [0])
    return kv[:, :, 0], toks[0], logits[0]


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
        return sample_tokens(lg[None], [temperature], [top_k], [top_p],
                             [seed], [position])[0]

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
