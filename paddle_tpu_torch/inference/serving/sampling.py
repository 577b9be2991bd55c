"""Token sampling: temperature / top-k / top-p (counterpart of
``paddle_tpu/inference/serving/sampling.py``).

``temperature == 0`` rows take the greedy argmax, exactly as in the JAX
package, so greedy tokens compare across the two packages.  Sampled
rows are Gumbel-max over the same top-k / top-p filter: ``argmax(
logits/T + G)`` is a categorical draw from ``softmax(logits/T)``
restricted to the kept support.

The noise is a counter-based hash of ``(seed, position, vocab index)``
in torch integer ops (:func:`gumbel_noise`), where ``position`` is the
sequence index of the token being sampled, never its batch slot or its
neighbours: the counterpart of the JAX package's ``fold_in(PRNGKey(
seed), position)``.  So the same seed gives the same tokens, alone or
inside a churning batch, and the draw is a function of device tensors
that a captured decode step holds in its graph.  The hash's bits are
the same on every device (each product stays below 2**49 in int64); its
Gumbel transform runs in float64 and rounds to float32 once.  The JAX
package's noise (threefry) is not reproduced: sampled tokens compare
only within the port.

:func:`sample_tokens` takes ``[B]`` tensors on the logits' device and
has no host branch.  :func:`sample_tokens_host` takes host sequences
(the eager prefill paths) and skips the filters and the noise when no
row samples, as the JAX package's ``lax.cond`` on ``any(temperature >
0)`` does.  :func:`sample_tokens_grid` is the ``[B, S]`` window form
that the speculative verify samples with.
"""

from __future__ import annotations

import numpy as np
import torch

from .ragged_attention import MASK_VALUE

#: floor for temperature / top-p so the temperature==0 select never
#: divides by zero and top_p==0 degenerates to the top token
_EPS = 1e-6

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a
    32-bit constant ``c``, through the 16-bit halves of ``c``: no
    intermediate reaches 2**49, so int64 never overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """murmur3's 32-bit finaliser on int64 values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def noise_bits(seed, position, vocab: int):
    """``[B]`` seeds (uint32 values) and ``[B]`` positions → ``[B,
    vocab]`` int64 hashes in ``[0, 2**32)``: a row key from ``(seed,
    position)``, then each vocabulary index mixed into it."""
    s = seed.to(torch.int64) & _M32
    p = position.to(torch.int64) & _M32
    row = _fmix32(_fmix32(s ^ 0x9E3779B9) ^ p)
    col = torch.arange(vocab, dtype=torch.int64, device=seed.device)
    return _fmix32(row[:, None] ^ _mul32(col, 0x27D4EB2F)[None])


def gumbel_noise(seed, position, vocab: int) -> torch.Tensor:
    """``[B, vocab]`` float32 Gumbel noise of :func:`noise_bits`: the
    uniform ``((h >> 8) + 0.5) * 2**-24`` (never 0 or 1), then
    ``-log(-log(u))`` in float64, rounded once."""
    h = noise_bits(seed, position, vocab)
    u = ((h >> 8).to(torch.float64) + 0.5) * 2.0 ** -24
    return (-torch.log(-torch.log(u))).to(torch.float32)


def sample_tokens(logits, temperature, top_k, top_p, seed, position,
                  noise=None):
    """``[B, V]`` logits → ``[B]`` int32 token ids.

    ``temperature`` (0 = greedy), ``top_k`` (<= 0 off), ``top_p`` (>= 1
    off), ``seed`` (uint32 values) and ``position`` (the sampled token's
    sequence index): ``[B]`` tensors on the logits' device.  ``noise``
    (``[B, V]`` float32) replaces :func:`gumbel_noise` (the tests inject
    the JAX package's).  Every row runs the filters; greedy rows then
    take the argmax.
    """
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature.float().clamp_min(_EPS)[:, None]
    # top-k: kth-largest threshold per row; k <= 0 disables
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    topk = top_k.to(torch.int64)
    kth = torch.gather(sorted_desc, 1, (topk.clamp(1, V) - 1)[:, None])
    keep = (topk <= 0)[:, None] | (scaled >= kth)
    filtered = torch.where(keep, scaled, MASK_VALUE)
    # top-p over the post-top-k distribution: keep a token when the
    # mass BEFORE it is < p (the top token always survives)
    probs = torch.softmax(filtered, dim=-1)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(p_desc, dim=-1)
    p = top_p.float().clamp(_EPS, 1.0)[:, None]
    in_nucleus = (csum - p_desc) < p
    cutoff = torch.where(in_nucleus, p_desc, torch.inf).amin(
        dim=-1, keepdim=True)
    keep_p = (top_p >= 1.0)[:, None] | (probs >= cutoff)
    filtered = torch.where(keep_p, filtered, MASK_VALUE)
    if noise is None:
        noise = gumbel_noise(seed, position, V)
    sampled = torch.argmax(filtered + noise, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


def sample_tokens_host(logits, temperature, top_k, top_p, seed,
                       position):
    """:func:`sample_tokens` with host sequences of length ``B``: an
    all-greedy batch takes the argmax alone; otherwise the vectors are
    staged to the logits' device (from private copies, without waiting
    for the device)."""
    temperature = np.asarray(temperature, dtype=np.float32)
    if not (temperature > 0.0).any():
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def stage(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(
            logits.device, non_blocking=True)

    return sample_tokens(logits, stage(temperature, np.float32),
                         stage(top_k, np.int64), stage(top_p, np.float32),
                         stage(np.asarray(seed, np.int64) & _M32, np.int64),
                         stage(position, np.int64))


def sample_tokens_grid(logits, temperature, top_k, top_p, seed, positions,
                       greedy: bool = False):
    """``[B, S, V]`` logits → ``[B, S]`` int32 tokens: the window form
    for the speculative verify.

    The per-request vectors stay ``[B]``; ``positions`` ``[B, S]`` is
    each window slot's sequence index.  The window is flattened into the
    batch axis and handed to :func:`sample_tokens` with the vectors
    repeated ``S`` times, so slot ``(b, i)`` draws the noise of ``(seed_b,
    positions[b, i])`` that the one-token path draws at that index: the
    speculative accept rule's exactness rests on it.  ``greedy`` (a host
    flag: the all-greedy variant of the captured step) takes the argmax
    over the grid alone.
    """
    B, S, V = logits.shape
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def rep(x):
        return x[:, None].expand(B, S).reshape(B * S)

    flat = sample_tokens(logits.reshape(B * S, V), rep(temperature),
                         rep(top_k), rep(top_p), rep(seed),
                         positions.reshape(B * S))
    return flat.reshape(B, S)
