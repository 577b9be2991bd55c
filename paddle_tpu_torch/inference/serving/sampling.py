"""Token sampling: temperature / top-k / top-p (counterpart of
``paddle_tpu/inference/serving/sampling.py``).

``temperature == 0`` rows take the greedy argmax, exactly as in the JAX
package, so greedy tokens compare across the two packages.  Sampled
rows are Gumbel-max over the same top-k / top-p filter: ``argmax(
logits/T + G)`` is a categorical draw from ``softmax(logits/T)``
restricted to the kept support.  The noise comes from a
``torch.Generator`` (Philox on the card) seeded as a pure function of
the request's ``(seed, position)``, where ``position`` is the sequence
index of the token being sampled, never of its batch slot or its
neighbours.  So the same seed gives the same tokens, alone or inside a
churning batch.  The JAX package's noise (threefry ``fold_in``) cannot
be reproduced in torch: sampled tokens compare only within the port.

The per-row sampling parameters arrive as host arrays: the engine
holds them on the host already, so choosing the all-greedy fast path
and seeding the generators costs no device sync.
"""

from __future__ import annotations

import numpy as np
import torch

from .ragged_attention import MASK_VALUE

#: floor for temperature / top-p so the temperature==0 select never
#: divides by zero and top_p==0 degenerates to the top token
_EPS = 1e-6


_MASK64 = (1 << 64) - 1


def _mix(seed: int, position: int) -> int:
    """splitmix64 of ``(seed, position)``: every bit of the generator
    seed depends on both (the CPU generator keeps only 32 of them)."""
    z = (((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _gumbel(seed: int, position: int, vocab: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, position))
    u = torch.rand(vocab, generator=gen, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def sample_tokens(logits, temperature, top_k, top_p, seed, position):
    """``[B, V]`` logits → ``[B]`` int32 token ids on ``logits``'s
    device.

    ``temperature``, ``top_k``, ``top_p``, ``seed``, ``position``:
    host sequences of length ``B`` (0 temperature = greedy; top_k <= 0
    and top_p >= 1 switch their filter off).
    """
    temperature = np.asarray(temperature, dtype=np.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not (temperature > 0.0).any():
        return greedy
    dev = logits.device
    B, V = logits.shape
    temp_t = torch.as_tensor(temperature, device=dev)
    topk = torch.as_tensor(np.asarray(top_k, dtype=np.int64), device=dev)
    topp_np = np.asarray(top_p, dtype=np.float32)
    topp = torch.as_tensor(topp_np, device=dev)

    scaled = logits.float() / temp_t.clamp_min(_EPS)[:, None]
    # top-k: kth-largest threshold per row; k <= 0 disables
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = topk.clamp(1, V)
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    keep = (topk <= 0)[:, None] | (scaled >= kth)
    filtered = torch.where(keep, scaled, MASK_VALUE)
    # top-p over the post-top-k distribution: keep a token when the
    # mass BEFORE it is < p (the top token always survives)
    probs = torch.softmax(filtered, dim=-1)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(p_desc, dim=-1)
    p = topp.clamp(_EPS, 1.0)[:, None]
    in_nucleus = (csum - p_desc) < p
    cutoff = torch.where(in_nucleus, p_desc, torch.inf).amin(
        dim=-1, keepdim=True)
    keep_p = (topp >= 1.0)[:, None] | (probs >= cutoff)
    filtered = torch.where(keep_p, filtered, MASK_VALUE)

    g = torch.zeros((B, V), dtype=torch.float32, device=dev)
    for b in np.nonzero(temperature > 0.0)[0]:
        g[b] = _gumbel(np.asarray(seed)[b], np.asarray(position)[b], V, dev)
    sampled = torch.argmax(filtered + g, dim=-1).to(torch.int32)
    return torch.where(temp_t > 0.0, sampled, greedy)
