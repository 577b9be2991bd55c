"""Speculative multi-token decoding inside the one decode step
(counterpart of ``paddle_tpu/inference/serving/spec_decode.py``).

One call proposes, verifies and accepts up to ``k+1`` tokens per
request, as tensor ops with no host read, so the engine captures it in
its decode graph:

1. **Draft.**  A draft model of the target's geometry (a self-draft is
   the target's own weights) proposes ``k`` tokens by ``k`` one-token
   :func:`~.decode_model.decode_forward` calls on the SHARED paged pool.
   Its K/V land in the look-ahead positions and the verify overwrites
   them: the draft never owns cache state.
2. **Verify.**  The target scores the ``k+1`` window positions (the
   incoming token and the proposals) in ONE
   :func:`~.decode_model.spec_score_forward`: the window is flattened
   into the batch axis, so the paged-attention kernel runs at ``[B *
   (k+1)]`` rows.
3. **Accept.**  The target's choice at each position is a pure function
   of (logits, seed, position) (``sampling.py``), so a proposal is
   accepted iff it EQUALS that choice; the first mismatch emits the
   target's token instead and ends the window.  The emitted tokens are
   those of one-token decoding, greedy and seeded sampling alike,
   whatever the draft proposed.

The verify's page writes commit the accepted prefix; positions past it
are masked by length in every later read.  Positions past the accepted
prefix emit :data:`SPEC_SENTINEL`, so the host pushes a fixed ``k+1``
views per dispatch without reading the accepted count.
"""

from __future__ import annotations

import torch

from .decode_model import decode_forward, spec_score_forward
from .sampling import sample_tokens, sample_tokens_grid

#: emitted-token placeholder past the accepted prefix: never a
#: vocabulary id; the engine strips it at finalize, streams skip it
SPEC_SENTINEL = -1


def spec_decode_step(params, draft_params, cfg, k: int, pool, page_table,
                     lengths, tokens, active, temps, topks, topps, seeds,
                     greedy: bool = False):
    """One speculative window for the whole batch.

    ``lengths``/``tokens``/``active`` as in
    :func:`~.decode_model.decode_forward` (``active`` is its
    ``write_ok``); the sampling vectors as in
    :func:`~.sampling.sample_tokens`; ``k`` and ``greedy`` (the
    all-greedy variant: argmax, no filters or noise) are host values.
    The pool is written in place.  Returns ``(emit [B, k+1], last [B],
    n_emit [B])``, int32: ``emit`` holds the accepted proposals and the
    target's token after them (:data:`SPEC_SENTINEL` beyond), ``last``
    the last emitted token (the next dispatch's input; ``tokens`` on
    inactive rows) and ``n_emit`` the real tokens emitted (0 on inactive
    rows).
    """
    S = k + 1
    # 1) draft: k sequential forwards on the shared pool, sampling with
    # the target's (seed, position) noise, so a self-draft agrees with
    # the verify and accepts everything
    props = []
    d_tok, d_len = tokens, lengths
    for _ in range(k):
        d_logits = decode_forward(draft_params, cfg, pool, page_table,
                                  d_len, d_tok, active)
        if greedy:
            d_tok = torch.argmax(d_logits, dim=-1).to(torch.int32)
        else:
            d_tok = sample_tokens(d_logits, temps, topks, topps, seeds,
                                  d_len + 1)
        props.append(d_tok)
        d_len = d_len + 1
    props = torch.stack(props, dim=1)                      # [B, k]
    window = torch.cat([tokens[:, None], props], dim=1)    # [B, S]
    # 2) verify: the target scores the window in one forward,
    # overwriting the draft's K/V with its own
    logits = spec_score_forward(params, cfg, pool, page_table, lengths,
                                window, active)
    # 3) the target's choice at every window position: the sampled
    # token's sequence index, as in the one-token step
    offs = torch.arange(S, dtype=torch.int32, device=lengths.device)
    positions = lengths[:, None] + 1 + offs[None]          # [B, S]
    choices = sample_tokens_grid(logits, temps, topks, topps, seeds,
                                 positions, greedy=greedy)
    # 4) accept the longest proposal prefix equal to the target's
    # choices; slot acc emits the target's token (acc == k: the bonus)
    match = (props == choices[:, :k]).to(torch.int32)
    acc = torch.cumprod(match, dim=1).sum(dim=1)           # [B] int64
    valid = (offs[None] <= acc[:, None]) & active[:, None]
    emit = torch.where(valid, choices,
                       torch.full_like(choices, SPEC_SENTINEL))
    last = torch.gather(choices, 1, acc[:, None])[:, 0]
    last = torch.where(active, last, tokens)
    n_emit = torch.where(active, acc + 1, 0).to(torch.int32)
    return emit, last, n_emit
