"""Continuous-batching decode engine (counterpart of
``paddle_tpu/inference/serving/engine.py``).

One engine step admits waiting requests, prefills them (same-bucket
groups, or chunk by chunk), advances at most ONE prefill chunk, grows
pages, and runs ONE batched decode dispatch over the paged KV pool.
Requests joining and leaving the batch change only page table, length
and sampling *data*; the decode dispatch always has the shapes
``[max_batch]`` and ``[max_batch, max_blocks_per_seq]``.

**The decode step is one captured CUDA graph** (the torch counterpart
of the JAX engine's single-trace decode program).  Its inputs and
outputs are static device buffers, written in place: the page table and
lengths (staged from the host before every dispatch), the per-slot
sampling vectors (re-staged only when a seat or a finalize changed
them) and the loop state, the tokens that feed back and the device
``done`` mask.  On a CUDA device the first dispatch of each variant
runs eagerly on the graph's stream (building kernels, the K1 split's
workspace and cuBLAS's), the step is then captured
(``framework/dispatch.py::CapturedCall``) and every later dispatch
replays it; the kernel wrappers' launch counts advance per replay
through a ledger.  Two variants exist: greedy-only, and mixed (the
top-k/top-p filters and the hashed Gumbel noise of ``sampling.py``);
the host picks one per dispatch from the temperatures it holds, as the
JAX program's ``lax.cond`` on ``any(temperature > 0)`` does on the
device, so an all-greedy batch never pays for two ``[B, V]`` sorts.  A
capture that fails raises with its CUDA error; nothing carries on
eagerly on the card.  On the CPU the same body runs eagerly.

**Prefill is captured too, one graph per shape key**, as the JAX engine
compiles one program per shape: a same-bucket group per (group bucket,
prompt bucket), a chunk per (chunk bucket, context-extent bucket).
Each key owns static input buffers (one int32 buffer, staged in one
copy from pinned memory) and a token buffer; its body is
:func:`~.decode_model.prefill_group_forward` with the grouped page
write, or :func:`~.decode_model.chunk_prefill_forward` (context gather,
attention, page write), every input read on the device.  The first run
of a key warms up and captures (``prefill_captures`` /
``chunk_captures``), later runs replay, and the tokens are copied out
before the key can run again.  ``torch.cuda.graph`` synchronises the
device and empties the allocator's cache when it is entered, so a
capture under traffic stalls every engine on the card: :meth:`warmup`
captures every key the given prompt lengths reach.  On the CPU the
same bodies run eagerly on the same buffers.

Device state rides the loop: EOS is detected on the device (``done``
mask), and the host learns of it only at ``done_poll_interval``
dispatch boundaries (``_poll_done``).  The interval is auto-tuned by
default (``done_poll_interval=None``), as in the JAX engine: the first
polls measure the pure cost of a poll (a second, empty-chain one) and
the wall a dispatch, and the shared
:class:`~paddle_tpu_torch.framework.dispatch.AutoFoldTuner` freezes the
smallest interval whose poll cost is at most
``PADDLE_TORCH_SERVING_POLL_TARGET`` of the dispatches it spans,
bounded by ``PADDLE_TORCH_SERVING_POLL_MAX``; an explicit interval
stays fixed.  Every dispatch copies the
emitted tokens out of the static buffer into a fresh ``[B]`` tensor,
which the requests see as
:class:`~paddle_tpu_torch.framework.lazy.LazyScalar` views of one
shared ``LazyStack``: one device→host copy per dispatch, and only if
somebody reads it.  The host loop itself never waits for the device
outside the poll, a request's finalize, and ``warmup``.

Chunked prefill (``prefill_chunk=``) admits a long prompt one chunk
per engine step against the context already in its pages; the
shared-prefix cache (``prefix_cache=``, ``prefix_cache.py``) maps full
prompt blocks to pool blocks that already hold their K/V, so a request
that hits runs only its suffix through the chunk path.

**Speculative decoding** (``draft=`` / ``draft_params=``, ``spec_k=``;
``spec_decode.py``): the captured step becomes one speculative window,
``k`` draft forwards at ``[B]`` rows and one verify at ``[B*(k+1)]``,
committing up to ``k+1`` tokens a lane; its two variants (greedy,
mixed) take the plain ones' place.  A window commits a count the host
does not know, so the lengths, the tokens committed (``gen``) and
``max_tokens`` live on the device and the step updates them in place;
the host stages only the page table, pushes ``k+1`` lazy views a lane
(:data:`~.spec_decode.SPEC_SENTINEL` past the accepted prefix) and
holds an upper bound of each length for page growth, brought back to
the truth at the poll.  Completion (EOS and ``max_tokens``) is detected
on the device.  ``network=`` takes the port's ``GPTForCausalLM``
through :func:`~.decode_model.extract_decode_params`.

The plain step is not a window of ``k = 0``, as in the JAX engine, whose
plain program stands beside ``_build_spec_step``.  It is the reference
the speculative engine's tokens are held against (``[serve spec]`` of
``chip_smoke.py``, ``tests/test_torch_serving_spec.py``).  Its host
knows every length and count exactly: it stages them with the page
table in one copy and ends a request at ``max_tokens`` itself, so a
greedy dispatch stages no sampling vectors
(``test_sampling_vectors_restage_only_when_they_change`` in
``tests/test_torch_serving_capture.py``) and its graph holds none of
the window's loop-state kernels (``gen``, the ``max_tokens`` stop, the
accept rule).

**Roles** (``role=``, :data:`ENGINE_ROLES`): ``"both"`` is the engine
above.  A ``"prefill"`` engine admits and prefills (grouped or
chunked), streams each request's first token and hands the rest of the
request out as a :class:`~.migration.PageMigration` (its pages gathered
in table order, its blocks exported): it never runs or captures the
decode step.  A ``"decode"`` engine takes requests only through
:meth:`DecodeEngine.submit_migration`: a locked inbox, drained FIFO on
its own thread into fresh blocks of its pool (written in place, so the
captured step reads them) and the static buffers, and never prefills.
``disagg.py`` routes between the two.

**Streams.**  On the card every engine issues its work on a CUDA stream
of its own (``stream``), whichever thread calls it, so two engines in
one process (a prefill and a decode replica) can overlap on the device;
the lazy tokens it hands out carry an event recorded after them
(``framework/lazy.py``), so any thread may read them.

**Observability.**  Each engine records into the process-wide registry
(``observability/metrics.py``) under the labels ``engine`` and
``phase`` (the role), with the JAX engine's metric names; every value
observed is a host number (no instrument reads the device), and the
decode dispatch, prefill, the poll and a migration's export and import
open spans of ``observability/trace.py``.  ``serving_intertoken_s``
observes the host's gap between dispatches, which is the host's enqueue
pace while the launch queue is not full, not the device's.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import resolve_device
from ...framework import env_knobs
from ...framework.dispatch import AutoFoldTuner, CapturedCall
from ...framework.lazy import LazyScalar, LazyStack
from ...io.bucketing import shape_bucket
from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from . import paged_attention_kernel as _pak
from .decode_model import (GPTDecodeWeights, ServingModelConfig,
                           chunk_prefill_forward, copy_decode_params_,
                           decode_forward, extract_decode_params,
                           prefill_group_forward)
from .kv_cache import SCRATCH_BLOCK, PagedKVCache, write_prompt_pages_group
from .migration import (MigrationError, PageMigration,
                        gather_request_pages, scatter_request_pages)
from .prefix_cache import PrefixCache
from .sampling import sample_tokens
from .scheduler import QueueFull, Request, Scheduler
from .spec_decode import SPEC_SENTINEL, spec_decode_step

#: phase roles: "both" prefills and decodes; "prefill" prefills and
#: hands each request out as a page migration; "decode" imports
#: migrations and decodes, and never prefills
ENGINE_ROLES = ("both", "prefill", "decode")

# synthetic Chrome-trace tracks for the request lifecycle spans: one
# lane per (engine, batch slot)
_REQ_LANE_BASE = 1 << 40
_engine_ids = itertools.count()

#: the kernel wrappers the decode step launches through; their host
#: counts advance once per replay by what the capture recorded
_COUNTED = (_pak.paged_ragged_attention, _pak._cuda_core_paged)


def _read_counts() -> Dict[object, int]:
    return {fn: fn.launches for fn in _COUNTED}


def _write_counts(counts: Dict[object, int]) -> None:
    for fn, n in counts.items():
        fn.launches = n


_LEDGER = (_read_counts, _write_counts)


class GenerationResult:
    """Resolved value of a request future."""

    __slots__ = ("request_id", "tokens", "stats")

    def __init__(self, request_id, tokens, stats):
        self.request_id = request_id
        self.tokens = tokens            # List[int], eos-truncated
        self.stats = stats              # RequestStats

    def __repr__(self):
        return (f"GenerationResult(id={self.request_id}, "
                f"tokens={self.tokens})")


class _PrefillJob:
    """Host bookkeeping for one chunk-prefilling request: how much of
    the prompt is in cache (prefix hits + completed chunks), the chain
    hash where prefix-cache insertion resumes, and the pool blocks
    this request computed itself (candidate cache entries)."""

    __slots__ = ("req", "slot", "chain", "done_tokens", "insert_from",
                 "computed_blocks")

    def __init__(self, req, slot, chain, done_tokens, insert_from):
        self.req = req
        self.slot = slot
        self.chain = chain
        self.done_tokens = int(done_tokens)
        self.insert_from = int(insert_from)
        self.computed_blocks: List[int] = []


def _pow2_buckets(max_n: int) -> List[int]:
    """1, 2, 4, … capped at ``max_n`` (prefill group sizes)."""
    out, b = [], 1
    while b < max_n:
        out.append(b)
        b *= 2
    out.append(max_n)
    return sorted(set(out))


def _default_buckets(block_size: int, max_context: int) -> List[int]:
    """Power-of-two block multiples up to the context limit, the top one
    floored to a block multiple."""
    top = (max_context // block_size) * block_size
    buckets, b = [], block_size
    while b < top:
        buckets.append(b)
        b *= 2
    if not buckets or buckets[-1] != top:
        buckets.append(top)
    return buckets


def _percentile(values, q):
    return float(np.percentile(values, q)) if values else None


def _shapes(params: GPTDecodeWeights):
    return [(n, tuple(p.shape)) for n, p in params.named_parameters()]


class _PrefillProgram:
    """One prefill shape key of an engine (an entry of the JAX engine's
    per-shape trace cache): the static device buffers of its inputs, one
    int32 buffer cut into ``fields`` (each ``(shape, kind, fill)``: kind
    ``"i"`` int32, ``"f"`` float32 bits, ``"u"`` uint32 bits; ``fill``
    the value a host image starts with), and of its ``n_out`` tokens.
    :meth:`run` stages an image in one copy and runs a body on the
    buffers: on the card the key's first run warms up on the graph's
    stream and captures, every later run replays; on the CPU the body
    runs eagerly.  Only the copy of the tokens it returns and the pool's
    pages outlive a run: replays of the engine's graphs share one
    pool."""

    def __init__(self, device: torch.device, graph_pool, capture_stream,
                 fields, n_out: int):
        self._fields = fields
        self._bounds = np.cumsum(
            [0] + [int(np.prod(shape)) for shape, _, _ in fields]).tolist()
        self._device = device
        self._graph_pool = graph_pool
        self._capture_stream = capture_stream
        self.inputs = torch.zeros(self._bounds[-1], dtype=torch.int32,
                                  device=device)
        self.out = torch.zeros(n_out, dtype=torch.int32, device=device)
        self.call: Optional[CapturedCall] = None

    def views(self, flat):
        """``flat`` (the device buffer, or a host image as numpy) cut
        into the key's inputs, each a view in its shape and dtype; a
        host image's are set to their fills."""
        on_device = isinstance(flat, torch.Tensor)
        out = []
        for i, (shape, kind, fill) in enumerate(self._fields):
            part = flat[self._bounds[i]:self._bounds[i + 1]]
            if kind == "f":
                part = part.view(torch.float32 if on_device else np.float32)
            elif kind == "u" and not on_device:
                part = part.view(np.uint32)
            part = part.reshape(shape)
            if not on_device:
                part[...] = fill
            out.append(part)
        return out

    def run(self, host: torch.Tensor, body) -> torch.Tensor:
        """Stage ``host`` (the int32 image of every input) and run
        ``body`` on the buffers, on the current stream; returns a copy
        of the tokens.  A capture that fails raises with its CUDA error,
        and the next run of the key captures again."""
        self.inputs.copy_(host, non_blocking=True)
        if self._device.type != "cuda":
            body()
        elif self.call is None:
            call = CapturedCall(self._device, self._graph_pool,
                                ledgers=[_LEDGER],
                                capture_error_mode="thread_local",
                                stream=self._capture_stream)
            call.warm_up(body)
            call.capture(body)
            self.call = call
        else:
            self.call.replay()
        return self.out.clone()

    @property
    def captures(self) -> int:
        return 0 if self.call is None else self.call.captures

    def close(self) -> None:
        if self.call is not None:
            self.call.close()
            self.call = None


class DecodeEngine:
    """Continuous-batching decode over a paged KV pool.

    Drive it directly (``submit`` + ``step`` / ``run_until_idle``) or
    through :class:`~paddle_tpu_torch.inference.serving.api.LLMServer`'s
    pump thread.  All methods except ``submit`` must be called from ONE
    thread; ``submit`` is safe from anywhere and never touches the
    device.

    ``network`` (the port's ``GPTForCausalLM``) or ``params`` (a
    :class:`GPTDecodeWeights` on ``device``, see
    ``decode_model.params_from_numpy``) with ``gpt_config``; the pool
    takes the weights' dtype.  ``device`` defaults to ``"cuda"`` and
    raises without a card.  ``draft`` (a network of the target's
    geometry) or ``draft_params`` turns on speculative decoding with
    ``spec_k`` proposals a window (default ``PADDLE_TORCH_SPEC_K``).
    ``prefill_chunk`` (a block multiple; default
    ``PADDLE_TORCH_PREFILL_CHUNK``, unset = off) admits prompts longer
    than it chunk by chunk, one chunk per engine step, and lifts the
    largest prefill bucket's cap on prompt length.  ``prefix_cache``
    (default ``PADDLE_TORCH_PREFIX_CACHE``) shares full prompt blocks
    between requests; ``prefix_reserve_discount`` (needs it) reserves
    each admission's worst case less its live cache hits.  ``role``
    (module docstring) is ``"both"``, ``"prefill"`` or ``"decode"``;
    ``submit_migration`` is thread-safe and host-only too.
    """

    def __init__(self, network=None, *, gpt_config=None,
                 params: Optional[GPTDecodeWeights] = None,
                 max_batch: int = 4, block_size: int = 16,
                 num_blocks: int = 128,
                 max_blocks_per_seq: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 done_poll_interval: Optional[int] = None,
                 max_queue: int = 64,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 role: str = "both",
                 prefix_reserve_discount: bool = False,
                 device=None,
                 draft=None, draft_params=None,
                 spec_k: Optional[int] = None):
        if role not in ENGINE_ROLES:
            raise ValueError(f"role {role!r} is not one of {ENGINE_ROLES}")
        self._device = resolve_device(device)
        if network is not None:
            params = extract_decode_params(network, device=self._device)
            gpt_config = network.config
        if params is None or gpt_config is None:
            raise ValueError("need network= or (params=, gpt_config=)")
        if params.wte.device != self._device:
            raise ValueError(
                f"params live on {params.wte.device}, engine device is "
                f"{self._device}; build them with params_from_numpy("
                "..., device=) for this device")
        self._cfg = (gpt_config
                     if isinstance(gpt_config, ServingModelConfig)
                     else ServingModelConfig.from_gpt_config(gpt_config))
        cfg = self._cfg
        self._params = params
        # -- speculative decoding: the draft shares the target's pool,
        # so it must have the target's serving geometry (a draft of
        # another geometry needs a weight pool of its own)
        if draft is not None and draft_params is None:
            dcfg = ServingModelConfig.from_gpt_config(draft.config)
            if dcfg != cfg:
                raise ValueError(
                    f"draft model geometry {dcfg} != target {cfg}: "
                    "speculative decoding shares the target's paged "
                    "pool, so the draft must match its serving geometry")
            draft_params = extract_decode_params(draft, device=self._device)
        if draft_params is not None:
            if role == "prefill":
                raise ValueError(
                    "draft= on a prefill-role engine: it never decodes, "
                    "so speculation cannot act; give the draft to the "
                    "decode replica")
            if _shapes(draft_params) != _shapes(params):
                raise ValueError(
                    "draft_params shapes do not match the target's "
                    "serving params: speculative decoding requires the "
                    "same pool/model geometry")
            if draft_params.wte.dtype != params.wte.dtype or \
                    draft_params.wte.device != self._device:
                raise ValueError(
                    f"draft_params are {draft_params.wte.dtype} on "
                    f"{draft_params.wte.device}; the target's are "
                    f"{params.wte.dtype} on {self._device}")
            if spec_k is None:
                spec_k = env_knobs.get_int("PADDLE_TORCH_SPEC_K", 4)
            if int(spec_k) < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            self.spec_k = int(spec_k)
        else:
            if spec_k is not None:
                raise ValueError(
                    "spec_k= without draft=/draft_params=: speculation "
                    "needs a proposal model")
            self.spec_k = 0
        self._draft_params = draft_params
        self.role = role
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        # None: the poll cadence is auto-tuned (``_timed_poll``), from 8
        self._poll_auto = done_poll_interval is None
        self.done_poll_interval = (8 if self._poll_auto
                                   else max(1, int(done_poll_interval)))
        self._poll_tuner = (AutoFoldTuner(
            target=env_knobs.get_float("PADDLE_TORCH_SERVING_POLL_TARGET",
                                       0.05),
            max_fold=env_knobs.get_int("PADDLE_TORCH_SERVING_POLL_MAX", 64),
            calib_groups=env_knobs.get_int("PADDLE_TORCH_SERVING_POLL_CALIB",
                                           3))
            if self._poll_auto else None)
        self._poll_decision: Optional[Dict[str, object]] = None
        self._last_poll_end: Optional[float] = None
        self._last_poll_dispatches = 0
        if max_blocks_per_seq is None:
            max_blocks_per_seq = -(-cfg.max_position // block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_context = min(cfg.max_position,
                               self.max_blocks_per_seq * block_size)
        self._kv = PagedKVCache(cfg.num_layers, num_blocks, block_size,
                                cfg.num_heads, cfg.head_dim,
                                dtype=params.wte.dtype,
                                device=self._device)
        # a prefill-role engine holds prompt blocks only: the decode
        # growth is the importing engine's to reserve
        door_need = ((lambda req: -(-len(req.prompt) // block_size))
                     if role == "prefill" else None)
        self.scheduler = Scheduler(self._kv.allocator, block_size,
                                   max_queue=max_queue,
                                   max_context=self.max_context,
                                   door_need_fn=door_need,
                                   lookahead=self.spec_k)
        if prefill_buckets is None:
            prefill_buckets = _default_buckets(block_size,
                                               self.max_context)
        for b in prefill_buckets:
            if b % block_size:
                raise ValueError(
                    f"prefill bucket {b} is not a multiple of "
                    f"block_size {block_size}")
        self._buckets = sorted(int(b) for b in prefill_buckets)
        self._group_buckets = _pow2_buckets(self.max_batch)
        # -- chunked prefill and the shared-prefix cache --
        if prefill_chunk is None:
            env_chunk = env_knobs.get_raw("PADDLE_TORCH_PREFILL_CHUNK", "")
            prefill_chunk = int(env_chunk) if env_chunk.strip() else None
        if prefill_chunk is not None and prefill_chunk <= 0:
            prefill_chunk = None
        if prefill_chunk is not None:
            if prefill_chunk % block_size:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} is not a multiple "
                    f"of block_size {block_size}")
            prefill_chunk = min(int(prefill_chunk), self._buckets[-1])
        self.prefill_chunk = prefill_chunk
        # the chunk path's shape buckets, as the JAX engine's: the chunk
        # (any residue length; the prefix-hit suffix uses them with
        # chunking off too) and the context extent it gathers (powers of
        # two in blocks)
        self._chunk_buckets = _default_buckets(
            block_size, self.prefill_chunk or self._buckets[-1])
        self._ctx_buckets = _pow2_buckets(self.max_blocks_per_seq)
        if prefix_cache is None:
            prefix_cache = env_knobs.get_bool("PADDLE_TORCH_PREFIX_CACHE")
        if prefix_reserve_discount and not prefix_cache:
            raise ValueError(
                "prefix_reserve_discount=True requires "
                "prefix_cache=True: there is nothing to discount "
                "against without the shared-prefix cache")
        self._reserve_discount = bool(prefix_reserve_discount)
        self._prefix = (PrefixCache(self._kv.allocator, block_size,
                                    pin_referenced=self._reserve_discount)
                        if prefix_cache else None)
        self._prefill_jobs: deque = deque()
        self._chunks = 0
        # page migration: tickets staged out (prefill role; the server's
        # pump hands them on) and the locked inbox of tickets to import
        # (drained on this engine's thread as slots and reservations
        # free up), with the inbox's reservation estimate
        self._ready_migrations: deque = deque()
        self._migration_inbox: deque = deque()
        self._mig_lock = threading.Lock()
        self._inbox_need = 0
        self._slots: List[Optional[Request]] = [None] * self.max_batch
        # host-side batch state (authoritative), held in the two int32
        # buffers it is staged from: the layout (page table, lengths),
        # copied before every dispatch, and the sampling vectors
        # (temperature and top-p as float32 bits, seeds as uint32 bits,
        # max_tokens, which only the speculative step reads), copied
        # only when a seat or finalize changed them
        B, M = self.max_batch, self.max_blocks_per_seq
        self._layout_host = np.zeros(B * M + B, dtype=np.int32)
        self._tables = self._layout_host[:B * M].reshape(B, M)
        self._tables[:] = SCRATCH_BLOCK
        # speculative: an upper bound of the device lengths (page growth
        # only), brought back to the truth at each poll
        self._lengths = self._layout_host[B * M:]
        self._samp_host = np.zeros(5 * B, dtype=np.int32)
        self._temps = self._samp_host[:B].view(np.float32)
        self._topks = self._samp_host[B:2 * B]
        self._topps = self._samp_host[2 * B:3 * B].view(np.float32)
        self._topps[:] = 1.0
        self._seeds = self._samp_host[3 * B:4 * B].view(np.uint32)
        self._maxt = self._samp_host[4 * B:]
        self._samp_stale = True
        # the decode step's static device buffers: the graph bakes in
        # their addresses, so they are written in place, never replaced
        dev = self._device
        self._layout_dev = torch.zeros(B * M + B, dtype=torch.int32,
                                       device=dev)
        self._table_dev = self._layout_dev[:B * M].view(B, M)
        self._lengths_dev = self._layout_dev[B * M:]
        self._samp_dev = torch.zeros(5 * B, dtype=torch.int32,
                                     device=dev)
        self._temps_dev = self._samp_dev[:B].view(torch.float32)
        self._topks_dev = self._samp_dev[B:2 * B]
        self._topps_dev = self._samp_dev[2 * B:3 * B].view(torch.float32)
        self._seeds_dev = self._samp_dev[3 * B:4 * B]
        self._maxt_dev = self._samp_dev[4 * B:]
        self._tokens = torch.zeros(B, dtype=torch.int32, device=dev)
        self._done = torch.zeros(B, dtype=torch.bool, device=dev)
        if self.spec_k:
            # a window commits a count the host does not know: lengths
            # and tokens committed (gen) ride the loop on the device,
            # next to the [B, k+1] window the step emits into
            self._spec_state = torch.zeros(2 * B, dtype=torch.int32,
                                           device=dev)
            self._lengths_dev = self._spec_state[:B]
            self._gen = self._spec_state[B:]
            self._emit = torch.zeros(B, self.spec_k + 1, dtype=torch.int32,
                                     device=dev)
        # host view of gen: an upper bound (+k+1 a dispatch) gating the
        # poll without an EOS id, and the count credited at the last poll
        self._gen_ub = np.zeros(B, dtype=np.int64)
        self._gen_seen = np.zeros(B, dtype=np.int64)
        self._spec_dispatches = 0
        self._spec_lanes = 0               # active lanes summed over them
        self._spec_emitted = 0             # tokens they committed (polled)
        self._spec_last_poll_lanes = 0
        self._spec_accept: Optional[float] = None
        # one captured step per variant (False: greedy-only, True:
        # mixed) and the prefill programs, sharing one graph pool and one
        # capture stream (so each graph reuses the blocks the others
        # freed); CUDA only
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        self._capture_stream = (torch.cuda.Stream(dev)
                                if dev.type == "cuda" else None)
        # the engine's own stream; it starts after the buffers above
        self.stream = None
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)
            self.stream.wait_stream(torch.cuda.current_stream(dev))
        self._steps: Dict[bool, CapturedCall] = {}
        # prefill programs: (group bucket, prompt bucket) and (chunk
        # bucket, context-extent bucket) keys
        self._prefill_progs: Dict[tuple, _PrefillProgram] = {}
        self._chunk_progs: Dict[tuple, _PrefillProgram] = {}
        self._total_tokens = 0
        self._latency: List[float] = []
        self._ttft: List[float] = []
        self._intertoken: List[float] = []
        self._dispatch_host: List[float] = []
        self._last_dispatch_t: Optional[float] = None
        self._init_observability()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def _dispatches(self) -> int:
        """Decode dispatches so far: the registry counter, added to
        with host ints only, so this read is exact and host-only."""
        return int(self._c_dispatches.collect(materialize=False))

    def _on_stream(self):
        """The engine's stream as the current one (CUDA), whatever
        thread calls."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _record(self):
        """An event recorded on this engine's stream now (None on the
        CPU)."""
        if self.stream is None:
            return None
        ready = torch.cuda.Event()
        ready.record(self.stream)
        return ready

    def _lazy(self, dev: torch.Tensor) -> LazyStack:
        """A lazy stack of a tensor just written on this engine's
        stream; on the card with an event after the write, so a read
        from any thread waits for that and no more."""
        return LazyStack(dev, ready=self._record())

    def _init_observability(self):
        """This engine's children of the process-wide registry, named
        and labelled as the JAX engine's (``engine``, ``phase``): host
        counters and fixed-bucket histograms on the hot path, gauges
        computed at scrape time through a weak reference (a dead engine
        scrapes as absent).  Children outlive the engine, as in any
        Prometheus client; :meth:`unregister_metrics` reclaims them."""
        ordinal = next(_engine_ids)
        self._obs_id = f"e{ordinal}"
        self._obs_lane_base = _REQ_LANE_BASE + (ordinal << 16)
        self._obs_labels = {"engine": self._obs_id, "phase": self.role}
        labels = self._obs_labels
        reg = _obs_metrics.registry()
        self._c_dispatches = reg.counter(
            "serving_dispatches_total", "batched decode dispatches",
            labels=labels)
        self._c_tokens = reg.counter(
            "serving_tokens_total", "generated tokens (eos-truncated)",
            labels=labels)
        self._c_requests = reg.counter(
            "serving_requests_completed_total", "finalized requests",
            labels=labels)
        self._h_latency = reg.histogram(
            "serving_latency_s", "request submit→finish latency",
            labels=labels)
        self._h_ttft = reg.histogram(
            "serving_ttft_s", "request submit→first-token latency",
            labels=labels)
        self._h_queue_time = reg.histogram(
            "serving_queue_time_s", "request submit→admission wait",
            labels=labels)
        self._c_prefix_hits = reg.counter(
            "serving_prefix_cache_hits_total",
            "prompt blocks reused from the shared-prefix cache",
            labels=labels)
        self._c_prefix_misses = reg.counter(
            "serving_prefix_cache_misses_total",
            "share-eligible prompt blocks prefilled fresh", labels=labels)
        self._c_prefix_evictions = reg.counter(
            "serving_prefix_cache_evictions_total",
            "idle prefix entries reclaimed under pool pressure",
            labels=labels)
        self._h_chunk = reg.histogram(
            "serving_prefill_chunk_s",
            "per-chunk prefill dispatch wall time", labels=labels)
        # migrations count on the IMPORTING engine, when seated
        self._c_migrations = reg.counter(
            "serving_page_migrations_total",
            "migrated requests imported into this engine's batch",
            labels=labels)
        self._c_migrated_blocks = reg.counter(
            "serving_migrated_blocks_total",
            "KV pool blocks imported via page migration", labels=labels)
        self._h_migration = reg.histogram(
            "serving_migration_s",
            "prefill-complete to decode-seated handoff wall time",
            labels=labels)
        # the decode pool's scaling signal: the host's gap between
        # dispatches of a non-empty batch (the enqueue pace, module
        # docstring)
        self._h_intertoken = reg.histogram(
            "serving_intertoken_s",
            "gap between consecutive decode dispatches of a non-empty "
            "batch", labels=labels)
        self._c_spec_dispatches = reg.counter(
            "serving_spec_dispatches_total",
            "speculative decode dispatches (k+1-token windows)",
            labels=labels)
        self._h_spec_tpd = reg.histogram(
            "serving_spec_tokens_per_dispatch",
            "committed tokens per active lane per speculative dispatch "
            "(poll-window mean)", labels=labels,
            edges=(0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
        wr = weakref.ref(self)

        def _gauge_fn(getter):
            def fn():
                eng = wr()
                return None if eng is None else getter(eng)
            return fn

        for name, help_, getter in (
                ("serving_queue_depth", "waiting requests",
                 lambda e: e.scheduler.queue_depth),
                ("serving_active", "requests in the running batch",
                 lambda e: e.active_count),
                ("serving_kv_fragmentation",
                 "KV block-pool fragmentation [0,1]",
                 lambda e: e._kv.allocator.stats()["fragmentation"]),
                ("serving_done_poll_interval",
                 "dispatches between EOS polls",
                 lambda e: e.done_poll_interval),
                # absent (None) while the cache or speculation is off
                ("serving_prefix_blocks",
                 "pool blocks owned by the shared-prefix cache",
                 lambda e: None if e._prefix is None
                 else e._prefix.cached_blocks),
                ("serving_prefix_refs",
                 "live request references onto shared prefix blocks",
                 lambda e: None if e._prefix is None
                 else e._prefix.live_refs),
                ("serving_spec_accept_rate",
                 "draft-token acceptance rate [0,1] implied by the "
                 "cumulative committed tokens per lane-dispatch",
                 lambda e: e._spec_accept if e.spec_k else None)):
            reg.gauge(name, help_, labels=labels).set_function(
                _gauge_fn(getter))
        self._obs_metric_names = (
            "serving_dispatches_total", "serving_tokens_total",
            "serving_requests_completed_total", "serving_latency_s",
            "serving_ttft_s", "serving_queue_time_s",
            "serving_prefix_cache_hits_total",
            "serving_prefix_cache_misses_total",
            "serving_prefix_cache_evictions_total",
            "serving_prefill_chunk_s", "serving_page_migrations_total",
            "serving_migrated_blocks_total", "serving_migration_s",
            "serving_intertoken_s", "serving_spec_dispatches_total",
            "serving_spec_tokens_per_dispatch", "serving_queue_depth",
            "serving_active", "serving_kv_fragmentation",
            "serving_done_poll_interval", "serving_prefix_blocks",
            "serving_prefix_refs", "serving_spec_accept_rate")

    def unregister_metrics(self):
        """Reclaim this engine's children from the process-wide
        registry (for callers that build many short-lived engines)."""
        reg = _obs_metrics.registry()
        for name in self._obs_metric_names:
            reg.unregister(name, labels=self._obs_labels)

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → device tensor without waiting for the device
        (a private copy, so later host edits cannot reach it)."""
        return torch.from_numpy(np.array(arr)).to(self._device,
                                                  non_blocking=True)

    # -- front door ----------------------------------------------------------
    def submit(self, prompt_ids, max_tokens: int, stream_cb=None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None) -> Request:
        """Enqueue a generation request (thread-safe, host only).
        Returns the :class:`Request`; its ``future`` resolves to a
        :class:`GenerationResult`.  Raises
        :class:`~.scheduler.QueueFull` at queue capacity and
        ``ValueError`` for requests the pool geometry can never run."""
        if self.role == "decode":
            raise ValueError(
                "decode-role engine admits only migrated requests "
                "(submit_migration); route prompts to a prefill replica")
        req = Request(prompt_ids, max_tokens, stream_cb=stream_cb,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        if self.prefill_chunk is None and \
                len(req.prompt) > self._buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the largest "
                f"prefill bucket {self._buckets[-1]}; enable chunked "
                "prefill (prefill_chunk=) for longer prompts")
        return self.scheduler.submit(req)

    def submit_migration(self, mig: PageMigration) -> None:
        """Enqueue a migrated request for import (thread-safe, host
        only; roles "decode" and "both").  Refuses what this engine can
        never or cannot now honour: :class:`MigrationError` for a
        consumed ticket or another pool geometry, ``ValueError`` for a
        request whose worst case exceeds this pool or context,
        :class:`QueueFull` when slots or reservations are taken (the
        router's signal to try the next replica).  The estimates here
        race with this engine's thread by design: an accepted ticket
        waits in the inbox until a reservation is taken, so it cannot
        run the pool dry."""
        if self.role == "prefill":
            raise MigrationError("prefill-role engine cannot import "
                                 "migrations: it never decodes")
        if mig.consumed:
            raise MigrationError(
                f"migration of request {mig.request.id} already "
                "imported; tickets are single-use")
        mig.check_geometry(self)
        req = mig.request
        need = req.worst_case_blocks(self.block_size, self.spec_k)
        if need > self._kv.allocator.capacity:
            raise ValueError(
                f"migrated request needs {need} blocks worst-case but "
                f"this pool only has {self._kv.allocator.capacity}")
        if len(req.prompt) + req.max_tokens - 1 > self.max_context:
            raise ValueError("migrated prompt+max_tokens exceeds max "
                             f"context {self.max_context}")
        with self._mig_lock:
            if (self.active_count + len(self._migration_inbox)
                    >= self.max_batch):
                raise QueueFull("decode replica batch full (active + "
                                "pending migrations at max_batch)")
            if not self._kv.allocator.can_reserve(need + self._inbox_need):
                raise QueueFull("decode replica cannot reserve the "
                                "migrated request's worst-case blocks")
            self._migration_inbox.append(mig)
            self._inbox_need += need

    @property
    def pending_migrations(self) -> int:
        """Migrations accepted but not imported yet."""
        with self._mig_lock:
            return len(self._migration_inbox)

    def pop_ready_migrations(self) -> List[PageMigration]:
        """Take the tickets a prefill-role step staged out (this
        engine's thread; the server hands them to its handoff hook)."""
        out = list(self._ready_migrations)
        self._ready_migrations.clear()
        return out

    def drain_all_migrations(self) -> List[PageMigration]:
        """Remove every migration in flight, inbound and staged out
        (teardown: their futures must not be stranded)."""
        with self._mig_lock:
            out = list(self._migration_inbox)
            self._migration_inbox.clear()
            self._inbox_need = 0
        out.extend(self._ready_migrations)
        self._ready_migrations.clear()
        return out

    # -- engine loop ---------------------------------------------------------
    def step(self) -> bool:
        """One engine step, by role.  "both": admit waiting requests,
        advance at most ONE prefill chunk, import waiting migrations,
        then run ONE batched decode dispatch.  "prefill": admission and
        prefill only; finished prompts stage out as migrations.
        "decode": import waiting migrations, then the decode dispatch.
        Returns True while there is (or may be) work."""
        with torch.no_grad(), self._on_stream():
            return self._step()

    def _step(self) -> bool:
        if self.role == "decode":
            self._drain_migration_inbox()
        else:
            self._admit()
            self._advance_prefill()
            if self.role == "both":
                self._drain_migration_inbox()
        if self.role == "prefill":
            return (self.scheduler.queue_depth > 0
                    or bool(self._prefill_jobs))
        active = [s for s, r in enumerate(self._slots)
                  if r is not None and not r.prefilling]
        if not active:
            self._last_dispatch_t = None
            return (self.scheduler.queue_depth > 0
                    or bool(self._prefill_jobs)
                    or self.pending_migrations > 0)
        t0 = time.perf_counter()
        self._grow_pages(active)
        with _obs_trace.span(
                "serving.dispatch",
                args=({"active": len(active)} if _obs_trace.enabled()
                      else None)):
            emit = self._decode_dispatch()
        self._c_dispatches.inc()
        stack = self._lazy(emit)       # ONE shared fetch, if read
        now = time.monotonic()
        if self._last_dispatch_t is not None:
            gap = now - self._last_dispatch_t
            self._intertoken.append(gap)
            self._h_intertoken.observe(gap)
        self._last_dispatch_t = now
        if self.spec_k:
            self._push_window(active, stack, now)
            self._dispatch_host.append(time.perf_counter() - t0)
            # without an EOS id, max_tokens is the only way a lane ends,
            # and the upper bound of gen says when one may have: the
            # poll (a sync) fires then, never earlier
            if self.eos_id is None:
                if any(self._gen_ub[s] >= self._slots[s].max_tokens
                       for s in active):
                    self._timed_poll()
            elif self._dispatches % self.done_poll_interval == 0:
                self._timed_poll()
            return True
        to_finish = []
        for s in active:
            req = self._slots[s]
            req.push_token(LazyScalar(stack, post=(lambda a, i=s: a[i])),
                           now)
            if not req.capped:
                self._lengths[s] += 1
            if len(req.lazy_tokens) >= req.max_tokens:
                to_finish.append(s)
        self._dispatch_host.append(time.perf_counter() - t0)
        for s in to_finish:
            self._finalize(s)
        if self.eos_id is not None and \
                self._dispatches % self.done_poll_interval == 0:
            self._timed_poll()
        return True

    def _push_window(self, active: List[int], stack: LazyStack, now: float):
        """A speculative dispatch's host side: ``k+1`` lazy views a lane
        (sentinels past the accepted prefix, stripped at finalize), and
        the length and gen upper bounds advanced by the window's most.
        Completion is the device's to detect, so nothing finishes
        here."""
        w = self.spec_k + 1
        self._spec_dispatches += 1
        self._c_spec_dispatches.inc()
        self._spec_lanes += len(active)
        for s in active:
            req = self._slots[s]
            for j in range(w):
                req.push_token(LazyScalar(
                    stack, post=(lambda a, i=s, jj=j: a[i, jj])), now)
            self._gen_ub[s] += w
            if not req.capped:
                self._lengths[s] += w

    def _decode_dispatch(self, mixed: Optional[bool] = None
                         ) -> torch.Tensor:
        """THE decode dispatch: stage the host state into the static
        buffers, run the step (a replay on the card) and return a copy
        of the emitted tokens (``[B]``; speculative ``[B, k+1]``), all
        enqueued without waiting for the device.  ``mixed`` picks the
        variant (default: whether any slot samples).  Speculative: the
        lengths live on the device, so only the page table is staged,
        and the sampling vectors carry ``max_tokens`` for both
        variants."""
        if self.spec_k:
            self._table_dev.copy_(torch.from_numpy(self._tables),
                                  non_blocking=True)
        else:
            self._layout_dev.copy_(torch.from_numpy(self._layout_host),
                                   non_blocking=True)
        if mixed is None:
            mixed = bool((self._temps > 0.0).any())
        if (mixed or self.spec_k) and self._samp_stale:
            self._samp_dev.copy_(torch.from_numpy(self._samp_host),
                                 non_blocking=True)
            self._samp_stale = False
        self._run_step(mixed)
        # the next replay overwrites the static output: the LazyStack
        # takes a copy
        return (self._emit if self.spec_k else self._tokens).clone()

    def _run_step(self, mixed: bool):
        if self._device.type != "cuda":
            self._decode_body(mixed)
            return
        step = self._steps.get(mixed)
        if step is not None:
            step.replay()
            return
        # first dispatch of this variant: it runs eagerly on the
        # graph's stream, then the step is captured for the next ones
        step = CapturedCall(self._device, self._graph_pool,
                            ledgers=[_LEDGER],
                            capture_error_mode="thread_local",
                            stream=self._capture_stream)
        # the warm-up also makes K1's split workspaces on the graph's
        # stream: one for [B] rows, and for the verify's [B*(k+1)]
        step.warm_up(lambda: self._decode_body(mixed))
        step.capture(lambda: self._decode_body(mixed))
        self._steps[mixed] = step

    def _decode_body(self, mixed: bool) -> None:
        """The decode step on the static buffers: reads the staged
        layout and sampling vectors and the loop state, appends one
        token's K/V per active slot to the pool, and writes the emitted
        tokens and the done mask in place.  The graph's body on the
        card."""
        if self.spec_k:
            self._spec_body(mixed)
            return
        lengths = self._lengths_dev
        active = (lengths > 0) & torch.logical_not(self._done)
        logits = decode_forward(self._params, self._cfg, self._kv.pool,
                                self._table_dev, lengths, self._tokens,
                                active)
        if mixed:
            # the sampled token's sequence index is lengths + 1: a pure
            # function of the request, never of slot or batch
            nxt = sample_tokens(logits, self._temps_dev, self._topks_dev,
                                self._topps_dev, self._seeds_dev,
                                lengths + 1)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if self.eos_id is not None:
            self._done.logical_or_(active & (nxt == int(self.eos_id)))
        self._tokens.copy_(torch.where(active, nxt, self.pad_id))

    def _spec_body(self, mixed: bool) -> None:
        """The speculative step on the static buffers: one window
        (:func:`~.spec_decode.spec_decode_step`), then the device-resident
        loop state updated in place: lengths and gen advance by the
        tokens committed, a lane is done at an EOS among them or at
        ``gen >= max_tokens``, the last token feeds back, and the window
        lands in the static ``[B, k+1]`` emit buffer."""
        k = self.spec_k
        lengths, gen, done = self._lengths_dev, self._gen, self._done
        active = (lengths > 0) & torch.logical_not(done)
        emit, last, n_emit = spec_decode_step(
            self._params, self._draft_params, self._cfg, k, self._kv.pool,
            self._table_dev, lengths, self._tokens, active,
            self._temps_dev, self._topks_dev, self._topps_dev,
            self._seeds_dev, greedy=not mixed)
        lengths.add_(n_emit)               # n_emit is 0 on inactive rows
        gen.add_(n_emit)
        if self.eos_id is not None:
            offs = torch.arange(k + 1, dtype=torch.int32,
                                device=lengths.device)
            hit = (offs[None] < n_emit[:, None]) & (emit == int(self.eos_id))
            done.logical_or_(active & hit.any(dim=1))
        done.logical_or_(active & (gen >= self._maxt_dev))
        self._tokens.copy_(last)
        self._emit.copy_(emit)

    def run_until_idle(self, max_dispatches: int = 100_000):
        """Pump :meth:`step` until queue and batch drain."""
        n = 0
        while self.step():
            n += 1
            if n > max_dispatches:
                raise RuntimeError(
                    f"run_until_idle: still busy after {n} dispatches")
        return n

    # -- admission / prefill -------------------------------------------------
    def _alloc_blocks(self, n: int) -> List[int]:
        """Pool draw with prefix-cache pressure relief: idle cached
        entries are the only occupancy beyond the reservation envelope,
        so evicting them (LRU, leaf-first) keeps reservation-gated
        admission's no-OOM guarantee."""
        self._evict_for(n)
        return self._kv.allocator.allocate(n)

    def _evict_for(self, n: int):
        """Evict idle prefix-cache entries until ``n`` blocks are free,
        counting the evictions."""
        if self._prefix is not None:
            ev0 = self._prefix.evictions
            self._prefix.ensure_free(n)
            if self._prefix.evictions - ev0:
                self._c_prefix_evictions.inc(self._prefix.evictions - ev0)

    def _set_sampling(self, slot: int, req: Request):
        self._temps[slot] = req.temperature
        self._topks[slot] = req.top_k
        self._topps[slot] = req.top_p
        self._seeds[slot] = np.uint32(req.seed & 0xFFFFFFFF)
        self._maxt[slot] = req.max_tokens
        self._samp_stale = True

    def _cache_insert(self, req: Request, start: int, chain: bytes,
                      blocks: List[int]):
        """Register a prefilled prompt's share-eligible blocks with the
        prefix cache (ownership moves to the cache; the request keeps a
        reference on each new entry and keeps hash-collision duplicates
        as its own)."""
        n_share = self._prefix.shareable_blocks(req.prompt)
        n_insert = max(0, n_share - start)
        if not n_insert:
            return
        entries, _ = self._prefix.insert(req.prompt, start, chain,
                                         blocks[:n_insert])
        req.prefix_entries = req.prefix_entries + entries
        inserted = {e.block for e in entries}
        req.blocks = [b for b in req.blocks if b not in inserted]
        if self._reserve_discount and entries:
            # cache-owned and pinned now: keeping them reserved too
            # would count them twice in the envelope
            self.scheduler.release_partial(req, len(entries))

    def _admission_need(self, req: Request) -> int:
        """Blocks to reserve for one admission: the worst case (a
        prefill-role engine: the prompt's blocks only, the decode growth
        is the importer's), less the live prefix-cache hit depth under
        discounted admission (the match is taken HERE, references and
        pins included, so the discount is against entries that can no
        longer be evicted)."""
        base = (-(-len(req.prompt) // self.block_size)
                if self.role == "prefill"
                else req.worst_case_blocks(self.block_size, self.spec_k))
        if not self._reserve_discount:
            return base
        entries, chain = self._prefix.match(req.prompt, count=False)
        req.pre_matched = (entries, chain)
        return max(0, base - len(entries))

    def _admission_cancel(self, req: Request):
        """A refused discounted admission: the request stays queued, so
        the match's references (and pins) drop until the next try."""
        if req.pre_matched is not None:
            self._prefix.release(req.pre_matched[0])
            req.pre_matched = None

    def _admit(self):
        """Admit waiting requests.  The prefix-cache lookup picks each
        one's prefill path: a request continuing from cached context,
        or longer than ``prefill_chunk``, goes through the chunk path;
        the rest prefill in same-bucket groups."""
        free = [s for s, r in enumerate(self._slots) if r is None]
        if not free:
            return
        grouped = []
        for req in self.scheduler.pop_admissible(
                len(free), need_fn=self._admission_need,
                cancel_fn=self._admission_cancel):
            slot = free.pop(0)
            req.slot = slot
            self._slots[slot] = req
            entries, chain = [], b""
            if self._prefix is not None:
                n_share = self._prefix.shareable_blocks(req.prompt)
                if req.pre_matched is not None:
                    entries, chain = req.pre_matched
                    req.pre_matched = None
                    self._prefix.count_match(len(entries),
                                             n_share - len(entries))
                else:
                    entries, chain = self._prefix.match(req.prompt)
                if entries:
                    self._c_prefix_hits.inc(len(entries))
                if n_share - len(entries):
                    self._c_prefix_misses.inc(n_share - len(entries))
            long_prompt = (self.prefill_chunk is not None
                           and len(req.prompt) > self.prefill_chunk)
            if entries or long_prompt:
                self._start_chunked(slot, req, entries, chain)
            else:
                grouped.append((slot, req))
        self._prefill_grouped(grouped)

    def _prefill_grouped(self, seated: List):
        """Batched same-bucket prefill: ONE run of the (group bucket,
        prompt bucket) program per group (group size padded to a power
        of two), the forward and the grouped page write in one graph,
        then per-request seating."""
        by_bucket: Dict[int, List] = {}
        for slot, req in seated:
            b = shape_bucket(len(req.prompt), self._buckets)
            by_bucket.setdefault(b, []).append((slot, req))
        for bucket, members in sorted(by_bucket.items()):
            Gb = shape_bucket(len(members), self._group_buckets)
            prog = self._group_program(Gb, bucket)
            host, image = self._host_image(prog)
            ids, lengths, temps, topks, topps, seeds, blocks = \
                prog.views(image)
            per_req_blocks = []
            for g, (slot, req) in enumerate(members):
                Lp = len(req.prompt)
                ids[g, :Lp] = req.prompt
                lengths[g] = Lp
                temps[g] = req.temperature
                topks[g] = req.top_k
                topps[g] = req.top_p
                seeds[g] = np.uint32(req.seed & 0xFFFFFFFF)
                nb = self._kv.blocks_for_tokens(Lp)
                per_req_blocks.append(self._alloc_blocks(nb))
                blocks[g, :nb] = per_req_blocks[-1]
            with _obs_trace.span(
                    "serving.prefill",
                    args=({"bucket": bucket, "group": len(members)}
                          if _obs_trace.enabled() else None)):
                toks = prog.run(host, lambda: self._group_body(prog))
            # the pages are written (on this stream, before anything the
            # host stages next): only now may the page table name them
            stack = self._lazy(toks)
            now = time.monotonic()
            for g, (slot, req) in enumerate(members):
                self._seat(slot, req, per_req_blocks[g], toks[g],
                           LazyScalar(stack, post=(lambda a, i=g: a[i])),
                           now)

    # -- prefill programs ----------------------------------------------------
    def _host_image(self, prog: _PrefillProgram):
        """A zeroed int32 host image of ``prog``'s inputs and its numpy
        view: pinned on the card (PyTorch's caching host allocator
        keeps the block until the copy from it has run), plain on the
        CPU."""
        host = torch.zeros(prog.inputs.numel(), dtype=torch.int32,
                           pin_memory=self._device.type == "cuda")
        return host, host.numpy()

    def _group_program(self, Gb: int, b: int) -> _PrefillProgram:
        """The (group bucket, prompt bucket) program: ids ``[Gb, b]``,
        lengths, temperatures, top-k, top-p and seeds ``[Gb]``, the
        pages ``[Gb, b / block_size]``; the first tokens ``[Gb]``."""
        prog = self._prefill_progs.get((Gb, b))
        if prog is None:
            g = (Gb,)
            prog = _PrefillProgram(
                self._device, self._graph_pool, self._capture_stream,
                (((Gb, b), "i", 0), (g, "i", 0), (g, "f", 0.0), (g, "i", 0),
                 (g, "f", 1.0), (g, "u", 0),
                 ((Gb, b // self.block_size), "i", SCRATCH_BLOCK)), Gb)
            self._prefill_progs[(Gb, b)] = prog
        return prog

    def _group_body(self, prog: _PrefillProgram) -> None:
        """A group program's body on its static buffers: the grouped
        forward, its pages written into the pool in place, the first
        tokens into ``prog.out``."""
        ids, lengths, temps, topks, topps, seeds, blocks = \
            prog.views(prog.inputs)
        kv, first, _ = prefill_group_forward(
            self._params, self._cfg, ids, lengths, temps, topks, topps,
            seeds)
        write_prompt_pages_group(self._kv.pool, kv, blocks)
        prog.out.copy_(first)

    def _chunk_program(self, Cb: int, nbc: int) -> _PrefillProgram:
        """The (chunk bucket, context-extent bucket) program: the
        context's page-table row ``[1, nbc]``, its length, the chunk's
        ids ``[1, Cb]``, its length and pages ``[Cb / block_size]``, the
        four sampling values; the token."""
        prog = self._chunk_progs.get((Cb, nbc))
        if prog is None:
            one = (1,)
            prog = _PrefillProgram(
                self._device, self._graph_pool, self._capture_stream,
                (((1, nbc), "i", SCRATCH_BLOCK), (one, "i", 0),
                 ((1, Cb), "i", 0), (one, "i", 0),
                 ((Cb // self.block_size,), "i", SCRATCH_BLOCK),
                 (one, "f", 0.0), (one, "i", 0), (one, "f", 1.0),
                 (one, "u", 0)), 1)
            self._chunk_progs[(Cb, nbc)] = prog
        return prog

    def _chunk_body(self, prog: _PrefillProgram) -> None:
        """A chunk program's body on its static buffers: the context
        gather, the attention, the chunk's pages written in place, the
        token into ``prog.out``."""
        tok, _ = chunk_prefill_forward(self._params, self._cfg,
                                       self._kv.pool,
                                       *prog.views(prog.inputs))
        prog.out.copy_(tok.reshape(1))

    def _chunk_keys(self, n: int, start: int) -> List[tuple]:
        """The chunk programs a prompt of ``n`` tokens runs from
        ``start`` cached tokens on (:meth:`_advance_prefill`'s rule)."""
        keys, done, bs = [], start, self.block_size
        while done < n:
            take = min(n - done, self.prefill_chunk or n - done)
            keys.append((shape_bucket(take, self._chunk_buckets),
                         shape_bucket(max(1, done // bs), self._ctx_buckets)))
            done += take
        return keys

    def _join(self, slot: int, tok_dev, length: int):
        """Join a seated request into the device loop state (its first
        token and a cleared done flag; speculative: its length and one
        token committed), in place on the engine's stream: earlier
        dispatches' LazyStacks hold copies."""
        self._tokens[slot] = tok_dev
        self._done[slot] = False
        if self.spec_k:
            self._lengths_dev[slot] = length
            self._gen[slot] = 1
            self._gen_ub[slot] = self._gen_seen[slot] = 1

    def _spec_clear(self, slots: Sequence[int]):
        """Take slots out of the speculative loop on the device (done,
        length 0): the lengths live there, and a stale positive one
        would run a dead lane."""
        for slot in slots:
            self._tokens[slot] = 0
            self._done[slot] = True
            self._lengths_dev[slot] = 0
            self._gen[slot] = 0
            self._gen_ub[slot] = self._gen_seen[slot] = 0

    def _seat(self, slot: int, req: Request, blocks: List[int], tok_dev,
              first_tok, now: float):
        """Seat a fully prefilled request in the decode batch: page
        table, sampling vectors, prefix-cache insertion of its full
        prompt blocks, and the prefill-emitted first token."""
        nb = len(blocks)
        req.blocks = list(blocks)
        start = req.n_prefix_blocks
        self._tables[slot, start + nb:] = SCRATCH_BLOCK
        self._tables[slot, start:start + nb] = blocks
        self._lengths[slot] = len(req.prompt)
        if self._prefix is not None:
            self._cache_insert(req, start, req.prefix_chain,
                               list(req.blocks))
        req.prefilling = False
        self._enter_decode(slot, req, tok_dev, first_tok, now)

    def _enter_decode(self, slot: int, req: Request, tok_dev, first_tok,
                      now: float):
        """A prefilled request's first token streams from here; then it
        joins this engine's decode loop, or (prefill role) leaves as a
        migration carrying the device token for the importer's next
        dispatch."""
        if self.role == "prefill":
            req.push_token(first_tok, now)
            if req.max_tokens == 1:
                self._finalize(slot)
            else:
                self._stage_handoff(slot, req, tok_dev, now)
            return
        self._set_sampling(slot, req)
        self._join(slot, tok_dev, len(req.prompt))
        req.push_token(first_tok, now)
        if req.max_tokens == 1:
            self._finalize(slot)

    def _start_chunked(self, slot: int, req: Request, entries, chain):
        """Enter the chunk path: seat the prefix-cache hits in the page
        table now (their K/V are in the pool already) and queue the rest
        of the prompt for chunkwise prefill between decode dispatches."""
        req.prefilling = True
        req.prefix_entries = list(entries)
        req.prefix_chain = chain
        self._tables[slot, :] = SCRATCH_BLOCK
        self._tables[slot, :len(entries)] = [e.block for e in entries]
        self._lengths[slot] = 0            # joins decode at completion
        self._prefill_jobs.append(
            _PrefillJob(req, slot, chain, len(entries) * self.block_size,
                        len(entries)))

    def _advance_prefill(self):
        """Run at most ONE chunk of the head prefill job: the fixed unit
        of prefill work an engine step may spend, so a 32k prompt admits
        over many steps while the decode batch keeps dispatching between
        chunks."""
        if not self._prefill_jobs:
            return
        job = self._prefill_jobs[0]
        req, slot = job.req, job.slot
        Lp = len(req.prompt)
        remaining = Lp - job.done_tokens
        take = min(remaining, self.prefill_chunk or remaining)
        bs = self.block_size
        # chunk starts are block-aligned (prefix hits and full chunks
        # are block multiples), so the new-block count is exact
        nb_new = -(-take // bs)
        new_blocks = self._alloc_blocks(nb_new)
        job.computed_blocks.extend(new_blocks)
        req.blocks.extend(new_blocks)
        have = req.n_prefix_blocks + len(req.blocks)
        self._tables[slot, have - nb_new:have] = new_blocks
        # the chunk padded to its bucket (pages past it: scratch), the
        # context table to its extent bucket (masked by ctx_len)
        Cb = shape_bucket(take, self._chunk_buckets)
        nbc = shape_bucket(max(1, job.done_tokens // bs), self._ctx_buckets)
        prog = self._chunk_program(Cb, nbc)
        host, image = self._host_image(prog)
        (table, ctx_len, ids, chunk_len, blocks, temp, topk, topp,
         seed) = prog.views(image)
        table[0] = self._tables[slot, :nbc]
        ctx_len[0] = job.done_tokens
        ids[0, :take] = req.prompt[job.done_tokens:job.done_tokens + take]
        chunk_len[0] = take
        blocks[:nb_new] = new_blocks
        temp[0] = req.temperature
        topk[0] = req.top_k
        topp[0] = req.top_p
        seed[0] = np.uint32(req.seed & 0xFFFFFFFF)
        t0 = time.monotonic()
        with _obs_trace.span(
                "serving.prefill_chunk",
                args=({"chunk": take, "ctx": job.done_tokens, "bucket": Cb}
                      if _obs_trace.enabled() else None)):
            toks = prog.run(host, lambda: self._chunk_body(prog))
        self._h_chunk.observe(time.monotonic() - t0)
        self._chunks += 1
        job.done_tokens += take
        if job.done_tokens < Lp:
            return
        # prompt complete: cache-insert its freshly computed full
        # blocks, seat the slot in the decode batch, emit token 0
        self._prefill_jobs.popleft()
        if self._prefix is not None:
            self._cache_insert(req, job.insert_from, job.chain,
                               job.computed_blocks)
        self._lengths[slot] = Lp
        req.prefilling = False
        self._enter_decode(slot, req, toks[0],
                           LazyScalar(self._lazy(toks),
                                      post=(lambda a: a[0])),
                           time.monotonic())

    def _grow_pages(self, active: List[int]):
        """Append-allocate blocks for requests whose next write crosses
        a block boundary.  A slot at its budget is a device-done request
        the host has not polled yet: growth and length advance stop and
        its masked writes land in scratch.  Speculative: the next window
        writes up to ``k`` positions past the length, and the host
        length is an upper bound of the device's, so covering it covers
        every real write; the budget includes the look-ahead, so
        rejection churn never runs the pool dry."""
        for s in active:
            req = self._slots[s]
            if req.capped:
                continue
            have = req.n_prefix_blocks + len(req.blocks)
            need = self._kv.blocks_for_tokens(int(self._lengths[s]) + 1,
                                              lookahead=self.spec_k)
            while have < need:
                if have >= req.block_budget or \
                        have >= self.max_blocks_per_seq:
                    req.capped = True
                    break
                blk = self._alloc_blocks(1)[0]
                req.blocks.append(blk)
                self._tables[s, have] = blk
                have += 1

    # -- page migration ------------------------------------------------------
    def _stage_handoff(self, slot: int, req: Request, tok_dev, now: float):
        """Cut the ticket of a prompt this prefill-role engine just
        finished: gather its pages in TABLE order (prefix-cache hits
        first, then its own blocks: the order the decode attention reads
        them), record the gather's event, export (free) its own blocks
        and drop its prefix references (the shared blocks stay cached
        here, warm for the next prompt).  Token 0 streamed already; the
        device token rides the ticket."""
        nb = req.n_prefix_blocks + len(req.blocks)
        ids = self._stage(np.ascontiguousarray(self._tables[slot, :nb]))
        with _obs_trace.span(
                "serving.export",
                args=({"blocks": nb} if _obs_trace.enabled() else None)):
            kv = gather_request_pages(self._kv.pool, ids)
        ready = self._record()
        kvc = self._kv
        mig = PageMigration(
            req, kv, nb, tok_dev, now,
            geometry={"num_layers": kvc.num_layers,
                      "block_size": kvc.block_size,
                      "num_heads": kvc.num_heads,
                      "head_dim": kvc.head_dim,
                      "dtype": str(kvc.pool.dtype)},
            source=self._obs_id, ready=ready)
        self.scheduler.finish(req)
        if req.blocks:
            kvc.allocator.export_blocks(req.blocks)
            req.blocks = []
        if req.prefix_entries:
            self._prefix.release(req.prefix_entries)
            req.prefix_entries = []
        self._slots[slot] = None
        self._lengths[slot] = 0
        self._tables[slot, :] = SCRATCH_BLOCK
        self._ready_migrations.append(mig)

    def _drain_migration_inbox(self):
        """Seat accepted migrations as slots and reservations free up
        (this engine's thread): strict FIFO, the head waits for room
        and is never overtaken.  While this engine decodes, the head
        also waits until its pages' gather has run on the exporter's
        stream (the ticket's event, polled without waiting): the
        exporter's host runs ahead of its device by whole captured
        prefills, and an import enqueued earlier would hold every later
        dispatch of this stream behind them."""
        while True:
            with self._mig_lock:
                if not self._migration_inbox:
                    return
                mig = self._migration_inbox[0]
            slot = next((s for s, r in enumerate(self._slots) if r is None),
                        None)
            if slot is None:
                return
            if mig.ready is not None and not mig.ready.query() and any(
                    r is not None and not r.prefilling for r in self._slots):
                return
            need = mig.request.worst_case_blocks(self.block_size,
                                                 self.spec_k)
            if not self._kv.allocator.reserve(need):
                return
            with self._mig_lock:
                self._migration_inbox.popleft()
                self._inbox_need -= need
            try:
                self._import_migration(slot, mig, need)
            except MigrationError:
                # a consumed ticket (a double submit): whoever imported
                # it first owns the request
                self._kv.allocator.release(need)

    def _import_migration(self, slot: int, mig: PageMigration, need: int):
        """Land one migrated request in this batch: fresh blocks of this
        pool, the ticket's pages scattered into them IN PLACE (the
        captured step holds the pool's address), the page table
        remapped to them in the staged host layout, the sampling
        vectors, and the device token joined as the next dispatch's
        input.  On the card this stream first waits for the ticket's
        event, and the ticket's tensors are marked in use on it until
        the scatter and the join have run."""
        req = mig.consume()
        nb = mig.nb
        kv, tok = mig.kv, mig.token
        if mig.ready is not None:
            torch.cuda.current_stream(self._device).wait_event(mig.ready)
        if kv.device != self._device:
            kv, tok = kv.to(self._device), tok.to(self._device)
        self._evict_for(nb)
        blocks = self._kv.allocator.import_blocks(nb)
        with _obs_trace.span(
                "serving.import",
                args=({"blocks": nb} if _obs_trace.enabled() else None)):
            scatter_request_pages(
                self._kv.pool, kv,
                self._stage(np.asarray(blocks, dtype=np.int32)))
        req.slot = slot
        self._slots[slot] = req
        req.blocks = list(blocks)
        req.prefix_entries = []
        req.reserved_blocks = need
        req.block_budget = need
        Lp = len(req.prompt)
        self._tables[slot, :] = SCRATCH_BLOCK
        self._tables[slot, :nb] = blocks
        self._lengths[slot] = Lp
        self._set_sampling(slot, req)
        if self._prefix is not None:
            # full prompt blocks of THIS pool now: later local prompts
            # may share them
            self._cache_insert(req, 0, b"", list(req.blocks))
        req.prefilling = False
        self._join(slot, tok, Lp)
        if self.stream is not None:
            kv.record_stream(self.stream)
            tok.record_stream(self.stream)
        self._c_migrations.inc()
        self._c_migrated_blocks.inc(nb)
        self._h_migration.observe(time.monotonic() - mig.t_start)

    # -- completion ----------------------------------------------------------
    def _timed_poll(self):
        """The poll site: the auto-tuner's calibration around
        :meth:`_poll_done` (``paddle_tpu/inference/serving/engine.py::
        _timed_poll``).  A fixed or decided interval, and a speculative
        engine without an EOS id (whose cadence is the ``max_tokens``
        gate, never the interval), poll once.  While calibrating it
        polls twice: the first drains the dispatches in flight (device
        work the loop pays either way), the second, on an empty chain,
        is the pure poll cost the tuner is fed, with the wall a dispatch
        since the last poll (the drain included) as the unit.  The tuner
        freezes ``done_poll_interval`` at the smallest interval whose
        poll cost is at most ``target`` of the dispatches it spans."""
        tuner = self._poll_tuner
        if (self.spec_k and self.eos_id is None) or tuner is None \
                or tuner.decided:
            self._poll_done()
            return
        t0 = time.monotonic()
        self._poll_done()                  # drains the chain in flight
        t1 = time.monotonic()
        self._poll_done()                  # an empty chain: the pure cost
        t2 = time.monotonic()
        n = self._dispatches - self._last_poll_dispatches
        if self._last_poll_end is not None and n > 0:
            tuner.observe(1, t2 - t1, (t1 - self._last_poll_end) / n)
        else:
            # the first poll (captures, warm-up): the tuner discards it
            tuner.observe(1, t2 - t1, t1 - t0)
        self._last_poll_end = t2
        self._last_poll_dispatches = self._dispatches
        if tuner.decided:
            self.done_poll_interval = tuner.fold
            d = tuner.decision
            self._poll_decision = {
                "done_poll_interval": self.done_poll_interval,
                "poll_cost_ms": d["host_ms_per_step"],
                "dispatch_ms": d["device_ms_per_step"],
                "target": d["overhead_target"],
                "max": d["max_fold"]}

    def _poll_done(self):
        """THE periodic sync: fetch the ``[B]`` device done mask so
        EOS'd requests free their slot and pages.  A chunk-prefilling
        slot has not joined the loop yet: its flag is its
        predecessor's.  Speculative: the same one fetch brings the
        lengths and gen too (:meth:`_reconcile_spec`)."""
        with _obs_trace.span("serving.poll"):
            if self.spec_k:
                B = self.max_batch
                state = torch.cat([self._done.to(torch.int32),
                                   self._spec_state]).cpu().numpy()
                done = state[:B].astype(bool)
                self._reconcile_spec(state[B:2 * B], state[2 * B:])
            else:
                done = self._done.cpu().numpy()
        for s, req in enumerate(self._slots):
            if req is not None and bool(done[s]) and not req.prefilling:
                self._finalize(s)

    def _reconcile_spec(self, lens: np.ndarray, gen: np.ndarray):
        """Fold one poll's device truth into the host: the length upper
        bounds drop to the lengths, the gen bounds to gen, and the
        tokens committed since the last poll are credited (tokens per
        lane-dispatch; the accept rate is ``(that - 1) / k``): the
        window's mean into ``serving_spec_tokens_per_dispatch``, the
        cumulative rate into the accept-rate gauge."""
        emitted = 0
        for s, req in enumerate(self._slots):
            if req is None or req.prefilling:
                continue
            self._lengths[s] = lens[s]
            self._gen_ub[s] = int(gen[s])
            d = int(gen[s]) - int(self._gen_seen[s])
            if d > 0:
                emitted += d
                self._gen_seen[s] = int(gen[s])
        self._spec_emitted += emitted
        lanes = self._spec_lanes - self._spec_last_poll_lanes
        if lanes > 0:
            self._h_spec_tpd.observe(emitted / lanes)
        if self._spec_lanes:
            self._spec_accept = max(0.0, min(1.0, (
                self._spec_emitted / self._spec_lanes - 1.0) / self.spec_k))
        self._spec_last_poll_lanes = self._spec_lanes

    def _release_slot(self, slot: int, req: Request):
        """Give back a leaving request's reservation, blocks, prefix
        references and slot state."""
        self.scheduler.finish(req)
        if req.blocks:
            self._kv.allocator.free(req.blocks)
            req.blocks = []
        if req.prefix_entries:
            # shared blocks stay cached (idle, warm for the next hit);
            # only the live reference drops
            self._prefix.release(req.prefix_entries)
            req.prefix_entries = []
        self._slots[slot] = None
        self._lengths[slot] = 0
        self._tables[slot, :] = SCRATCH_BLOCK
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 1.0
        self._seeds[slot] = 0
        self._maxt[slot] = 0
        self._samp_stale = True

    def _finalize(self, slot: int):
        """Resolve a leaving request: reading its lazy tokens is the
        sanctioned device→host copy.  The sentinels go, then the last
        window's tokens past ``max_tokens`` (the device stops after the
        window that crosses it), then the EOS cut; a plain engine emits
        no sentinel and no token past ``max_tokens``."""
        req = self._slots[slot]
        toks = [t for t in map(int, req.lazy_tokens)
                if t != SPEC_SENTINEL][:req.max_tokens]
        if self.eos_id is not None and self.eos_id in toks:
            toks = toks[:toks.index(self.eos_id) + 1]
        req.stats.finished = time.monotonic()
        req.stats.generated = len(toks)
        self._release_slot(slot, req)
        if self.spec_k:
            self._spec_clear([slot])
        self._total_tokens += len(toks)
        self._latency.append(req.stats.latency)
        if req.stats.ttft is not None:
            self._ttft.append(req.stats.ttft)
        self._observe_finalize(slot, req, len(toks))
        req.future.set_result(GenerationResult(req.id, toks, req.stats))

    def _observe_finalize(self, slot: int, req: Request, n_toks: int):
        """The registry's record of a finished request and, while
        tracing, its lifecycle spans (queued, prefill, decode) rebuilt
        from its milestones on a track of its own per slot."""
        st = req.stats
        self._c_requests.inc()
        self._c_tokens.inc(n_toks)
        self._h_latency.observe(st.latency)
        if st.ttft is not None:
            self._h_ttft.observe(st.ttft)
        if st.queue_time is not None:
            self._h_queue_time.observe(st.queue_time)
        if not _obs_trace.enabled():
            return
        lane = self._obs_lane_base + slot
        _obs_trace.set_track_name(lane, f"serving-{self._obs_id}-slot{slot}")
        _obs_trace.add_span("request", st.submitted, st.finished, tid=lane,
                            args={"request_id": req.id,
                                  "prompt_len": st.prompt_len,
                                  "generated": st.generated})
        if st.admitted is not None:
            _obs_trace.add_span("request.queued", st.submitted, st.admitted,
                                tid=lane)
            if st.first_token is not None:
                _obs_trace.add_span("request.prefill", st.admitted,
                                    st.first_token, tid=lane)
                _obs_trace.add_span("request.decode", st.first_token,
                                    st.finished, tid=lane)

    def release_all(self, exc: Exception):
        """Fail every in-flight and queued request with ``exc`` and
        release its pool state (server teardown path); the migrations in
        flight are the caller's (:meth:`drain_all_migrations`)."""
        with self._on_stream():
            self._release_all(exc)

    def _release_all(self, exc: Exception):
        self._prefill_jobs.clear()
        released = []
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            self._release_slot(s, req)
            released.append(s)
            if not req.future.done():
                req.future.set_exception(exc)
        for req in self.scheduler.drain_waiting():
            if not req.future.done():
                req.future.set_exception(exc)
        if self.spec_k:
            # after every future is failed: a device fault raises here
            self._spec_clear(released)

    def load_params(self, params: GPTDecodeWeights,
                    draft_params: Optional[GPTDecodeWeights] = None):
        """Copy new weights into the served ones IN PLACE (and into the
        draft's, given ``draft_params``): the captured steps hold the
        weight tensors' addresses, so their next replays read the new
        values and nothing is captured again.  Shapes and dtypes must
        match (``ValueError``).  Call it with no dispatch running (the
        pump stopped)."""
        if draft_params is not None and not self.spec_k:
            raise ValueError("draft weights on a non-speculative engine: "
                             "construct it with draft= first")
        if draft_params is not None and self._draft_params is self._params:
            raise ValueError("the draft is the target's own weights "
                             "(draft_params=params): refresh the target "
                             "alone")
        with self._on_stream():
            copy_decode_params_(self._params, params)
            if draft_params is not None:
                copy_decode_params_(self._draft_params, draft_params)

    def release_graphs(self):
        """Wait for this engine's stream, then free the captured decode
        steps and prefill programs (the next run of each captures it
        again)."""
        if self.stream is not None:
            self.stream.synchronize()
        for step in self._steps.values():
            step.close()
        self._steps.clear()
        for progs in (self._prefill_progs, self._chunk_progs):
            for prog in progs.values():
                prog.close()
            progs.clear()

    # -- warmup / stats ------------------------------------------------------
    def warmup(self, prompt_lengths: Optional[Sequence[int]] = None
               ) -> Dict[str, object]:
        """Before traffic: run both decode variants on an all-inactive
        batch, which on the card captures them, then every prefill
        program the given prompt lengths reach (default: every prefill
        bucket's length), which captures each: a length within the
        grouped path (at most ``prefill_chunk``) reaches its prompt
        bucket at every group bucket; a longer one the (chunk, context)
        keys of its chunks; with the prefix cache, a length also reaches
        the keys of its own repeat (every shareable block a hit).  By
        role: a prefill-role engine runs no decode variant (it never
        captures one) and gathers scratch pages as an export does, at
        one block and at the largest bucket's count (the gather's two
        kernels); a decode-role engine runs no prefill program and
        scatters a page as an import does.  The captures come first:
        each empties the caching allocator, which the eager migration
        ops then warm.  Loads the kernels (building them on first use; a
        kernel's first launch loads its module, which waits for the
        device; ``PERF.md`` §6) and the BLAS handles; writes land in the
        scratch block.  The one engine method that waits for the device;
        returns wall times and the keys."""
        if self.active_count or self._prefill_jobs:
            raise RuntimeError("warmup() runs before traffic: requests "
                               "are in flight")
        t0 = time.monotonic()
        lengths = ([int(n) for n in prompt_lengths] if prompt_lengths
                   else list(self._buckets))
        buckets = sorted({shape_bucket(n, self._buckets) for n in lengths})
        group_keys, chunk_keys = set(), set()
        for n in lengths:
            if self.prefill_chunk is not None and n > self.prefill_chunk:
                chunk_keys.update(self._chunk_keys(n, 0))
            else:
                b = shape_bucket(n, self._buckets)
                group_keys.update((Gb, b) for Gb in self._group_buckets)
            if self._prefix is not None and (n - 1) // self.block_size:
                chunk_keys.update(self._chunk_keys(
                    n, (n - 1) // self.block_size * self.block_size))
        if self.role == "decode":
            buckets, group_keys, chunk_keys = [], set(), set()
        per_key = {}
        with torch.no_grad(), self._on_stream():
            if self.role != "prefill":
                for mixed in (False, True):
                    self._decode_dispatch(mixed)
            self._sync()
            decode_s = time.monotonic() - t0
            for kind, keys in (("prefill", group_keys),
                               ("chunk", chunk_keys)):
                for key in sorted(keys):
                    tk = time.monotonic()
                    self._warm_program(kind, key)
                    self._sync()
                    per_key[f"{kind} {key[0]}x{key[1]}"] = \
                        time.monotonic() - tk
            self._warm_migration()
            self._sync()
        return {"warmup_s": time.monotonic() - t0, "decode_s": decode_s,
                "program_s": per_key, "buckets": buckets,
                "prefill_keys": sorted(group_keys),
                "chunk_keys": sorted(chunk_keys), **self.compile_stats()}

    def _warm_program(self, kind: str, key: tuple) -> None:
        """One run of a prefill program on a one-token input whose pages
        are the scratch block (its capture, on the card)."""
        if kind == "prefill":
            prog, body = self._group_program(*key), self._group_body
        else:
            prog, body = self._chunk_program(*key), self._chunk_body
        host, image = self._host_image(prog)
        prog.views(image)[1 if kind == "prefill" else 3][:] = 1
        prog.run(host, lambda: body(prog))

    def _warm_migration(self):
        """The migration ops of this engine's role on the scratch block:
        a prefill-role engine's gathers (one block, and the largest
        bucket's count, which takes the gather's other kernel), an
        importing engine's scatter."""
        scratch = np.full(self._buckets[-1] // self.block_size,
                          SCRATCH_BLOCK, dtype=np.int32)
        if self.role == "prefill":
            for n in (1, len(scratch)):
                gather_request_pages(self._kv.pool, self._stage(scratch[:n]))
        else:
            ids = self._stage(scratch[:1])
            scatter_request_pages(self._kv.pool,
                                  gather_request_pages(self._kv.pool, ids),
                                  ids)

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @property
    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def compile_stats(self) -> Dict[str, int]:
        """Capture pins (the JAX engine's ``decode_traces``,
        ``prefill_traces`` and ``chunk_traces``): at most one capture per
        decode variant, whatever the join/leave pattern, and one per
        prefill program; 0 on the CPU, where the bodies run eagerly.
        ``prefill_programs`` and ``chunk_programs`` count the keys seen,
        on every device."""
        return {"decode_captures": sum(s.captures
                                       for s in self._steps.values()),
                "prefill_captures": sum(p.captures for p in
                                        self._prefill_progs.values()),
                "chunk_captures": sum(p.captures for p in
                                      self._chunk_progs.values()),
                "prefill_programs": len(self._prefill_progs),
                "chunk_programs": len(self._chunk_progs)}

    def stats(self) -> Dict[str, object]:
        """Host-clock serving stats.  ``intertoken`` is the host gap
        between consecutive decode dispatches of a non-empty batch;
        dispatch is asynchronous, so it reads the device's pace only
        once the launch queue is full.  ``dispatch_host_us`` is the host
        time of a dispatch (page growth, staging, the replay's launch,
        the per-slot bookkeeping; finalizes and polls apart)."""
        st = {"active": self.active_count,
              "role": self.role,
              "queue_depth": self.scheduler.queue_depth,
              "pending_migrations": self.pending_migrations,
              "dispatches": self._dispatches,
              "total_tokens": self._total_tokens,
              "completed": len(self._latency),
              "done_poll_interval": self.done_poll_interval,
              "prefill_chunk": self.prefill_chunk,
              "prefill_chunks": self._chunks,
              "latency_p50_s": _percentile(self._latency, 50),
              "latency_p99_s": _percentile(self._latency, 99),
              "ttft_p50_s": _percentile(self._ttft, 50),
              "ttft_p99_s": _percentile(self._ttft, 99),
              "intertoken_p50_s": _percentile(self._intertoken, 50),
              "intertoken_p99_s": _percentile(self._intertoken, 99),
              "dispatch_host_us_p50": (
                  None if not self._dispatch_host else
                  _percentile(self._dispatch_host, 50) * 1e6),
              "decode_capture_s": {("mixed" if m else "greedy"): s.capture_s
                                   for m, s in self._steps.items()},
              "prefill_capture_s": sum(
                  p.call.capture_s for p in itertools.chain(
                      self._prefill_progs.values(),
                      self._chunk_progs.values()) if p.call is not None),
              "graph_pool_bytes": self._graph_pool_bytes(),
              "kv": self._kv.allocator.stats()}
        if self.spec_k:
            # per active lane and dispatch, over the polls so far: a
            # live lane commits 1 + accept*k tokens a window
            tpd = (self._spec_emitted / self._spec_lanes
                   if self._spec_lanes else None)
            st["spec"] = {
                "k": self.spec_k, "dispatches": self._spec_dispatches,
                "tokens_per_dispatch": tpd,
                "accept_rate": (None if tpd is None else
                                max(0.0, min(1.0, (tpd - 1.0) / self.spec_k)))}
        if self._prefix is not None:
            st["prefix_cache"] = self._prefix.stats()
        if self._poll_decision is not None:
            st["done_poll_decision"] = dict(self._poll_decision)
        st.update(self.compile_stats())
        return st

    def _graph_pool_bytes(self) -> Optional[int]:
        """Bytes the caching allocator holds for this engine's graph
        pool (its segments' sizes); None on the CPU."""
        if self._graph_pool is None:
            return None
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(seg["total_size"] for seg in segments
                   if tuple(seg["segment_pool_id"]) == tuple(self._graph_pool))
