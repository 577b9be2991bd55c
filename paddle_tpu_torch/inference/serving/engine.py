"""Continuous-batching decode engine (counterpart of
``paddle_tpu/inference/serving/engine.py``, role ``"both"``).

One engine step admits waiting requests, prefills them in same-bucket
groups, grows pages, and runs ONE batched decode dispatch over the
paged KV pool.  Requests joining and leaving the batch change only page
table and length *data*; the decode dispatch always has the shapes
``[max_batch]`` and ``[max_batch, max_blocks_per_seq]``.

Device state rides the loop: the emitted tokens feed back as the next
dispatch's input on the device, EOS is detected on the device (``done``
mask), and the host learns of it only at ``done_poll_interval``
dispatch boundaries (``_poll_done``).  Every dispatch's tokens reach
the requests as :class:`~paddle_tpu_torch.framework.lazy.LazyScalar`
views of one shared ``LazyStack``: one device→host copy per dispatch,
and only if somebody reads it.  The host loop itself never waits for
the device outside the poll, a request's finalize, and ``warmup``.

Kept for later slices (each refused with ``NotImplementedError`` where
the JAX engine has an argument for it): chunked prefill, the prefix
cache, speculative decoding, the prefill/decode roles with page
migration, the auto-tuned poll cadence, observability metrics, and the
CUDA-graph capture of the decode step.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ... import resolve_device
from ...framework.lazy import LazyScalar, LazyStack
from ...io.bucketing import shape_bucket
from .decode_model import (GPTDecodeWeights, ServingModelConfig,
                           decode_forward, prefill_group_forward)
from .kv_cache import SCRATCH_BLOCK, PagedKVCache, write_prompt_pages_group
from .sampling import sample_tokens
from .scheduler import Request, Scheduler

#: the only phase role this slice serves
ENGINE_ROLES = ("both",)


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


def _deferred(feature: str, slice_name: str):
    return NotImplementedError(
        f"{feature} is not ported yet; it comes with the {slice_name} "
        "slice of the PyTorch port (ROADMAP.md queue A)")


class DecodeEngine:
    """Continuous-batching decode over a paged KV pool.

    Drive it directly (``submit`` + ``step`` / ``run_until_idle``) or
    through :class:`~paddle_tpu_torch.inference.serving.api.LLMServer`'s
    pump thread.  All methods except ``submit`` must be called from ONE
    thread; ``submit`` is safe from anywhere.

    ``params`` is a :class:`GPTDecodeWeights` on ``device`` (see
    ``decode_model.params_from_numpy``); the pool takes its dtype.
    ``device`` defaults to ``"cuda"`` and raises without a card.
    """

    def __init__(self, network=None, *, gpt_config=None,
                 params: Optional[GPTDecodeWeights] = None,
                 max_batch: int = 4, block_size: int = 16,
                 num_blocks: int = 128,
                 max_blocks_per_seq: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 done_poll_interval: Optional[int] = 8,
                 max_queue: int = 64,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 role: str = "both",
                 prefix_reserve_discount: bool = False,
                 device=None,
                 draft=None, draft_params=None,
                 spec_k: Optional[int] = None):
        if network is not None:
            raise _deferred("network= (a training GPTForCausalLM)",
                            "training")
        if role != "both":
            raise _deferred(f"role={role!r} with page migration",
                            "disaggregated serving")
        if draft is not None or draft_params is not None or \
                spec_k is not None:
            raise _deferred("speculative decoding (draft=/spec_k=)",
                            "speculative decoding")
        if prefill_chunk is not None:
            raise _deferred("chunked prefill (prefill_chunk=)",
                            "long-context")
        if prefix_cache or prefix_reserve_discount:
            raise _deferred("the shared-prefix cache", "long-context")
        if done_poll_interval is None:
            raise _deferred("the auto-tuned done-poll cadence",
                            "observability")
        self._device = resolve_device(device)
        if params is None or gpt_config is None:
            raise ValueError("need params= and gpt_config=")
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
        self.role = role
        self.max_batch = int(max_batch)
        self.block_size = int(block_size)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.done_poll_interval = max(1, int(done_poll_interval))
        if max_blocks_per_seq is None:
            max_blocks_per_seq = -(-cfg.max_position // block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_context = min(cfg.max_position,
                               self.max_blocks_per_seq * block_size)
        self._kv = PagedKVCache(cfg.num_layers, num_blocks, block_size,
                                cfg.num_heads, cfg.head_dim,
                                dtype=params.wte.dtype,
                                device=self._device)
        self.scheduler = Scheduler(self._kv.allocator, block_size,
                                   max_queue=max_queue,
                                   max_context=self.max_context)
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
        # host-side batch state (authoritative; staged per dispatch)
        self._slots: List[Optional[Request]] = [None] * self.max_batch
        self._tables = np.full((self.max_batch, self.max_blocks_per_seq),
                               SCRATCH_BLOCK, dtype=np.int32)
        self._lengths = np.zeros(self.max_batch, dtype=np.int32)
        self._temps = np.zeros(self.max_batch, dtype=np.float32)
        self._topks = np.zeros(self.max_batch, dtype=np.int32)
        self._topps = np.ones(self.max_batch, dtype=np.float32)
        self._seeds = np.zeros(self.max_batch, dtype=np.uint32)
        # device-resident loop state; replaced, never written in place,
        # because a dispatch's LazyStack may still hold the old tensor
        self._tokens = torch.zeros(self.max_batch, dtype=torch.int32,
                                   device=self._device)
        self._done = torch.zeros(self.max_batch, dtype=torch.bool,
                                 device=self._device)
        self._dispatches = 0
        self._total_tokens = 0
        self._latency: List[float] = []
        self._ttft: List[float] = []
        self._intertoken: List[float] = []
        self._last_dispatch_t: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return self._device

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → device tensor without waiting for the device
        (a private copy, so later host edits cannot reach it)."""
        return torch.from_numpy(arr.copy()).to(self._device,
                                               non_blocking=True)

    # -- front door ----------------------------------------------------------
    def submit(self, prompt_ids, max_tokens: int, stream_cb=None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None) -> Request:
        """Enqueue a generation request (thread-safe).  Returns the
        :class:`Request`; its ``future`` resolves to a
        :class:`GenerationResult`.  Raises
        :class:`~.scheduler.QueueFull` at queue capacity and
        ``ValueError`` for requests the pool geometry can never run."""
        req = Request(prompt_ids, max_tokens, stream_cb=stream_cb,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        if len(req.prompt) > self._buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the largest "
                f"prefill bucket {self._buckets[-1]} (chunked prefill "
                "is not ported yet)")
        return self.scheduler.submit(req)

    # -- engine loop ---------------------------------------------------------
    def step(self) -> bool:
        """Admit and prefill waiting requests, then run ONE batched
        decode dispatch.  Returns True while there is (or may be)
        work."""
        with torch.no_grad():
            return self._step()

    def _step(self) -> bool:
        self._admit()
        active = [s for s, r in enumerate(self._slots) if r is not None]
        if not active:
            self._last_dispatch_t = None
            return self.scheduler.queue_depth > 0
        self._grow_pages(active)
        emit, self._done = self._decode_dispatch()
        self._tokens = emit            # feeds back next dispatch (D2D)
        self._dispatches += 1
        stack = LazyStack(emit)        # ONE shared fetch, if read
        now = time.monotonic()
        if self._last_dispatch_t is not None:
            self._intertoken.append(now - self._last_dispatch_t)
        self._last_dispatch_t = now
        to_finish = []
        for s in active:
            req = self._slots[s]
            req.push_token(LazyScalar(stack, post=(lambda a, i=s: a[i])),
                           now)
            if not req.capped:
                self._lengths[s] += 1
            if len(req.lazy_tokens) >= req.max_tokens:
                to_finish.append(s)
        for s in to_finish:
            self._finalize(s)
        if self.eos_id is not None and \
                self._dispatches % self.done_poll_interval == 0:
            self._poll_done()
        return True

    def _decode_dispatch(self):
        """THE decode dispatch: returns ``(emit [B], done [B])`` on the
        device, enqueued without waiting for it."""
        table = self._stage(self._tables)
        lengths = self._stage(self._lengths)
        active = (lengths > 0) & torch.logical_not(self._done)
        logits = decode_forward(self._params, self._cfg, self._kv.pool,
                                table, lengths, self._tokens, active)
        # the sampled token's sequence index is lengths + 1: a pure
        # function of the request, never of slot or batch
        nxt = sample_tokens(logits, self._temps, self._topks,
                            self._topps, self._seeds, self._lengths + 1)
        emit = torch.where(active, nxt, torch.full_like(nxt, self.pad_id))
        done = self._done
        if self.eos_id is not None:
            done = done | (active & (nxt == int(self.eos_id)))
        return emit, done

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
    def _admit(self):
        free = [s for s, r in enumerate(self._slots) if r is None]
        if not free:
            return
        seated = []
        for req in self.scheduler.pop_admissible(len(free)):
            slot = free.pop(0)
            req.slot = slot
            self._slots[slot] = req
            seated.append((slot, req))
        self._prefill_grouped(seated)

    def _prefill_grouped(self, seated: List):
        """Batched same-bucket prefill: ONE prefill per bucket group
        (group size padded to a power of two), one grouped page write,
        then per-request seating."""
        by_bucket: Dict[int, List] = {}
        for slot, req in seated:
            b = shape_bucket(len(req.prompt), self._buckets)
            by_bucket.setdefault(b, []).append((slot, req))
        for bucket, members in sorted(by_bucket.items()):
            Gb = shape_bucket(len(members), self._group_buckets)
            ids = np.zeros((Gb, bucket), dtype=np.int32)
            lengths = np.zeros(Gb, dtype=np.int32)
            temps = np.zeros(Gb, dtype=np.float32)
            topks = np.zeros(Gb, dtype=np.int32)
            topps = np.ones(Gb, dtype=np.float32)
            seeds = np.zeros(Gb, dtype=np.uint32)
            for g, (slot, req) in enumerate(members):
                Lp = len(req.prompt)
                ids[g, :Lp] = req.prompt
                lengths[g] = Lp
                temps[g] = req.temperature
                topks[g] = req.top_k
                topps[g] = req.top_p
                seeds[g] = np.uint32(req.seed & 0xFFFFFFFF)
            kv, toks, _ = prefill_group_forward(
                self._params, self._cfg, self._stage(ids), lengths,
                temps, topks, topps, seeds)
            blocks_arr = np.full((Gb, bucket // self.block_size),
                                 SCRATCH_BLOCK, dtype=np.int32)
            per_req_blocks = []
            for g, (slot, req) in enumerate(members):
                nb = self._kv.blocks_for_tokens(len(req.prompt))
                blocks = self._kv.allocator.allocate(nb)
                blocks_arr[g, :nb] = blocks
                per_req_blocks.append(blocks)
            write_prompt_pages_group(self._kv.pool, kv,
                                     self._stage(blocks_arr))
            stack = LazyStack(toks)
            now = time.monotonic()
            for g, (slot, req) in enumerate(members):
                self._seat(slot, req, per_req_blocks[g], toks[g],
                           LazyScalar(stack, post=(lambda a, i=g: a[i])),
                           now)

    def _join(self, slot: int, tok_dev):
        """Join a seated request into the device loop state (token and
        done flag), out of place."""
        tokens = self._tokens.clone()
        tokens[slot] = tok_dev
        done = self._done.clone()
        done[slot] = False
        self._tokens, self._done = tokens, done

    def _seat(self, slot: int, req: Request, blocks: List[int], tok_dev,
              first_tok, now: float):
        """Seat a prefilled request in the decode batch: page table,
        sampling parameters, and the prefill-emitted first token."""
        req.blocks = list(blocks)
        self._tables[slot, :] = SCRATCH_BLOCK
        self._tables[slot, :len(blocks)] = blocks
        self._lengths[slot] = len(req.prompt)
        self._temps[slot] = req.temperature
        self._topks[slot] = req.top_k
        self._topps[slot] = req.top_p
        self._seeds[slot] = np.uint32(req.seed & 0xFFFFFFFF)
        self._join(slot, tok_dev)
        req.push_token(first_tok, now)
        if req.max_tokens == 1:
            self._finalize(slot)

    def _grow_pages(self, active: List[int]):
        """Append-allocate blocks for requests whose next write crosses
        a block boundary.  A slot at its budget is a device-done request
        the host has not polled yet: growth and length advance stop and
        its masked writes land in scratch."""
        for s in active:
            req = self._slots[s]
            if req.capped:
                continue
            have = len(req.blocks)
            need = self._kv.blocks_for_tokens(int(self._lengths[s]) + 1)
            while have < need:
                if have >= req.block_budget or \
                        have >= self.max_blocks_per_seq:
                    req.capped = True
                    break
                blk = self._kv.allocator.allocate(1)[0]
                req.blocks.append(blk)
                self._tables[s, have] = blk
                have += 1

    # -- completion ----------------------------------------------------------
    def _poll_done(self):
        """THE periodic sync: fetch the ``[B]`` device done mask so
        EOS'd requests free their slot and pages."""
        done = self._done.cpu().numpy()
        for s, req in enumerate(self._slots):
            if req is not None and bool(done[s]):
                self._finalize(s)

    def _finalize(self, slot: int):
        """Resolve a leaving request: reading its lazy tokens is the
        sanctioned device→host copy."""
        req = self._slots[slot]
        toks = [int(t) for t in req.lazy_tokens]
        if self.eos_id is not None and self.eos_id in toks:
            toks = toks[:toks.index(self.eos_id) + 1]
        req.stats.finished = time.monotonic()
        req.stats.generated = len(toks)
        self.scheduler.finish(req)
        if req.blocks:
            self._kv.allocator.free(req.blocks)
            req.blocks = []
        self._slots[slot] = None
        self._lengths[slot] = 0
        self._tables[slot, :] = SCRATCH_BLOCK
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 1.0
        self._seeds[slot] = 0
        self._total_tokens += len(toks)
        self._latency.append(req.stats.latency)
        if req.stats.ttft is not None:
            self._ttft.append(req.stats.ttft)
        req.future.set_result(GenerationResult(req.id, toks, req.stats))

    def release_all(self, exc: Exception):
        """Fail every in-flight and queued request with ``exc`` and
        release its pool state (server teardown path)."""
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            self.scheduler.finish(req)
            if req.blocks:
                self._kv.allocator.free(req.blocks)
                req.blocks = []
            self._lengths[s] = 0
            self._tables[s, :] = SCRATCH_BLOCK
            self._slots[s] = None
            if not req.future.done():
                req.future.set_exception(exc)
        for req in self.scheduler.drain_waiting():
            if not req.future.done():
                req.future.set_exception(exc)

    # -- warmup / stats ------------------------------------------------------
    def warmup(self, prompt_lengths: Optional[Sequence[int]] = None
               ) -> Dict[str, object]:
        """Run every prefill bucket the given prompt lengths touch
        (default: all) and one all-inactive decode dispatch before
        traffic: loads the kernels (building them on first use), the
        BLAS handles and the allocator's pools.  Writes land in the
        scratch block.  The one engine method that waits for the
        device; returns wall times."""
        t0 = time.monotonic()
        buckets = (sorted({shape_bucket(int(n), self._buckets)
                           for n in prompt_lengths})
                   if prompt_lengths else list(self._buckets))
        per_bucket = {}
        with torch.no_grad():
            for b in buckets:
                tb = time.monotonic()
                kv, tok, _ = prefill_group_forward(
                    self._params, self._cfg,
                    self._stage(np.zeros((1, b), dtype=np.int32)),
                    [1], [0.0], [0], [1.0], [0])
                write_prompt_pages_group(
                    self._kv.pool, kv,
                    self._stage(np.full((1, b // self.block_size),
                                        SCRATCH_BLOCK, dtype=np.int32)))
                self._sync()
                per_bucket[b] = time.monotonic() - tb
            td = time.monotonic()
            self._join(0, torch.zeros((), dtype=torch.int32,
                                      device=self._device))
            self._tokens, self._done = self._decode_dispatch()
            self._sync()
        return {"warmup_s": time.monotonic() - t0,
                "decode_s": time.monotonic() - td,
                "prefill_bucket_s": per_bucket, "buckets": buckets}

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @property
    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def stats(self) -> Dict[str, object]:
        """Host-clock serving stats.  ``intertoken`` is the host gap
        between consecutive decode dispatches of a non-empty batch;
        dispatch is asynchronous, so it reads the device's pace only
        once the launch queue is full."""
        return {"active": self.active_count,
                "role": self.role,
                "queue_depth": self.scheduler.queue_depth,
                "dispatches": self._dispatches,
                "total_tokens": self._total_tokens,
                "completed": len(self._latency),
                "done_poll_interval": self.done_poll_interval,
                "latency_p50_s": _percentile(self._latency, 50),
                "latency_p99_s": _percentile(self._latency, 99),
                "ttft_p50_s": _percentile(self._ttft, 50),
                "ttft_p99_s": _percentile(self._ttft, 99),
                "intertoken_p50_s": _percentile(self._intertoken, 50),
                "intertoken_p99_s": _percentile(self._intertoken, 99),
                "kv": self._kv.allocator.stats()}
