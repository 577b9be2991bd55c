"""Continuous-batching scheduler: request queue + admission control
(counterpart of ``paddle_tpu/inference/serving/scheduler.py``; host
code, of which the port keeps its own copy).

- ``submit`` enqueues up to ``max_queue`` waiting requests and beyond
  that REJECTS (:class:`QueueFull`), so callers see backpressure.
- A waiting request is admitted when a batch slot is free and the
  allocator can *reserve* its worst-case block need
  ``ceil((len(prompt) + max_tokens - 1) / bs)``, so an admitted
  request can never fail a mid-decode block allocation.
- FCFS order is strict: a large request at the head blocks smaller
  ones behind it.
- The engine may override the reservation (``need_fn``: prompt blocks
  only on a prefill-role engine, the worst case less the live
  prefix-cache hits under discounted admission) and release side state
  when it is refused (``cancel_fn``); ``door_need_fn`` replaces the
  worst case in ``submit``'s capacity check the same way.

``submit`` may be called from any thread; ``pop_admissible`` runs only
on the engine thread.  One lock guards the deque.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional


class QueueFull(RuntimeError):
    """Admission queue is at capacity — shed load upstream."""


class RequestStats:
    """Host-clock milestones of one request (``time.monotonic``
    seconds).  Device work is asynchronous, so these time the dispatch
    timeline the engine's host loop sees."""

    __slots__ = ("submitted", "admitted", "first_token", "finished",
                 "prompt_len", "generated")

    def __init__(self):
        self.submitted: float = 0.0
        self.admitted: Optional[float] = None
        self.first_token: Optional[float] = None
        self.finished: Optional[float] = None
        self.prompt_len: int = 0
        self.generated: int = 0

    @property
    def latency(self) -> Optional[float]:
        if self.finished is None:
            return None
        return self.finished - self.submitted

    @property
    def queue_time(self) -> Optional[float]:
        if self.admitted is None:
            return None
        return self.admitted - self.submitted

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (prefill emits it)."""
        if self.first_token is None:
            return None
        return self.first_token - self.submitted

    def as_dict(self):
        return {"prompt_len": self.prompt_len,
                "generated": self.generated,
                "latency_s": self.latency,
                "queue_time_s": self.queue_time,
                "ttft_s": self.ttft}


class Request:
    """One generation request riding through the engine."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, max_tokens: int,
                 stream_cb: Optional[Callable] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None):
        self.id = next(Request._ids)
        self.prompt = [int(t) for t in prompt_ids]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_tokens = int(max_tokens)
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        # temperature 0 = greedy; top_k <= 0 / top_p >= 1 disable the
        # filters; seed None derives a per-request default (request id)
        self.temperature = float(temperature)
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        self.seed = int(seed) if seed is not None else self.id
        self.stream_cb = stream_cb
        self.future: Future = Future()
        self.stats = RequestStats()
        self.stats.prompt_len = len(self.prompt)
        self.stats.submitted = time.monotonic()
        # engine-side state
        self.slot: Optional[int] = None
        self.blocks: List[int] = []     # exclusively-owned pool blocks
        self.prefix_entries: list = []  # PrefixCache refs (shared)
        self.prefilling = False         # chunk prefill still running
        self.prefix_chain = b""         # chain hash at the cache match
        self.pre_matched = None         # discounted admission's match
        # reserved_blocks is admission ACCOUNTING (released at finish,
        # shrunk by discounted-mode cache inserts); block_budget is the
        # page-table growth CAP (always the worst case)
        self.reserved_blocks = 0
        self.block_budget = 0
        self.lazy_tokens: list = []     # per-step lazy device views
        self.capped = False             # page growth stopped (done-lag)

    @property
    def n_prefix_blocks(self) -> int:
        """Table entries borrowed from the prefix cache (shared,
        cache-owned; the request holds one reference each)."""
        return len(self.prefix_entries)

    def worst_case_blocks(self, block_size: int,
                          lookahead: int = 0) -> int:
        # prompt positions + one cache write per decode dispatch (the
        # last generated token is emitted, never written); `lookahead`
        # covers the writes a speculative window makes past the
        # committed length before it knows how many commit
        need = len(self.prompt) + self.max_tokens - 1 + int(lookahead)
        return -(-need // block_size)

    def push_token(self, lazy_tok, t_now: float):
        if not self.lazy_tokens:
            self.stats.first_token = t_now
        self.lazy_tokens.append(lazy_tok)
        self.stats.generated = len(self.lazy_tokens)
        if self.stream_cb is not None:
            # lazy delivery: reading the token is the consumer's sync
            self.stream_cb(self.id, len(self.lazy_tokens) - 1, lazy_tok)


class Scheduler:
    """FCFS waiting queue with block-budget admission control."""

    def __init__(self, allocator, block_size: int, max_queue: int = 64,
                 max_context: Optional[int] = None,
                 door_need_fn: Optional[Callable] = None,
                 lookahead: int = 0):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.max_queue = int(max_queue)
        self.max_context = max_context
        # per-dispatch write look-ahead folded into every worst case
        # (admission reservation and growth budget): a speculative
        # engine's k uncommitted writes never outrun the allocation
        self.lookahead = int(lookahead)
        # the blocks THIS engine will ever hold for a request (default
        # its worst case; a prefill-role engine holds its prompt only,
        # the decode growth is the importing engine's)
        self._door_need_fn = door_need_fn
        self._waiting: deque = deque()
        self._lock = threading.Lock()

    def submit(self, req: Request) -> Request:
        need = (self._door_need_fn(req) if self._door_need_fn is not None
                else req.worst_case_blocks(self.block_size, self.lookahead))
        if need > self.allocator.capacity:
            raise ValueError(
                f"request needs {need} blocks worst-case but the pool "
                f"only has {self.allocator.capacity}; lower max_tokens "
                "or grow num_blocks")
        if self.max_context is not None and \
                len(req.prompt) + req.max_tokens - 1 > self.max_context:
            raise ValueError(
                f"prompt+max_tokens ({len(req.prompt)}+{req.max_tokens})"
                f" exceeds max context {self.max_context}")
        with self._lock:
            if len(self._waiting) >= self.max_queue:
                raise QueueFull(
                    f"admission queue at capacity ({self.max_queue}); "
                    "shed load upstream")
            self._waiting.append(req)
        return req

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    def pop_admissible(self, free_slots: int,
                       need_fn: Optional[Callable] = None,
                       cancel_fn: Optional[Callable] = None
                       ) -> List[Request]:
        """Admit FCFS-head requests while slots and block reservations
        allow; reservations are taken here, released at finish.

        ``need_fn(req) -> int`` overrides the worst-case reservation
        (a prefill-role engine's prompt blocks; reservation-discounted
        admission: the worst case less the live prefix-cache hits); it
        may take side state (prefix references),
        which ``cancel_fn(req)`` releases when the reservation is
        refused and the request stays queued.  ``block_budget`` is
        always the undiscounted worst case."""
        admitted: List[Request] = []
        now = time.monotonic()
        with self._lock:
            while free_slots > 0 and self._waiting:
                req = self._waiting[0]
                need = (need_fn(req) if need_fn is not None
                        else req.worst_case_blocks(self.block_size,
                                                   self.lookahead))
                if not self.allocator.reserve(need):
                    if cancel_fn is not None:
                        cancel_fn(req)
                    break           # strict FCFS: no head-of-line skip
                self._waiting.popleft()
                req.reserved_blocks = need
                req.block_budget = req.worst_case_blocks(
                    self.block_size, self.lookahead)
                req.stats.admitted = now
                admitted.append(req)
                free_slots -= 1
        return admitted

    def release_partial(self, req: Request, n: int):
        """Shrink a live request's reservation by ``n`` blocks (blocks
        whose ownership moved to the prefix cache are counted by the
        allocator's pin from then on)."""
        n = min(int(n), req.reserved_blocks)
        if n > 0:
            self.allocator.release(n)
            req.reserved_blocks -= n

    def drain_waiting(self) -> List[Request]:
        """Remove and return every waiting request (teardown path)."""
        with self._lock:
            out = list(self._waiting)
            self._waiting.clear()
        return out

    def finish(self, req: Request):
        """Release the request's block reservation."""
        if req.reserved_blocks:
            self.allocator.release(req.reserved_blocks)
            req.reserved_blocks = 0
