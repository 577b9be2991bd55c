"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``): batches
of a map-style or iterable dataset, collated on the host into torch
tensors.

Readers:

- ``num_workers > 0`` on a map-style dataset: ordered worker threads.
  Each takes the next batch's indices, reads and collates it; batch *i*
  always comes out *i*-th, whatever worker made it, as the JAX package's
  native reader orders them (``paddle_tpu/io/native_reader.py``).  At
  most ``num_workers * prefetch_factor`` batches are in flight.  A
  worker's exception is raised in the caller at its batch's position.
  The C++ blocking queue behind the JAX reader (``native/``) is not
  ported (ROADMAP queue A, item 12); the threads hand batches over
  through Python.
- ``num_workers > 0`` on an iterable dataset: each worker thread
  iterates the dataset with its :class:`~.dataset.WorkerInfo` set, and
  batches interleave in completion order.
- otherwise one prefetch thread (``use_buffer_reader``, the default) or
  none.

Every random draw (the batch order) is made in the caller's thread when
iteration starts, from the sampler's explicit ``torch.Generator``.  When
a card is present every batch lands in page-locked host memory.

The device prefetcher: while ``Model.fit`` or ``Model.evaluate`` drives
the loader on the card with a fold of 1, the loader stages the next two
batches onto the card on a copy stream of its own.  The consumer's
stream waits for each batch's copy, and the batch is recorded on the
consumer's stream, so a captured step's copy into its static inputs
never reads a half-written batch and the allocator never reuses its
memory under queued work.  With a fold above 1 the batches stay on the
host: the fold engine's stacked copy of a group is the one host-to-
device point (``io/staging.py::stack_to_device``).
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from .dataset import Dataset, IterableDataset, WorkerInfo, _set_worker_info
from .sampler import BatchSampler
from .staging import record_on, stage_batch


def default_collate_fn(batch):
    """Stack samples: arrays and tensors along a new dim 0, Python ints
    as int64, floats as float32; tuples, lists and dicts field by
    field; strings as a list."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.as_tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.as_tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(f))
                            for f in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch])
                for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    return torch.as_tensor(np.asarray(batch))


def _pin(batch):
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch


def _put(q, item, stop) -> bool:
    """Put with a stop check, so that an abandoned iterator does not park
    its producer forever.  False when stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


class _PrefetchIterator:
    """One thread running ``gen_fn()`` ahead of the consumer by up to
    ``buffer_size`` items; its exception is raised in the consumer.  The
    thread holds no reference to the iterator, so an iterator the
    consumer drops (a loop that breaks early) stops its thread."""

    def __init__(self, gen_fn, buffer_size: int):
        q: "queue.Queue" = queue.Queue(maxsize=max(1, buffer_size))
        stop, done, err = threading.Event(), object(), []

        def worker():
            try:
                for item in gen_fn():
                    if not _put(q, item, stop):
                        return
            except BaseException as e:      # re-raised in the consumer
                err.append(e)
            finally:
                _put(q, done, stop)

        self._q, self._stop, self._done, self._err = q, stop, done, err
        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()


class _MapState:
    """What the ordered workers share (and all they hold, so that the
    iterator itself can be dropped): the batches, the next batch to
    take, the results by position and the in-flight bound."""

    def __init__(self, dataset, batches, collate, num_workers,
                 prefetch_factor, worker_init_fn, pin):
        self.dataset, self.batches = dataset, batches
        self.collate, self.pin, self.init = collate, pin, worker_init_fn
        self.n = max(1, int(num_workers))
        self.slots = threading.Semaphore(self.n * max(1, prefetch_factor))
        self.lock = threading.Lock()
        self.cond = threading.Condition()
        self.results = {}
        self.next_index = 0
        self.fatal = None
        self.stop = threading.Event()


def _map_worker(st: _MapState, wid: int) -> None:
    _set_worker_info(WorkerInfo(wid, st.n, st.dataset))
    try:
        if st.init is not None:
            st.init(wid)
    except BaseException as e:              # re-raised in the consumer
        with st.cond:
            st.fatal = e
            st.cond.notify_all()
        return
    while not st.stop.is_set():
        if not st.slots.acquire(timeout=0.2):
            continue
        with st.lock:
            seq = st.next_index
            st.next_index += 1
        if seq >= len(st.batches):
            st.slots.release()
            return
        try:
            batch = st.collate([st.dataset[i] for i in st.batches[seq]])
            res = (True, _pin(batch) if st.pin else batch)
        except BaseException as e:          # re-raised in the consumer
            res = (False, e)
        with st.cond:
            st.results[seq] = res
            st.cond.notify_all()


class _OrderedMapIterator:
    """``num_workers`` threads reading and collating the batches of
    ``batches`` (lists of indices); batch *i* is handed out *i*-th."""

    def __init__(self, dataset, batches, collate, num_workers,
                 prefetch_factor, worker_init_fn, pin):
        self._st = st = _MapState(dataset, batches, collate, num_workers,
                                  prefetch_factor, worker_init_fn, pin)
        self._next_out = 0
        self._threads = [threading.Thread(target=_map_worker,
                                          args=(st, w), daemon=True)
                         for w in range(st.n)]
        for t in self._threads:
            t.start()

    def __iter__(self):
        return self

    def __next__(self):
        st = self._st
        if st.stop.is_set() or self._next_out >= len(st.batches):
            self.close()
            raise StopIteration
        with st.cond:
            while self._next_out not in st.results:
                if st.fatal is not None:
                    self.close()
                    raise st.fatal
                st.cond.wait(0.2)
            ok, value = st.results.pop(self._next_out)
        self._next_out += 1
        st.slots.release()
        if not ok:
            self.close()
            raise value
        return value

    def close(self):
        self._st.stop.set()

    def __del__(self):
        self._st.stop.set()


class _DevicePrefetcher:
    """Keeps ``depth`` batches of ``inner`` staged on ``device``, copied
    on a stream of its own (module docstring)."""

    def __init__(self, inner, device, depth: int = 2):
        self._inner = inner
        self._it = iter(inner)
        self._device = device
        self._stream = torch.cuda.Stream(device)
        self._buf = collections.deque()
        self._depth = max(1, depth)
        self._exhausted = False
        self._pending_err = None

    def _stage(self, item):
        with torch.cuda.stream(self._stream):
            staged = stage_batch(item, self._device)
        ready = torch.cuda.Event()
        ready.record(self._stream)
        return staged, ready

    def _fill(self):
        while not self._exhausted and len(self._buf) < self._depth:
            try:
                self._buf.append(self._stage(next(self._it)))
            except StopIteration:
                self._exhausted = True
            except BaseException:
                # an iterator that raised is finished; never pull it again
                self._exhausted = True
                raise

    def __iter__(self):
        return self

    def __next__(self):
        if self._pending_err is not None and not self._buf:
            # the batches before the error first; then the error, at the
            # position of the batch that caused it
            err, self._pending_err = self._pending_err, None
            raise err
        self._fill()
        if not self._buf:
            raise StopIteration
        out, ready = self._buf.popleft()
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(ready)
        record_on(out, consumer)
        try:
            self._fill()      # start the next copies now
        except BaseException as e:
            self._pending_err = e
            self._exhausted = True
        return out

    def close(self):
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


class DataLoader:
    """``batch_size=None`` yields the samples unbatched; ``batch_sampler``
    replaces ``batch_size``/``shuffle``/``drop_last``; ``generator`` is
    the shuffling's ``torch.Generator`` (default: the port's CPU
    generator).  ``use_shared_memory``, ``timeout`` and
    ``persistent_workers`` are accepted and have no effect: the workers
    are threads of this process, started at each pass."""

    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, generator=None):
        if batch_size is not None and int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.use_buffer_reader = use_buffer_reader
        self.worker_init_fn = worker_init_fn
        self.generator = generator
        self.batch_size = None if batch_size is None else int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.pin_memory = torch.cuda.is_available()
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode or (batch_sampler is None
                                   and batch_size is None):
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=self.batch_size,
                drop_last=drop_last, generator=generator)
        # set by Model.fit / Model.evaluate while they drive the loader:
        # the fold (above 1, batches stay on the host) and the device the
        # prefetcher stages onto
        self._fold_hint = 1
        self._stage_device = None

    def _finish(self, batch):
        return _pin(batch) if self.pin_memory else batch

    def _generate_iterable(self):
        batch = []
        for sample in self.dataset:
            if self.batch_size is None:
                yield sample
                continue
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._finish(self.collate_fn(batch))
                batch = []
        if batch and not self.drop_last:
            yield self._finish(self.collate_fn(batch))

    def _generate_map(self, batches):
        if batches is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        for indices in batches:
            yield self._finish(self.collate_fn(
                [self.dataset[i] for i in indices]))

    def _generate_iterable_workers(self):
        """The iterable dataset in ``num_workers`` threads, each with its
        :class:`WorkerInfo`; batching and ``drop_last`` apply per
        worker."""
        out: "queue.Queue" = queue.Queue(
            maxsize=self.num_workers * self.prefetch_factor)
        stop = threading.Event()
        end = object()

        def work(wid):
            try:
                _set_worker_info(WorkerInfo(wid, self.num_workers,
                                            self.dataset))
                if self.worker_init_fn is not None:
                    self.worker_init_fn(wid)
                for item in self._generate_iterable():
                    if not _put(out, item, stop):
                        return
            except BaseException as e:
                _put(out, e, stop)
            finally:
                _put(out, end, stop)

        threads = [threading.Thread(target=work, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        done = 0
        try:
            while done < self.num_workers:
                item = out.get()
                if item is end:
                    done += 1
                elif isinstance(item, BaseException):
                    raise item
                else:
                    yield item
        finally:
            stop.set()

    def _reader(self):
        if self._iterable_mode:
            if self.num_workers > 0:
                gen = self._generate_iterable_workers
            else:
                gen = self._generate_iterable
        else:
            # the batch order is drawn here, in the caller's thread
            batches = (None if self.batch_sampler is None
                       else [list(b) for b in self.batch_sampler])
            if self.num_workers > 0 and batches is not None:
                return _OrderedMapIterator(
                    self.dataset, batches, self.collate_fn,
                    self.num_workers, self.prefetch_factor,
                    self.worker_init_fn, self.pin_memory)

            def gen():
                return self._generate_map(batches)
        if self.use_buffer_reader:
            return _PrefetchIterator(gen, self.prefetch_factor)
        return gen()

    def __iter__(self):
        reader = self._reader()
        dev = self._stage_device
        if dev is not None and dev.type == "cuda" and self._fold_hint <= 1:
            return _DevicePrefetcher(reader, dev)
        return reader

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)
