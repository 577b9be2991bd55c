"""Checkpoint manager: periodic, async, retention-managed training
checkpoints with verified, preemption-safe resume (counterpart of
``paddle_tpu/distributed/checkpoint/manager.py``).

``save(step, model, optimizer)`` writes step ``step`` in the port's
format (``reshard.py``) under ``<directory>/<step>``: each rank of the
process group its own files, the coordinator the index and, once every
rank's files are on disk (a barrier), the commit manifest
``RESILIENCE_MANIFEST.json`` over all of them, with the JAX package's
digest policy: whole-file sha256 up to the chunk size, per-chunk
digests past it, optionally sampled (``PADDLE_TPU_CKPT_DIGEST_CHUNK_MB``,
``PADDLE_TPU_CKPT_DIGEST_SAMPLE_CHUNKS``).  A step's files are written
into ``.partial-<step>`` and renamed to ``<step>`` at the commit, so a
step that never committed is never listed.

- ``save_interval_steps`` / ``max_to_keep``: a step saves when it
  divides by the interval (or ``force``), and the coordinator deletes
  the oldest committed steps past ``max_to_keep``;
- ``async_save``: the host copy is taken on the caller's thread (so a
  weight update right after ``save`` cannot reach it), the files are
  written on a background thread, and the commit of every step older
  than the one being saved happens in that ``save`` (the rolling flush),
  the rest in ``wait_until_finished`` / ``close``; a save from another
  thread is written synchronously (``cross_thread_syncs``);
- ``verify_step``, ``verified_steps``; ``restore(verified_only=)`` walks
  back past torn or unverified steps and quarantines every newer one
  into ``_quarantined/`` (never deleted); ``rollback_to(step)``;
- ``save_on_preemption``: a SIGTERM handler that saves this rank's
  files without any collective (a cached ownership plan, or every
  piece) and commits at once on a one-rank group; on a world the commit
  waits for the next call that every rank makes.  A signal that lands
  inside a save is deferred until that save returns.

Fault points ``checkpoint.save`` / ``.commit`` / ``.restore``, spans and
the ``checkpoint_*`` metrics are the JAX manager's.  Every rank of the
group makes the same calls in the same order; with no process group the
manager is a single-process one.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

from ...observability import metrics as _obs_metrics
from ...observability import trace as _obs_trace
from ..resilience import faults as _faults
from ..resilience import retry as _retry
from . import reshard

MANIFEST_NAME = "RESILIENCE_MANIFEST.json"
_DIGEST_CHUNK_ENV = "PADDLE_TPU_CKPT_DIGEST_CHUNK_MB"
_DIGEST_SAMPLE_ENV = "PADDLE_TPU_CKPT_DIGEST_SAMPLE_CHUNKS"
_PARTIAL = ".partial-"


def _env_number(name, default, kind):
    raw = os.environ.get(name, "").strip()
    try:
        return kind(raw) if raw else default
    except ValueError:
        return default


def _digest_policy():
    """``(chunk_bytes | None, sample_chunks)``: 0 or less turns either
    off (the JAX policy)."""
    chunk_mb = _env_number(_DIGEST_CHUNK_ENV, 64.0, float)
    sample = _env_number(_DIGEST_SAMPLE_ENV, 0, int)
    chunk_bytes = max(1, int(chunk_mb * (1 << 20))) if chunk_mb > 0 \
        else None
    return chunk_bytes, max(0, sample)


def _sample_indices(n_chunks: int, max_chunks: int) -> List[int]:
    """The first and last chunk always, the rest evenly spaced."""
    if max_chunks <= 0 or n_chunks <= max_chunks:
        return list(range(n_chunks))
    max_chunks = max(2, max_chunks)
    if n_chunks <= max_chunks:
        return list(range(n_chunks))
    return sorted({round(i * (n_chunks - 1) / (max_chunks - 1))
                   for i in range(max_chunks)})


def _chunk_digest(path, chunk_bytes, indices) -> Dict[str, str]:
    out = {}
    with open(path, "rb") as f:
        for idx in indices:
            f.seek(idx * chunk_bytes)
            h = hashlib.sha256()
            remaining = chunk_bytes
            while remaining > 0:
                piece = f.read(min(1 << 20, remaining))
                if not piece:
                    break
                h.update(piece)
                remaining -= len(piece)
            out[str(idx)] = h.hexdigest()
    return out


def _file_digest_entry(path) -> Dict[str, Any]:
    size = os.path.getsize(path)
    chunk_bytes, sample = _digest_policy()
    if chunk_bytes is None or size <= chunk_bytes:
        return {"size": size, "sha256": CheckpointManager._digest(path)}
    n_chunks = -(-size // chunk_bytes)
    return {"size": size, "chunk_bytes": chunk_bytes,
            "chunks": _chunk_digest(path, chunk_bytes,
                                    _sample_indices(n_chunks, sample))}


def _verify_file_entry(path, meta) -> bool:
    try:
        if os.path.getsize(path) != meta["size"]:
            return False
        if "sha256" in meta:
            return CheckpointManager._digest(path) == meta["sha256"]
        if "chunks" in meta:
            chunk_bytes = int(meta["chunk_bytes"])
            indices = sorted(int(i) for i in meta["chunks"])
            actual = _chunk_digest(path, chunk_bytes, indices)
            return all(actual.get(str(i)) == meta["chunks"][str(i)]
                       for i in indices)
    except (OSError, KeyError, ValueError):
        return False
    return False


class CheckpointManager:
    """Step-indexed training checkpoints.

    >>> mgr = CheckpointManager(dir, save_interval_steps=100,
    ...                         max_to_keep=3)
    >>> for step in ...:
    ...     mgr.save(step, model, optimizer)      # no-op off-interval
    >>> start = mgr.restore(model, optimizer)     # latest, or 0
    """

    def __init__(self, directory: str, save_interval_steps: int = 1,
                 max_to_keep: int = 5, async_save: bool = True,
                 process_group=None, coordinator_rank: int = 0):
        from ..communication import get_group
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.max_to_keep = max_to_keep
        self._async = bool(async_save)
        self._group = get_group(process_group)
        self._coord = int(coordinator_rank)
        self._lock = threading.RLock()
        self._commit_lock = threading.Lock()
        self._owner_thread = threading.get_ident()
        self.cross_thread_syncs = 0
        self._pending_manifest: List[int] = []
        self._writers: Dict[int, threading.Thread] = {}
        self._errors: Dict[int, BaseException] = {}
        self._prev_sigterm = None
        self._sigterm_handler = None
        self._in_save = False
        self._in_signal = False
        self._deferred_sigterm = None

    # -- the group ---------------------------------------------------------
    @property
    def _world(self) -> bool:
        return self._group.pg is not None and self._group.nranks > 1

    @property
    def _is_coord(self) -> bool:
        return not self._world or self._group.rank == self._coord

    def _barrier(self):
        if self._world:
            from ..communication import barrier
            barrier(self._group)

    # -- save -----------------------------------------------------------------
    @staticmethod
    def _payload(model=None, optimizer=None, extra=None):
        tree: Dict[str, Any] = {}
        if model is not None:
            tree["model"] = reshard.model_tree(model)
        if optimizer is not None:
            reshard.name_slots(optimizer, model)
            tree["optimizer"] = reshard.optimizer_tree(optimizer)
        if extra:
            tree["extra"] = dict(extra)
        return tree

    def save(self, step: int, model=None, optimizer=None,
             extra: Optional[Dict[str, Any]] = None,
             force: bool = False) -> bool:
        """Save if the step hits the interval (or ``force``); retried on
        transient IO errors.  Returns whether it saved."""
        t0 = time.monotonic()
        with _obs_trace.span("checkpoint.save",
                             args=({"step": int(step)}
                                   if _obs_trace.enabled() else None)):
            saved = self._save_impl(int(step), model, optimizer, extra,
                                    force)
        if saved:
            reg = _obs_metrics.registry()
            reg.counter("checkpoint_saves_total",
                        "committed checkpoint saves").inc()
            reg.histogram("checkpoint_save_s",
                          "checkpoint save host wall time"
                          ).observe(time.monotonic() - t0)
            reg.gauge("checkpoint_last_saved_step",
                      "step of the last committed save").set(int(step))
        return saved

    def _save_impl(self, step, model, optimizer, extra, force) -> bool:
        if not force and step % self.save_interval_steps:
            return False
        cross_thread = (self._async and
                        threading.get_ident() != self._owner_thread)
        if cross_thread and not self._lock.acquire(timeout=10.0):
            warnings.warn("CheckpointManager: cross-thread force-save "
                          "skipped: the owner thread holds the save lock")
            return False
        if not cross_thread:
            self._lock.acquire()
        try:
            if os.path.isdir(self._step_dir(step)) or \
                    step in self._pending_manifest:
                return False
            self._in_save = True
            try:
                copy = reshard.host_copy(
                    self._payload(model, optimizer, extra), self._group,
                    collective=not self._in_signal)
                partial = self._partial_dir(step)

                def write():
                    _faults.fault_point("checkpoint.save", step=step)
                    reshard.write_host_copy(copy, partial, self._is_coord)

                def write_retried():
                    _retry.retry_call(write, max_attempts=3, base_delay=0.1,
                                      deadline=60.0, retry_on=(OSError,),
                                      label="checkpoint.save")

                if self._async and not cross_thread and \
                        not self._in_signal:
                    th = threading.Thread(
                        target=self._guarded, args=(step, write_retried),
                        daemon=True)
                    self._writers[step] = th
                    th.start()
                else:
                    write_retried()
                    if cross_thread:
                        self.cross_thread_syncs += 1
                self._pending_manifest.append(step)
            finally:
                self._in_save = False
        finally:
            self._lock.release()
        if cross_thread or not self._async:
            self._flush_manifests(only=[step] if cross_thread else None)
        else:
            self._flush_manifests(older_than=step)
        deferred, self._deferred_sigterm = self._deferred_sigterm, None
        if deferred is not None and self._sigterm_handler is not None:
            self._sigterm_handler(*deferred)
        return True

    def _guarded(self, step, fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - surfaced at commit
            self._errors[step] = e

    def wait_until_finished(self):
        self._flush_manifests()

    # -- commit and verification -------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _partial_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PARTIAL}{step}")

    def _flush_manifests(self, older_than: Optional[int] = None,
                         only=None):
        """Commit the pending steps whose files are written (every rank's:
        a barrier first on a world): those older than ``older_than``,
        those in ``only``, or all."""
        with self._lock:
            pending = [t for t in self._pending_manifest
                       if (older_than is None or t < older_than)
                       and (only is None or t in only)]
            self._pending_manifest = [t for t in self._pending_manifest
                                      if t not in pending]
        if self._in_signal and self._world:
            # no collective in a signal handler: the commit waits
            with self._lock:
                self._pending_manifest = sorted(
                    set(self._pending_manifest) | set(pending))
            return
        for step in pending:
            th = self._writers.pop(step, None)
            if th is not None:
                th.join()
        self._barrier()
        for step in pending:
            err = self._errors.pop(step, None)
            if err is not None:
                warnings.warn(f"CheckpointManager: step {step}'s write "
                              f"failed ({type(err).__name__}: {err}); it "
                              "stays uncommitted")
                continue
            if self._is_coord:
                self._commit(step)
        if pending:
            self._barrier()
            if self._is_coord:
                self._retain()
            self._barrier()

    def _commit(self, step: int):
        """Index, rename into the step namespace, then the manifest:
        a crash between leaves the step unverified, which restore
        skips."""
        partial = self._partial_dir(step)
        if not os.path.isdir(partial):
            warnings.warn(f"CheckpointManager: step {step} was queued for "
                          "a commit manifest but its files never appeared; "
                          "it will stay unverified")
            return
        with self._commit_lock:
            reshard._atomic_json(reshard.merge_index(partial),
                                 os.path.join(partial, reshard.INDEX_NAME))
            os.replace(partial, self._step_dir(step))
            self._commit_manifest(step)

    @staticmethod
    def _digest(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def _walk_step_files(self, step: int) -> Dict[str, str]:
        root = self._step_dir(step)
        out: Dict[str, str] = {}
        for dirpath, _, files in os.walk(root):
            for name in files:
                if name == MANIFEST_NAME:
                    continue
                p = os.path.join(dirpath, name)
                out[os.path.relpath(p, root)] = p
        return out

    def _scan_files(self, step: int) -> Dict[str, Dict[str, Any]]:
        return {rel: _file_digest_entry(p)
                for rel, p in self._walk_step_files(step).items()}

    def _commit_manifest(self, step: int):
        _faults.fault_point("checkpoint.commit", step=step)
        manifest = {"step": int(step), "files": self._scan_files(step)}
        path = os.path.join(self._step_dir(step), MANIFEST_NAME)
        tmp = path + ".tmp"

        def write():
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, path)

        _retry.retry_call(write, max_attempts=3, base_delay=0.05,
                          deadline=15.0, retry_on=(OSError,),
                          label="checkpoint.manifest")

    def _retain(self):
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - int(self.max_to_keep))]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def verify_step(self, step: int) -> bool:
        """True iff the step's bytes (every rank's files) match its
        commit manifest."""
        path = os.path.join(self._step_dir(step), MANIFEST_NAME)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        expected = manifest.get("files", {})
        actual = self._walk_step_files(step)
        if set(expected) - set(actual):
            return False
        return all(_verify_file_entry(actual[rel], meta)
                   for rel, meta in expected.items())

    def verified_steps(self) -> List[int]:
        self._flush_manifests()
        return [s for s in self.all_steps() if self.verify_step(s)]

    def latest_verified_step(self) -> Optional[int]:
        vs = self.verified_steps()
        return vs[-1] if vs else None

    def oldest_verified_step(self) -> Optional[int]:
        vs = self.verified_steps()
        return vs[0] if vs else None

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and
                      os.path.isdir(os.path.join(self.directory, n)))

    def restore(self, model=None, optimizer=None,
                step: Optional[int] = None,
                verified_only: bool = True) -> int:
        """Load the given (or the latest usable) step into ``model`` /
        ``optimizer`` in place; returns the step (0 if none).  With
        ``step=None`` the scan walks back past steps that fail
        verification or reading; manifest-less steps come after every
        verified one (``verified_only``) or in step order.  The steps
        newer than the one restored are quarantined."""
        t0 = time.monotonic()
        with _obs_trace.span("checkpoint.restore"):
            restored = self._restore_scan(model, optimizer, step,
                                          verified_only)
        reg = _obs_metrics.registry()
        reg.counter("checkpoint_restores_total",
                    "checkpoint restore attempts that returned").inc()
        reg.histogram("checkpoint_restore_s",
                      "checkpoint restore host wall time"
                      ).observe(time.monotonic() - t0)
        reg.gauge("checkpoint_last_restored_step",
                  "step returned by the last restore (0 = none)"
                  ).set(int(restored))
        return restored

    def _restore_scan(self, model, optimizer, step, verified_only) -> int:
        if step is not None:
            return self._restore_step(int(step), model, optimizer)
        self._flush_manifests()
        candidates = sorted(self.all_steps(), reverse=True)
        manifested = [s for s in candidates if os.path.exists(
            os.path.join(self._step_dir(s), MANIFEST_NAME))]
        unverified = [s for s in candidates if s not in manifested]
        corrupt: List[int] = []
        order = (manifested + unverified) if verified_only else candidates
        for s in order:
            if s in manifested:
                if not self.verify_step(s):
                    warnings.warn(
                        f"CheckpointManager: step {s} failed verification "
                        "(torn or corrupt checkpoint); falling back to an "
                        "older step")
                    corrupt.append(s)
                    continue
            else:
                warnings.warn(
                    f"CheckpointManager: attempting manifest-less step {s} "
                    "(its manifest was never written); restoring without "
                    "verification")
            try:
                restored = self._restore_step(s, model, optimizer)
            except Exception as e:  # noqa: BLE001 - scan past bad steps
                warnings.warn(
                    f"CheckpointManager: restoring step {s} failed "
                    f"({type(e).__name__}: {e}); falling back to an older "
                    "step")
                continue
            self._quarantine_steps([t for t in candidates if t > s])
            return restored
        self._quarantine_steps(corrupt)
        return 0

    def rollback_to(self, step: int):
        """Quarantine every saved step newer than ``step``."""
        self._flush_manifests()
        self._quarantine_steps([s for s in self.all_steps()
                                if s > int(step)])

    def _quarantine_steps(self, steps: List[int]):
        """Move unusable steps into ``_quarantined/`` (the coordinator;
        every rank waits for it)."""
        self._barrier()
        if self._is_coord:
            qroot = os.path.join(self.directory, "_quarantined")
            for s in sorted(set(steps)):
                src = self._step_dir(s)
                if not os.path.isdir(src):
                    continue
                os.makedirs(qroot, exist_ok=True)
                dst = os.path.join(qroot, str(s))
                n = 0
                while os.path.exists(dst):
                    n += 1
                    dst = os.path.join(qroot, f"{s}.{n}")
                warnings.warn(f"CheckpointManager: quarantining unusable "
                              f"checkpoint step {s} -> {dst}")
                try:
                    os.replace(src, dst)
                except OSError as e:
                    warnings.warn(f"CheckpointManager: could not quarantine "
                                  f"step {s} ({e}); a later save of this "
                                  "step may fail")
        self._barrier()

    def _restore_step(self, step: int, model=None, optimizer=None) -> int:
        root = self._step_dir(step)

        def read():
            _faults.fault_point("checkpoint.restore", step=step)
            index = reshard.read_index(root)["leaves"]
            tree = self._payload(model, None)
            masters = set()
            if optimizer is not None:
                reshard.name_slots(optimizer, model)
                tree["optimizer"] = reshard.optimizer_tree(optimizer,
                                                           create=True)
                masters = reshard.load_template(tree["optimizer"], index,
                                                "optimizer")
            if model is not None and not any(
                    k.startswith("model/") for k in index):
                del tree["model"]
            reshard.load_state_dict(tree, root, self._group)
            if optimizer is not None:
                reshard.restore_bookkeeping(optimizer, tree["optimizer"],
                                            masters)
            if model is not None:
                reshard.refresh_pieces(model)
            return int(step)

        return _retry.retry_call(read, max_attempts=3, base_delay=0.1,
                                 deadline=60.0, retry_on=(OSError,),
                                 label="checkpoint.restore")

    # -- preemption --------------------------------------------------------------
    def save_on_preemption(self, get_step, model=None, optimizer=None):
        """Install a SIGTERM handler that force-saves this rank's files
        before exit (module docstring); the previous handler runs after
        it, else the process exits with 143."""
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            if self._in_save:
                self._deferred_sigterm = (signum, frame)
                return
            self._in_signal = True
            try:
                self.save(int(get_step()), model, optimizer, force=True)
                self.wait_until_finished()
            finally:
                self._in_signal = False
                if callable(prev):
                    prev(signum, frame)
                else:
                    raise SystemExit(143)

        self._prev_sigterm = prev
        self._sigterm_handler = handler
        signal.signal(signal.SIGTERM, handler)

    def uninstall_preemption_handler(self):
        if self._sigterm_handler is None:
            return
        try:
            if signal.getsignal(signal.SIGTERM) is self._sigterm_handler:
                signal.signal(signal.SIGTERM,
                              self._prev_sigterm or signal.SIG_DFL)
        except ValueError:
            pass
        finally:
            self._sigterm_handler = None
            self._prev_sigterm = None

    def close(self):
        self.uninstall_preemption_handler()
        self._flush_manifests()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
