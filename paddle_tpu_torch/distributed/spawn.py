"""``paddle.distributed.spawn`` (counterpart of
``paddle_tpu/distributed/spawn.py``).

Starts ``nprocs`` rank processes with ``torch.multiprocessing``'s
``spawn`` start method (a forked child of a process that touched CUDA
cannot use the card), sets Paddle's env contract in each child before
the user function runs (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_MASTER``, and ``options["env"]``), and joins them.  One rank
that dies ends the others and raises (``ProcessContext.join``): a
survivor would otherwise wait in a collective for its dead peer.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Sequence

import torch.multiprocessing as mp


class ProcessContext:
    def __init__(self, procs):
        self.processes = procs

    def terminate(self):
        for p in self.processes:
            if p.exitcode is None:
                p.terminate()
        for p in self.processes:
            p.join(10)
            if p.exitcode is None:
                p.kill()
                p.join(5)

    def join(self, timeout=None):
        """Wait for every rank.  A rank that exits non-zero ends the rest
        and raises; past ``timeout`` seconds returns False with the ranks
        still running (``terminate()`` ends them)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in self.processes]
            bad = [(p.name, c) for p, c in zip(self.processes, codes)
                   if c not in (0, None)]
            if bad:
                self.terminate()
                raise RuntimeError(
                    f"distributed.spawn: worker(s) failed: {bad}")
            if all(c == 0 for c in codes):
                for p in self.processes:
                    p.join()
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(func, args, env):
    os.environ.update(env)
    func(*args)


def spawn(func, args: Sequence = (), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options):
    """Run ``func(*args)`` in ``nprocs`` rank processes; the rank comes
    from the env contract (``paddle.distributed.get_rank()`` /
    ``init_parallel_env()``).  ``options["env"]`` adds variables to every
    child's environment.  With ``join`` it returns once every rank has
    ended; otherwise it returns the :class:`ProcessContext`."""
    if nprocs <= 0:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    master = f"127.0.0.1:{_free_port()}"
    endpoints = [f"127.0.0.1:{_free_port()}" for _ in range(nprocs)]
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_MASTER": master,
        }
        env.update(options.get("env", {}))
        p = ctx.Process(target=_worker, args=(func, tuple(args), env),
                        daemon=daemon, name=f"spawn-rank{rank}")
        p.start()
        procs.append(p)
    context = ProcessContext(procs)
    if join:
        context.join()
    return context
