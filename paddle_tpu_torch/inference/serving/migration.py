"""KV page migration: the ticket between serving phases (counterpart of
``paddle_tpu/inference/serving/migration.py``).

Disaggregated serving runs prefill and decode on separate engines.
When a prefill-role engine finishes a prompt, the request's pages and
sampling state leave it as a :class:`PageMigration` and enter a
decode-role engine's pool under that pool's own block ids: a page-table
remap, not a pointer handoff.  What crosses, for the decode side to
continue token for token:

- the K/V pages of the whole prompt in table order (prefix-cache hits
  first, then the request's own blocks);
- the prompt length and the first generated token, still on the
  device (the decode engine's next dispatch reads it);
- the request object itself, with its sampling settings and RESOLVED
  seed (the noise is a function of (seed, position) only).

The device copy is :func:`gather_request_pages` on the exporter (a new
tensor; the source pool stays as it is) and
:func:`scatter_request_pages` on the importer, which writes the
destination pool IN PLACE: the decode step is a captured CUDA graph
holding the pool's address, so a new pool tensor would leave the graph
reading the old one.  Ids past the real blocks point at
``SCRATCH_BLOCK``; duplicate scratch ids race only inside scratch,
which nothing reads.

**Streams.**  The gather runs on the exporting engine's stream (its
pump thread), the scatter on the importing engine's.  On the card the
ticket carries ``ready``, a CUDA event recorded after the gather (and
so after the prefill that produced the first token); the importer's
stream waits on it before the scatter, and the ticket's tensors are
marked in use on the importer's stream (``record_stream``), so the
caching allocator cannot hand their memory to the exporter's next
prefill before the scatter has read it.  Neither side waits on the
host: in one process a migration is a device-to-device copy riding
the two streams.

A ticket is single-use (:meth:`PageMigration.consume`): the source
pages were freed when it was cut, so a second import would seat one
future twice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["MigrationError", "PageMigration", "gather_request_pages",
           "scatter_request_pages"]


class MigrationError(RuntimeError):
    """A page migration cannot be honoured: pool geometries differ, the
    ticket was consumed already, or the engine's role never imports."""


def gather_request_pages(pool: torch.Tensor,
                         block_ids: torch.Tensor) -> torch.Tensor:
    """One request's pages out of a pool: ``pool`` ``[L, 2, NB, BS, H,
    Dh]``, ``block_ids`` ``[n]`` int → a new ``[L, 2, n, BS, H, Dh]``
    tensor."""
    return pool.index_select(2, block_ids.long())


def scatter_request_pages(pool: torch.Tensor, kv: torch.Tensor,
                          block_ids: torch.Tensor) -> None:
    """Write migrated pages into ``pool`` in place, under its own block
    ids: ``kv`` ``[L, 2, n, BS, H, Dh]`` from
    :func:`gather_request_pages`, ``block_ids`` ``[n]`` int (padding at
    ``SCRATCH_BLOCK``)."""
    pool.index_copy_(2, block_ids.long(), kv)


class PageMigration:
    """One request's pages and sampling state between two engines: cut
    by the exporting engine at prompt completion (its copy of the pages
    is freed by then: the ticket owns the K/V), consumed exactly once
    by the importing engine."""

    __slots__ = ("request", "kv", "nb", "token", "t_start", "geometry",
                 "consumed", "source", "ready")

    def __init__(self, request, kv, nb: int, token, t_start: float,
                 geometry: Dict[str, Any], source: str = "",
                 ready: Optional[Any] = None):
        self.request = request          # carries future, stats, seed
        self.kv = kv                    # [L, 2, nb, BS, H, Dh]
        self.nb = int(nb)
        self.token = token              # first generated token, device
        self.t_start = float(t_start)   # export time (time.monotonic)
        self.geometry = dict(geometry)
        self.source = source            # exporting engine's id
        self.ready = ready              # CUDA event after the gather
        self.consumed = False

    def check_geometry(self, engine) -> None:
        """Refuse an import the destination pool cannot hold bit for
        bit: pages are raw ``[BS, H, Dh]`` slabs, so every shape
        component and the dtype must agree."""
        kvc = engine._kv
        want = {"num_layers": kvc.num_layers,
                "block_size": kvc.block_size,
                "num_heads": kvc.num_heads,
                "head_dim": kvc.head_dim,
                "dtype": str(kvc.pool.dtype)}
        if self.geometry != want:
            raise MigrationError(
                f"pool geometry mismatch: ticket {self.geometry} vs "
                f"destination {want}; migration needs identical block "
                "shape and dtype")

    def consume(self):
        """The single-use gate: returns the request, or refuses a
        second import."""
        if self.consumed:
            raise MigrationError(
                f"migration of request {self.request.id} already "
                "imported; tickets are single-use")
        self.consumed = True
        return self.request

    def __repr__(self):
        return (f"PageMigration(request={self.request.id}, nb={self.nb}, "
                f"consumed={self.consumed})")
