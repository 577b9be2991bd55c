"""Host-to-device staging (counterpart of ``paddle_tpu/io/staging.py``).

Every host batch reaches the card through here: ``Model``'s single
step (:func:`to_device_values`), the fold engine's stacked copy of a
group (:func:`stack_to_device`, the one host-to-device point of a
folded fit) and the DataLoader's device prefetcher (:func:`stage_batch`
on a copy stream of its own).  A copy from page-locked host memory is
enqueued without waiting.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(np.asarray(v))


def to_device_values(values: Sequence, device) -> List[torch.Tensor]:
    """Each value as a tensor on ``device`` (a copy that does not wait
    where the value lies in page-locked memory)."""
    return [as_tensor(v).to(device, non_blocking=True) for v in values]


def stack_to_device(groups: Sequence[Sequence], device) -> List[torch.Tensor]:
    """K same-structure batches as one ``[K, ...]`` tensor a position on
    ``device``: stacked on the host in page-locked memory and copied
    once without waiting, or, where the batches already lie on the
    device (a prefetcher staged them), stacked there."""
    out = []
    for col in zip(*groups):
        vals = [as_tensor(v) for v in col]
        if device.type == "cpu" or vals[0].device == device:
            out.append(torch.stack([v.to(device) for v in vals]))
            continue
        host = torch.empty((len(vals),) + tuple(vals[0].shape),
                           dtype=vals[0].dtype, pin_memory=True)
        torch.stack([v.cpu() for v in vals], out=host)
        out.append(host.to(device, non_blocking=True))
    return out


def stage_batch(item, device):
    """A loader batch with every tensor leaf copied to ``device``
    without waiting (the caller picks the stream)."""
    if isinstance(item, torch.Tensor):
        return item.to(device, non_blocking=True)
    if isinstance(item, (list, tuple)):
        return type(item)(stage_batch(v, device) for v in item)
    if isinstance(item, dict):
        return {k: stage_batch(v, device) for k, v in item.items()}
    return item


def record_on(item, stream) -> None:
    """Mark every CUDA tensor leaf of ``item`` as used on ``stream``, so
    the caching allocator does not hand its memory out again before the
    work queued there has run."""
    if isinstance(item, torch.Tensor):
        if item.is_cuda:
            item.record_stream(stream)
    elif isinstance(item, (list, tuple)):
        for v in item:
            record_on(v, stream)
    elif isinstance(item, dict):
        for v in item.values():
            record_on(v, stream)
