"""The DataLoader's device prefetcher (``paddle_tpu_torch/io/
dataloader.py``): while ``Model.fit`` or ``Model.evaluate`` drives a
loader on the card with a fold of 1, the loader stages the next batches
onto the card on a copy stream of its own.  This file imports no JAX,
so its ``cuda`` test can run on the card; on the CPU the loader hands
out host batches whatever stage device it is given."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import io as tio


def _loader(workers=0):
    ds = tio.TensorDataset([np.arange(40, dtype=np.float32).reshape(20, 2),
                            np.arange(20, dtype=np.int64)])
    return tio.DataLoader(ds, batch_size=4, num_workers=workers)


@pytest.mark.parametrize("workers", [0, 2])
def test_a_cpu_stage_device_hands_out_host_batches(workers):
    loader = _loader(workers)
    loader._stage_device = torch.device("cpu")
    got = [b[1].tolist() for b in loader]
    assert got == [list(range(i, i + 4)) for i in range(0, 20, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 2])
def test_cuda_prefetcher_stages_in_order(workers):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the prefetcher stages onto one")
    loader = _loader(workers)
    loader._stage_device = torch.device("cuda", torch.cuda.current_device())
    staged = list(loader)
    assert all(b[0].is_cuda and b[1].is_cuda for b in staged)
    loader._stage_device = None
    host = list(loader)
    for s, h in zip(staged, host):
        assert torch.equal(s[0].cpu(), h[0]) and torch.equal(s[1].cpu(), h[1])
    loader._fold_hint = 4                # a fold above 1 keeps batches home
    loader._stage_device = torch.device("cuda", torch.cuda.current_device())
    assert not any(b[0].is_cuda for b in loader)
