"""The input pipeline and checkpoint format of the PyTorch port
(``paddle_tpu_torch/io``, ``vision/datasets``, ``framework/io.py``)
against the JAX package's.

The synthetic datasets must give identical arrays; sequential, batch
and distributed (unshuffled) sampler orders must be equal.  The port's
samplers draw from explicit ``torch.Generator`` s and the JAX ones from
numpy's global state, so shuffled orders are compared as permutations
(ROADMAP queue C, sampler RNG).  Worker threads must hand batches out
in order, and a worker's exception must reach the caller.
"""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import io as jio
from paddle_tpu.vision import datasets as jdatasets

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import staging
from paddle_tpu_torch.vision import datasets as tdatasets

SYNTH_N = 48


@pytest.fixture
def small_synth(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SYNTH_N", str(SYNTH_N))
    monkeypatch.setenv("PADDLE_TORCH_SYNTH_N", str(SYNTH_N))
    monkeypatch.delenv("PADDLE_DATASET_HOME", raising=False)


# -- datasets ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "Cifar10",
                                  "Cifar100"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_datasets_equal_jax(name, mode, small_synth):
    jds = getattr(jdatasets, name)(mode=mode)
    tds = getattr(tdatasets, name)(mode=mode)
    assert len(tds) == len(jds) == SYNTH_N
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.labels, jds.labels)
    for i in (0, SYNTH_N - 1):
        (ti, tl), (ji, jl) = tds[i], jds[i]
        assert ti.dtype == np.float32 and tl.dtype == np.int64
        assert tl.shape == (1,) and ti.ndim == 3
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_synthetic_images_equal_jax():
    kw = dict(num_samples=20, image_shape=(3, 16, 16), num_classes=7,
              seed=3)
    jds, tds = jdatasets.SyntheticImages(**kw), tdatasets.SyntheticImages(**kw)
    assert len(tds) == len(jds) == 20
    for i in (0, 5, 19):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)


def test_composed_datasets_equal_jax():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6, dtype=np.int64)
    t1, j1 = tio.TensorDataset([x, y]), jio.TensorDataset([x, y])
    t2, j2 = tio.TensorDataset([y * 10]), jio.TensorDataset([y * 10])
    pairs = [(tio.ComposeDataset([t1, t2]), jio.ComposeDataset([j1, j2])),
             (tio.ConcatDataset([t1, t2]), jio.ConcatDataset([j1, j2])),
             (tio.Subset(t1, [5, 0, 3]), jio.Subset(j1, [5, 0, 3]))]
    for tds, jds in pairs:
        assert len(tds) == len(jds)
        for i in range(len(tds)):
            for a, b in zip(tds[i], jds[i]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tio.ConcatDataset([t1, t2])[-1][0] == 50


def test_random_split_draws_from_its_generator():
    ds = tio.TensorDataset([np.arange(10)])
    a = tio.random_split(ds, [3, 7], generator=torch.Generator().manual_seed(4))
    b = tio.random_split(ds, [0.3, 0.7],
                         generator=torch.Generator().manual_seed(4))
    assert [len(s) for s in a] == [3, 7]
    assert a[0].indices == b[0].indices and a[1].indices == b[1].indices
    assert sorted(a[0].indices + a[1].indices) == list(range(10))
    with pytest.raises(ValueError):
        tio.random_split(ds, [3, 3])


# -- samplers ---------------------------------------------------------------


@pytest.mark.parametrize("drop_last", [False, True])
def test_sequential_and_batch_orders_equal_jax(drop_last):
    ds = tio.TensorDataset([np.arange(11)])
    assert list(tio.SequenceSampler(ds)) == list(jio.SequenceSampler(ds))
    tb = tio.BatchSampler(ds, batch_size=4, drop_last=drop_last)
    jb = jio.BatchSampler(ds, batch_size=4, drop_last=drop_last)
    assert list(tb) == list(jb) and len(tb) == len(jb)


@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_orders_equal_jax(drop_last):
    ds = tio.TensorDataset([np.arange(11)])
    for rank in range(3):
        t = tio.DistributedBatchSampler(ds, 2, num_replicas=3, rank=rank,
                                        drop_last=drop_last)
        j = jio.DistributedBatchSampler(ds, 2, num_replicas=3, rank=rank,
                                        drop_last=drop_last)
        assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(NotImplementedError, match="item 10"):
        tio.DistributedBatchSampler(ds, 2)


def test_shuffled_orders_are_permutations_and_seeded():
    ds = tio.TensorDataset([np.arange(20)])
    gen = torch.Generator().manual_seed(1)
    order = list(tio.RandomSampler(ds, generator=gen))
    assert sorted(order) == list(range(20)) and order != list(range(20))
    again = list(tio.RandomSampler(
        ds, generator=torch.Generator().manual_seed(1)))
    assert order == again
    sub = list(tio.SubsetRandomSampler([3, 5, 7, 9],
                                       generator=torch.Generator()))
    assert sorted(sub) == [3, 5, 7, 9]
    draws = list(tio.WeightedRandomSampler([0.0, 1.0, 0.0], 5,
                                           generator=torch.Generator()))
    assert draws == [1] * 5
    shards = []
    for rank in range(2):
        s = tio.DistributedBatchSampler(ds, 4, num_replicas=2, rank=rank,
                                        shuffle=True)
        s.set_epoch(3)
        shards.append(sum(list(s), []))
    assert sorted(shards[0] + shards[1]) == list(range(20))
    s.set_epoch(4)
    assert sum(list(s), []) != shards[1]


# -- the loader -------------------------------------------------------------


class _Slow(tio.Dataset):
    """Rows whose reading time varies, so that worker threads finish out
    of order; ``bad`` raises."""

    def __init__(self, n=40, bad=None):
        self.n, self.bad = n, bad

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"row {i} is bad")
        threading.Event().wait(0.002 * ((i * 7) % 5))
        return np.full((3,), i, np.float32), np.int64(i)

    def __len__(self):
        return self.n


def test_workers_hand_out_batches_in_order():
    plain = [tuple(t.tolist() for t in b)
             for b in tio.DataLoader(_Slow(), batch_size=4)]
    loader = tio.DataLoader(_Slow(), batch_size=4, num_workers=3)
    assert len(loader) == 10
    assert [tuple(t.tolist() for t in b) for b in loader] == plain
    gen = torch.Generator().manual_seed(2)
    a = [b[1].tolist() for b in tio.DataLoader(
        _Slow(), batch_size=4, shuffle=True, num_workers=3, generator=gen)]
    b = [b[1].tolist() for b in tio.DataLoader(
        _Slow(), batch_size=4, shuffle=True,
        generator=torch.Generator().manual_seed(2))]
    assert a == b


def test_ordered_workers_under_a_short_switch_interval():
    """More worker threads than cores, switching every microsecond: every
    batch arrives once, in order (a lost update of the shared batch
    counter would skip or repeat one)."""
    import sys
    ds = tio.TensorDataset([np.arange(400, dtype=np.int64)])
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [b[0].tolist() for b in tio.DataLoader(
            ds, batch_size=2, num_workers=16, prefetch_factor=1)]
    finally:
        sys.setswitchinterval(saved)
    assert sum(got, []) == list(range(400))


def test_a_workers_exception_reaches_the_caller_at_its_batch():
    got = []
    with pytest.raises(ValueError, match="row 13 is bad"):
        for b in tio.DataLoader(_Slow(bad=13), batch_size=4, num_workers=3):
            got.append(b[1].tolist())
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]

    def init(wid):
        raise RuntimeError(f"init {wid}")

    with pytest.raises(RuntimeError, match="init"):
        list(tio.DataLoader(_Slow(), batch_size=4, num_workers=2,
                            worker_init_fn=init))


@pytest.mark.parametrize("workers", [0, 3])
def test_an_abandoned_iteration_stops_its_threads(workers):
    """A loop that breaks early (``fit(num_iters=)``) drops the iterator,
    and that stops its reader threads."""
    import gc
    before = set(threading.enumerate())
    loader = tio.DataLoader(_Slow(n=400), batch_size=2, num_workers=workers)
    it = iter(loader)
    next(it)
    started = set(threading.enumerate()) - before
    assert started
    del it
    gc.collect()
    for t in started:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in started)


class _Stream(tio.IterableDataset):
    """0..n-1, sharded across workers by ``get_worker_info``."""

    def __init__(self, n=24):
        self.n = n

    def __iter__(self):
        info = tio.get_worker_info()
        wid, nw = (0, 1) if info is None else (info.id, info.num_workers)
        for i in range(wid, self.n, nw):
            yield np.int64(i)


def test_iterable_dataset_with_workers_shards_by_worker_info():
    assert tio.get_worker_info() is None
    plain = [b.tolist() for b in tio.DataLoader(_Stream(), batch_size=4)]
    assert plain == [list(range(i, i + 4)) for i in range(0, 24, 4)]
    seen = []
    loader = tio.DataLoader(_Stream(), batch_size=4, num_workers=3,
                            worker_init_fn=seen.append)
    batches = [b.tolist() for b in loader]
    assert sorted(seen) == [0, 1, 2]
    assert sorted(sum(batches, [])) == list(range(24))
    for b in batches:              # each batch from one worker's shard
        assert len({i % 3 for i in b}) == 1
    chained = tio.ChainDataset([_Stream(3), _Stream(2)])
    assert [int(v) for v in chained] == [0, 1, 2, 0, 1]
    with pytest.raises(TypeError):
        len(loader)


def test_loader_options():
    ds = tio.TensorDataset([np.arange(10, dtype=np.int64)])
    assert [int(s[0]) for s in tio.DataLoader(ds, batch_size=None)] == \
        list(range(10))
    bs = tio.BatchSampler(ds, batch_size=3, drop_last=True)
    loader = tio.DataLoader(ds, batch_sampler=bs,
                            collate_fn=lambda rows: [r[0] for r in rows],
                            use_buffer_reader=False)
    assert len(loader) == 3
    assert list(loader) == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    dicts = tio.default_collate_fn([{"a": np.zeros(2), "s": "x"},
                                    {"a": np.ones(2), "s": "y"}])
    assert dicts["a"].shape == (2, 2) and dicts["s"] == ["x", "y"]


def test_stack_to_device_on_the_cpu():
    groups = [[np.full((2,), i, np.float32), torch.tensor([i])]
              for i in range(3)]
    xs, ys = staging.stack_to_device(groups, torch.device("cpu"))
    assert xs.shape == (3, 2) and ys.tolist() == [[0], [1], [2]]


# -- save / load --------------------------------------------------------------


def test_save_load_round_trip_and_bf16(tmp_path):
    obj = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
           "n": 3, "nested": [torch.zeros(()), (np.int64(2),)]}
    path = str(tmp_path / "a.pdparams")
    tpaddle.save(obj, path)
    back = tpaddle.load(path)
    assert torch.equal(back["w"], obj["w"]) and back["n"] == 3
    # bf16 is written as its exact fp32 widening
    assert back["h"].dtype == torch.float32
    assert torch.equal(back["h"].to(torch.bfloat16), obj["h"])
    assert back["nested"][0].shape == ()
    raw = tpaddle.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)
    # the JAX package reads the port's file
    jback = jpaddle.load(path)
    np.testing.assert_array_equal(np.asarray(jback["w"].numpy()),
                                  obj["w"].numpy())


def test_jax_bf16_arrays_load_bit_for_bit(tmp_path):
    vals = np.array([1.0, -3.140625, 65280.0, 1e-3], np.float32)
    path = str(tmp_path / "j.pdparams")
    jpaddle.save({"b": vals.astype(ml_dtypes.bfloat16), "f": vals}, path)
    back = tpaddle.load(path)
    assert back["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["b"].float().numpy(),
        vals.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(back["f"].numpy(), vals)
