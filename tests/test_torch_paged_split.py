"""The split-K paged decode attention's plain mirror and launch plan,
against the JAX package.

``paged_split_reference`` computes each split's partial softmax state
from the gathered rows and merges the partials in the kernel's order
(``csrc/paged_attention_sm90.cu``); it is held against the JAX Pallas
kernel in interpret mode and the JAX gather path at 2e-6 in fp32 (the
reference's own bound for the kernel vs the gather path), at several
split lengths, pages of 4 and 16 tokens, and lengths 0, 1, a split
boundary, the boundary +- 1 and ``MAXNB*BS``.  ``split_plan`` takes the
shapes only: the launch it gives is the same for any lengths.  The CUDA
kernel itself runs under the CPU emulation in
``tests/test_torch_cuda_emulated.py`` and on the card in
``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.inference.serving import gather_pages as jax_gather_pages
from paddle_tpu.inference.serving import (
    ragged_decode_attention as jax_ragged_decode_attention)
from paddle_tpu.inference.serving.paged_attention_kernel import (
    paged_ragged_attention as jax_paged_ragged_attention)

from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak

TOL = 2e-6
H, Dh, MAXNB = 2, 8, 8


def _lengths(split_tokens, BS):
    """0, 1, a split boundary, the boundary -1 and +1, the longest."""
    T = MAXNB * BS
    return (0, 1, split_tokens, split_tokens - 1, min(split_tokens + 1, T),
            T)


def _case(lengths, BS, seed=0):
    B = len(lengths)
    NB = B * MAXNB + 1
    rng = np.random.RandomState(seed)
    pool_k = rng.randn(NB, BS, H, Dh).astype(np.float32)
    pool_v = rng.randn(NB, BS, H, Dh).astype(np.float32)
    q = rng.randn(B, H, Dh).astype(np.float32)
    table = np.zeros((B, MAXNB), dtype=np.int32)     # 0 = scratch
    free = list(rng.permutation(np.arange(1, NB)))   # scattered pages
    for b, n in enumerate(lengths):
        for j in range(-(-n // BS)):
            table[b, j] = free.pop()
    return pool_k, pool_v, table, np.asarray(lengths, np.int32), q


def _split(case, split_tokens):
    return pak.paged_split_reference(
        *[torch.from_numpy(a) for a in case], split_tokens).numpy()


SPLITS = [(4, 4), (4, 8), (4, 12), (4, 32), (16, 16), (16, 24), (16, 48)]


@pytest.mark.parametrize("BS,split_tokens", SPLITS)
def test_split_reference_matches_jax_kernel_interpret(BS, split_tokens):
    case = _case(_lengths(split_tokens, BS), BS)
    ref = np.asarray(jax_paged_ragged_attention(
        *[jnp.asarray(a) for a in case], interpret=True), dtype=np.float32)
    out = _split(case, split_tokens)
    assert out.dtype == np.float32 and out.shape == case[4].shape
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert np.all(out[0] == 0.0)                     # lengths[0] == 0


@pytest.mark.parametrize("BS,split_tokens", SPLITS)
def test_split_reference_matches_jax_gather_path(BS, split_tokens):
    case = _case(_lengths(split_tokens, BS), BS, seed=1)
    pool_k, pool_v, table, lengths, q = [jnp.asarray(a) for a in case]
    kp, vp = jax_gather_pages(jnp.stack([pool_k, pool_v])[None], 0, table)
    ref = np.asarray(jax_ragged_decode_attention(q, kp, vp, lengths),
                     dtype=np.float32)
    np.testing.assert_allclose(_split(case, split_tokens), ref, rtol=TOL,
                               atol=TOL)


def test_partials_of_splits_past_the_length_are_empty():
    BS, st = 4, 8
    case = [torch.from_numpy(a) for a in _case(_lengths(st, BS), BS)]
    m, l, acc = pak.paged_split_partials(*case, st)
    S = -(-MAXNB * BS // st)
    assert m.shape == (6, S, H) and acc.shape == (6, S, H, Dh)
    for b, n in enumerate(case[3].tolist()):
        past = torch.arange(S) * st >= n
        assert bool((m[b, past] == -1e30).all())
        assert bool((l[b, past] == 0).all()) and bool((acc[b, past] == 0)
                                                      .all())
        assert bool((l[b, ~past] > 0).all())


def test_leaving_out_a_split_changes_the_rows_that_have_it():
    BS, st = 4, 8
    case = [torch.from_numpy(a) for a in _case(_lengths(st, BS), BS)]
    m, l, acc = pak.paged_split_partials(*case, st)
    full = pak.paged_split_combine(m, l, acc, case[3], st, MAXNB * BS,
                                   torch.float32)
    m[:, 1], l[:, 1], acc[:, 1] = -1e30, 0.0, 0.0
    broken = pak.paged_split_combine(m, l, acc, case[3], st, MAXNB * BS,
                                     torch.float32)
    differs = (full - broken).abs().amax(dim=(1, 2)) > 1e-3
    assert differs.tolist() == [n > st for n in case[3].tolist()]


def test_split_reference_clamps_lengths_and_page_ids():
    """A stale row (length past MAXNB*BS, page id past the pool) stays
    memory-safe and equals the clamped row, as the kernel does."""
    BS, st = 4, 8
    pool_k, pool_v, table, lengths, q = [
        torch.from_numpy(a) for a in _case(_lengths(st, BS), BS)]
    bad_t, bad_l = table.clone(), lengths.clone()
    bad_t[1, 5] = 10_000                      # past the length: unused
    bad_l[5] = MAXNB * BS + 7
    got = pak.paged_split_reference(pool_k, pool_v, bad_t, bad_l, q, st)
    want = pak.paged_split_reference(pool_k, pool_v, table, lengths, q, st)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


SHAPES = [  # B, H, Dh, BS, MAXNB
    (8, 12, 64, 16, 64), (8, 12, 64, 16, 2048), (8, 12, 64, 256, 128),
    (1, 1, 16, 1, 4), (4, 3, 48, 24, 5), (64, 16, 128, 16, 256),
    (2, 32, 256, 16, 8), (3, 64, 80, 7, 9), (256, 12, 64, 16, 64),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_split_plan_fits_the_kernel(shape, itemsize):
    B, H, Dh, BS, MAXNB = shape
    p = pak.split_plan(B, H, Dh, BS, MAXNB, itemsize, 132)
    T = MAXNB * BS
    assert H % p.heads == 0 and 1 <= p.tile <= BS
    assert 1 <= p.token_groups <= p.tile and p.stages == pak.STAGES
    assert p.split_tokens % p.tile == 0
    assert p.splits == -(-T // p.split_tokens)
    assert (p.splits - 1) * p.split_tokens < T
    lanes = pak.group_lanes(Dh, itemsize)
    assert -(-p.heads * p.token_groups * lanes // 32) * 32 + 32 <= 416
    ring = p.stages * 2 * p.tile * p.heads * Dh * itemsize
    merge = p.heads * p.token_groups * (Dh + 2) * 4
    assert 128 + max(ring, merge) <= 232448 // pak.CTAS_PER_SM
    if p.heads < H:                       # one copy per token slice
        assert p.heads * Dh * itemsize >= 32
    assert B * (H // p.heads) * p.splits <= max(
        pak.CTAS_PER_SM * 132, B * (H // p.heads))


def test_split_plan_of_the_decode_shapes():
    # GPT-2-small decode: 32 splits of 32 tokens, 2 CTAs on each of 132
    # SMs; the long-context shape: 33 splits, one wave of 264 CTAs
    p = pak.split_plan(8, 12, 64, 16, 64, 2, 132)
    assert (p.heads, p.tile, p.split_tokens, p.splits) == (12, 16, 32, 32)
    p = pak.split_plan(8, 12, 64, 16, 2048, 2, 132)
    assert (p.heads, p.tile, p.splits) == (12, 16, 33)
    p = pak.split_plan(8, 12, 64, 256, 128, 4, 132)
    assert (p.heads, p.tile, p.splits) == (12, 8, 33)


class _Recorder:
    """Stands in for the kernel's library: records each launch's
    arguments."""

    def __init__(self):
        self.calls = []

    def paddle_paged_attention_sm90(self, *args):
        self.calls.append(args)
        return 0


def _numbers(desc_ptr):
    d = pak.Launch.from_address(desc_ptr)
    return tuple(getattr(d, n) for n, _ in pak.Launch._fields_)


@pytest.mark.parametrize("lengths", [(0, 0, 0, 0), (1, 2, 3, 4),
                                     (32, 32, 32, 32), (0, 32, 17, 9)])
def test_launch_depends_on_the_shapes_only(lengths):
    BS = 4
    case = [torch.from_numpy(a) for a in _case((32, 32, 32, 32), BS)]
    case[3] = torch.tensor(lengths, dtype=torch.int32)
    lib = _Recorder()
    scale = 0.25                         # exact in fp32
    pak._launch_sm90(lib, None, *case, scale, 132)
    (args,) = lib.calls
    assert len(args) == 9 and args[8] is None        # the stream
    plan = pak.split_plan(4, H, Dh, BS, MAXNB, 4, 132)
    # dtype, the shapes, the plan and the scale: no length among them
    assert _numbers(args[0]) == (0, 4, H, Dh, case[0].shape[0], BS, MAXNB,
                                 *plan, scale)
    assert (args[7] is None) == (plan.splits == 1)


def test_workspace_is_reused_on_one_stream():
    case = [torch.from_numpy(a) for a in _case((32, 32, 32, 32), 4)]
    lib = _Recorder()
    pak._launch_sm90(lib, None, *case, 0.25, 132)
    pak._launch_sm90(lib, None, *case, 0.25, 132)
    pak._launch_sm90(lib, 7, *case, 0.25, 132)       # another stream
    (first, second, other) = lib.calls
    assert first[7] is not None and first[7] == second[7] != other[7]
    assert first[0] == second[0] == other[0]         # one packed launch


def test_launch_writes_the_given_output():
    case = [torch.from_numpy(a) for a in _case((32, 32, 32, 32), 4)]
    lib = _Recorder()
    buf = torch.empty_like(case[4])
    assert pak._launch_sm90(lib, None, *case, 0.25, 132, out=buf) is buf
    fresh = pak._launch_sm90(lib, None, *case, 0.25, 132)
    assert fresh is not buf and fresh.shape == buf.shape
    assert [c[6] for c in lib.calls] == [buf.data_ptr(), fresh.data_ptr()]


def test_launch_raises_on_a_kernel_error():
    class Failing(_Recorder):
        def paddle_paged_attention_sm90(self, *args):
            return 1
    case = [torch.from_numpy(a) for a in _case((1, 2, 3, 4), 4)]
    with pytest.raises(RuntimeError, match="cudaError 1"):
        pak._launch_sm90(Failing(), None, *case, 0.5, 132)


def test_comparison_entry_is_for_the_card_only():
    case = [torch.from_numpy(a) for a in _case((1, 2, 3, 4), 4)]
    before = pak._cuda_core_paged.launches
    with pytest.raises(ValueError, match="card"):
        pak._cuda_core_paged(*case)
    assert pak._cuda_core_paged.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_split_reference(cuda_device, dtype):
    BS = 16
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    plan = pak.split_plan(6, H, Dh * 8, BS, MAXNB, 4, sms)
    rng = np.random.RandomState(0)
    lengths = _lengths(plan.split_tokens, BS) if plan.split_tokens < \
        MAXNB * BS else (0, 1, 17, 64, 100, 128)
    B, NB = len(lengths), len(lengths) * MAXNB + 1
    pool_k = torch.from_numpy(rng.randn(NB, BS, H, Dh * 8).astype(
        np.float32)).to(cuda_device, dtype)
    pool_v = torch.from_numpy(rng.randn(NB, BS, H, Dh * 8).astype(
        np.float32)).to(cuda_device, dtype)
    q = torch.from_numpy(rng.randn(B, H, Dh * 8).astype(np.float32)).to(
        cuda_device, dtype)
    table = torch.arange(1, B * MAXNB + 1, dtype=torch.int32,
                         device=cuda_device).reshape(B, MAXNB)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    out = pak.paged_ragged_attention(pool_k, pool_v, table, lens, q)
    ref = pak.paged_split_reference(pool_k.float(), pool_v.float(), table,
                                    lens, q.float(), plan.split_tokens)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref).abs().max().item() <= tol
    assert bool((out[0] == 0).all())
