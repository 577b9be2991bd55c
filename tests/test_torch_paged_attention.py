"""Paged decode attention of the PyTorch port against the JAX package.

The port's plain version (``paged_ragged_attention`` on CPU tensors) is
held against the JAX Pallas kernel run in interpret mode and against
the JAX gather composition, at 2e-6 in fp32 (the reference's own bound
for the kernel vs the gather path).  The CUDA kernel itself is held
against the plain version on the card by the ``cuda``-marked tests,
which skip on a machine without one.
"""

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
from paddle_tpu_torch.inference.serving import paged_decode_attention

TOL = 2e-6


def _case(seed=0, B=4, H=2, Dh=8, BS=4, NB=12, MAXNB=4,
          lengths=(0, 1, 4, 9)):
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


def _torch_out(pool_k, pool_v, table, lengths, q):
    return pak.paged_ragged_attention(
        torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(q)).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_pallas_kernel_interpret(seed):
    pool_k, pool_v, table, lengths, q = _case(seed)
    ref = np.asarray(jax_paged_ragged_attention(
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(table),
        jnp.asarray(lengths), jnp.asarray(q), interpret=True),
        dtype=np.float32)
    out = _torch_out(pool_k, pool_v, table, lengths, q)
    assert out.dtype == np.float32 and out.shape == q.shape
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_gather_path(seed):
    pool_k, pool_v, table, lengths, q = _case(seed)
    pool = jnp.stack([jnp.asarray(pool_k), jnp.asarray(pool_v)])[None]
    kp, vp = jax_gather_pages(pool, 0, jnp.asarray(table))
    ref = np.asarray(jax_ragged_decode_attention(
        jnp.asarray(q), kp, vp, jnp.asarray(lengths)), dtype=np.float32)
    out = _torch_out(pool_k, pool_v, table, lengths, q)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_empty_row_is_exact_zero_and_no_launch_on_cpu():
    pool_k, pool_v, table, lengths, q = _case()
    before = pak.paged_ragged_attention.launches
    out = _torch_out(pool_k, pool_v, table, lengths, q)
    assert np.all(out[0] == 0.0)                     # lengths[0] == 0
    assert np.isfinite(out).all()
    assert pak.paged_ragged_attention.launches == before


def test_seam_reads_one_layer_of_the_pool():
    pool_k, pool_v, table, lengths, q = _case()
    pool = torch.zeros((3, 2) + pool_k.shape)
    pool[1, 0] = torch.from_numpy(pool_k)
    pool[1, 1] = torch.from_numpy(pool_v)
    out = paged_decode_attention(pool, 1, torch.from_numpy(table),
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(q))
    np.testing.assert_array_equal(
        out.numpy(), _torch_out(pool_k, pool_v, table, lengths, q))


def test_wrapper_rejects_bad_inputs():
    pool_k, pool_v, table, lengths, q = [
        torch.from_numpy(a) for a in _case()]
    with pytest.raises(TypeError):
        pak.paged_ragged_attention(pool_k, pool_v, table.long(), lengths, q)
    with pytest.raises(TypeError):
        pak.paged_ragged_attention(pool_k, pool_v, table, lengths.long(), q)
    with pytest.raises(ValueError):
        pak.paged_ragged_attention(pool_k, pool_v[:, :2], table, lengths, q)
    with pytest.raises(ValueError):
        pak.paged_ragged_attention(pool_k, pool_v, table, lengths, q[:, :1])
    with pytest.raises(ValueError):
        pak.paged_ragged_attention(pool_k, pool_v, table[:2], lengths, q)


def test_attention_bytes_counts_real_rows():
    # 2 rows: lengths 0 and 5, BS 4 -> 2 pages; H*Dh*itemsize = 64
    got = pak.attention_bytes([0, 5], 4, 2, 8, 4)
    assert got == 2 * 5 * 64 + 2 * 2 * 64 + 4 * (2 + 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol):
    pool_k, pool_v, table, lengths, q = [
        torch.from_numpy(a).to(cuda_device)
        for a in _case(B=4, H=2, Dh=64, BS=16, NB=16, MAXNB=4,
                       lengths=(0, 1, 17, 64))]
    kb, vb, qb = pool_k.to(dtype), pool_v.to(dtype), q.to(dtype)
    before = pak.paged_ragged_attention.launches
    out = pak.paged_ragged_attention(kb, vb, table, lengths, qb)
    assert pak.paged_ragged_attention.launches == before + 1
    ref = pak.paged_ragged_attention_reference(
        kb.float(), vb.float(), table, lengths, qb.float())
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= tol
    assert bool((out[0] == 0).all())
