"""fp16 and head dims 16 / 32 in the PyTorch port against the JAX
package (the JAX kernels take any dtype and these head dims; the port's
card kernels take them too, and their plain versions are what the CPU
runs).

Flash attention: the port's public ``flash_attention`` on CPU tensors
(the kernels' plain versions) against ``pallas_ops.flash_attention.raw``
in interpret mode, forward and vjp, on inputs made with numpy from a
seed.  In fp16 the JAX kernels round p to fp16 before ``P V`` and write
fp16 outputs and gradients; the plain versions sum in fp32 and round
the outputs.  Tolerances: fp16 within 2e-3 relative and absolute on
outputs and 4e-3 on gradients (a few fp16 ulps: 2^-11 of the value; the
bf16 bound elsewhere is 5e-2 x max(|ref|, 1)); head dims 16 and 32 in
fp32 at the JAX package's own 2e-4 / 2e-5 on outputs and 5e-4 / 5e-5
on gradients.  The head-packed ``[B*H, S, D]`` path runs with the JAX
and port knobs set side by side (``PADDLE_TPU_FLASH_*`` /
``PADDLE_TORCH_FLASH_*``), 128-row JAX blocks at S=256.

Paged decode attention at Dh = 16 (gpt_tiny's head dim) against the
JAX Pallas kernel in interpret mode, fp32 at 2e-6 (the reference's own
bound), and fp16 inputs against the JAX kernel on the same fp16 values
within 2e-3.

The ``cuda``-marked tests run the card kernels at these dtypes and head
dims against their plain versions and skip without a card.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.inference.serving.paged_attention_kernel import (
    paged_ragged_attention as jax_paged_ragged_attention)
from paddle_tpu.ops import pallas_ops

from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
from paddle_tpu_torch.nn.functional import flash_attention
from paddle_tpu_torch.ops import flash_attention_kernel as fk

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
FP16_OUT_TOL = dict(rtol=2e-3, atol=2e-3)
FP16_GRAD_TOL = dict(rtol=4e-3, atol=4e-3)
PAGED_TOL = 2e-6
PAGED_FP16_TOL = 2e-3
CARD_TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
KNOBS = ("NO_PACKED", "HEADPACK", "FUSED_BWD")


@pytest.fixture()
def interpret(monkeypatch):
    """JAX kernels in interpret mode over 128-row blocks, no knob set;
    the one-time kernel probe taken eagerly so it cannot fail inside a
    trace."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_FLASH_BQ", "128")
    monkeypatch.setenv("PADDLE_TPU_FLASH_BK", "128")
    for name in KNOBS:
        for prefix in ("PADDLE_TPU_FLASH_", "PADDLE_TORCH_FLASH_"):
            monkeypatch.delenv(prefix + name, raising=False)
    pallas_ops._PALLAS_HEALTH.pop("ok", None)
    assert pallas_ops._pallas_healthy()


def _bh_knobs(monkeypatch, hp):
    """The ``[B*H, S, D]`` path with head packing and the fused backward,
    in both packages."""
    for prefix in ("PADDLE_TPU_FLASH_", "PADDLE_TORCH_FLASH_"):
        monkeypatch.setenv(prefix + "NO_PACKED", "1")
        monkeypatch.setenv(prefix + "HEADPACK", str(hp))
        monkeypatch.setenv(prefix + "FUSED_BWD", "1")


def _inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    q, k, v = [(rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
               for _ in range(3)]
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, g


def _jax(q, k, v, g, causal, dtype):
    def f(q_, k_, v_):
        return pallas_ops.flash_attention.raw(q_, k_, v_, causal=causal)
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g).astype(dtype))
    assert out.dtype == dtype and all(x.dtype == dtype for x in grads)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(x.astype(jnp.float32)) for x in grads])


def _port(q, k, v, g, causal, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    fk.reset_counts()
    out, _ = flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(g).to(dtype))
    assert out.dtype == dtype and all(t.grad.dtype == dtype for t in ts)
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in ts])


def _compare(inputs, causal, torch_dtype, jax_dtype, out_tol, grad_tol):
    q, k, v, g = inputs
    ref, rgrads = _jax(q, k, v, g, causal, jax_dtype)
    out, grads = _port(q, k, v, g, causal, torch_dtype)
    np.testing.assert_allclose(out, ref, **out_tol)
    for name, a, b in zip("qkv", grads, rgrads):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **grad_tol)


# ---------------------------------------------------------------------------
# fp16 flash attention against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,causal", [((1, 128, 2, 64), True),
                                          ((2, 128, 4, 64), True),
                                          ((2, 128, 4, 64), False)])
def test_fp16_flash_matches_jax_interpret(interpret, shape, causal):
    _compare(_inputs(20, *shape), causal, torch.float16, jnp.float16,
             FP16_OUT_TOL, FP16_GRAD_TOL)
    assert fk.flash_fwd.plain_calls == 1


def test_fp16_head_packed_fused_path_matches_jax(interpret, monkeypatch):
    _bh_knobs(monkeypatch, 2)
    _compare(_inputs(21, 2, 256, 4, 64), True, torch.float16, jnp.float16,
             FP16_OUT_TOL, FP16_GRAD_TOL)
    assert fk.flash_fwd_hpack.plain_calls == 1
    assert fk.flash_bwd_fused.plain_calls == 1


# ---------------------------------------------------------------------------
# head dims 16 and 32 against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_small_head_dims_match_jax_interpret(interpret, d, causal):
    _compare(_inputs(22, 2, 256, 4, d), causal, torch.float32, jnp.float32,
             OUT_TOL, GRAD_TOL)
    assert fk.flash_fwd.plain_calls == 1


@pytest.mark.parametrize("d,hp", [(16, 2), (32, 4)])
def test_small_head_dims_head_packed_match_jax(interpret, monkeypatch, d,
                                               hp):
    _bh_knobs(monkeypatch, hp)
    _compare(_inputs(23, 2, 256, 4, d), True, torch.float32, jnp.float32,
             OUT_TOL, GRAD_TOL)
    assert fk.flash_fwd_hpack.plain_calls == 1


def test_fp16_head_dim_16_matches_jax(interpret):
    _compare(_inputs(24, 2, 128, 4, 16), True, torch.float16, jnp.float16,
             FP16_OUT_TOL, FP16_GRAD_TOL)


# ---------------------------------------------------------------------------
# paged decode attention at Dh = 16, fp32 and fp16
# ---------------------------------------------------------------------------
def _paged_case(seed, Dh=16, B=4, H=2, BS=4, NB=12, MAXNB=4,
                lengths=(0, 1, 4, 9)):
    rng = np.random.RandomState(seed)
    pool_k = rng.randn(NB, BS, H, Dh).astype(np.float32)
    pool_v = rng.randn(NB, BS, H, Dh).astype(np.float32)
    q = rng.randn(B, H, Dh).astype(np.float32)
    table = np.zeros((B, MAXNB), dtype=np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for b, n in enumerate(lengths):
        for j in range(-(-n // BS)):
            table[b, j] = free.pop()
    return pool_k, pool_v, table, np.asarray(lengths, np.int32), q


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, PAGED_TOL),
    (torch.float16, jnp.float16, PAGED_FP16_TOL)])
def test_paged_head_dim_16_matches_jax_kernel(dtype, jdtype, tol):
    pool_k, pool_v, table, lengths, q = _paged_case(30)
    ref = jax_paged_ragged_attention(
        *[jnp.asarray(a).astype(jdtype) for a in (pool_k, pool_v)],
        jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(q).astype(jdtype), interpret=True)
    out = pak.paged_ragged_attention(
        *[torch.from_numpy(a).to(dtype) for a in (pool_k, pool_v)],
        torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(q).to(dtype))
    assert out.dtype == dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert (out[0] == 0).all()


def test_paged_wrapper_takes_multiples_of_16(monkeypatch):
    """On the card Dh = 16 and 48 reach the kernel (lane groups of 2 and
    8 in fp16); Dh = 40 and 272 still raise before any launch."""
    calls = []

    class FakeLib:
        def paddle_paged_attention_sm90(self, *args):
            calls.append(pak.Launch.from_address(args[0]).Dh)
            return 0
    monkeypatch.setattr(pak, "_lib", lambda name: FakeLib())
    monkeypatch.setattr(pak, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    for Dh in (16, 48, 40, 272):
        pool = torch.zeros((4, 4, 2, Dh), dtype=torch.float16)
        args = (pool, pool, torch.zeros((2, 2), dtype=torch.int32),
                torch.ones(2, dtype=torch.int32),
                torch.zeros((2, 2, Dh), dtype=torch.float16))
        if Dh in (40, 272):
            with pytest.raises(ValueError, match="multiple of 16"):
                pak.paged_ragged_attention(*args)
        else:
            pak.paged_ragged_attention(*args)
    assert calls == [16, 48]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# on the card: the kernels at these dtypes and head dims
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_close(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_card_flash_kernels_match_plain(cuda_device, dtype, d):
    q, k, v, g = [torch.from_numpy(a).to(cuda_device).to(dtype)
                  for a in _inputs(25, 2, 200, 4, d)]
    tol = CARD_TOLS[dtype]
    fk.reset_counts()
    out, lse = fk.flash_fwd(q, k, v, True)
    assert fk.flash_fwd.tc_launches == int(dtype != torch.float32
                                           and d == 64)
    ref = fk.flash_fwd_tc_reference(q, k, v, True)
    _card_close(out, ref[0], tol)
    _card_close(lse, ref[1], tol)
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, True)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, True)
    rdq, _ = fk.flash_bwd_dq_reference(q, k, v, out, lse, g, True)
    rdk, rdv = fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta, True)
    for got, r in ((dq, rdq), (dk, rdk), (dv, rdv)):
        _card_close(got, r, tol)
    fused = fk.flash_bwd_fused(q, k, v, out, lse, g, True)
    for got, r in zip(fused, fk.flash_bwd_fused_reference(
            q, k, v, out, lse, g, True)):
        _card_close(got, r, tol)
    qb, kb, vb = [t.permute(0, 2, 1, 3).reshape(8, 200, 1, d).contiguous()
                  for t in (q, k, v)]
    rb = fk.flash_fwd_tc_reference(qb, kb, vb, True)
    for hp in (2, 4):
        o, l = fk.flash_fwd_hpack(qb, kb, vb, hp, True)
        _card_close(o, rb[0], tol)
        _card_close(l, rb[1], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("Dh", [16, 48, 64])
def test_card_paged_kernel_matches_plain(cuda_device, dtype, Dh):
    pool_k, pool_v, table, lengths, q = _paged_case(31, Dh=Dh)
    dev = cuda_device
    args = [torch.from_numpy(a).to(dev) for a in (pool_k, pool_v, table,
                                                   lengths, q)]
    args[0], args[1], args[4] = [args[i].to(dtype) for i in (0, 1, 4)]
    out = pak.paged_ragged_attention(*args)
    ref = pak.paged_ragged_attention_reference(
        args[0].float(), args[1].float(), args[2], args[3],
        args[4].float(), scale=1.0 / math.sqrt(Dh))
    torch.cuda.synchronize()
    assert out.dtype == dtype
    _card_close(out, ref, 1e-5 if dtype == torch.float32 else
                CARD_TOLS[dtype])
    assert (out[0] == 0).all()
