"""Flash attention of the PyTorch port against the JAX package.

The port's ``flash_attention`` on CPU tensors runs ``FlashAttnFunc``
through the three kernel wrappers' plain versions; the JAX side runs
its Pallas kernels in interpret mode (``PADDLE_TPU_PALLAS_INTERPRET=1``,
as ``tests/test_flash_attention.py`` does), which for GPT-like head
geometry is the packed layout K5/K6.  Inputs are numpy arrays from a
seed, at B=2, S=128/256, H=4, D=64.  Tolerances are the JAX package's
own for its kernels against the composed form: 2e-4 relative / 2e-5
absolute on outputs and 5e-4 / 5e-5 on gradients (fp32, blockwise
online softmax vs whole-row sums).  The CUDA kernels are held against
the same plain versions on the card by the ``cuda``-marked tests, which
skip without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import pallas_ops

from paddle_tpu_torch import _build
from paddle_tpu_torch.nn.functional import flash_attention
from paddle_tpu_torch.ops import flash_attention_kernel as fk

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(seed, b=2, sq=128, sk=None, h=4, hkv=None, d=64):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    hkv = hkv or h
    q = (rng.standard_normal((b, sq, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, sk, hkv, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, sk, hkv, d)) * 0.5).astype(np.float32)
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, g


def _jax(q, k, v, g, causal, qseg=None, kseg=None):
    """JAX forward and vjp through the public op's raw function."""
    def f(q_, k_, v_):
        return pallas_ops.flash_attention.raw(
            q_, k_, v_, causal=causal, segment_ids=qseg,
            kv_segment_ids=kseg)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port(q, k, v, g, causal, qseg=None, kseg=None):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out, none = flash_attention(
        *ts, causal=causal,
        segment_ids=None if qseg is None else torch.from_numpy(qseg),
        kv_segment_ids=None if kseg is None else torch.from_numpy(kseg))
    assert none is None
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _compare(q, k, v, g, causal, qseg=None, kseg=None):
    ref, rgrads = _jax(q, k, v, g, causal, qseg, kseg)
    out, grads = _port(q, k, v, g, causal, qseg, kseg)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **OUT_TOL)
    for name, a, b in zip("qkv", grads, rgrads):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)
    return out, grads


@pytest.mark.parametrize("s", [128, 256])
def test_causal_matches_jax_interpret(interpret, s):
    _compare(*_inputs(0, sq=s), causal=True)


def test_non_causal_sq_ne_sk_matches_jax_interpret(interpret):
    _compare(*_inputs(1, sq=128, sk=256), causal=False)


def test_gqa_matches_jax_interpret(interpret):
    _compare(*_inputs(2, sq=128, hkv=2), causal=True)


def test_segment_ids_match_jax_interpret(interpret):
    q, k, v, g = _inputs(3, sq=256)
    seg = np.repeat(np.arange(4, dtype=np.int32), 64)[None].repeat(2, 0)
    seg[1] = np.repeat(np.array([0, 1], np.int32), 128)
    _compare(q, k, v, g, True, seg, seg)


def test_fully_masked_row_gives_zero_not_nan(interpret):
    """Query rows whose segment matches no key see nothing: output 0,
    gradients 0, nothing NaN, in both packages."""
    q, k, v, g = _inputs(4, sq=128, sk=256)
    qseg = np.zeros((2, 128), np.int32)
    qseg[:, :3] = 9                       # no key carries segment 9
    kseg = np.zeros((2, 256), np.int32)
    kseg[:, 200:] = 1
    out, grads = _compare(q, k, v, g, False, qseg, kseg)
    assert np.isfinite(out).all() and all(np.isfinite(x).all()
                                          for x in grads)
    assert (out[:, :3] == 0).all() and (grads[0][:, :3] == 0).all()
    _, lse = fk.flash_fwd(*[torch.from_numpy(a) for a in (q, k, v)], False,
                          torch.from_numpy(qseg), torch.from_numpy(kseg))
    assert (lse[:, :, :3] == fk.LSE_FLOOR).all()


def test_backward_wrappers_equal_autograd_of_the_composed_form():
    """The plain versions of the dq and dk/dv kernels (explicit
    formulas) against torch autograd through the composed forward."""
    q, k, v, g = [torch.from_numpy(a) for a in _inputs(5, sq=96, sk=160)]
    qseg = torch.zeros((2, 96), dtype=torch.int32)
    qseg[:, 50:] = 1
    kseg = torch.zeros((2, 160), dtype=torch.int32)
    kseg[:, 70:] = 1
    out, lse = fk.flash_fwd(q, k, v, False, qseg, kseg)
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, False, qseg, kseg)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, False, qseg, kseg)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = fk.flash_attention_reference(*leaves, False, qseg, kseg)
    ref.backward(g)
    for a, b in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(a, b.grad, rtol=1e-5, atol=1e-6)


def test_strided_qkv_views_need_no_copy_and_match_contiguous():
    """GPT hands in q/k/v as slices of the fused projection."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3, 2, 64))
                           .astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    a, la = fk.flash_fwd(q, k, v, True)
    b, lb = fk.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                         True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)


def test_dropout_uses_the_given_generator():
    q, k, v, _ = [torch.from_numpy(a) for a in _inputs(7, sq=32, d=64)]

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return flash_attention(q, k, v, dropout=0.5, causal=True,
                               generator=gen)[0]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    eval_out = flash_attention(q, k, v, dropout=0.5, causal=True,
                               training=False)[0]
    torch.testing.assert_close(
        eval_out, flash_attention(q, k, v, causal=True)[0], rtol=0, atol=0)


def test_cpu_tensors_launch_nothing_and_bad_calls_raise():
    q, k, v, g = [torch.from_numpy(a) for a in _inputs(8, sq=16)]
    fk.reset_counts()
    flash_attention(q, k, v, causal=True)
    assert [f.launches for f in fk.WRAPPERS] == [0, 0, 0]
    assert fk.flash_fwd.plain_calls == 1
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k[:, :8], v[:, :8], causal=True)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, k[:, :, :3], v[:, :, :3])
    with pytest.raises(TypeError):
        fk.flash_fwd(q, k.double(), v, True)


def test_cuda_wrapper_propagates_a_build_failure(monkeypatch):
    """A CUDA tensor never falls back to the plain version: a kernel
    that cannot be built raises KernelBuildError out of the wrapper."""
    def broken(name):
        raise _build.KernelBuildError("nvcc refused the source")
    monkeypatch.setattr(fk, "_lib", None)
    monkeypatch.setattr(_build, "load", broken)
    q = torch.empty((1, 8, 1, 64))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    before = fk.flash_fwd.plain_calls
    with pytest.raises(_build.KernelBuildError):
        fk.flash_fwd(q, q, q, True)
    assert fk.flash_fwd.plain_calls == before


def test_cuda_wrapper_rejects_other_head_dims(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    q = torch.empty((1, 8, 1, 32))
    with pytest.raises(NotImplementedError, match="head dim"):
        fk.flash_fwd(q, q, q, True)


def test_kernel_work_counts_the_causal_triangle():
    flops, nbytes = fk.kernel_work("flash_fwd", 8, 12, 1024, 1024, 64, True,
                                   2)
    pairs = 8 * 12 * 1024 * 1025 // 2
    assert flops == 4 * 64 * pairs
    assert nbytes == 4 * 8 * 1024 * 12 * 64 * 2 + 8 * 12 * 1024 * 4
    assert fk.kernel_work("flash_bwd_dkv", 1, 1, 4, 6, 64, False, 4)[0] \
        == 8 * 64 * 24


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,causal", [
    ((2, 200, 3, 64, 200), True),
    ((1, 96, 2, 128, 160), False),
])
def test_cuda_kernels_match_plain(cuda_device, dtype, tol, shape, causal):
    B, Sq, H, D, Sk = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(dtype)

    q, k, v, g = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D), \
        rnd(B, Sq, H, D)
    fk.reset_counts()
    out, lse = fk.flash_fwd(q, k, v, causal)
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    assert [f.launches for f in fk.WRAPPERS] == [1, 1, 1]
    f32 = [t.float() for t in (q, k, v, g)]
    rout, rlse = fk.flash_attention_reference(*f32[:3], causal)
    rdq, rdelta = fk.flash_bwd_dq_reference(*f32[:3], out.float(), lse,
                                            f32[3], causal)
    rdk, rdv = fk.flash_bwd_dkv_reference(*f32[:3], f32[3], lse, delta,
                                          causal)
    torch.cuda.synchronize()
    for got, ref in ((out, rout), (lse, rlse), (delta, rdelta), (dq, rdq),
                     (dk, rdk), (dv, rdv)):
        err = (got.float() - ref).abs().max().item()
        assert err <= tol * max(1.0, ref.abs().max().item()), err
