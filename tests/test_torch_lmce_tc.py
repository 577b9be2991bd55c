"""The fused lm-head cross-entropy in fp16, and the tensor-core backward
(``csrc/lmce_sm90.cu``): the port's plain versions against the JAX
package in fp16, the wrappers' routing, and on the card the
tensor-core kernels against the plain versions.

The JAX side runs ``pallas_lmce._call_fwd`` / ``_call_bwd`` in interpret
mode on fp16 operands (the Pallas kernels take any dtype: dL is rounded
to the operand dtype, dh and dW come out in it).  Inputs are numpy
arrays from a seed.  Tolerances: the loss and lse within 2e-3 (fp32
statistics of fp16 logits summed in another order), dh and dW within
1e-2 (fp16 outputs: one fp16 ulp is 2^-11 of the value, and the two
sides round dL at slightly different values); the bf16 bound of
``test_torch_lmce.py`` is 3e-2.

The routing tests run on the CPU with the launch helpers replaced: on
the card bf16 and fp16 go to the tensor-core entries, fp32 to the
CUDA-core ones, a D that breaks TMA's 16-byte row rule raises before
any launch, a failing tensor-core launch raises, and nothing falls
back.  The card's gate (``chip_smoke.lmce_grad_gate``: each element
within one ulp of the value plus the bound of rounding each dL once,
``(u |dL| + eta) @ |B|``) is checked here to pass the plain gradient
summed in another order and to fail the gradient of a backward without
the S product.  The ``cuda``-marked tests need a
card (the kernels are inline PTX with ``wgmma`` and TMA, which the CPU
emulation in ``tests/cuda_emu`` does not run) and skip without one;
they hold the kernels with that gate.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_lmce as L

from paddle_tpu_torch.ops import lmce_kernel as lk
from torch_parity_helpers import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the card's gate, held here too)

LOSS_TOL = dict(rtol=2e-3, atol=2e-3)
FP16_GRAD_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _inputs(n, v, d, seed, ignore=False):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(v, d) * 0.05).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    if ignore:
        labels[::4] = -100
        labels[1] = -1
    g = rng.rand(n).astype(np.float32)
    return h, w, labels, g


# ---------------------------------------------------------------------------
# fp16: the plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,v,d,ignore", [
    (128, 256, 128, False),   # exact blocks
    (100, 700, 64, True),     # row pad, vocab mask, ignored labels
])
def test_fp16_operands_match_jax_kernel(n, v, d, ignore):
    h, w, labels, g = _inputs(n, v, d, 11, ignore)
    jh = jnp.asarray(h).astype(jnp.float16)
    jw = jnp.asarray(w).astype(jnp.float16)
    jl = jnp.asarray(labels)
    jloss, jlse = L._call_fwd(jh, jw, jl)
    jdh, jdw = L._call_bwd(jh, jw, jl, jlse, jnp.asarray(g))
    assert jdh.dtype == jdw.dtype == jnp.float16
    th = torch.from_numpy(h).half()
    tw = torch.from_numpy(w).half()
    tl, tg = torch.from_numpy(labels), torch.from_numpy(g)
    loss, lse = lk.lmce_fwd(th, tw, tl)
    dh = lk.lmce_bwd_dh(th, tw, tl, lse, tg)
    dw = lk.lmce_bwd_dw(th, tw, tl, lse, tg)
    assert loss.dtype == lse.dtype == torch.float32
    assert dh.dtype == dw.dtype == torch.float16
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **LOSS_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:n, 0],
                               **LOSS_TOL)
    for got, ref in ((dh, jdh), (dw, jdw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **FP16_GRAD_TOL)
    if ignore:
        assert (dh[torch.from_numpy(labels) < 0] == 0).all()


# ---------------------------------------------------------------------------
# routing, with the launch helpers replaced
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_card(monkeypatch):
    """Tensors report a CUDA device and every backward launch helper
    records its call instead of launching; returns the list of calls."""
    calls = []

    def recorder(name):
        def launch(lib, stream, h, w, *args):
            calls.append((name, lib))
            like = h if "_dh" in name else w
            return torch.zeros(like.shape, dtype=like.dtype)
        return launch

    for name in ("_launch_bwd_dh", "_launch_bwd_dw", "_launch_bwd_dh_tc",
                 "_launch_bwd_dw_tc"):
        monkeypatch.setattr(lk, name, recorder(name))
    monkeypatch.setattr(lk, "_kernel", lambda: "lmce")
    monkeypatch.setattr(lk, "_tc_kernel", lambda: "lmce_sm90")
    monkeypatch.setattr(lk, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    lk.reset_counts()
    yield calls
    lk.reset_counts()


def _args(dtype, n=8, v=24, d=64):
    return (torch.zeros((n, d), dtype=dtype), torch.zeros((v, d), dtype=dtype),
            torch.zeros(n, dtype=torch.int32), torch.zeros(n),
            torch.ones(n))


@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, True),
                                      (torch.float16, True),
                                      (torch.float32, False)])
def test_backward_routes_by_dtype(fake_card, dtype, tc):
    """bf16 and fp16 reach the tensor-core entries, fp32 the CUDA-core
    ones (the fp32 parity gates need fp32 sums, not TF32)."""
    dh = lk.lmce_bwd_dh(*_args(dtype))
    dw = lk.lmce_bwd_dw(*_args(dtype))
    suffix, lib = ("_tc", "lmce_sm90") if tc else ("", "lmce")
    assert fake_card == [(f"_launch_bwd_dh{suffix}", lib),
                         (f"_launch_bwd_dw{suffix}", lib)]
    assert dh.shape == (8, 64) and dw.shape == (24, 64)
    assert dh.dtype == dw.dtype == dtype
    for fn in (lk.lmce_bwd_dh, lk.lmce_bwd_dw):
        assert (fn.launches, fn.tc_launches, fn.plain_calls) == (1, int(tc),
                                                                 0)
    assert lk._cuda_core_bwd.launches == 0


def test_tma_rule_raises_before_any_launch(fake_card):
    """A 16-bit D whose rows are not a multiple of 16 bytes apart (D = 100:
    200 bytes) raises before any launch; nothing falls back.  The rule is
    the one every lmce kernel keeps, D a multiple of 8, which at 2 bytes
    an element is TMA's."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for fn in (lk.lmce_bwd_dh, lk.lmce_bwd_dw):
            with pytest.raises(NotImplementedError,
                               match="multiple of 8.*16-byte row stride"):
                fn(*_args(dtype, d=100))
    assert fake_card == []
    for fn in (lk.lmce_bwd_dh, lk.lmce_bwd_dw):
        assert (fn.launches, fn.tc_launches, fn.plain_calls) == (0, 0, 0)


def test_misaligned_operands_reach_the_kernel_as_aligned_copies(fake_card,
                                                              monkeypatch):
    """TMA needs 16-byte-aligned bases: a view 8 bytes into its storage
    is copied before the launch, never handed over as it is."""
    seen = []

    def launch(lib, stream, h, w, *args):
        seen.append((h.data_ptr() % 16, w.data_ptr() % 16,
                     h.is_contiguous()))
        return torch.zeros(h.shape, dtype=h.dtype)
    monkeypatch.setattr(lk, "_launch_bwd_dh_tc", launch)
    h = torch.zeros(8 * 64 + 4, dtype=torch.bfloat16)[4:].view(8, 64)
    assert h.data_ptr() % 16
    _, w, labels, lse, g = _args(torch.bfloat16)
    lk.lmce_bwd_dh(h, w, labels, lse, g)
    assert seen == [(0, 0, True)]


def test_a_failing_tensor_core_launch_raises(fake_card, monkeypatch):
    def refused(*args):
        raise RuntimeError("lmce_bwd_dh_tc kernel launch failed: the driver "
                           "refused a tensor map")
    monkeypatch.setattr(lk, "_launch_bwd_dh_tc", refused)
    with pytest.raises(RuntimeError, match="tensor map"):
        lk.lmce_bwd_dh(*_args(torch.bfloat16))
    assert fake_card == []
    assert (lk.lmce_bwd_dh.launches, lk.lmce_bwd_dh.tc_launches,
            lk.lmce_bwd_dh.plain_calls) == (0, 0, 0)


def test_cuda_core_comparison_backward_counts_apart(fake_card):
    lk._cuda_core_bwd("dh", *_args(torch.bfloat16))
    lk._cuda_core_bwd("dw", *_args(torch.float16))
    assert fake_card == [("_launch_bwd_dh", "lmce"),
                         ("_launch_bwd_dw", "lmce")]
    assert lk._cuda_core_bwd.launches == 2
    assert all(fn.launches == 0 for fn in lk.WRAPPERS)


def test_raise_on_names_the_tensor_map_errors():
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        lk._raise_on(-1, "lmce_bwd_dw_tc")
    with pytest.raises(RuntimeError, match="refused a tensor map"):
        lk._raise_on(-2, "lmce_bwd_dw_tc")
    with pytest.raises(RuntimeError, match="cudaError 1"):
        lk._raise_on(1, "lmce_bwd_dw_tc")
    lk._raise_on(0, "lmce_bwd_dw_tc")


def _reordered(which, h, w, labels, lse, g):
    """The plain gradient with dL rounded alike but the contraction over
    the vocabulary (dh) or the tokens (dW) summed in another order, as
    the kernel sums: 64-wide chunks, last chunk first."""
    dl = lk._dlogits(h, w, labels, lse, g, h.dtype)
    a, b = (dl, w.float()) if which == "dh" else (dl.t(), h.float())
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in reversed(range(0, a.shape[1], 64)):
        out += a[:, k0:k0 + 64] @ b[k0:k0 + 64]
    return out.to(h.dtype)


@pytest.mark.parametrize("which", ["dh", "dw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_card_gate_passes_reordered_sums_and_fails_without_s(dtype, which):
    """``chip_smoke.lmce_grad_gate`` passes the plain gradient summed in
    another order (what a right kernel differs by) and fails the
    gradient of a backward that drops the S product (p = exp(-lse)),
    whose error lies in the softmax part, ~1e-2 of the one-hot part."""
    h, w, labels, g = [torch.from_numpy(a)
                       for a in _inputs(256, 2048, 128, 13, ignore=True)]
    h, w = h.to(dtype), w.to(dtype)
    _, lse = lk.lmce_reference(h, w, labels)
    plain = lk.lmce_bwd_dh_reference if which == "dh" else \
        lk.lmce_bwd_dw_reference
    ref = plain(h, w, labels, lse, g)
    args = (h, w, labels, lse, g)
    _, ratio = chip_smoke.lmce_grad_gate(
        torch, lk, which, _reordered(which, *args), ref, *args)
    assert ratio <= 1.0
    s_free = chip_smoke.lmce_s_free(torch, which, *args)
    _, ratio = chip_smoke.lmce_grad_gate(torch, lk, which, s_free, ref,
                                         *args)
    assert ratio > 10.0
    # the gate it replaced, 2e-2 x max(|ref|, 1), passes the S-free one
    err = (s_free.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.float().abs().max().item())


# ---------------------------------------------------------------------------
# on the card: the tensor-core kernels against the plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the tensor-core lmce backward is "
                    "wgmma and TMA, which have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,v,d", [(333, 786, 200), (1000, 1000, 64),
                                   (300, 1000, 2048), (512, 4096, 768)])
def test_tensor_core_backward_matches_plain_and_repeats(cuda_device, dtype,
                                                        n, v, d):
    h, w, labels, g = [torch.from_numpy(a).to(cuda_device)
                       for a in _inputs(n, v, d, 12, ignore=True)]
    h, w = h.to(dtype), w.to(dtype)
    _, lse = lk.lmce_reference(h, w, labels)
    lk.reset_counts()
    dh = lk.lmce_bwd_dh(h, w, labels, lse, g)
    dw = lk.lmce_bwd_dw(h, w, labels, lse, g)
    assert [f.tc_launches for f in (lk.lmce_bwd_dh, lk.lmce_bwd_dw)] == \
        [1, 1]
    again = (lk.lmce_bwd_dh(h, w, labels, lse, g),
             lk.lmce_bwd_dw(h, w, labels, lse, g))
    rdh = lk.lmce_bwd_dh_reference(h, w, labels, lse, g)
    rdw = lk.lmce_bwd_dw_reference(h, w, labels, lse, g)
    torch.cuda.synchronize()
    for which, got, ref in (("dh", dh, rdh), ("dw", dw, rdw)):
        assert got.dtype == dtype
        assert chip_smoke.lmce_grad_gate(torch, lk, which, got, ref, h, w,
                                         labels, lse, g)[1] <= 1.0
    assert torch.equal(dh, again[0]) and torch.equal(dw, again[1])
    assert (dh[labels < 0] == 0).all()
