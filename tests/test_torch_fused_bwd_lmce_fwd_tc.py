"""The tensor-core fused flash backward (``flash_bwd_fused_tc`` in
``csrc/flash_bwd_sm90.cu``) and the tensor-core lm-head cross-entropy
forward (``lmce_fwd_tc`` in ``csrc/lmce_fwd_sm90.cu``): their routing,
the forward's vocabulary split and partial-combine, and on the card both
kernels against their plain versions.

The routing tests run on the CPU with the launch helpers replaced:
bf16 and fp16 at head dims 64 and 128 send ``flash_bwd_fused`` to the
tensor-core sweep, fp32 and head dims 16 and 32 to the CUDA-core one;
bf16 and fp16 send ``lmce_fwd`` to the tensor-core forward and fp32 to
the CUDA-core one.  TMA's 16-byte rule raises before any launch, a
failing tensor-core launch raises, nothing falls back, and the card's
comparison entries count apart from the wrappers.

The tensor-core forward splits the vocabulary into runs of 64-row tiles
and merges per-slice partials (max, sum-exp, picked logit) in slice
order.  Its plain mirror (``lmce_fwd_split_reference``) is held against
a combine written here in numpy, against ``lmce_reference`` and against
the JAX ``_call_fwd`` in interpret mode at small N, V and D with a
ragged V and ignored labels, within 1e-5 (fp32 statistics; the slices
only reorder the sum-exp).  ``chip_smoke.lmce_fwd_gate``, the card's
per-row gate for the forward, passes the mirror and fails the three
broken forwards the card's controls use: the ragged vocabulary edge
dropped, the label column off by one, one slice's partial left out of
the combine.  The ``cuda``-marked tests need a card (the kernels are
inline PTX with ``wgmma`` and TMA, which ``tests/cuda_emu`` does not run)
and skip without one.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_lmce as L

from paddle_tpu_torch.ops import flash_attention_kernel as fk
from paddle_tpu_torch.ops import lmce_kernel as lk
from torch_parity_helpers import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the card's gates, held here too)

FUSED_LAUNCHERS = ("_launch_bwd_fused", "_launch_bwd_fused_tc")
FWD_LAUNCHERS = ("_launch_fwd", "_launch_fwd_tc")


# ---------------------------------------------------------------------------
# routing, with the launch helpers replaced
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_card(monkeypatch):
    """Tensors report a CUDA device and the fused backward's and the
    lmce forward's launch helpers record their calls instead of
    launching; returns the list of calls."""
    calls = []

    def fused(name):
        def launch(lib, stream, q, k, v, *args):
            calls.append((name, lib))
            return (torch.zeros(q.shape, dtype=q.dtype),
                    torch.zeros(k.shape, dtype=k.dtype),
                    torch.zeros(v.shape, dtype=v.dtype))
        return launch

    def fwd(name):
        def launch(lib, stream, h, w, labels):
            calls.append((name, lib))
            return torch.zeros(h.shape[0]), torch.zeros(h.shape[0])
        return launch

    for name in FUSED_LAUNCHERS:
        monkeypatch.setattr(fk, name, fused(name))
    for name in FWD_LAUNCHERS:
        monkeypatch.setattr(lk, name, fwd(name))
    monkeypatch.setattr(fk, "_kernel", lambda: "flash_attention")
    monkeypatch.setattr(fk, "_bwd_tc_kernel", lambda: "flash_bwd_sm90")
    monkeypatch.setattr(lk, "_kernel", lambda: "lmce")
    monkeypatch.setattr(lk, "_fwd_tc_kernel", lambda: "lmce_fwd_sm90")
    for mod in (fk, lk):
        monkeypatch.setattr(mod, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    fk.reset_counts()
    lk.reset_counts()
    yield calls
    fk.reset_counts()
    lk.reset_counts()


def _fused_args(dtype, shape=(1, 8, 2, 64)):
    """``(q, k, v, out, lse, dout)`` of ``shape``."""
    b, s, h, _ = shape
    t = [torch.zeros(shape, dtype=dtype) for _ in range(5)]
    return t[0], t[1], t[2], t[3], torch.zeros(b, h, s), t[4]


def _helpers():
    return dict(fk.flash_bwd_fused.helper_launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_16bit_fused_backward_runs_the_tensor_core_sweep(fake_card, dtype,
                                                         d):
    dq, dk, dv = fk.flash_bwd_fused(*_fused_args(dtype, (1, 8, 2, d)), True)
    assert fake_card == [("_launch_bwd_fused_tc", "flash_bwd_sm90")]
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    fn = fk.flash_bwd_fused
    assert (fn.launches, fn.tc_launches, fn.plain_calls) == (1, 1, 0)
    assert _helpers() == {"flash_bwd_fused_prep": 1,
                          "flash_bwd_fused_dq_cast": 1}
    assert fk._cuda_core_flash_bwd.launches == 0


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 64), (torch.float32, 128), (torch.float32, 16),
    (torch.float32, 32), (torch.bfloat16, 16), (torch.bfloat16, 32),
    (torch.float16, 16), (torch.float16, 32)])
def test_fp32_and_small_head_dims_run_the_cuda_core_sweep(fake_card, dtype,
                                                          d):
    """fp32 (the parity gates' 1e-4 needs fp32 sums) and head dims 16 and
    32 in every dtype run the CUDA-core sweep, chosen before any launch;
    fp32 has no dq cast (its workspace is dq)."""
    fk.flash_bwd_fused(*_fused_args(dtype, (1, 8, 2, d)), False)
    assert fake_card == [("_launch_bwd_fused", "flash_attention")]
    fn = fk.flash_bwd_fused
    assert (fn.launches, fn.tc_launches, fn.plain_calls) == (1, 0, 0)
    assert _helpers() == {"flash_bwd_fused_prep": 1,
                          "flash_bwd_fused_dq_cast":
                              int(dtype != torch.float32)}


def _misaligned(dtype):
    """A ``[1, 8, 2, 64]`` view whose base address is 8 bytes in."""
    flat = torch.zeros(8 * 2 * 64 + 4, dtype=dtype)
    return flat[4:].view(1, 8, 2, 64)


@pytest.mark.parametrize("which", ["q", "k", "v", "out", "dout"])
def test_fused_tma_rule_raises_before_any_launch(fake_card, which):
    """The tensor-core sweep reads q, k, v and dout through TMA (and its
    pre-pass reads out): a base address that is not a multiple of 16
    bytes raises, nothing launches and nothing falls back; fp32 (the
    CUDA-core sweep) has no such rule."""
    names = ("q", "k", "v", "out", "lse", "dout")
    args = dict(zip(names, _fused_args(torch.bfloat16)))
    args[which] = _misaligned(torch.bfloat16)
    with pytest.raises(NotImplementedError, match=f"{which}.*16 bytes"):
        fk.flash_bwd_fused(*args.values(), True)
    assert fake_card == []
    assert fk.flash_bwd_fused.launches == 0
    assert _helpers() == {"flash_bwd_fused_prep": 0,
                          "flash_bwd_fused_dq_cast": 0}
    args = {n: (t.float() if n != "lse" else t) for n, t in args.items()}
    args[which] = _misaligned(torch.float32)
    fk.flash_bwd_fused(*args.values(), True)
    assert fake_card == [("_launch_bwd_fused", "flash_attention")]


def test_fused_strided_head_dim_rule_is_the_wrappers(fake_card):
    """Head and sequence strides that are not multiples of 16 bytes
    (heads 65 elements apart) raise for the tensor-core sweep."""
    flat = torch.zeros(1, 8, 2 * 65, dtype=torch.bfloat16)
    bad = flat.as_strided((1, 8, 2, 64), (8 * 130, 130, 65, 1))
    q, k, v, out, lse, dout = _fused_args(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="q.*16 bytes"):
        fk.flash_bwd_fused(bad, k, v, out, lse, dout, True)
    assert fake_card == []


def test_a_failing_tensor_core_sweep_raises(fake_card, monkeypatch):
    def refused(*args):
        raise RuntimeError("flash_bwd_fused_tc kernel launch failed: the "
                           "driver refused a tensor map")
    monkeypatch.setattr(fk, "_launch_bwd_fused_tc", refused)
    with pytest.raises(RuntimeError, match="tensor map"):
        fk.flash_bwd_fused(*_fused_args(torch.bfloat16), True)
    assert fake_card == []
    fn = fk.flash_bwd_fused
    assert (fn.launches, fn.tc_launches, fn.plain_calls) == (0, 0, 0)
    assert fk._cuda_core_flash_bwd.launches == 0


def test_cuda_core_comparison_sweep_counts_apart(fake_card):
    """``_cuda_core_flash_bwd("fused", ...)`` runs the CUDA-core sweep in
    bf16 for the card's comparison; neither the wrapper's counts nor the
    helper counts move, and ``reset_counts`` zeroes its own."""
    fk._cuda_core_flash_bwd("fused", *_fused_args(torch.bfloat16), True)
    assert fake_card == [("_launch_bwd_fused", "flash_attention")]
    assert fk._cuda_core_flash_bwd.launches == 1
    assert all(fn.launches == 0 for fn in fk.ALL_WRAPPERS)
    assert fk.flash_bwd_fused.tc_launches == 0
    assert _helpers() == {"flash_bwd_fused_prep": 0,
                          "flash_bwd_fused_dq_cast": 0}
    fk.reset_counts()
    assert fk._cuda_core_flash_bwd.launches == 0


def test_fused_autograd_counts_on_the_tensor_core_sweep(fake_card,
                                                        monkeypatch):
    """``FlashAttnFunc`` with ``fused_bwd`` on 16-bit inputs counts its
    backward as a tensor-core launch, and ``reset_counts`` zeroes it."""
    monkeypatch.setattr(fk, "_launch_fwd_tc", lambda lib, st, q, *a: (
        torch.zeros(q.shape, dtype=q.dtype),
        torch.zeros(q.shape[0], q.shape[2], q.shape[1])))
    monkeypatch.setattr(fk, "_tc_kernel", lambda: "flash_fwd_sm90")
    q, k, v = [torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3)]
    out = fk.FlashAttnFunc.apply(q, k, v, True, None, None, 1, True)
    out.backward(torch.ones_like(out))
    assert fake_card == [("_launch_bwd_fused_tc", "flash_bwd_sm90")]
    assert fk.flash_bwd_fused in fk.TC_WRAPPERS
    assert fk.flash_bwd_fused.tc_launches == 1
    fk.reset_counts()
    assert [fn.tc_launches for fn in fk.TC_WRAPPERS] == [0] * 5


def _lmce_args(dtype, n=8, v=24, d=64):
    return (torch.zeros((n, d), dtype=dtype), torch.zeros((v, d), dtype=dtype),
            torch.zeros(n, dtype=torch.int32))


@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, True),
                                      (torch.float16, True),
                                      (torch.float32, False)])
def test_lmce_forward_routes_by_dtype(fake_card, dtype, tc):
    loss, lse = lk.lmce_fwd(*_lmce_args(dtype))
    assert fake_card == [("_launch_fwd_tc", "lmce_fwd_sm90") if tc else
                         ("_launch_fwd", "lmce")]
    assert loss.shape == lse.shape == (8,)
    fn = lk.lmce_fwd
    assert (fn.launches, fn.tc_launches, fn.plain_calls) == (1, int(tc), 0)
    assert lk._cuda_core_fwd.launches == 0


def test_lmce_forward_tma_rule_raises_before_any_launch(fake_card):
    """D = 100 (rows 200 bytes apart, not a multiple of 16) raises in
    every dtype before any launch; nothing falls back."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        with pytest.raises(NotImplementedError,
                           match="multiple of 8.*16-byte row stride"):
            lk.lmce_fwd(*_lmce_args(dtype, d=100))
    assert fake_card == []
    assert (lk.lmce_fwd.launches, lk.lmce_fwd.tc_launches) == (0, 0)


def test_lmce_forward_hands_the_kernel_aligned_copies(fake_card,
                                                      monkeypatch):
    seen = []

    def launch(lib, stream, h, w, labels):
        seen.append((h.data_ptr() % 16, w.data_ptr() % 16,
                     h.is_contiguous(), labels.dtype))
        return torch.zeros(h.shape[0]), torch.zeros(h.shape[0])
    monkeypatch.setattr(lk, "_launch_fwd_tc", launch)
    h = torch.zeros(8 * 64 + 4, dtype=torch.bfloat16)[4:].view(8, 64)
    assert h.data_ptr() % 16
    _, w, labels = _lmce_args(torch.bfloat16)
    lk.lmce_fwd(h, w, labels.long())
    assert seen == [(0, 0, True, torch.int32)]


def test_a_failing_tensor_core_forward_raises(fake_card, monkeypatch):
    def refused(*args):
        raise RuntimeError("lmce_fwd_tc kernel launch failed: cudaError 1")
    monkeypatch.setattr(lk, "_launch_fwd_tc", refused)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        lk.lmce_fwd(*_lmce_args(torch.bfloat16))
    assert fake_card == []
    fn = lk.lmce_fwd
    assert (fn.launches, fn.tc_launches, fn.plain_calls) == (0, 0, 0)
    assert lk._cuda_core_fwd.launches == 0


def test_cuda_core_comparison_forward_counts_apart(fake_card):
    lk._cuda_core_fwd(*_lmce_args(torch.bfloat16))
    lk._cuda_core_fwd(*_lmce_args(torch.float16))
    assert fake_card == [("_launch_fwd", "lmce")] * 2
    assert lk._cuda_core_fwd.launches == 2
    assert all(fn.launches == 0 for fn in lk.WRAPPERS)
    assert lk.lmce_fwd in lk.TC_WRAPPERS
    lk.reset_counts()
    assert lk._cuda_core_fwd.launches == 0


def test_fused_lmce_autograd_runs_the_tensor_core_forward(fake_card,
                                                          monkeypatch):
    """``FusedLinearCrossEntropy``'s forward on bf16 operands is a
    tensor-core launch."""
    for name in ("_launch_bwd_dh_tc", "_launch_bwd_dw_tc"):
        monkeypatch.setattr(lk, name, lambda lib, st, h, w, *a, n=name: (
            torch.zeros(h.shape if "dh" in n else w.shape, dtype=h.dtype)))
    monkeypatch.setattr(lk, "_tc_kernel", lambda: "lmce_sm90")
    h, w, labels = _lmce_args(torch.bfloat16)
    h.requires_grad_()
    loss = lk.FusedLinearCrossEntropy.apply(h, w, labels)
    loss.sum().backward()
    assert fake_card == [("_launch_fwd_tc", "lmce_fwd_sm90")]
    assert [fn.tc_launches for fn in lk.TC_WRAPPERS] == [1, 1, 1]


# ---------------------------------------------------------------------------
# the vocabulary split and the partial-combine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,v,sms", [(8192, 50304, 132), (1000, 786, 132),
                                     (100, 64, 132), (5, 7000, 1),
                                     (300000, 50304, 132), (128, 1000, 8)])
def test_vocab_slices_fill_the_card_with_whole_nonempty_tiles(n, v, sms):
    s = lk.vocab_slices(n, v, sms)
    row_blocks = -(-n // lk.FWD_ROW_BLOCK)
    n_vt = -(-v // lk.FWD_VOCAB_TILE)
    per = -(-n_vt // s)
    assert 1 <= s <= n_vt
    assert (s - 1) * per < n_vt                 # no empty slice
    assert row_blocks * s <= max(sms, row_blocks)
    if n_vt >= sms // max(row_blocks, 1) > 0:
        # no fewer slices than the card leaves room for, up to the tiles'
        # rounding
        assert row_blocks * s >= sms // 2 or s == n_vt
    if (n, v, sms) == (8192, 50304, 132):
        assert s == 2                           # 128 CTAs, one wave


def _lmce_inputs(n, v, d, seed, ignore=True):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    if ignore:
        labels[::4] = -100
        labels[1] = -1
    return h, w, labels


def _numpy_split(h, w, labels, slices):
    """The slices' partials and their combine in numpy, float64 exps on
    float32 logits: ``(loss, lse)``."""
    s = (h.astype(np.float64) @ w.astype(np.float64).T).astype(np.float32)
    v = w.shape[0]
    per = -(-(-(-v // 64)) // slices) * 64
    ms, ls, ps = [], [], []
    for k in range(slices):
        sk = s[:, k * per:min((k + 1) * per, v)].astype(np.float64)
        m = np.maximum(sk.max(axis=1) if sk.shape[1] else
                       np.full(len(labels), -1e30), -1e30)
        ms.append(m)
        ls.append(np.exp(sk - m[:, None]).sum(axis=1))
        inside = (labels >= k * per) & (labels < min((k + 1) * per, v))
        ps.append(np.where(inside, s[np.arange(len(labels)),
                                     np.clip(labels, 0, v - 1)], -1e30))
    m = np.max(ms, axis=0)
    l = sum(lk_ * np.exp(mk - m) for lk_, mk in zip(ls, ms))
    lse = m + np.log(np.maximum(l, 1e-30))
    loss = np.where(labels >= 0, lse - np.max(ps, axis=0), 0.0)
    return loss, lse


@pytest.mark.parametrize("n,v,d,slices", [
    (100, 700, 64, 3), (77, 786, 200, 13), (64, 130, 8, 1),
    (200, 1000, 40, 5)])     # the last: 16 tiles in runs of 4, one empty
def test_split_forward_matches_numpy_reference_and_jax(n, v, d, slices,
                                                       monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    h, w, labels = _lmce_inputs(n, v, d, seed=n + v)
    th, tw, tl = (torch.from_numpy(h), torch.from_numpy(w),
                  torch.from_numpy(labels))
    loss, lse = lk.lmce_fwd_split_reference(th, tw, tl, slices)
    assert loss.dtype == lse.dtype == torch.float32
    assert (loss[tl < 0] == 0).all()
    nloss, nlse = _numpy_split(h, w, labels, slices)
    np.testing.assert_allclose(lse.numpy(), nlse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), nloss, rtol=1e-5, atol=1e-5)
    rloss, rlse = lk.lmce_reference(th, tw, tl)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=1e-5)
    jloss, jlse = L._call_fwd(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(labels))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:n, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss)[:n],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_forward_on_16bit_operands_matches_jax(dtype, monkeypatch):
    """The mirror on 16-bit values sums their fp32 products, as the JAX
    kernel does with its 16-bit operands."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    h, w, labels = _lmce_inputs(100, 700, 64, seed=5)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    jloss, jlse = L._call_fwd(jnp.asarray(h).astype(jd),
                              jnp.asarray(w).astype(jd), jnp.asarray(labels))
    loss, lse = lk.lmce_fwd_split_reference(
        torch.from_numpy(h).to(dtype), torch.from_numpy(w).to(dtype),
        torch.from_numpy(labels), 4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:100, 0],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss)[:100],
                               rtol=2e-5, atol=2e-5)


def test_labels_outside_the_vocabulary_pick_neg():
    h, w, labels = _lmce_inputs(16, 200, 16, seed=3, ignore=False)
    labels[3] = 200
    labels[5] = 10 ** 6
    th, tw, tl = (torch.from_numpy(a) for a in (h, w, labels))
    part = lk.lmce_fwd_partials(th, tw, tl, 2)
    assert (part[2, :, 3] == lk.NEG).all() and (part[2, :, 5] == lk.NEG).all()
    loss, lse = lk.lmce_fwd_combine(part, tl)
    rloss, rlse = lk.lmce_reference(th, tw, tl)
    torch.testing.assert_close(loss, rloss)
    torch.testing.assert_close(lse, rlse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_card_forward_gate_passes_the_mirror_and_fails_the_controls(dtype):
    """``chip_smoke.lmce_fwd_gate`` passes the split mirror (the kernel's
    order of sums) and fails each control of the card's ``[lmce tc fwd]``
    phase."""
    h, w, labels = [torch.from_numpy(a)
                    for a in _lmce_inputs(256, 786, 200, seed=7)]
    h, w = h.to(dtype), w.to(dtype)
    args = (h, w, labels)
    ref = lk.lmce_reference(*args)
    got = lk.lmce_fwd_split_reference(*args, 13)
    assert chip_smoke.lmce_fwd_gate(torch, got, ref, *args) <= 1.0
    for name, bad in chip_smoke.lmce_fwd_controls(torch, lk, 13,
                                                  *args).items():
        ratio = chip_smoke.lmce_fwd_gate(torch, bad, ref, *args)
        assert ratio > 10.0, (name, ratio)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the tensor-core kernels are wgmma "
                    "and TMA, which have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,causal,seg", [
    ((4, 256, 1, 64, 256), True, False), ((2, 200, 2, 64, 200), True, False),
    ((1, 96, 2, 128, 160), False, False), ((2, 150, 2, 64, 150), False, True)])
def test_cuda_fused_tc_matches_plain(cuda_device, dtype, shape, causal, seg):
    """The tensor-core sweep against the plain version through the card's
    gate (``chip_smoke.flash_bwd_gate``); dk and dv bitwise equal on a
    second run; a masked row's dq exactly 0."""
    B, Sq, H, D, Sk = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(dtype)

    q, k, v, g = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D), \
        rnd(B, Sq, H, D)
    qs = ks = None
    if seg:
        qs = torch.zeros((B, Sq), dtype=torch.int32, device=cuda_device)
        qs[:, Sq // 2:] = 1
        qs[:, 5] = 7
        ks = torch.zeros((B, Sk), dtype=torch.int32, device=cuda_device)
        ks[:, Sk // 2:] = 1
    out, lse = fk.flash_fwd(q, k, v, causal, qs, ks)
    fk.reset_counts()
    got = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qs, ks)
    again = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qs, ks)
    assert fk.flash_bwd_fused.tc_launches == 2
    ref = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal, qs, ks)
    spread = chip_smoke.flash_bwd_terms(torch, fk, q, k, v, g, out, lse,
                                        fk._delta(out, g), causal, qs, ks)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        _, ratio, same = chip_smoke.flash_bwd_gate(torch, a, r, spread[name])
        assert chip_smoke.flash_bwd_passes(dtype, ratio, same), (name, ratio,
                                                                 same)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    if seg:
        assert bool((got[0][:, 5] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,v,d", [(333, 786, 200), (1000, 1000, 64),
                                   (300, 1000, 2048), (512, 4096, 768)])
def test_cuda_lmce_forward_tc_matches_plain_and_repeats(cuda_device, dtype,
                                                        n, v, d):
    h, w, labels = [torch.from_numpy(a).to(cuda_device)
                    for a in _lmce_inputs(n, v, d, seed=12)]
    h, w = h.to(dtype), w.to(dtype)
    lk.reset_counts()
    got = lk.lmce_fwd(h, w, labels)
    again = lk.lmce_fwd(h, w, labels)
    assert lk.lmce_fwd.tc_launches == 2
    ref = lk.lmce_reference(h, w, labels)
    assert chip_smoke.lmce_fwd_gate(torch, got, ref, h, w, labels) <= 1.0
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert bool((got[0][labels < 0] == 0).all())
