"""The tensor-core flash forward (``csrc/flash_fwd_sm90.cu``): its plain
version against the JAX package, the wrappers' routing, and on the card
the kernels against the plain version.

``flash_fwd_tc_reference`` rounds ``p`` to bf16 before ``P V`` and sums
the unrounded fp32 ``p`` in the denominator, as the JAX ``_flash_kernel``
and ``_flash_packed_fwd_kernel`` do.  Inputs are bf16, made with numpy
from a seed; the JAX kernels run in interpret mode over 128-row blocks
(``_pallas_flash_bh`` / ``_pallas_flash_packed`` with ``block_q =
block_k = 128``), so every sweep at S=256 crosses two blocks.
Tolerance: outputs within 5e-3 x max(|ref|, 1) at most and 1e-4 on
average, lse within 1e-5 x max(|ref|, 1).  The two sides round p
against different maxima (the kernel's running max, the plain
version's row max) and round the output to bf16, so single elements
differ by one bf16 ulp (measured: at most 3.9e-3, on average 2e-5 to
5e-5); the plain version with fp32 ``p`` needs the 2e-2 of
``chip_smoke.py``'s bf16 checks and averages 1.7e-4 on the causal case.

The routing tests run on the CPU with the launch helpers replaced: a
bf16 or fp16 tensor on the card at head dim 64 or 128 goes to the
tensor-core entries, fp32 and head dims 16 and 32 (every dtype) to the
CUDA-core ones, a call that breaks TMA's 16-byte rule raises before any
launch, and nothing falls back.  The ``cuda``-marked tests need a card
(the kernel is inline PTX with ``wgmma`` and TMA, which the CPU
emulation in ``tests/cuda_emu`` does not run) and skip without one.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_ops

from paddle_tpu_torch.ops import flash_attention_kernel as fk
from torch_parity_helpers import torch_one_thread  # noqa: F401

MAX_TOL = 5e-3      # x max(|ref|, 1), one bf16 ulp of the output
MEAN_TOL = 1e-4
LSE_TOL = 1e-5      # x max(|ref|, 1); fp32 sums in another order
CARD_TOL = 1e-2     # x max(|ref|, 1); chip_smoke.py's [flash tc] gate

CASES = {
    "causal": dict(b=2, sq=256, sk=256, h=4, d=64, causal=True),
    "non-causal Sq != Sk": dict(b=2, sq=128, sk=256, h=4, d=64,
                                causal=False),
    "segments + masked row": dict(b=2, sq=256, sk=256, h=4, d=64,
                                  causal=False, seg=True),
    "D=128 causal": dict(b=2, sq=256, sk=256, h=2, d=128, causal=True),
}
MASKED_ROW = 5


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PADDLE_TPU_FLASH_HEADPACK", raising=False)


def _case(name, seed=0):
    c = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = [rng.standard_normal((c["b"], s, c["h"], c["d"]))
               .astype(np.float32)
               for s in (c["sq"], c["sk"], c["sk"])]
    qs = ks = None
    if c.get("seg"):
        qs = np.zeros((c["b"], c["sq"]), np.int32)
        qs[:, c["sq"] // 2:] = 1
        qs[:, MASKED_ROW] = 7                          # sees no key
        ks = np.zeros((c["b"], c["sk"]), np.int32)
        ks[:, c["sk"] // 2:] = 1
    return c, q, k, v, qs, ks


def _bf16(a):
    return jnp.asarray(a, dtype=jnp.bfloat16)


def _jax_bh(c, q, k, v, qs, ks):
    """``_pallas_flash_bh`` on ``[B*H, S, D]``: out ``[B*H, Sq, D]``,
    lse ``[B*H, Sq]``."""
    b, h, d = c["b"], c["h"], c["d"]

    def bh(a):
        return _bf16(a.transpose(0, 2, 1, 3).reshape(b * h, -1, d))
    seg = [None if s is None else jnp.asarray(np.repeat(s, h, 0))
           for s in (qs, ks)]
    out, lse = pallas_ops._pallas_flash_bh(
        bh(q), bh(k), bh(v), *seg, causal=c["causal"], block_q=128,
        block_k=128)
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(lse)[..., 0])


def _jax_packed(c, q, k, v, qs, ks):
    """``_pallas_flash_packed`` on ``[B, S, H*D]``: out ``[B, Sq, H, D]``,
    lse ``[B, H, Sq]``."""
    b, sq, h, d = c["b"], c["sq"], c["h"], c["d"]
    seg = [None if s is None else jnp.asarray(s) for s in (qs, ks)]
    out, lse = pallas_ops._pallas_flash_packed(
        *[_bf16(a.reshape(b, a.shape[1], h * d)) for a in (q, k, v)], h, d,
        *seg, causal=c["causal"], block_q=128, block_k=128)
    out = np.asarray(out.astype(jnp.float32)).reshape(b, sq, h, d)
    lse = np.asarray(lse).reshape(b, sq, h, d)[..., 0].transpose(0, 2, 1)
    return out, lse


def _port(c, q, k, v, qs, ks, layout):
    """``flash_fwd_tc_reference`` on bf16 tensors in ``layout``, returned
    in the JAX function's layout."""
    b, h, d = c["b"], c["h"], c["d"]
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    seg = [None if s is None else torch.from_numpy(s) for s in (qs, ks)]
    if layout == "bh":
        t = [x.transpose(1, 2).reshape(b * h, -1, 1, d) for x in t]
        seg = [None if s is None else s.repeat_interleave(h, 0)
               for s in seg]
    out, lse = fk.flash_fwd_tc_reference(*t, c["causal"], *seg)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    if layout == "bh":
        return out.float()[:, :, 0].numpy(), lse[:, 0].numpy()
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("layout", ["bh", "packed"])
@pytest.mark.parametrize("case", list(CASES))
def test_tc_reference_matches_jax_interpret(interpret, case, layout):
    c, q, k, v, qs, ks = _case(case)
    jax_fn = _jax_bh if layout == "bh" else _jax_packed
    ref, ref_lse = jax_fn(c, q, k, v, qs, ks)
    out, lse = _port(c, q, k, v, qs, ks, layout)
    err = np.abs(out - ref)
    assert err.max() <= MAX_TOL * max(np.abs(ref).max(), 1.0), err.max()
    assert err.mean() <= MEAN_TOL, err.mean()
    lse_err = np.abs(lse - ref_lse).max()
    assert lse_err <= LSE_TOL * max(np.abs(ref_lse).max(), 1.0), lse_err
    if c.get("seg"):                  # the row is axis 1 in both layouts
        assert (out[:, MASKED_ROW] == 0).all()
        assert (lse[..., MASKED_ROW] == fk.LSE_FLOOR).all()


def test_tc_reference_in_fp32_is_the_composed_form():
    """In fp32 the rounding of p is a no-op: the plain version equals
    ``flash_attention_reference`` up to where the division happens."""
    c, q, k, v, qs, ks = _case("segments + masked row", seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    seg = [torch.from_numpy(s) for s in (qs, ks)]
    out, lse = fk.flash_fwd_tc_reference(*t, False, *seg)
    ref, ref_lse = fk.flash_attention_reference(*t, False, *seg)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# routing, with the launch helpers replaced
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_card(monkeypatch):
    """Tensors report a CUDA device and every launch helper records its
    call instead of launching; returns the list of calls."""
    calls = []

    def recorder(name):
        def launch(lib, stream, q, *args):
            calls.append((name, lib))
            b, sq, h, _ = q.shape
            return torch.zeros(q.shape, dtype=q.dtype), torch.zeros(b, h, sq)
        return launch

    for name in ("_launch_fwd", "_launch_fwd_tc", "_launch_fwd_hpack",
                 "_launch_fwd_hpack_tc"):
        monkeypatch.setattr(fk, name, recorder(name))
    monkeypatch.setattr(fk, "_kernel", lambda: "flash_attention")
    monkeypatch.setattr(fk, "_tc_kernel", lambda: "flash_fwd_sm90")
    monkeypatch.setattr(fk, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    fk.reset_counts()
    yield calls
    fk.reset_counts()


def _qkv(dtype, shape=(1, 8, 2, 64)):
    return [torch.zeros(shape, dtype=dtype) for _ in range(3)]


def test_bf16_runs_the_tensor_core_body_and_fp32_the_cuda_cores(fake_card):
    fk.flash_fwd(*_qkv(torch.bfloat16), True)
    fk.flash_fwd(*_qkv(torch.float32), True)
    fk.flash_fwd_hpack(*_qkv(torch.bfloat16, (2, 8, 1, 64)), 2, False)
    fk.flash_fwd_hpack(*_qkv(torch.float32, (2, 8, 1, 64)), 2, False)
    assert fake_card == [("_launch_fwd_tc", "flash_fwd_sm90"),
                         ("_launch_fwd", "flash_attention"),
                         ("_launch_fwd_hpack_tc", "flash_fwd_sm90"),
                         ("_launch_fwd_hpack", "flash_attention")]
    for fn in (fk.flash_fwd, fk.flash_fwd_hpack):
        assert (fn.launches, fn.tc_launches, fn.plain_calls) == (2, 1, 0)
    assert fk._cuda_core_fwd.launches == 0


def test_fp16_runs_the_tensor_core_body(fake_card):
    """fp16 takes the tensor-core forward at head dims 64 and 128 (the
    ``.f16`` wgmma form), as bf16 does."""
    fk.flash_fwd(*_qkv(torch.float16), True)
    fk.flash_fwd(*_qkv(torch.float16, (1, 8, 2, 128)), False)
    fk.flash_fwd_hpack(*_qkv(torch.float16, (2, 8, 1, 64)), 2, False)
    assert fake_card == [("_launch_fwd_tc", "flash_fwd_sm90")] * 2 + [
        ("_launch_fwd_hpack_tc", "flash_fwd_sm90")]
    assert (fk.flash_fwd.launches, fk.flash_fwd.tc_launches) == (2, 2)
    assert (fk.flash_fwd_hpack.launches,
            fk.flash_fwd_hpack.tc_launches) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [16, 32])
def test_small_head_dims_count_on_the_cuda_core_forward(fake_card, dtype, d):
    """Below head dim 64 every dtype runs the CUDA-core forward (and its
    head-packed form), chosen by head dim before any launch: the
    launches count, the tensor-core counts stay 0, and nothing reaches
    the tensor-core library."""
    fk.flash_fwd(*_qkv(dtype, (1, 8, 2, d)), True)
    fk.flash_fwd_hpack(*_qkv(dtype, (4, 8, 1, d)), 4, True)
    assert fake_card == [("_launch_fwd", "flash_attention"),
                         ("_launch_fwd_hpack", "flash_attention")]
    for fn in (fk.flash_fwd, fk.flash_fwd_hpack):
        assert (fn.launches, fn.tc_launches, fn.plain_calls) == (1, 0, 0)


def test_other_head_dims_still_raise_before_any_launch(fake_card):
    for d in (8, 48, 96, 256):
        with pytest.raises(NotImplementedError, match="head dim"):
            fk.flash_fwd(*_qkv(torch.bfloat16, (1, 8, 2, d)), True)
    with pytest.raises(NotImplementedError, match="flash_fwd_hpack"):
        fk.flash_fwd_hpack(*_qkv(torch.float16, (2, 8, 1, 128)), 2, True)
    assert fake_card == []


def _strided(dtype, seq_stride):
    """``[1, 8, 2, 64]`` whose sequence stride is ``seq_stride``."""
    base = torch.zeros(8 * seq_stride, dtype=dtype)
    return base.as_strided((1, 8, 2, 64), (8 * seq_stride, seq_stride, 64, 1))


def test_tma_rule_raises_before_any_launch_and_nothing_falls_back(
        fake_card):
    """A bf16 view whose sequence stride (132 elements = 264 bytes) or
    base address (8 bytes in) breaks TMA's 16-byte rule raises; fp32
    takes the CUDA-core kernel, which has no such rule."""
    bad_stride = _strided(torch.bfloat16, 132)
    flat = torch.zeros(8 * 2 * 64 + 4, dtype=torch.bfloat16)
    bad_base = flat[4:].view(1, 8, 2, 64)
    good = _qkv(torch.bfloat16)[0]
    for q, k in ((bad_stride, good), (good, bad_base)):
        with pytest.raises(NotImplementedError, match="16 bytes"):
            fk.flash_fwd(q, k, good, True)
    with pytest.raises(NotImplementedError, match="16 bytes"):
        fk.flash_fwd_hpack(good, good, bad_stride, 2, True)
    assert fake_card == []
    assert fk.flash_fwd.launches == fk.flash_fwd.plain_calls == 0
    fk.flash_fwd(*[_strided(torch.float32, 132)] * 3, True)
    assert fake_card == [("_launch_fwd", "flash_attention")]


def test_a_failing_tensor_core_launch_raises(fake_card, monkeypatch):
    def refused(*args):
        raise RuntimeError("flash_fwd_tc kernel launch failed: the driver "
                           "refused a tensor map")
    monkeypatch.setattr(fk, "_launch_fwd_tc", refused)
    with pytest.raises(RuntimeError, match="tensor map"):
        fk.flash_fwd(*_qkv(torch.bfloat16), False)
    assert fake_card == []
    assert (fk.flash_fwd.launches, fk.flash_fwd.tc_launches,
            fk.flash_fwd.plain_calls) == (0, 0, 0)


def test_cuda_core_comparison_forward_counts_apart(fake_card):
    fk._cuda_core_fwd(*_qkv(torch.bfloat16), True)
    fk._cuda_core_fwd(*_qkv(torch.bfloat16, (2, 8, 1, 64)), True, hp=2)
    assert fake_card == [("_launch_fwd", "flash_attention"),
                         ("_launch_fwd_hpack", "flash_attention")]
    assert fk._cuda_core_fwd.launches == 2
    assert all(fn.launches == 0 for fn in fk.ALL_WRAPPERS)


def test_tma_strides_give_unit_dims_contiguous_strides():
    """TMA never steps along a size-1 dim, but its stride must still be
    a multiple of 16 bytes: it becomes the contiguous one."""
    t = torch.zeros(8, 64).as_strided((1, 1, 2, 64), (0, 0, 64, 1))
    bh = torch.zeros(4, 8, 64).unsqueeze(2)           # [B*H, S, 1, D]
    assert list(fk._tma_strides(t, bh)) == [128, 128, 64, 512, 64, 64]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the tensor-core kernel has no CPU "
                    "mode")
    return torch.device("cuda")


CARD_SHAPES = {
    "GPT-like views causal": ((2, 256, 3, 64, 256), True, "qkv"),
    "ragged S=200 causal": ((2, 200, 2, 64, 200), True, None),
    "non-causal Sq=96 Sk=160 D=128": ((1, 96, 2, 128, 160), False, None),
    "segments + masked row": ((2, 150, 2, 64, 150), False, "seg"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_cuda_tc_kernel_matches_plain(cuda_device, name):
    _tc_matches_plain(cuda_device, name, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_cuda_tc_kernel_matches_plain_fp16(cuda_device, name):
    """The ``.f16`` form of the same kernel body."""
    _tc_matches_plain(cuda_device, name, torch.float16)


def _tc_matches_plain(cuda_device, name, dtype):
    (B, Sq, H, D, Sk), causal, kind = CARD_SHAPES[name]
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(dtype)

    if kind == "qkv":
        qkv = rnd(B, Sq, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
    qs = ks = None
    if kind == "seg":
        qs = torch.zeros((B, Sq), dtype=torch.int32, device=cuda_device)
        qs[:, Sq // 2:] = 1
        qs[:, MASKED_ROW] = 7
        ks = torch.zeros((B, Sk), dtype=torch.int32, device=cuda_device)
        ks[:, Sk // 2:] = 1
    fk.reset_counts()
    out, lse = fk.flash_fwd(q, k, v, causal, qs, ks)
    assert (fk.flash_fwd.launches, fk.flash_fwd.tc_launches) == (1, 1)
    ref, ref_lse = fk.flash_fwd_tc_reference(q, k, v, causal, qs, ks)
    torch.cuda.synchronize()
    for got, want in ((out, ref), (lse, ref_lse)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= CARD_TOL * max(1.0, want.float().abs().max().item())
    if kind == "seg":
        assert bool((out[:, MASKED_ROW] == 0).all())
        assert bool((lse[:, :, MASKED_ROW] == fk.LSE_FLOOR).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hp,causal", [
    ((2, 300, 3, 64), 2, False),          # odd H: packs straddle batches
    ((8, 256, 1, 64), 4, True),
])
def test_cuda_hpack_tc_equals_flash_fwd_tc_bitwise(cuda_device, shape, hp,
                                                   causal):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = [torch.randn(shape, generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3)]
    fk.reset_counts()
    out, lse = fk.flash_fwd_hpack(q, k, v, hp, causal)
    ref, ref_lse = fk.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fk.flash_fwd_hpack.tc_launches == fk.flash_fwd.tc_launches == 1
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
