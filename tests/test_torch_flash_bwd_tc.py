"""The split flash backward: its plain versions' rounding against the JAX
package's split kernels, the wrappers' routing to the tensor-core pair
(``csrc/flash_bwd_sm90.cu``), and on the card the pair against the plain
versions.

The TPU kernels round dS to the input dtype before ``dS K`` and ``dS^T
Q``, and p before ``P^T dO`` (``pallas_ops.py:542, 607, 614``; packed
:940, :1009, :1014); ``flash_bwd_dq_reference`` and
``flash_bwd_dkv_reference`` round them too.  An absolute or terms-based
tolerance cannot see a missing rounding (it moves each sum by less than
its terms' rounding bound), so the tests count the elements that come
out equal in the 16-bit dtype: the plain versions and the JAX kernels
round the same values and part only where an fp32 sum taken in another
order straddles a rounding boundary (measured: 98.9% to 99.99% equal),
while an unrounded plain version leaves about 58% equal.  Required: at
least :data:`SAME_MIN` of dq, dk and dv equal, and every element within
one ulp of the reference plus half an ulp of the largest |reference|
(rows with few visible keys, where dP - delta cancels, part by an ulp of
the row's larger values).  Inputs come from numpy with a seed; the JAX
kernels run in interpret mode over 128-row blocks, as
``tests/test_torch_flash_tc.py`` runs the forward; both sides read the
same out and lse (the JAX forward's).

The routing tests run on the CPU with the launch helpers replaced: bf16
and fp16 at head dims 64 and 128 on the card go to the tensor-core
entries, fp32 and head dims 16 and 32 to the CUDA-core pair, TMA's
16-byte rule on q, k, v, out and dout raises before any launch, and
nothing falls back.  The ``cuda``-marked tests need a card (the kernels
are inline PTX with ``wgmma`` and TMA, which ``tests/cuda_emu`` does not
run) and skip without one.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_ops

from paddle_tpu_torch.ops import flash_attention_kernel as fk
from torch_parity_helpers import torch_one_thread  # noqa: F401

SAME_MIN = 0.98
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
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
    monkeypatch.delenv("PADDLE_TPU_FLASH_FUSED_BWD", raising=False)


def _case(name, seed=0):
    c = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = [rng.standard_normal((c["b"], s, c["h"], c["d"]))
               .astype(np.float32)
               for s in (c["sq"], c["sk"], c["sk"])]
    g = rng.standard_normal((c["b"], c["sq"], c["h"], c["d"])).astype(
        np.float32)
    qs = ks = None
    if c.get("seg"):
        qs = np.zeros((c["b"], c["sq"]), np.int32)
        qs[:, c["sq"] // 2:] = 1
        qs[:, MASKED_ROW] = 7                          # sees no key
        ks = np.zeros((c["b"], c["sk"]), np.int32)
        ks[:, c["sk"] // 2:] = 1
    return c, q, k, v, g, qs, ks


def _jax_bh(c, jd, q, k, v, g, qs, ks):
    """``_pallas_flash_bwd``'s split branch on ``[B*H, S, D]`` (after
    ``_pallas_flash_bh``): ``(out, lse [B, H, Sq], dq, dk, dv)``, all
    numpy in ``[B, S, H, D]``."""
    b, h, d = c["b"], c["h"], c["d"]

    def bh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, -1, d),
                           dtype=jd)

    def back(x):
        x = np.asarray(x.astype(jnp.float32))
        return x.reshape(b, h, -1, d).transpose(0, 2, 1, 3).copy()

    seg = [None if s is None else jnp.asarray(np.repeat(s, h, 0))
           for s in (qs, ks)]
    blocks = dict(block_q=128, block_k=128)
    out, lse = pallas_ops._pallas_flash_bh(bh(q), bh(k), bh(v), *seg,
                                           causal=c["causal"], **blocks)
    grads = pallas_ops._pallas_flash_bwd(bh(q), bh(k), bh(v), out, lse,
                                         bh(g), *seg, causal=c["causal"],
                                         **blocks)
    lse = np.array(lse)[..., 0].reshape(b, h, -1)
    return (back(out), lse, *[back(x) for x in grads])


def _jax_packed(c, jd, q, k, v, g, qs, ks):
    """``_pallas_flash_packed_bwd`` on ``[B, S, H*D]`` (after
    ``_pallas_flash_packed``), returned as :func:`_jax_bh` returns."""
    b, h, d = c["b"], c["h"], c["d"]

    def packed(a):
        return jnp.asarray(a.reshape(b, a.shape[1], h * d), dtype=jd)

    def back(x):
        return np.array(x.astype(jnp.float32)).reshape(b, -1, h, d)

    seg = [None if s is None else jnp.asarray(s) for s in (qs, ks)]
    blocks = dict(block_q=128, block_k=128)
    args = [packed(a) for a in (q, k, v)]
    out, lse = pallas_ops._pallas_flash_packed(*args, h, d, *seg,
                                               causal=c["causal"], **blocks)
    grads = pallas_ops._pallas_flash_packed_bwd(
        *args, out, lse, packed(g), h, d, *seg, causal=c["causal"], **blocks)
    lse = np.asarray(lse).reshape(b, -1, h, d)[..., 0].transpose(0, 2, 1)
    return (back(out), np.ascontiguousarray(lse), *[back(x) for x in grads])


def _port_split(td, q, k, v, g, out, lse, causal, qs, ks):
    """The split plain versions on the 16-bit values, from the given out
    and lse: ``(dq, dk, dv)`` as fp32 numpy."""
    t = [torch.from_numpy(a).to(td) for a in (q, k, v, g)]
    seg = [None if s is None else torch.from_numpy(s) for s in (qs, ks)]
    out = torch.from_numpy(out).to(td)
    lse = torch.from_numpy(lse)
    dq, delta = fk.flash_bwd_dq_reference(*t[:3], out, lse, t[3], causal,
                                          *seg)
    dk, dv = fk.flash_bwd_dkv_reference(*t[:3], t[3], lse, delta, causal,
                                        *seg)
    assert dq.dtype == dk.dtype == dv.dtype == td
    return [x.float().numpy() for x in (dq, dk, dv)]


def _same_share(got, ref, td, what):
    """The share of elements equal to ``ref``; every element within one
    ulp of ``ref`` plus half an ulp of max |ref| (fp32 numpy holding
    16-bit values)."""
    eps = torch.finfo(td).eps
    diff = np.abs(got - ref)
    bound = eps * np.abs(ref) + eps / 2 * np.abs(ref).max()
    assert (diff <= bound).all(), (what, diff.max(), (diff / bound).max())
    return float((got == ref).mean())


@pytest.mark.parametrize("layout", ["bh", "packed"])
@pytest.mark.parametrize("dn", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_split_plain_versions_round_as_the_jax_kernels(interpret, case, dn,
                                                       layout):
    c, q, k, v, g, qs, ks = _case(case)
    td, jd = DTYPES[dn]
    jax_fn = _jax_bh if layout == "bh" else _jax_packed
    out, lse, *ref = jax_fn(c, jd, q, k, v, g, qs, ks)
    got = _port_split(td, q, k, v, g, out, lse, c["causal"], qs, ks)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        share = _same_share(a, r, td, name)
        assert share >= SAME_MIN, (name, share)
    if c.get("seg"):
        assert (got[0][:, MASKED_ROW] == 0).all()


def test_unrounded_split_pair_fails_the_share():
    """The count is what tells the roundings apart: the split pair's
    arithmetic with dS and p left in fp32 matches the rounded plain
    versions in about 58% of the elements (bf16), and the bound of
    :func:`_same_share` alone passes it."""
    c, q, k, v, g, _, _ = _case("causal", seed=1)
    td = torch.bfloat16
    t = [torch.from_numpy(a).to(td) for a in (q, k, v, g)]
    out, lse = fk.flash_fwd(*t[:3], True)
    dq, delta = fk.flash_bwd_dq_reference(*t[:3], out, lse, t[3], True)
    p = fk._probs(t[0], t[1], lse, True, None, None, 0.125)
    dp = torch.einsum("bqhd,bkhd->bhqk", t[3].float(), t[2].float())
    ds = p * (dp - delta[..., None]) * 0.125
    dq32 = torch.einsum("bhqk,bkhd->bqhd", ds, t[1].float()).to(td)
    share = _same_share(dq32.float().numpy(), dq.float().numpy(), td, "dq")
    assert share < 0.7, share


def test_rounding_is_a_no_op_in_fp32():
    """In fp32 the split plain versions equal autograd of the composed
    form, as before the rounding."""
    c, q, k, v, g, qs, ks = _case("segments + masked row", seed=2)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    seg = [torch.from_numpy(s) for s in (qs, ks)]
    out, lse = fk.flash_fwd(*t[:3], False, *seg)
    dq, delta = fk.flash_bwd_dq(*t[:3], out, lse, t[3], False, *seg)
    dk, dv = fk.flash_bwd_dkv(*t[:3], t[3], lse, delta, False, *seg)
    leaves = [x.clone().requires_grad_() for x in t[:3]]
    ref, _ = fk.flash_attention_reference(*leaves, False, *seg)
    ref.backward(t[3])
    for a, b in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(a, b.grad, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# routing, with the launch helpers replaced
# ---------------------------------------------------------------------------
LAUNCHERS = ("_launch_fwd", "_launch_fwd_tc", "_launch_bwd_dq",
             "_launch_bwd_dq_tc", "_launch_bwd_dkv", "_launch_bwd_dkv_tc")


@pytest.fixture
def fake_card(monkeypatch):
    """Tensors report a CUDA device and every launch helper records its
    call instead of launching; returns the list of calls."""
    calls = []

    def recorder(name):
        def launch(lib, stream, q, k, *args):
            calls.append((name, lib))
            b, sq, h, _ = q.shape
            if "dkv" in name:
                return torch.zeros(k.shape, dtype=k.dtype), \
                    torch.zeros(k.shape, dtype=k.dtype)
            return torch.zeros(q.shape, dtype=q.dtype), torch.zeros(b, h, sq)
        return launch

    for name in LAUNCHERS:
        monkeypatch.setattr(fk, name, recorder(name))
    monkeypatch.setattr(fk, "_kernel", lambda: "flash_attention")
    monkeypatch.setattr(fk, "_tc_kernel", lambda: "flash_fwd_sm90")
    monkeypatch.setattr(fk, "_bwd_tc_kernel", lambda: "flash_bwd_sm90")
    monkeypatch.setattr(fk, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    fk.reset_counts()
    yield calls
    fk.reset_counts()


def _bwd_args(dtype, shape=(1, 8, 2, 64)):
    """``(q, k, v, out, lse, dout)`` of ``shape``."""
    b, s, h, _ = shape
    t = [torch.zeros(shape, dtype=dtype) for _ in range(5)]
    return t[0], t[1], t[2], t[3], torch.zeros(b, h, s), t[4]


def _backward(args, causal=True):
    q, k, v, out, lse, dout = args
    _, delta = fk.flash_bwd_dq(q, k, v, out, lse, dout, causal)
    fk.flash_bwd_dkv(q, k, v, dout, lse, delta, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_16bit_backward_runs_the_tensor_core_pair(fake_card, dtype, d):
    _backward(_bwd_args(dtype, (1, 8, 2, d)))
    assert fake_card == [("_launch_bwd_dq_tc", "flash_bwd_sm90"),
                         ("_launch_bwd_dkv_tc", "flash_bwd_sm90")]
    for fn in (fk.flash_bwd_dq, fk.flash_bwd_dkv):
        assert (fn.launches, fn.tc_launches, fn.plain_calls) == (1, 1, 0)
    assert fk._cuda_core_flash_bwd.launches == 0


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 64), (torch.float32, 128), (torch.float32, 16),
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.float16, 16),
    (torch.float16, 32), (torch.float32, 32)])
def test_fp32_and_small_head_dims_run_the_cuda_core_pair(fake_card, dtype,
                                                         d):
    """fp32 (the parity gates need fp32 sums, which TF32 would break) and
    head dims 16 and 32 in every dtype run the CUDA-core pair, chosen by
    dtype and head dim before any launch."""
    _backward(_bwd_args(dtype, (1, 8, 2, d)))
    assert fake_card == [("_launch_bwd_dq", "flash_attention"),
                         ("_launch_bwd_dkv", "flash_attention")]
    for fn in (fk.flash_bwd_dq, fk.flash_bwd_dkv):
        assert (fn.launches, fn.tc_launches, fn.plain_calls) == (1, 0, 0)


def _misaligned(dtype):
    """A ``[1, 8, 2, 64]`` view whose base address is 8 bytes in."""
    flat = torch.zeros(8 * 2 * 64 + 4, dtype=dtype)
    return flat[4:].view(1, 8, 2, 64)


@pytest.mark.parametrize("which", ["out", "dout"])
def test_tma_rule_on_out_and_dout_raises_before_any_launch(fake_card,
                                                           which):
    """The tensor-core dq reads out (16-byte loads for delta) and dout
    (TMA), dkv dout: a misaligned one raises, nothing launches and
    nothing falls back to the CUDA-core pair."""
    q, k, v, out, lse, dout = _bwd_args(torch.bfloat16)
    bad = _misaligned(torch.bfloat16)
    if which == "out":
        out = bad
    else:
        dout = bad
    with pytest.raises(NotImplementedError, match=f"{which}.*16 bytes"):
        fk.flash_bwd_dq(q, k, v, out, lse, dout, True)
    if which == "dout":
        with pytest.raises(NotImplementedError, match="dout.*16 bytes"):
            fk.flash_bwd_dkv(q, k, v, dout, lse, lse, True)
    assert fake_card == []
    assert (fk.flash_bwd_dq.launches, fk.flash_bwd_dkv.launches) == (0, 0)
    # fp32 runs the CUDA-core pair, which has no such rule
    _backward([t.float() if t.dtype != torch.float32 else t
               for t in (q, k, v, _misaligned(torch.float32), lse,
                         _misaligned(torch.float32))])
    assert [n for n, _ in fake_card] == ["_launch_bwd_dq", "_launch_bwd_dkv"]


@pytest.mark.parametrize("name", ["_launch_bwd_dq_tc", "_launch_bwd_dkv_tc"])
def test_a_failing_tensor_core_backward_launch_raises(fake_card, monkeypatch,
                                                      name):
    def refused(*args):
        raise RuntimeError(f"{name[8:]} kernel launch failed: the driver "
                           "refused a tensor map")
    monkeypatch.setattr(fk, name, refused)
    with pytest.raises(RuntimeError, match="tensor map"):
        _backward(_bwd_args(torch.bfloat16))
    assert all(n.endswith("_tc") for n, _ in fake_card)
    assert fk.flash_bwd_dq.plain_calls == fk.flash_bwd_dkv.plain_calls == 0
    assert fk._cuda_core_flash_bwd.launches == 0
    assert fk.flash_bwd_dkv.launches == 0


def test_cuda_core_comparison_backward_counts_apart(fake_card):
    q, k, v, out, lse, dout = _bwd_args(torch.bfloat16)
    fk._cuda_core_flash_bwd("dq", q, k, v, out, lse, dout, True)
    fk._cuda_core_flash_bwd("dkv", q, k, v, dout, lse, lse, True)
    assert fake_card == [("_launch_bwd_dq", "flash_attention"),
                         ("_launch_bwd_dkv", "flash_attention")]
    assert fk._cuda_core_flash_bwd.launches == 2
    assert all(fn.launches == 0 for fn in fk.ALL_WRAPPERS)
    fk.reset_counts()
    assert fk._cuda_core_flash_bwd.launches == 0


def test_autograd_backward_counts_on_the_tensor_core_pair(fake_card):
    """``FlashAttnFunc``'s backward goes through the two wrappers; every
    16-bit launch of the default path counts as a tensor-core one."""
    q, k, v = [torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3)]
    out = fk.FlashAttnFunc.apply(q, k, v, True, None, None)
    out.backward(torch.ones_like(out))
    assert [n for n, _ in fake_card] == ["_launch_fwd_tc",
                                         "_launch_bwd_dq_tc",
                                         "_launch_bwd_dkv_tc"]
    assert [fn.tc_launches for fn in fk.TC_WRAPPERS] == [1, 0, 1, 1, 0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the tensor-core kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = {
    "GPT-like views causal": ((2, 256, 3, 64, 256), True, "qkv"),
    "ragged S=200 causal": ((2, 200, 2, 64, 200), True, None),
    "non-causal Sq=96 Sk=160 D=128": ((1, 96, 2, 128, 160), False, None),
    "segments + masked row": ((2, 150, 2, 64, 150), False, "seg"),
}
CARD_SAME_MIN = {torch.bfloat16: 0.95, torch.float16: 0.9}


def _card_inputs(dev, shape, kind, dtype, seed):
    (B, Sq, H, D, Sk) = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(dtype)

    if kind == "qkv":
        qkv = rnd(B, Sq, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
    qs = ks = None
    if kind == "seg":
        qs = torch.zeros((B, Sq), dtype=torch.int32, device=dev)
        qs[:, Sq // 2:] = 1
        qs[:, MASKED_ROW] = 7
        ks = torch.zeros((B, Sk), dtype=torch.int32, device=dev)
        ks[:, Sk // 2:] = 1
    return q, k, v, rnd(B, Sq, H, D), qs, ks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_cuda_tc_backward_matches_plain(cuda_device, name, dtype):
    """The pair against the plain versions on the same values: most
    elements equal, every one within one ulp plus half an ulp of the
    largest (``chip_smoke.py``'s ``[flash tc bwd]`` holds the full
    per-element gate); a fully-masked row's dq exactly 0."""
    shape, causal, kind = CARD_SHAPES[name]
    q, k, v, g, qs, ks = _card_inputs(cuda_device, shape, kind, dtype, 0)
    out, lse = fk.flash_fwd(q, k, v, causal, qs, ks)
    fk.reset_counts()
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qs, ks)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qs, ks)
    assert (fk.flash_bwd_dq.tc_launches, fk.flash_bwd_dkv.tc_launches) == \
        (1, 1)
    rdq, rdelta = fk.flash_bwd_dq_reference(q, k, v, out, lse, g, causal,
                                            qs, ks)
    rdk, rdv = fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal,
                                          qs, ks)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, rdelta, rtol=1e-5, atol=1e-5)
    for what, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        share = _same_share(got.float().cpu().numpy(),
                            ref.float().cpu().numpy(), dtype, what)
        assert share >= CARD_SAME_MIN[dtype], (what, share)
    if kind == "seg":
        assert bool((dq[:, MASKED_ROW] == 0).all())


@pytest.mark.cuda
def test_cuda_tc_backward_is_deterministic(cuda_device):
    q, k, v, g, _, _ = _card_inputs(cuda_device, (2, 300, 3, 64, 300),
                                    None, torch.bfloat16, 1)
    out, lse = fk.flash_fwd(q, k, v, True)

    def run():
        dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, True)
        return (dq, delta) + fk.flash_bwd_dkv(q, k, v, g, lse, delta, True)

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
