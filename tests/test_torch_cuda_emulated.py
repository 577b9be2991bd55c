"""The port's CUDA kernels, run on the CPU under an emulation of their
threads, against their plain versions.

There is no card and no nvcc here, so ``tests/cuda_emu`` rewrites each
``csrc/*.cu`` lightly (kernel launches, shared memory) and ``g++``
compiles it as C++ against headers that emulate the CUDA runtime: a
launch runs its blocks in turn, each block's threads as OS threads that
meet at ``__syncthreads`` and at warp shuffles, with shared memory
filled with NaN first.  The port's own ctypes launch helpers drive the
library with CPU pointers, so strides, layouts and argument packing are
the ones the card sees.  This checks the kernels' indexing, masking,
tiling and arithmetic at small shapes; speed, the GPU compiler and the
memory model are the card's to check (``chip_smoke.py``).

Tolerances: fp32 within 1e-5 x max(|ref|, 1) (the kernels sum in tiles,
the plain version whole rows); bf16 within 2e-2 x max(|ref|, 1) of the
plain version computed in fp32 on the same bf16 values (outputs round
to 8 mantissa bits); fp16 within 5e-3 x max(|ref|, 1) the same way
(outputs, p and dS round to 11 bits).  The fp16 and head-dim 16 / 32
cases hold those instantiations (``cuda_emu/cuda_fp16.h`` emulates the
fp16 type).  The module skips where no ``g++`` exists.
"""

import ctypes
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from paddle_tpu_torch.ops import lmce_kernel as lk

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_emu"))
import emulate  # noqa: E402

FP32_TOL = 1e-5
BF16_TOL = 2e-2
FP16_TOL = 5e-3
TOLS = {torch.float32: FP32_TOL, torch.bfloat16: BF16_TOL,
        torch.float16: FP16_TOL}


@pytest.fixture(scope="module")
def emu_libs(tmp_path_factory):
    if emulate.compiler() is None:
        pytest.skip("no g++ to build the CUDA emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    libs = {n: ctypes.CDLL(str(emulate.build(_build.CSRC_DIR / f"{n}.cu",
                                             out)))
            for n in ("flash_attention", "paged_attention")}
    p, i = ctypes.c_void_p, ctypes.c_int
    fk.bind(libs["flash_attention"])
    pa = libs["paged_attention"].paddle_paged_attention
    pa.argtypes = [i] + [p] * 6 + [i] * 6 + [ctypes.c_float, p]
    pa.restype = ctypes.c_int
    return libs


@pytest.fixture(scope="module")
def lmce_lib(tmp_path_factory):
    if emulate.compiler() is None:
        pytest.skip("no g++ to build the CUDA emulation")
    out = tmp_path_factory.mktemp("cuda_emu_lmce")
    return lk.bind(ctypes.CDLL(str(emulate.build(_build.CSRC_DIR / "lmce.cu",
                                                 out))))


def _close(got, ref, tol, what):
    got, ref = got.float(), ref.float()
    assert not torch.isnan(got).any(), f"{what}: NaN"
    err = (got - ref).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), (what, err)


FLASH_CASES = {
    "causal ragged S=130": dict(B=1, Sq=130, Sk=130, H=2, D=64, causal=True),
    "non-causal Sq=70 Sk=150": dict(B=2, Sq=70, Sk=150, H=1, D=64,
                                    causal=False),
    "D=128 causal": dict(B=1, Sq=80, Sk=80, H=1, D=128, causal=True),
    "segments + masked row": dict(B=1, Sq=100, Sk=96, H=2, D=64,
                                  causal=False, seg=True),
    "qkv views": dict(B=1, Sq=128, Sk=128, H=2, D=64, causal=True,
                      packed=True),
    "[B*H,S,D] layout": dict(B=2, Sq=65, Sk=65, H=2, D=64, causal=True,
                             bh=True),
    "bf16 causal": dict(B=1, Sq=96, Sk=96, H=1, D=64, causal=True,
                        dtype=torch.bfloat16),
    "bf16 D=128 non-causal": dict(B=1, Sq=33, Sk=70, H=1, D=128,
                                  causal=False, dtype=torch.bfloat16),
    "fp16 causal qkv views": dict(B=1, Sq=96, Sk=96, H=2, D=64,
                                  causal=True, packed=True,
                                  dtype=torch.float16),
    "fp32 D=16 segments + masked row": dict(B=1, Sq=100, Sk=96, H=2, D=16,
                                            causal=False, seg=True),
    "fp16 D=16 causal ragged S=130": dict(B=1, Sq=130, Sk=130, H=2, D=16,
                                          causal=True, dtype=torch.float16),
    "bf16 D=32 non-causal Sq=70 Sk=150": dict(B=2, Sq=70, Sk=150, H=1,
                                              D=32, causal=False,
                                              dtype=torch.bfloat16),
    "fp16 D=32 [B*H,S,D] layout": dict(B=2, Sq=65, Sk=65, H=2, D=32,
                                       causal=True, bh=True,
                                       dtype=torch.float16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain(emu_libs, case):
    c = dict(FLASH_CASES[case])
    B, Sq, Sk, H, D, causal = (c.pop(k) for k in
                               ("B", "Sq", "Sk", "H", "D", "causal"))
    dtype = c.get("dtype", torch.float32)
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    if c.get("packed"):
        qkv = torch.randn(B, Sq, 3, H, D, generator=gen).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(B, Sq, H, D, generator=gen).to(dtype)
        k = torch.randn(B, Sk, H, D, generator=gen).to(dtype)
        v = torch.randn(B, Sk, H, D, generator=gen).to(dtype)
    g = torch.randn(B, Sq, H, D, generator=gen).to(dtype)
    qs = ks = None
    if c.get("seg"):
        qs = torch.zeros(B, Sq, dtype=torch.int32)
        qs[:, Sq // 2:] = 1
        qs[:, 3] = 7                                   # sees no key
        ks = torch.zeros(B, Sk, dtype=torch.int32)
        ks[:, Sk // 3:] = 1
    if c.get("bh"):
        q, k, v, g = [t.permute(0, 2, 1, 3).reshape(B * H, -1, 1, D)
                      for t in (q, k, v, g)]
    lib, scale = emu_libs["flash_attention"], 1.0 / math.sqrt(D)
    out, lse = fk._launch_fwd(lib, None, q, k, v, causal, qs, ks, scale)
    dq, delta = fk._launch_bwd_dq(lib, None, q, k, v, out, lse, g, causal,
                                  qs, ks, scale)
    dk, dv = fk._launch_bwd_dkv(lib, None, q, k, v, g, lse, delta, causal,
                                qs, ks, scale)
    f32 = [t.float() for t in (q, k, v, g)]
    rout, rlse = fk.flash_attention_reference(*f32[:3], causal, qs, ks)
    rdq, rdelta = fk.flash_bwd_dq_reference(*f32[:3], out.float(), lse,
                                            f32[3], causal, qs, ks)
    rdk, rdv = fk.flash_bwd_dkv_reference(*f32[:3], f32[3], lse, delta,
                                          causal, qs, ks)
    tol = TOLS[dtype]
    for what, got, ref in (("out", out, rout), ("lse", lse, rlse),
                           ("delta", delta, rdelta), ("dq", dq, rdq),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        _close(got, ref, tol, what)
    assert out.dtype == dtype and dq.dtype == dtype and lse.dtype == \
        torch.float32
    if qs is not None:
        assert (out[:, 3] == 0).all() and (lse[:, :, 3] == fk.LSE_FLOOR).all()


def test_flash_kernels_are_deterministic(emu_libs):
    gen = torch.Generator().manual_seed(11)
    q, k, v, g = [torch.randn(1, 70, 2, 64, generator=gen)
                  for _ in range(4)]
    lib = emu_libs["flash_attention"]

    def run():
        out, lse = fk._launch_fwd(lib, None, q, k, v, True, None, None,
                                  0.125)
        dq, delta = fk._launch_bwd_dq(lib, None, q, k, v, out, lse, g, True,
                                      None, None, 0.125)
        return (out, lse, dq) + fk._launch_bwd_dkv(
            lib, None, q, k, v, g, lse, delta, True, None, None, 0.125)

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


# fault C3: the CUDA-core split backward rounds dS (and, for dv, p) to
# the input dtype before its products, as the TPU kernels do.  A
# tolerance cannot see a missing rounding (it moves each sum by less than
# the terms' rounding bound), so the count of elements equal in the
# 16-bit dtype decides: the same rounded values part only where an fp32
# sum taken in another order straddles a rounding boundary, while the
# unrounded kernel left about 58% equal.  Every element must also lie
# within one ulp plus half an ulp of the largest |reference|.
SPLIT_SAME_MIN = 0.98


def _rounded_split(q, k, v, g, lse, delta, causal, scale):
    """dq, dk, dv of the TPU kernels' arithmetic, written out: dS and p
    rounded to the input dtype before their products, fp32 sums."""
    dt = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(),
                          float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    p = p.to(dt).float()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(dt),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(dt),
            torch.einsum("bhqk,bqhd->bkhd", p, g.float()).to(dt))


def _same_share(got, ref, what):
    got, ref = got.float(), ref.float()
    eps = torch.finfo(torch.bfloat16 if what.endswith("bf16") else
                      torch.float16).eps
    diff = (got - ref).abs()
    bound = eps * ref.abs() + eps / 2 * ref.abs().max()
    assert bool((diff <= bound).all()), (what, diff.max().item())
    return (got == ref).float().mean().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_core_split_backward_rounds_as_the_tpu_kernels(emu_libs, dtype,
                                                            causal):
    gen = torch.Generator().manual_seed(12 + causal)
    q, k, v, g = [torch.randn(1, 128, 2, 64, generator=gen).to(dtype)
                  for _ in range(4)]
    lib, scale = emu_libs["flash_attention"], 0.125
    out, lse = fk._launch_fwd(lib, None, q, k, v, causal, None, None, scale)
    dq, delta = fk._launch_bwd_dq(lib, None, q, k, v, out, lse, g, causal,
                                  None, None, scale)
    dk, dv = fk._launch_bwd_dkv(lib, None, q, k, v, g, lse, delta, causal,
                                None, None, scale)
    want = _rounded_split(q, k, v, g, lse, delta, causal, scale)
    plain = (fk.flash_bwd_dq_reference(q, k, v, out, lse, g, causal)[0],
             *fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal))
    tag = "bf16" if dtype == torch.bfloat16 else "fp16"
    for name, got, w, pl in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                plain):
        assert got.dtype == dtype
        share = _same_share(got, w, f"{name} {tag}")
        assert share >= SPLIT_SAME_MIN, (name, share)
        assert _same_share(pl, w, f"{name} plain {tag}") >= SPLIT_SAME_MIN


# the [B*H, S, D] configuration's kernels: flash_fwd_hpack (K3) and
# flash_bwd_fused (K4a).  "bh" cases run the [B*H, S, 1, D] layout the
# public function hands them; otherwise heads are consecutive along B*H
# of a [B, S, H, D] tensor, so with an odd H a CTA's heads straddle two
# batches.
BH_CASES = {
    "fp32 causal ragged S=130 hp=2": dict(B=1, Sq=130, Sk=130, H=2,
                                          causal=True, hp=2, bh=True),
    "fp32 non-causal Sq=70 Sk=150 hp=4": dict(B=2, Sq=70, Sk=150, H=2,
                                              causal=False, hp=4),
    "fp32 odd H=3 hp=2 straddles batches": dict(B=2, Sq=65, Sk=65, H=3,
                                                causal=True, hp=2),
    "fp32 segments + masked row": dict(B=1, Sq=100, Sk=96, H=2,
                                       causal=False, seg=True),
    "fp32 D=128 causal": dict(B=1, Sq=80, Sk=80, H=1, D=128, causal=True),
    "bf16 causal S=96 hp=2": dict(B=1, Sq=96, Sk=96, H=2, causal=True, hp=2,
                                  bh=True, dtype=torch.bfloat16),
    "bf16 non-causal Sq=33 Sk=70 hp=4": dict(B=1, Sq=33, Sk=70, H=4,
                                             causal=False, hp=4,
                                             dtype=torch.bfloat16),
    "fp16 causal S=96 hp=2": dict(B=1, Sq=96, Sk=96, H=2, causal=True,
                                  hp=2, bh=True, dtype=torch.float16),
    "fp32 D=16 odd H=3 hp=2": dict(B=2, Sq=65, Sk=65, H=3, D=16,
                                   causal=True, hp=2),
    "fp16 D=16 causal S=130 hp=2": dict(B=1, Sq=130, Sk=130, H=2, D=16,
                                        causal=True, hp=2, bh=True,
                                        dtype=torch.float16),
    "bf16 D=32 non-causal Sq=33 Sk=70 hp=4": dict(B=1, Sq=33, Sk=70, H=4,
                                                  D=32, causal=False, hp=4,
                                                  dtype=torch.bfloat16),
}


def _bh_inputs(case):
    c = dict(BH_CASES[case])
    B, Sq, Sk, H = c["B"], c["Sq"], c["Sk"], c["H"]
    D, dtype = c.get("D", 64), c.get("dtype", torch.float32)
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    q, g = [torch.randn(B, Sq, H, D, generator=gen).to(dtype)
            for _ in range(2)]
    k, v = [torch.randn(B, Sk, H, D, generator=gen).to(dtype)
            for _ in range(2)]
    qs = ks = None
    if c.get("seg"):
        qs = torch.zeros(B, Sq, dtype=torch.int32)
        qs[:, Sq // 2:] = 1
        qs[:, 3] = 7                                   # sees no key
        ks = torch.zeros(B, Sk, dtype=torch.int32)
        ks[:, Sk // 3:] = 1
    if c.get("bh"):
        q, k, v, g = [t.permute(0, 2, 1, 3).reshape(B * H, -1, 1, D)
                      .contiguous() for t in (q, k, v, g)]
    return c, q, k, v, g, qs, ks


@pytest.mark.parametrize("case", list(BH_CASES))
def test_bh_kernels_match_plain(emu_libs, case):
    c, q, k, v, g, qs, ks = _bh_inputs(case)
    lib, scale = emu_libs["flash_attention"], 1.0 / math.sqrt(q.shape[-1])
    causal, dtype = c["causal"], q.dtype
    tol = TOLS[dtype]
    out, lse = fk._launch_fwd(lib, None, q, k, v, causal, qs, ks, scale)
    if "hp" in c:
        hout, hlse = fk._launch_fwd_hpack(lib, None, q, k, v, c["hp"],
                                          causal, scale)
        # each head in flash_fwd's order: the same bits
        assert torch.equal(hout, out) and torch.equal(hlse, lse)
        rout, rlse = fk.flash_attention_reference(
            *[t.float() for t in (q, k, v)], causal, scale=scale)
        _close(hout, rout, tol, "hpack out")
        _close(hlse, rlse, tol, "hpack lse")
    dq, dk, dv = fk._launch_bwd_fused(lib, None, q, k, v, out, lse, g, causal,
                                      qs, ks, scale)
    ref = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal, qs, ks,
                                       scale)
    for what, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == r.shape
        _close(got, r, tol, what)
    if dtype == torch.float32:
        # the fused sweep against the split pair on the same inputs
        sdq, delta = fk._launch_bwd_dq(lib, None, q, k, v, out, lse, g,
                                       causal, qs, ks, scale)
        sdk, sdv = fk._launch_bwd_dkv(lib, None, q, k, v, g, lse, delta,
                                      causal, qs, ks, scale)
        for what, got, r in (("dq", dq, sdq), ("dk", dk, sdk),
                             ("dv", dv, sdv)):
            _close(got, r, FP32_TOL, f"fused vs split {what}")
    if qs is not None:
        assert (dq[:, 3] == 0).all()


def test_fused_backward_dk_dv_same_bits_every_run(emu_libs):
    """dk and dv have one summation order; dq's partial sums meet
    through atomics (fixed order here, where blocks run in turn)."""
    _, q, k, v, g, _, _ = _bh_inputs("bf16 causal S=96 hp=2")
    lib = emu_libs["flash_attention"]
    out, lse = fk._launch_fwd(lib, None, q, k, v, True, None, None, 0.125)

    def run():
        return fk._launch_bwd_fused(lib, None, q, k, v, out, lse, g, True,
                                    None, None, 0.125)

    (dq1, dk1, dv1), (dq2, dk2, dv2) = run(), run()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    _close(dq1, dq2, FP32_TOL, "dq run to run")


def test_bh_entries_refuse_what_they_are_not_built_for(emu_libs):
    lib = emu_libs["flash_attention"]
    q = torch.zeros(1, 8, 3, 64)
    with pytest.raises(RuntimeError, match="flash_fwd_hpack"):
        fk._launch_fwd_hpack(lib, None, q, q, q, 2, True, 0.125)  # BH = 3
    q = torch.zeros(1, 8, 2, 128)
    with pytest.raises(RuntimeError, match="flash_fwd_hpack"):
        fk._launch_fwd_hpack(lib, None, q, q, q, 2, True, 0.125)  # D = 128
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(RuntimeError, match="flash_fwd"):
        fk._launch_fwd(lib, None, q, q, q, True, None, None, 0.125)  # D = 48


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_paged_attention_kernel_matches_plain(emu_libs, dtype, tol):
    _paged_matches_plain(emu_libs, dtype, tol, 64)


@pytest.mark.parametrize("dtype,Dh", [
    (torch.float16, 64), (torch.float32, 16), (torch.bfloat16, 16),
    (torch.float16, 48),
])
def test_paged_attention_kernel_fp16_and_small_head_dims(emu_libs, dtype,
                                                         Dh):
    """Dh a multiple of 32 runs a warp per row; Dh = 16 (gpt_tiny's) and
    48 half a warp, two token tiles per warp."""
    _paged_matches_plain(emu_libs, dtype, TOLS[dtype], Dh)


def _paged_matches_plain(emu_libs, dtype, tol, Dh):
    B, H, BS, NB, MAXNB = 4, 2, 16, 16, 4
    lengths_l = [0, 1, 17, 64]
    rng = np.random.default_rng(3)
    table = np.zeros((B, MAXNB), dtype=np.int32)
    free = rng.permutation(np.arange(1, NB)).tolist()
    for b, n in enumerate(lengths_l):
        table[b, :-(-n // BS)] = [free.pop() for _ in range(-(-n // BS))]
    gen = torch.Generator().manual_seed(4)
    pool_k, pool_v = [torch.randn(NB, BS, H, Dh, generator=gen).to(dtype)
                      for _ in range(2)]
    q = torch.randn(B, H, Dh, generator=gen).to(dtype)
    table_t = torch.from_numpy(table)
    lengths = torch.tensor(lengths_l, dtype=torch.int32)
    out = torch.empty_like(q)
    err = emu_libs["paged_attention"].paddle_paged_attention(
        pak._DTYPE_CODES[dtype], q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), table_t.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Dh, NB, BS, MAXNB, 1.0 / math.sqrt(Dh), None)
    assert err == 0
    ref = pak.paged_ragged_attention_reference(
        pool_k.float(), pool_v.float(), table_t, lengths, q.float())
    _close(out, ref, tol, "out")
    assert (out[0] == 0).all()


# the split-K kernel (csrc/paged_attention_sm90.cu): its mbarriers and
# bulk copies run on the plain twins of tests/cuda_emu/sm90.cuh (a copy
# is a memcpy counted off its barrier, after the card's alignment
# checks); the SM count sets the plan's split count
PAGED_SPLIT_CASES = {
    "fp32 Dh=64 BS=16, 2 splits": dict(
        dtype=torch.float32, H=2, Dh=64, BS=16, MAXNB=4,
        lengths=[0, 1, 17, 64], sms=4),
    "bf16 Dh=64 BS=16, 2 splits": dict(
        dtype=torch.bfloat16, H=2, Dh=64, BS=16, MAXNB=4,
        lengths=[0, 1, 17, 64], sms=4),
    "fp16 Dh=48 BS=8, 4 splits, half-empty lane groups": dict(
        dtype=torch.float16, H=3, Dh=48, BS=8, MAXNB=8,
        lengths=[5, 0, 64, 33], sms=8),
    "fp32 Dh=256 head groups of 2, one split": dict(
        dtype=torch.float32, H=8, Dh=256, BS=4, MAXNB=8,
        lengths=[32, 7, 13], sms=4),
    "bf16 Dh=256 head groups of 4, 4 splits": dict(
        dtype=torch.bfloat16, H=8, Dh=256, BS=16, MAXNB=4,
        lengths=[64, 20], sms=8),
    "bf16 Dh=16 BS=24, 16-token tiles, 3 token groups, 2 stages": dict(
        dtype=torch.bfloat16, H=4, Dh=16, BS=24, MAXNB=3,
        lengths=[72, 49], sms=4, plan=pak.SplitPlan(4, 16, 3, 2, 40, 2)),
    "fp32 Dh=32 stale row: length past MAXNB*BS, page id past the pool": dict(
        dtype=torch.float32, H=2, Dh=32, BS=4, MAXNB=6,
        lengths=[24, 24, 0], sms=6, stale=True),
    "bf16 Dh=64 one split, empty rows (no combine launch)": dict(
        dtype=torch.bfloat16, H=2, Dh=64, BS=16, MAXNB=4,
        lengths=[0, 64, 0, 5], sms=1, splits=1),
    "fp32 Dh=256 head groups, one split, empty rows": dict(
        dtype=torch.float32, H=8, Dh=256, BS=4, MAXNB=8,
        lengths=[0, 32, 0], sms=1, splits=1),
}


@pytest.fixture(scope="module")
def paged_sm90_lib(tmp_path_factory):
    if emulate.compiler() is None:
        pytest.skip("no g++ to build the CUDA emulation")
    out = tmp_path_factory.mktemp("cuda_emu_paged_sm90")
    return pak.bind(ctypes.CDLL(str(emulate.build(
        _build.CSRC_DIR / "paged_attention_sm90.cu", out))))


@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_paged_split_kernel_matches_plain(paged_sm90_lib, case):
    c = PAGED_SPLIT_CASES[case]
    dtype, H, Dh, BS, MAXNB = (c["dtype"], c["H"], c["Dh"], c["BS"],
                               c["MAXNB"])
    lengths_l = c["lengths"]
    B, NB = len(lengths_l), len(lengths_l) * MAXNB + 1
    rng = np.random.default_rng(5)
    table = np.zeros((B, MAXNB), dtype=np.int32)
    free = rng.permutation(np.arange(1, NB)).tolist()
    for b, n in enumerate(lengths_l):
        table[b, :-(-n // BS)] = [free.pop() for _ in range(-(-n // BS))]
    gen = torch.Generator().manual_seed(6)
    pool_k, pool_v = [torch.randn(NB, BS, H, Dh, generator=gen).to(dtype)
                      for _ in range(2)]
    q = torch.randn(B, H, Dh, generator=gen).to(dtype)
    table_t = torch.from_numpy(table)
    lengths = torch.tensor(lengths_l, dtype=torch.int32)
    ref_lengths = lengths
    if c.get("stale"):
        table_t[0, -1] = NB + 5                # clamps to the last page
        lengths = lengths.clone()
        lengths[1] = MAXNB * BS + 9            # clamps to MAXNB*BS
        ref_lengths = lengths.clamp(max=MAXNB * BS)
    plan = c.get("plan") or pak.split_plan(B, H, Dh, BS, MAXNB,
                                           q.element_size(), c["sms"])
    assert plan.splits == c.get("splits", plan.splits)
    args = (pool_k, pool_v, table_t, lengths, q, 1.0 / math.sqrt(Dh),
            c["sms"])
    # NaN-filled outputs: an element the kernels leave unwritten fails
    out, again = [pak._launch_sm90(paged_sm90_lib, None, *args, plan=plan,
                                   out=torch.full_like(q, float("nan")))
                  for _ in range(2)]
    f32 = (pool_k.float(), pool_v.float(), table_t.clamp(0, NB - 1),
           ref_lengths, q.float())
    ref = pak.paged_ragged_attention_reference(*f32)
    _close(out, ref, TOLS[dtype], "out vs plain")
    _close(out, pak.paged_split_reference(*f32, plan.split_tokens),
           TOLS[dtype], "out vs the plain mirror of the split")
    assert out.dtype == dtype and torch.equal(out, again)
    assert bool((out[lengths == 0] == 0).all())


LMCE_CASES = {
    "fp32 D=64 ragged rows+vocab, ignored labels": dict(
        N=70, V=300, D=64, ignore=True),
    "fp32 D=200": dict(N=45, V=257, D=200),
    "fp32 D=768": dict(N=33, V=130, D=768),
    "fp32 D=1032 (two gradient slices)": dict(N=36, V=131, D=1032,
                                             ignore=True),
    "bf16 D=64 ignored labels": dict(N=64, V=200, D=64, ignore=True,
                                     dtype=torch.bfloat16),
    "bf16 D=200": dict(N=33, V=129, D=200, dtype=torch.bfloat16),
    "bf16 D=768 ignored labels": dict(N=40, V=260, D=768, ignore=True,
                                      dtype=torch.bfloat16),
    "fp16 D=64 ignored labels": dict(N=64, V=200, D=64, ignore=True,
                                     dtype=torch.float16),
    "fp16 D=200": dict(N=33, V=129, D=200, dtype=torch.float16),
}


def _lmce_inputs(N, V, D, dtype, ignore, seed):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32)
                         * np.float32(0.05))
    labels = torch.from_numpy(rng.integers(0, V, N).astype(np.int32))
    if ignore:
        labels[::4] = -100
        labels[1] = -1
    g = torch.from_numpy(rng.random(N, dtype=np.float32))
    return h.to(dtype), w.to(dtype), labels, g


@pytest.mark.parametrize("case", list(LMCE_CASES))
def test_lmce_kernels_match_plain(lmce_lib, case):
    c = dict(LMCE_CASES[case])
    dtype = c.get("dtype", torch.float32)
    h, w, labels, g = _lmce_inputs(c["N"], c["V"], c["D"], dtype,
                                   c.get("ignore", False),
                                   sum(map(ord, case)))
    loss, lse = lk._launch_fwd(lmce_lib, None, h, w, labels)
    dh = lk._launch_bwd_dh(lmce_lib, None, h, w, labels, lse, g)
    dw = lk._launch_bwd_dw(lmce_lib, None, h, w, labels, lse, g)
    rloss, rlse = lk.lmce_reference(h, w, labels)
    rdh = lk.lmce_bwd_dh_reference(h, w, labels, lse, g)
    rdw = lk.lmce_bwd_dw_reference(h, w, labels, lse, g)
    tol = TOLS[dtype]
    for what, got, ref in (("loss", loss, rloss), ("lse", lse, rlse),
                           ("dh", dh, rdh), ("dw", dw, rdw)):
        _close(got, ref, tol, what)
    assert loss.dtype == lse.dtype == torch.float32
    assert dh.dtype == dw.dtype == dtype
    assert dh.shape == h.shape and dw.shape == w.shape
    if c.get("ignore"):
        ignored = labels < 0
        assert (loss[ignored] == 0).all() and (dh[ignored] == 0).all()
        assert (loss[~ignored] > 0).all()


def test_lmce_kernels_are_deterministic(lmce_lib):
    h, w, labels, g = _lmce_inputs(40, 140, 64, torch.float32, True, 5)

    def run():
        loss, lse = lk._launch_fwd(lmce_lib, None, h, w, labels)
        return (loss, lse,
                lk._launch_bwd_dh(lmce_lib, None, h, w, labels, lse, g),
                lk._launch_bwd_dw(lmce_lib, None, h, w, labels, lse, g))

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
