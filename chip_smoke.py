"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with a CUDA card.  It
builds the port's CUDA kernels from ``paddle_tpu_torch/csrc`` with
``nvcc`` (one process per source, all at once, into the git-ignored
``paddle_tpu_torch/_build/``) and then:

1. prints the card (``nvidia-smi`` name and power limit), the CUDA
   version and the kernel build time; turns TF32 off for the fp32
   phases;
2. ``[kernel]`` holds the split-K paged-attention kernel
   (``csrc/paged_attention_sm90.cu``) against its plain PyTorch version
   at GPT-2-small decode shapes with ragged lengths and scattered page
   tables in fp32 (within 1e-5 max abs error), bf16 and fp16, each
   element within half an ulp of the output dtype plus the fp32
   reorder bound and, in 16 bits, at least ``K1_SAME_MIN`` of the
   elements equal to the rounded plain output (:func:`paged_gate`);
   three broken outputs (one split left out of the combine, the tail
   mask off by one, a page id replaced by its neighbour) must fail that
   gate; empty rows exactly 0, two runs bitwise equal and equal to a
   third into a NaN-filled output, no ptxas spill; then at B=256 in fp32
   and bf16, a plan of one split (no combine launch) with every fourth
   row empty.  Times the kernel (``torch.profiler`` device time and CUDA events,
   L2 flushed before each call) beside the kernel it replaced
   (``_cuda_core_paged``), the plain version, the bound and, as a
   yardstick only, ``scaled_dot_product_attention`` on pre-gathered
   K/V; ``[kernel long]`` does the same at the long-context tier's
   shape, every request 32768 tokens, with pages of 16 and 256 tokens
   (and ragged lengths up to 32768 in bf16, with the controls);
3. ``[flash]`` holds the three flash-attention kernels (forward, dq,
   dk/dv) against their plain versions: at the training path's shapes
   (B=8, S=1024, H=12, D=64, causal) as strided ``[B, S, H, D]`` views
   of a fused qkv tensor and in the ``[B*H, S, D]`` layout, in bf16
   (within 2e-2 x max(|ref|, 1)) and fp32 (within 1e-4 x max(|ref|, 1));
   then at awkward shapes in fp32: S=1000 (ragged tiles), non-causal
   Sq=384 != Sk=640, D=128, segment ids with fully-masked rows (output
   exactly 0), and GQA through the public ``flash_attention`` with
   gradients through autograd.  Times each kernel, its plain version
   and, as a yardstick only, ``scaled_dot_product_attention`` forward
   and forward+backward at the main shape in bf16;
4. ``[lmce]`` holds the three fused lm-head cross-entropy kernels
   (forward, dh, dW; for bf16 operands the tensor-core kernels, for
   fp32 the CUDA-core ones) against their plain versions
   computed in fp32 on the same values: at the training path's shape
   (N=8192, V=50304, D=768) in bf16 (within 2e-2 x max(|ref|, 1)) and
   fp32 (within 1e-4 x max(|ref|, 1)), then in fp32 at N=1000 (ragged
   rows) with V=1000 and V=786 (ragged vocab), every fourth label -100
   (loss and dh rows exactly 0), D=64, 200 and 2048.  Times the
   forward, its plain version and, as a yardstick only, ``h @ W.T``
   with fp32 ``F.cross_entropy``, forward and forward+backward, in
   bf16 (the backward's times are ``[lmce tc]``'s);
5. serves GPT-2-small (12 layers, hidden 768, 12 heads, vocab 50304,
   random weights from ``--seed``) through ``LLMServer`` in fp32:
   12 greedy requests over 8 slots; checks every token count, that
   the kernel launched exactly 12 times per decode dispatch (and the
   comparison entry ``_cuda_core_paged`` never), and that
   two requests' tokens equal the sequential ``reference_decode``;
6. serves the same model in bf16 and checks counts and launches;
7. ``[train]`` trains GPT-2-small at full width through
   ``Model.fit``: B=8, S=1024, dropout 0, ``amp.decorate(level="O2",
   dtype="bfloat16")``, ``AdamW(1e-4, multi_precision=True)``, random
   weights and tokens from ``--seed``, labels = tokens rolled by one,
   TRAIN_STEPS steps on one repeated batch.  Checks finite losses, the
   last below the first, each flash kernel launched 12 times per step
   and no plain call; prints step ms, tokens/s and peak memory, and a
   ``torch.profiler`` breakdown of two more steps;
8. ``[train fused lmce]`` repeats 7 with ``enable_fused_lmce`` (the
   lm head and the loss in the three lmce kernels, the logits never in
   device memory): also checks each lmce kernel launched once per
   step, all three as the tensor-core kernels (``.tc``) and the
   CUDA-core forward and backward never, the first loss within 1e-2
   relative of
   7's and a lower peak; ``[train fp16]`` repeats 7 after
   ``amp.decorate(level="O2")`` with its default dtype, float16, and
   no GradScaler: finite losses, the launch checks of 7 and the first
   loss within 1e-2 relative of 7's;
9. ``[train fp32 parity]`` trains a small GPT (2 layers, hidden 128,
   head dim 64, S=256) for three steps on the card and on the CPU's
   plain path from the same weights and compares the losses, unfused
   and fused;
10. ``[flash bh]`` holds the ``[B*H, S, D]`` configuration's kernels,
    ``flash_fwd_hpack`` (head-packed forward) and ``flash_bwd_fused``
    (single-sweep backward), against their plain versions at GPT's
    ``[96, 1024, 64]`` causal and ERNIE's ``[192, 512, 64]`` non-causal
    shapes, in bf16 (within 2e-2 x max(|ref|, 1)) and fp32 (within
    1e-4 x max(|ref|, 1)), and in fp32 against ``flash_fwd`` and the
    split ``flash_bwd_dq`` + ``flash_bwd_dkv`` (within 1e-5 x
    max(|ref|, 1)); then in fp32 at S=1000, odd H with hp=2 (heads
    straddling batches), hp=4, segment ids with fully-masked rows
    (exactly 0) and, through the public ``flash_attention`` under the
    knobs, D=128, whose launches must show ``flash_fwd``, not the
    head-packed kernel.  Times each kernel, its plain version and, as
    a yardstick only, ``scaled_dot_product_attention`` forward (and
    forward+backward for the fused backward), and the ``[B*H, S, D]``
    layout copies;
11. ``[flash tc]`` holds the tensor-core forward of bf16
    ``flash_fwd`` and ``flash_fwd_hpack`` (``csrc/flash_fwd_sm90.cu``,
    ``wgmma`` fed by TMA) against ``flash_fwd_tc_reference`` (p rounded
    to bf16 as the kernel rounds it; within 1e-2 x max(|ref|, 1)) at
    GPT's ``[8, 1024, 12, 64]`` views and ``[96, 1024, 64]`` causal,
    ERNIE's ``[192, 512, 64]`` non-causal, S=1000, Sq != Sk, D=128,
    odd H with hp=2 (packs straddling batches), hp=4 and segment ids
    with a fully-masked row (out exactly 0, lse the floor); the
    head-packed kernel bitwise against ``flash_fwd``; counts the
    ``HGMMA`` instructions in the library's SASS and prints ptxas's
    registers and spills; times the kernels at the three main shapes
    beside the CUDA-core forward they replaced for bf16, the plain
    version and, as a yardstick only, SDPA, with the bound and
    TFLOP/s;
12. ``[flash tc bwd]`` holds the tensor-core split backward of bf16
    and fp16 ``flash_bwd_dq`` and ``flash_bwd_dkv``
    (``csrc/flash_bwd_sm90.cu``) against the plain versions (dS and p
    rounded to the input dtype, as the TPU kernels round them) at GPT's
    ``[8, 1024, 12, 64]`` views causal, ``[B*H, S, D]`` with segment ids
    and a fully-masked row (dq exactly 0), S=1000, non-causal Sq=384
    Sk=640 and D=128, element by element (:func:`flash_bwd_gate`: each
    element within rtol |ref| plus the bound of rounding each term once
    and of the fp32 sums' order, and at least ``TC_BWD_SAME_MIN`` of the
    elements equal to the plain version's in the 16-bit dtype), delta
    within its fp32 bound, two runs bitwise equal; at the main shape a
    backward with delta = 0 and one with dS and p unrounded must fail
    the same gate; counts the ``HGMMA`` instructions, prints ptxas's
    registers and spills (none allowed); times the pair at the main
    shape by CUDA events and by device time (``torch.profiler``) beside
    the CUDA-core pair it replaced for 16-bit inputs, the plain
    versions and, as a yardstick only, SDPA's backward alone;
12b. ``[flash tc fused]`` holds the tensor-core fused backward
    (``flash_bwd_fused`` on bf16 and fp16 at D 64/128, the fused sweep of
    ``csrc/flash_bwd_sm90.cu``) against ``flash_bwd_fused_reference``
    element by element with the same gate at GPT's ``[96, 1024, 64]``
    causal and ERNIE's ``[192, 512, 64]`` non-causal, segment ids with a
    fully-masked row (dq exactly 0), S=1000, Sq=384 != Sk=640 and D=128,
    with the delta = 0 and unrounded controls at GPT's shape (which must
    fail), two runs' dk and dv bitwise equal (dq's atomic reduce-adds may
    reorder); prints registers and spills (none allowed); times it at
    both main shapes by device time beside the CUDA-core sweep it
    replaced for 16-bit inputs, the tensor-core split pair and, as a
    yardstick only, SDPA's backward alone;
13. ``[train bh]`` repeats 7 with ``PADDLE_TORCH_FLASH_NO_PACKED=1``,
    ``HEADPACK=2`` and ``FUSED_BWD=1``: the two kernels launched 12
    times per step, both as the tensor-core kernels (the fused
    backward's pre-pass and bf16 epilogue as often), the default path's
    three flash kernels never, no plain call, the first loss within
    1e-2 relative of 7's;
14. ``[train ernie bh]`` trains ERNIE-3.0-base MLM (12 layers, hidden
    768, 12 heads, vocab 40000, random weights from ``--seed``) at
    B=16, S=512, bf16 O2, AdamW, dropout 0, under the same knobs,
    labels = the tokens on 15% of positions and -100 elsewhere, with
    the checks of 13 (the first loss against the default path's loss
    on the same weights and batch) and a profile;
15. ``[train fp32 parity bh]`` trains a small GPT and a small BERT
    (2 layers, hidden 128, head dim 64, S=256) for three fp32 steps on
    the card and on the CPU under the knobs and compares the losses
    (fp32 never launches the tensor-core forward);
16. ``[lmce tc]`` holds the tensor-core LMCE backward
    (``csrc/lmce_sm90.cu``, ``wgmma`` fed by TMA) against its plain
    versions (dL rounded to the operand dtype; each element within
    rtol |ref| + (u |dL| + eta) @ |B|: rtol one ulp of the value, 1e-2
    bf16 and 2e-3 fp16, then the bound of rounding each dL once) at
    the main shape in bf16 and fp16 and at N=333 V=786 D=200, N=1000
    V=1000 D=64 and N=1000 V=786 D=2048 (every fourth label -100) in
    both: ignored rows of dh exactly 0, two runs bitwise equal, and at
    the main shape the gradient of a backward without the S product
    fails the same gate; counts the ``HGMMA`` instructions in its SASS and
    prints ptxas's registers and spills; times both kernels at the main
    shape beside the CUDA-core backward they replaced for 16-bit
    operands and the plain versions, with the bound and TFLOP/s;
16b. ``[lmce tc fwd]`` holds the tensor-core forward
    (``csrc/lmce_fwd_sm90.cu``: 128 h rows a CTA, W streamed through a
    TMA ring, the vocabulary split into slices merged by a second pass)
    against ``lmce_reference`` per row (:func:`lmce_fwd_gate`: fp32 sums
    of D products and of V exps in other orders) at the main shape and
    N=333 V=786 D=200, N=1000 V=1000 D=64 and N=1000 V=786 D=2048 (h
    streamed), bf16 and fp16: ignored rows exactly 0, two runs bitwise
    equal, and at V=786 D=200 three broken forwards (the ragged
    vocabulary edge dropped, the label column off by one, one slice left
    out of the combine) fail the gate; counts ``HGMMA``, prints
    registers and spills (none allowed); times it at the main shape by
    device time and events beside the CUDA-core forward it replaced for
    16-bit operands, the plain version and, as a yardstick only,
    ``h @ W.T`` with fp32 ``F.cross_entropy``;
17. ``[fp16]`` holds every kernel against its plain version in fp16
    (within 1e-2 x max(|ref|, 1)): K1, the flash forward (tensor-core
    and CUDA-core), dq/dkv, the fused backward, the head-packed forward
    (both bodies) at ``[train fp16]``'s views (B=8, S=1024, H=12,
    D=64), and the three LMCE kernels (the backward's both bodies held
    element by element, as in 16);
18. ``[headdim]`` holds the flash kernels (forward, split and fused
    backward, head-packed forward at hp 2 and 4) at head dims 16 and 32
    in fp32, bf16 and fp16, causal and not (no tensor-core launch: below
    64 the CUDA-core forward runs), and K1 at Dh=16 (half a warp per
    row), each against its plain version;
19. prints the kernels' JSON line, the card line, and last the line
    ``{"ok": true, "device": {...}}``.

In every training phase each 16-bit flash launch (forward, split and
fused backward) must be the tensor-core kernel's
(``<wrapper>.tc_launches`` equal to ``launches``: 12 per step each) and
the CUDA-core comparison entries, which the timings call through
``_cuda_core_fwd`` and ``_cuda_core_flash_bwd``, must not launch;
likewise every 16-bit lmce launch (forward, dh, dW) is the tensor-core
kernel's and ``lmce_kernel._cuda_core_fwd`` / ``_cuda_core_bwd`` never
launch.

Any failed check raises, so the script exits non-zero; without a card,
or without the repository beside it, it exits non-zero before any
result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
FP32_TOL = 1e-5
BF16_TOL = 2e-2
FLASH_FP32_TOL = 1e-4            # x max(|ref|, 1); fp32 sums reordered
FLASH_BF16_TOL = 2e-2            # x max(|ref|, 1); bf16 inputs/outputs
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 8
PARITY_TOL = 1e-4                # relative, per loss; cuBLAS vs CPU sums
FUSED_FIRST_LOSS_TOL = 1e-2      # relative; the unfused path rounds the
                                 # logits to bf16, the fused one does not
FP16_FIRST_LOSS_TOL = 1e-2       # relative; fp16 against bf16 rounding
BH_FIRST_LOSS_TOL = 1e-2         # relative; the [B*H, S, D] path rounds
                                 # p and dS to bf16 in the fused backward
FLASH_PAIR_TOL = 1e-5            # x max(|ref|, 1); kernel against kernel,
                                 # fp32, sums in other orders or atomics
ERNIE_B, ERNIE_S = 16, 512
BH_KNOBS = {"PADDLE_TORCH_FLASH_NO_PACKED": "1",
            "PADDLE_TORCH_FLASH_HEADPACK": "2",
            "PADDLE_TORCH_FLASH_FUSED_BWD": "1"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_cuda(torch, fn, iters, warmup=5, flush=None):
    """Median milliseconds per call, CUDA events around each call; the
    L2 flush (if any) runs outside the timed region."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# paged decode attention (K1): csrc/paged_attention_sm90.cu
# ---------------------------------------------------------------------------
K1_SOURCE = "paddle_tpu_torch/csrc/paged_attention_sm90.cu"
K1_CORE_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
K1_REPLACES = "paddle_tpu/inference/serving/paged_attention_kernel.py:62"
K1_SAME_MIN = 0.99               # share of 16-bit outputs equal to the
                                 # plain output rounded to the dtype
K1_LONG = 32768                  # tokens a request holds in [kernel long]
K1_NAMES = {"split": ("paged_split_kernel",),
            "combine": ("paged_combine_kernel",)}
K1_CORE_NAMES = {"core": ("paged_attn_kernel",)}
F32_EPS = 2.0 ** -23
HALF_ULP = {"bfloat16": (7, -126), "float16": (10, -14)}  # (mantissa
                                 # bits, least normal exponent)


def paged_inputs(torch, seed, B, H, Dh, BS, MAXNB, lengths_l):
    """fp32 pools of ``B*MAXNB + 1`` pages (page 0 the scratch page), each
    request's pages scattered over the pool, q; on the card."""
    NB = B * MAXNB + 1
    rng = np.random.default_rng(seed)
    table = np.zeros((B, MAXNB), dtype=np.int32)
    free = rng.permutation(np.arange(1, NB)).tolist()
    for b, n in enumerate(lengths_l):
        nb = -(-n // BS)
        table[b, :nb] = [free.pop() for _ in range(nb)]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pool_k = torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
    pool_v = torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
    q = torch.randn((B, H, Dh), generator=gen, device=dev)
    return (pool_k, pool_v, torch.as_tensor(table, device=dev),
            torch.as_tensor(np.array(lengths_l, np.int32), device=dev), q)


def paged_exact(torch, inputs, v_abs=False):
    """The plain version's arithmetic in fp64 on the same values (its
    rounding far under fp32's): ``[B, H, Dh]``; with ``v_abs``, of |v|
    (``a = sum_t p_t |v_t| / l``)."""
    pk, pv, table, lengths, q = inputs
    NB, BS, H, Dh = pk.shape
    idx = table.long().clamp(0, NB - 1)
    k = pk.double()[idx].flatten(1, 2)                 # [B, T, H, Dh]
    v = pv.double()[idx].flatten(1, 2)
    if v_abs:
        v = v.abs()
    logits = torch.einsum("bhd,bthd->bht", q.double(), k) / np.sqrt(Dh)
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, :]
    logits = torch.where(valid, logits, -1e30)
    w = torch.where(valid, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    den = w.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bht,bthd->bhd", w / den, v)


def paged_gate(torch, got, ref, inputs, plan, exact):
    """Per element against ``exact``, the fp64 output and ``a`` of
    :func:`paged_exact`:
    ``|got - exact| <= half an ulp of |exact| + eta`` in the output dtype
    (no rounding term for fp32), eta the bound of the kernel's fp32
    arithmetic: ``((2n + 8) eps + ds) (a + |exact|)`` with ``n = 2
    ceil(ST/TS) + TS + NS`` the longest chain of fp32 sums and rescalings
    a token's term meets (a lane group's, then the merges of the token
    groups and of the splits), ``ds = Dh eps scale max_t sum_i |q_i
    k_ti|`` a score's own error, ``8 eps`` for the exps and the division
    and ``a = sum_t p_t |v_t| / l``.  Returns ``(largest |err| / bound,
    share of elements equal to the fp32 plain output ``ref`` rounded to
    the dtype)``; passes at ratio <= 1 and, in 16 bits, share >=
    ``K1_SAME_MIN``."""
    pk, pv, table, lengths, q = inputs
    NB, BS, H, Dh = pk.shape
    T = table.shape[1] * BS
    ex, a = exact
    kg = pk.float().abs()[table.long().clamp(0, NB - 1)].reshape(
        -1, T, H, Dh)
    dots = torch.einsum("bhd,bthd->bht", q.float().abs(), kg)
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, :]
    ds = Dh * F32_EPS / np.sqrt(Dh) * torch.where(valid, dots, 0.0).amax(-1)
    del kg, dots
    n = 2 * -(-plan.split_tokens // plan.token_groups) + \
        plan.token_groups + plan.splits
    eta = ((2 * n + 8) * F32_EPS + ds.double())[..., None] * (a + ex.abs())
    bound = eta
    name = str(got.dtype).split(".")[-1]
    if name in HALF_ULP:
        bits, emin = HALF_ULP[name]
        e = torch.floor(torch.log2((ex.abs() + eta).clamp_min(2.0 ** emin)))
        bound = bound + 0.5 * torch.exp2(e - bits)
    diff = (got.double() - ex).abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / bound).max().item()
    share = (got == ref.to(got.dtype)).float().mean().item()
    return ratio, share


def paged_controls(torch, pak, inputs, plan, dtype):
    """Three broken outputs the gate must fail: one split left out of the
    combine, the tail mask off by one, a page id replaced by its
    neighbour in the pool (each from the plain version, rounded to
    ``dtype``)."""
    pk, pv, table, lengths, q = [t.float() if t.is_floating_point() else t
                                 for t in inputs]
    NB, BS = pk.shape[:2]
    T = table.shape[1] * BS
    m, l, acc = pak.paged_split_partials(pk, pv, table, lengths, q,
                                         plan.split_tokens)
    m[:, 1], l[:, 1], acc[:, 1] = -1e30, 0.0, 0.0
    longest = int(lengths.argmax().item())
    moved = table.clone()
    moved[longest, 1] = moved[longest, 1] % (NB - 1) + 1
    return {
        "split 1 not combined": pak.paged_split_combine(
            m, l, acc, lengths, plan.split_tokens, T, dtype),
        "tail mask + 1": pak.paged_ragged_attention_reference(
            pk, pv, table, torch.where(lengths > 0, lengths + 1,
                                       lengths).clamp(max=T), q).to(dtype),
        "page id + 1": pak.paged_ragged_attention_reference(
            pk, pv, moved, lengths, q).to(dtype),
    }


def paged_check(torch, pak, phase, tag, inputs, controls=False):
    """The kernel on ``inputs`` against the plain version on the same
    values in fp32 and against the plain mirror of its split
    (:func:`paged_gate`), two runs bitwise equal, empty rows exactly 0;
    ``controls``: the three broken outputs of :func:`paged_controls` fail
    the gate.  Returns ``{max_abs_err, split_max_abs_err, gate_ratio,
    equal_share, plan}``."""
    pk, pv, table, lengths, q = inputs
    B, MAXNB = table.shape
    NB, BS, H, Dh = pk.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = pak.split_plan(B, H, Dh, BS, MAXNB, q.element_size(), sms)
    before = pak.paged_ragged_attention.launches
    core_before = pak._cuda_core_paged.launches
    got = pak.paged_ragged_attention(*inputs)
    again = pak.paged_ragged_attention(*inputs)
    torch.cuda.synchronize()
    check(pak.paged_ragged_attention.launches == before + 2
          and pak._cuda_core_paged.launches == core_before,
          f"[{phase}] {tag}: the split kernel did not launch (or the "
          "comparison entry did)")
    # once more into a NaN-filled output (not counted): an element the
    # kernels leave unwritten shows
    poisoned = pak._launch_sm90(
        pak._lib(pak.KERNEL_NAME), torch.cuda.current_stream().cuda_stream,
        *inputs, 1.0 / np.sqrt(Dh), sms, out=torch.full_like(q, np.nan))
    torch.cuda.synchronize()
    check(torch.equal(poisoned, got),
          f"[{phase}] {tag}: into a NaN-filled output the kernel leaves "
          "elements unwritten or differs")
    f32 = [t.float() if t.is_floating_point() else t for t in inputs]
    ref = pak.paged_ragged_attention_reference(*f32)
    sref = pak.paged_split_reference(*f32, plan.split_tokens)
    check(got.dtype == q.dtype and bool(torch.isfinite(got.float()).all()),
          f"[{phase}] {tag}: dtype {got.dtype} or not finite")
    empty = lengths == 0
    check(bool((got[empty] == 0).all()),
          f"[{phase}] {tag}: an empty row is not exactly 0")
    same = torch.equal(got, again)
    err = (got.float() - ref).abs().max().item()
    serr = (sref - ref).abs().max().item()
    exact = (paged_exact(torch, inputs),
             paged_exact(torch, inputs, v_abs=True))
    ratio, share = paged_gate(torch, got, ref, inputs, plan, exact)
    line = (f"[{phase}] {tag} {plan}: max_abs_err={err:.3e} (plain split "
            f"mirror {serr:.3e}); gate ratio {ratio:.3e} (<= 1)"
            + (f", {share:.5f} of the elements equal to the rounded plain "
               f"output" if q.dtype != torch.float32 else "")
            + f"; two runs bitwise equal: {same}, and a third into a "
            f"NaN-filled output; {int(empty.sum().item())} empty rows "
            f"exactly 0")
    ctl = {}
    if controls:
        for name, bad in paged_controls(torch, pak, inputs, plan,
                                        q.dtype).items():
            ctl[name] = paged_gate(torch, bad, ref, inputs, plan, exact)
        line += "; controls (fail, as they must): " + "; ".join(
            f"{n} ratio {r:.3e} equal {sh:.5f}" for n, (r, sh) in
            ctl.items())
    print(line, flush=True)
    sixteen = q.dtype != torch.float32
    for name, (r, sh) in ctl.items():
        check(r > 1.0 or (sixteen and sh < K1_SAME_MIN),
              f"[{phase}] {tag}: the gate passes the {name} control")
    check(ratio <= 1.0, f"[{phase}] {tag}: gate ratio {ratio:.3e} > 1")
    check(not sixteen or share >= K1_SAME_MIN,
          f"[{phase}] {tag}: {share:.5f} equal < {K1_SAME_MIN}")
    check(q.dtype != torch.float32 or err <= FP32_TOL,
          f"[{phase}] {tag}: fp32 kernel vs plain {err} > {FP32_TOL}")
    check(same, f"[{phase}] {tag}: two runs differ")
    return {"max_abs_err": err, "split_max_abs_err": serr,
            "gate_ratio": ratio, "equal_share": share, "plan": plan,
            "controls": ctl}


def l2_flush(torch):
    """A call that reads 128 MB, so the 50 MB L2 then holds none of a
    kernel's inputs and no dirty line (a write-based flush leaves ~50 MB
    for the next kernel to write back)."""
    buf = torch.zeros(128 * 1024 * 1024 // 4, device="cuda")
    return buf.sum


def k1_device_ms(torch, fn, iters, groups, flush):
    """Device milliseconds per call of ``fn`` by ``torch.profiler``, the L2
    flush run before each call and not counted: ``{group: ms}`` over the
    kernels whose name holds one of the group's substrings (an empty
    tuple: every kernel but the flush's)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush()
        torch.cuda.synchronize()
    flush_keys = {e.key for e in prof.key_averages()}
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(groups, 0.0)
    for e in prof.key_averages():
        if not e.count:
            continue
        # the profiler may drop some kernel records: a kernel's time a
        # call is its mean per launch times its launches a call
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / e.count * \
            max(1, round(e.count / iters))
        for g, subs in groups.items():
            if any(x in e.key for x in subs) if subs else \
                    e.key not in flush_keys:
                out[g] += us
    return {g: us / 1e3 for g, us in out.items()}


def host_us(torch, fn, calls=200):
    """Host microseconds per call of ``fn``: the Python loop's time with
    nothing waited on (``calls`` calls stay inside the card's launch
    queue), the device drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def paged_times(torch, pak, inputs, flush, iters, plain_iters):
    """The kernel (device time per launch pair and events), the kernel it
    replaced (``_cuda_core_paged``), the plain version and, as a
    yardstick only, SDPA over K/V gathered beforehand (the gather not
    timed: no PyTorch call attends through a page table)."""
    pk, pv, table, lengths, q = inputs
    B, MAXNB = table.shape
    NB, BS, H, Dh = pk.shape
    dev = k1_device_ms(torch, lambda: pak.paged_ragged_attention(*inputs),
                       iters, {**K1_NAMES, "all": K1_NAMES["split"]
                               + K1_NAMES["combine"]}, flush)
    core_dev = k1_device_ms(torch, lambda: pak._cuda_core_paged(*inputs),
                            iters, K1_CORE_NAMES, flush)["core"]
    host = host_us(torch, lambda: pak.paged_ragged_attention(*inputs))
    core_host = host_us(torch, lambda: pak._cuda_core_paged(*inputs))
    ms = time_cuda(torch, lambda: pak.paged_ragged_attention(*inputs),
                   iters, flush=flush)
    core_ms = time_cuda(torch, lambda: pak._cuda_core_paged(*inputs), iters,
                        flush=flush)
    plain_ms = time_cuda(torch, lambda: pak.paged_ragged_attention_reference(
        *inputs), plain_iters, warmup=1, flush=flush)
    kg, vg = pak.gather_pages(torch.stack([pk, pv])[None], 0, table)
    kg = kg.permute(0, 2, 1, 3).contiguous()              # [B, H, T, Dh]
    vg = vg.permute(0, 2, 1, 3).contiguous()
    T = kg.shape[2]
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(q[:, :, None], kg, vg, attn_mask=mask)
    lib_ms = time_cuda(torch, lib, iters, flush=flush)
    lib_dev = k1_device_ms(torch, lib, iters, {"all": ()}, flush)["all"]
    del kg, vg
    lens = lengths.tolist()
    nbytes = pak.attention_bytes(lens, BS, H, Dh, q.element_size())
    flops = 4 * sum(lens) * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return {"device_ms": dev["all"], "split_device_ms": dev["split"],
            "combine_device_ms": dev["combine"], "ms": ms,
            "host_us": host, "cuda_core_host_us": core_host,
            "cuda_core_device_ms": core_dev, "cuda_core_ms": core_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tb_per_s": nbytes / (dev["all"] * 1e-3) / 1e12}


def times_line(r):
    return (f"device_ms={r['device_ms']:.5f} (split "
            f"{r['split_device_ms']:.5f}, combine "
            f"{r['combine_device_ms']:.5f}; {r['tb_per_s']:.3f} TB/s) "
            f"kernel_ms={r['ms']:.5f} by events, host {r['host_us']:.2f} "
            f"us a call; the kernel it replaced (_cuda_core_paged) "
            f"device_ms={r['cuda_core_device_ms']:.5f} events "
            f"{r['cuda_core_ms']:.5f} host {r['cuda_core_host_us']:.2f} us; "
            f"plain_ms={r['plain_ms']:.5f}; "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}, {r['bytes']} "
            f"bytes); library yardstick (not used by the port): sdpa on "
            f"K/V gathered beforehand {r['library_ms']:.5f} ms, device "
            f"{r['library_device_ms']:.5f}")


def kernel_phase(torch, seed, nvcc_log=""):
    """``[kernel]``: the split-K kernel at GPT-2-small's decode shape
    with ragged lengths and scattered pages, fp32, bf16 and fp16, held
    by :func:`paged_check` (the three controls in bf16 and fp16), and
    timed beside the kernel it replaced, the plain version, the bound
    and SDPA (:func:`l2_flush` before each call)."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    B, H, Dh, BS, MAXNB = 8, 12, 64, 16, 64
    lengths_l = [0, 1, 16, 17, 500, 1024, 333, 64]
    if nvcc_log:
        from paddle_tpu_torch import _build
        _, regs, spills = sass_summary(
            _build.library_path("paged_attention_sm90"), nvcc_log)
        print(f"[kernel] {K1_SOURCE}: ptxas registers per kernel {regs}, "
              f"spill store bytes {spills}", flush=True)
        check(not any(spills), f"[kernel] ptxas spills {spills}")
    inputs = paged_inputs(torch, seed, B, H, Dh, BS, MAXNB, lengths_l)
    flush = l2_flush(torch)
    res = {}
    for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                      ("fp16", torch.float16)):
        x = [t.to(dtype) if t.is_floating_point() else t for t in inputs]
        r = paged_check(torch, pak, "kernel", f"{dn} B={B} H={H} Dh={Dh} "
                        f"BS={BS} MAXNB={MAXNB} lengths={lengths_l}", x,
                        controls=dn != "fp32")
        if dn != "fp16":
            r.update(paged_times(torch, pak, x, flush, 100, 20))
            print(f"[kernel] {dn}: " + times_line(r), flush=True)
        res[dn] = r
    # serving at max_batch 256: 256 (request, head group) pairs fill the
    # card, so one split and no combine; an inactive slot has length 0
    B1 = 256
    lengths_1 = [0 if b % 4 == 0 else (37 * b) % 1024 + 1
                 for b in range(B1)]
    one = paged_inputs(torch, seed + 1, B1, H, Dh, BS, MAXNB, lengths_1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        x = [t.to(dtype) if t.is_floating_point() else t for t in one]
        check(pak.split_plan(B1, H, Dh, BS, MAXNB, x[4].element_size(),
                             sms).splits == 1,
              f"[kernel] B={B1}: the plan has more than one split")
        res[f"{dn} one split"] = paged_check(
            torch, pak, "kernel", f"{dn} B={B1} H={H} Dh={Dh} BS={BS} "
            f"MAXNB={MAXNB} one split, every 4th row empty", x)
        del x
    del one
    return res


def kernel_long_phase(torch, seed):
    """``[kernel long]``: the kernel at the long-context tier's decode
    shape (B=8, H=12, Dh=64, every request 32768 tokens) with pages of 16
    and of 256 tokens, fp32, bf16 and fp16 (and ragged lengths up to
    32768 in bf16), held by :func:`paged_check` and timed as ``[kernel]``
    is (fp32 and bf16)."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    B, H, Dh = 8, 12, 64
    flush = l2_flush(torch)
    res = {}
    for BS in (16, 256):
        MAXNB = K1_LONG // BS
        inputs = paged_inputs(torch, seed + BS, B, H, Dh, BS, MAXNB,
                              [K1_LONG] * B)
        for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                          ("fp16", torch.float16)):
            x = [t.to(dtype) if t.is_floating_point() else t
                 for t in inputs]
            r = paged_check(torch, pak, "kernel long", f"{dn} B={B} H={H} "
                            f"Dh={Dh} BS={BS} MAXNB={MAXNB} lengths "
                            f"{K1_LONG} each", x)
            if dn != "fp16":
                r.update(paged_times(torch, pak, x, flush, 10, 3))
                print(f"[kernel long] {dn} BS={BS}: " + times_line(r),
                      flush=True)
            res[f"{dn} bs{BS}"] = r
            del x
        if BS == 256:
            ragged = [K1_LONG, K1_LONG - 1, 1, 0, 256, 257, 20000, 12345]
            x = list(inputs)
            x[3] = torch.as_tensor(np.array(ragged, np.int32),
                                   device=x[4].device)
            x = [t.to(torch.bfloat16) if t.is_floating_point() else t
                 for t in x]
            res["bf16 ragged"] = paged_check(
                torch, pak, "kernel long", f"bf16 B={B} H={H} Dh={Dh} "
                f"BS={BS} MAXNB={MAXNB} lengths={ragged}", x, controls=True)
            del x
        del inputs
    return res


REQ_LENS = [5, 17, 40, 64, 100, 200, 333, 500, 700, 900, 15, 250]
REQ_MAX = [64, 48, 32, 64, 40, 56, 64, 32, 64, 48, 64, 60]
ORACLE_REQS = (0, 2)


def serving_phase(torch, seed, dtype, tag, check_oracle):
    from paddle_tpu_torch.inference.serving import (LLMServer,
                                                    ServingModelConfig,
                                                    params_from_numpy,
                                                    reference_decode)
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.models import gpt2_small, init_decode_weights_numpy
    cfg = gpt2_small()
    params = params_from_numpy(init_decode_weights_numpy(cfg, seed),
                               device="cuda", dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in REQ_LENS]
    server = LLMServer(params=params, gpt_config=cfg, max_batch=8,
                       block_size=16, num_blocks=512, eos_id=None,
                       auto_start=False, device="cuda")
    try:
        warm = server.warmup(REQ_LENS)
        d0 = server.engine.stats()["dispatches"]
        pak.paged_ragged_attention.launches = 0
        pak._cuda_core_paged.launches = 0
        server.start()
        t0 = time.monotonic()
        futs = [server.submit(p, max_tokens=m)
                for p, m in zip(prompts, REQ_MAX)]
        results = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        launches = pak.paged_ragged_attention.launches
        core_launches = pak._cuda_core_paged.launches
        st = server.stats()
    finally:
        server.close()
    dispatches = st["dispatches"] - d0
    for r, m in zip(results, REQ_MAX):
        check(len(r.tokens) == m, f"{tag}: {len(r.tokens)} tokens != {m}")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{tag}: token out of vocab")
    check(launches == dispatches * cfg.num_hidden_layers,
          f"{tag}: kernel launches {launches} != dispatches {dispatches}"
          f" x {cfg.num_hidden_layers}")
    check(core_launches == 0, f"{tag}: the comparison entry "
          f"_cuda_core_paged launched {core_launches} times")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve {tag}] GPT-2-small L=12 D=768 H=12 V=50304: "
          f"{len(results)} requests, {n_tok} tokens in {wall:.4f} s = "
          f"{n_tok / wall:.2f} tokens/s; dispatches={dispatches} "
          f"kernel_launches={launches} (_cuda_core_paged "
          f"{core_launches}); ttft_p50_s={st['ttft_p50_s']:.6f}"
          f" intertoken_p50_s={st['intertoken_p50_s']:.6f} "
          f"intertoken_p99_s={st['intertoken_p99_s']:.6f}; warmup_s="
          f"{warm['warmup_s']:.3f}", flush=True)
    if check_oracle:
        scfg = ServingModelConfig.from_gpt_config(cfg)
        with torch.no_grad():
            for i in ORACLE_REQS:
                ref, lg = reference_decode(params, scfg, prompts[i],
                                           REQ_MAX[i])
                ref = ref.tolist()
                got = results[i].tokens
                if got != ref:
                    j = next(k for k in range(len(ref)) if got[k] != ref[k])
                    top = torch.topk(lg[j].float(), 2).values.tolist()
                    raise AssertionError(
                        f"{tag}: request {i} differs from reference_decode"
                        f" at token {j} ({got[j]} vs {ref[j]}; oracle top-2"
                        f" logits {top})")
        print(f"[serve {tag}] greedy tokens of requests {ORACLE_REQS} equal"
              " the sequential reference_decode", flush=True)
    return {"launches": launches, "dispatches": dispatches,
            "core_launches": core_launches, "tokens_per_s": n_tok / wall}


# ---------------------------------------------------------------------------
# flash attention: the three kernels against their plain versions
# ---------------------------------------------------------------------------
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BH_KERNELS = ("flash_fwd_hpack", "flash_bwd_fused")    # [flash bh] phase
FLASH_REPLACES = {
    "flash_fwd": "paddle_tpu/ops/pallas_ops.py:795",
    "flash_bwd_dq": "paddle_tpu/ops/pallas_ops.py:883",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas_ops.py:959",
    "flash_fwd_hpack": "paddle_tpu/ops/pallas_ops.py:192",
    "flash_bwd_fused": "paddle_tpu/ops/pallas_ops.py:397",
}


def _err(got, ref):
    """(max abs error, error / max(|ref|, 1))."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1.0)


def flash_run(fk, q, k, v, g, causal, qseg=None, kseg=None):
    """The three kernels in the order the backward runs them."""
    out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg, kseg)
    return {"out": out, "lse": lse, "delta": delta, "dq": dq, "dk": dk,
            "dv": dv}


def flash_plain(torch, fk, q, k, v, g, causal, qseg=None, kseg=None):
    """The plain forward in fp32 on the same values, and dq/dk/dv of it
    through autograd."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out, lse = fk.flash_attention_reference(*leaves, causal, qseg, kseg)
    dq, dk, dv = torch.autograd.grad(out, leaves, g.float())
    delta = (g.float() * out.detach()).sum(-1).permute(0, 2, 1)
    return {"out": out.detach(), "lse": lse.detach(), "delta": delta,
            "dq": dq, "dk": dk, "dv": dv}


def flash_compare(torch, fk, tag, tol, q, k, v, g, causal, qseg=None,
                  kseg=None):
    got = flash_run(fk, q, k, v, g, causal, qseg, kseg)
    ref = flash_plain(torch, fk, q, k, v, g, causal, qseg, kseg)
    torch.cuda.synchronize()
    errs = {}
    for name in ("out", "lse", "delta", "dq", "dk", "dv"):
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[flash] {tag}: {name} not finite")
        err, rel = _err(got[name], ref[name])
        check(rel <= tol, f"[flash] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name] = err
    print(f"[flash] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + f" (tol {tol} x "
          "max(|ref|, 1))", flush=True)
    return got, errs


def flash_phase(torch, seed):
    from paddle_tpu_torch.nn.functional import flash_attention
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, S, H, D = TRAIN_B, TRAIN_S, 12, 64
    res = {}
    for dtype, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                       (torch.float32, FLASH_FP32_TOL)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        qkv = rnd(B, S, 3, H, D, dtype=dtype)          # GPT's layout
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        g = rnd(B, S, H, D, dtype=dtype)
        _, errs = flash_compare(torch, fk, f"{name} [B,S,H,D] views "
                                f"B={B} S={S} H={H} D={D} causal", tol,
                                q, k, v, g, True)
        res[name] = errs

        def bh(t):
            return t.permute(0, 2, 1, 3).reshape(B * H, S, 1, D)
        flash_compare(torch, fk, f"{name} [B*H,S,D] layout", tol,
                      bh(q), bh(k), bh(v), bh(g), True)
        if dtype == torch.bfloat16:
            main = (q, k, v, g)

    tol = FLASH_FP32_TOL
    flash_compare(torch, fk, "S=1000 causal (ragged)", tol,
                  *[rnd(2, 1000, 4, 64) for _ in range(4)], True)
    q, g = rnd(2, 384, 4, 64), rnd(2, 384, 4, 64)
    flash_compare(torch, fk, "non-causal Sq=384 Sk=640", tol, q,
                  rnd(2, 640, 4, 64), rnd(2, 640, 4, 64), g, False)
    flash_compare(torch, fk, "D=128 causal S=512", tol,
                  *[rnd(2, 512, 4, 128) for _ in range(4)], True)
    qseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    qseg[:, 150:] = 1
    qseg[:, 7] = 9                                   # sees no key
    kseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    kseg[:, 150:] = 1
    got, _ = flash_compare(torch, fk, "segment ids + fully-masked row",
                           tol, *[rnd(2, 300, 4, 64) for _ in range(4)],
                           False, qseg, kseg)
    check(bool((got["out"][:, 7] == 0).all()), "[flash] masked row not 0")
    check(bool((got["lse"][:, :, 7] == fk.LSE_FLOOR).all()),
          "[flash] masked row lse not the floor")
    # GQA through the public function, gradients through autograd
    q = rnd(2, 256, 8, 64).requires_grad_()
    kv = [rnd(2, 256, 2, 64).requires_grad_() for _ in range(2)]
    g = rnd(2, 256, 8, 64)
    out, _ = flash_attention(q, *kv, causal=True)
    grads = torch.autograd.grad(out, [q, *kv], g)
    ref, _ = fk.flash_attention_reference(
        q, *[torch.repeat_interleave(t, 4, dim=2) for t in kv], True)
    rgrads = torch.autograd.grad(ref, [q, *kv], g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (ref, *rgrads)):
        err, rel = _err(a, b)
        check(rel <= tol, f"[flash] GQA {name} error {err:.3e}")
    print(f"[flash] GQA Hq=8 Hkv=2 through flash_attention: out and "
          f"grads within {tol}", flush=True)

    # times at the main shape, bf16, the GPT layout
    q, k, v, g = main
    fwd = fk.flash_fwd(q, k, v, True)
    dq_res = fk.flash_bwd_dq(q, k, v, fwd[0], fwd[1], g, True)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    calls = {
        "flash_fwd": (lambda: fk.flash_fwd(q, k, v, True),
                      lambda: fk.flash_attention_reference(q, k, v, True)),
        "flash_bwd_dq": (
            lambda: fk.flash_bwd_dq(q, k, v, fwd[0], fwd[1], g, True),
            lambda: fk.flash_bwd_dq_reference(q, k, v, fwd[0], fwd[1], g,
                                              True)),
        "flash_bwd_dkv": (
            lambda: fk.flash_bwd_dkv(q, k, v, g, fwd[1], dq_res[1], True),
            lambda: fk.flash_bwd_dkv_reference(q, k, v, g, fwd[1],
                                               dq_res[1], True)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, gt = [t.transpose(1, 2) for t in (q, k, v, g)]
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        o = sdpa(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, gt)

    with torch.no_grad():
        sdpa_ms = time_cuda(torch, lambda: sdpa(qt, kt, vt, is_causal=True),
                            20, flush=flush)
    sdpa_fb_ms = time_cuda(torch, sdpa_fwd_bwd, 20, flush=flush)
    for name, (kern, plain) in calls.items():
        with torch.no_grad():
            ms = time_cuda(torch, kern, 20, flush=flush)
            plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
        flops, nbytes = fk.kernel_work(name, B, H, S, S, D, True, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        err_key = {"flash_fwd": "out", "flash_bwd_dq": "dq",
                   "flash_bwd_dkv": "dk"}[name]
        max_err = (max(res["bf16"]["dk"], res["bf16"]["dv"])
                   if name == "flash_bwd_dkv" else res["bf16"][err_key])
        res[name] = {
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sdpa_ms if name == "flash_fwd" else None,
            "max_abs_err": max_err, "flops": flops, "bytes": nbytes,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        r = res[name]
        print(f"[flash] {name} bf16 B={B} S={S} H={H} D={D} causal: "
              f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}: {flops} flop, "
              f"{nbytes} bytes) achieved {r['tflops']:.2f} TFLOP/s",
              flush=True)
    res["sdpa_fwd_ms"], res["sdpa_fwd_bwd_ms"] = sdpa_ms, sdpa_fb_ms
    print(f"[flash] library yardstick (not used by the port): sdpa "
          f"forward {sdpa_ms:.5f} ms, forward+backward {sdpa_fb_ms:.5f} "
          f"ms; flash kernels forward+dq+dkv "
          f"{sum(res[n]['ms'] for n in FLASH_KERNELS):.5f} ms", flush=True)
    return res


# ---------------------------------------------------------------------------
# the tensor-core forward (csrc/flash_fwd_sm90.cu): bf16 flash_fwd and
# flash_fwd_hpack
# ---------------------------------------------------------------------------
TC_SOURCE = "paddle_tpu_torch/csrc/flash_fwd_sm90.cu"
CORE_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
TC_TOL = 1e-2                    # x max(|ref|, 1); the kernel against its
                                 # plain version, both rounding p to 16 bits


def sass_summary(lib_path, nvcc_log):
    """``HGMMA`` instructions in the library's SASS (``cuobjdump``) and
    ptxas's registers and spill bytes per kernel from the build log."""
    from paddle_tpu_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    regs, spills = [], []
    for line in nvcc_log.splitlines():
        if "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
        if "spill stores" in line:
            spills.append(int(line.split("bytes spill stores")[0]
                              .split(",")[-1]))
    return hgmma, regs, spills


def tc_compare(torch, fk, tag, q, k, v, causal, hp=1, qseg=None,
               kseg=None):
    """A tensor-core forward (``flash_fwd``, or ``flash_fwd_hpack`` when
    ``hp > 1``, which must also equal ``flash_fwd`` bit for bit) against
    ``flash_fwd_tc_reference`` on the same bf16 values."""
    before = fk.flash_fwd.tc_launches + fk.flash_fwd_hpack.tc_launches
    if hp > 1:
        out, lse = fk.flash_fwd_hpack(q, k, v, hp, causal)
        fout, flse = fk.flash_fwd(q, k, v, causal)
    else:
        out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    ref, ref_lse = fk.flash_fwd_tc_reference(q, k, v, causal, qseg, kseg)
    torch.cuda.synchronize()
    check(fk.flash_fwd.tc_launches + fk.flash_fwd_hpack.tc_launches
          == before + (2 if hp > 1 else 1),
          f"[flash tc] {tag}: the tensor-core kernels did not launch")
    check(out.dtype == torch.bfloat16 and lse.dtype == torch.float32,
          f"[flash tc] {tag}: dtypes {out.dtype}, {lse.dtype}")
    errs = {}
    for name, got, want in (("out", out, ref), ("lse", lse, ref_lse)):
        check(bool(torch.isfinite(got.float()).all()),
              f"[flash tc] {tag}: {name} not finite")
        err, rel = _err(got, want)
        check(rel <= TC_TOL, f"[flash tc] {tag}: {name} error {err:.3e} "
                             f"(relative {rel:.3e}) > {TC_TOL}")
        errs[name] = err
    line = (f"[flash tc] {tag}: vs flash_fwd_tc_reference max_abs_err "
            f"out={errs['out']:.3e} lse={errs['lse']:.3e} (tol {TC_TOL} x "
            "max(|ref|, 1))")
    if hp > 1:
        same = torch.equal(out, fout) and torch.equal(lse, flse)
        check(same, f"[flash tc] {tag}: flash_fwd_hpack hp={hp} differs "
                    "from flash_fwd")
        line += f"; hp={hp} bitwise equal to flash_fwd: {same}"
    print(line, flush=True)
    return out, lse, errs


def flash_tc_phase(torch, seed, nvcc_log):
    """``[flash tc]``: the tensor-core forward against its plain version
    at the main path's shapes and awkward ones, the head-packed entry
    bitwise against ``flash_fwd``, the SASS's ``HGMMA`` count, and times
    beside the CUDA-core forward it replaced for bf16 and SDPA."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    hgmma, regs, spills = sass_summary(_build.library_path("flash_fwd_sm90"),
                                       nvcc_log)
    print(f"[flash tc] {TC_SOURCE}: {hgmma} HGMMA instructions in the SASS;"
          f" ptxas registers per kernel {regs}, spill store bytes {spills}",
          flush=True)
    check(hgmma > 0, "[flash tc] no HGMMA instruction in the SASS")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}

    qkv = rnd(TRAIN_B, TRAIN_S, 3, 12, 64)              # GPT's layout
    gpt = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    bh = {"gpt": ([rnd(TRAIN_B * 12, TRAIN_S, 1, 64) for _ in range(3)],
                  True),
          "ernie": ([rnd(ERNIE_B * 12, ERNIE_S, 1, 64) for _ in range(3)],
                    False)}
    errs = {}
    _, _, errs["views"] = tc_compare(
        torch, fk, f"GPT [B,S,H,D] views B={TRAIN_B} S={TRAIN_S} H=12 D=64 "
        "causal", *gpt, True)
    for model, (args, causal) in bh.items():
        _, _, errs[model] = tc_compare(
            torch, fk, f"{model} {list(args[0].shape)} "
            f"{'causal' if causal else 'non-causal'}", *args, causal, hp=2)
    tc_compare(torch, fk, "S=1000 causal (ragged) [2, 1000, 4, 64]",
               *[rnd(2, 1000, 4, 64) for _ in range(3)], True)
    tc_compare(torch, fk, "S=1000 causal hp=2 [8, 1000, 1, 64]",
               *[rnd(8, 1000, 1, 64) for _ in range(3)], True, hp=2)
    tc_compare(torch, fk, "non-causal Sq=384 Sk=640", rnd(2, 384, 4, 64),
               rnd(2, 640, 4, 64), rnd(2, 640, 4, 64), False)
    tc_compare(torch, fk, "D=128 causal S=512",
               *[rnd(2, 512, 4, 128) for _ in range(3)], True)
    tc_compare(torch, fk, "D=128 non-causal Sq=200 Sk=333",
               rnd(2, 200, 3, 128), rnd(2, 333, 3, 128), rnd(2, 333, 3, 128),
               False)
    tc_compare(torch, fk, "odd H [2, 300, 3, 64] hp=2, packs straddle "
               "batches", *[rnd(2, 300, 3, 64) for _ in range(3)], False,
               hp=2)
    tc_compare(torch, fk, "hp=4 [8, 256, 1, 64] causal",
               *[rnd(8, 256, 1, 64) for _ in range(3)], True, hp=4)
    qseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    qseg[:, 150:] = 1
    qseg[:, 7] = 9                                   # sees no key
    kseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    kseg[:, 150:] = 1
    out, lse, _ = tc_compare(torch, fk, "segment ids + fully-masked row",
                             *[rnd(2, 300, 4, 64) for _ in range(3)], False,
                             qseg=qseg, kseg=kseg)
    check(bool((out[:, 7] == 0).all())
          and bool((lse[:, :, 7] == fk.LSE_FLOOR).all()),
          "[flash tc] masked row: out not 0 or lse not the floor")
    print("[flash tc] fully-masked row: out exactly 0, lse exactly "
          f"{fk.LSE_FLOOR}", flush=True)

    # times: the tensor-core kernel, the CUDA-core kernel it replaced for
    # bf16, the plain version and SDPA (a yardstick, not used by the port)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cells = {"flash_fwd": (gpt, True, 1, "views", TRAIN_B, 12, TRAIN_S),
             "flash_fwd_hpack": (bh["gpt"][0], True, 2, "gpt",
                                 TRAIN_B * 12, 1, TRAIN_S),
             "flash_fwd_hpack ernie": (bh["ernie"][0], False, 2, "ernie",
                                       ERNIE_B * 12, 1, ERNIE_S)}
    for cell, (args, causal, hp, model, B, H, S) in cells.items():
        q, k, v = args
        qt, kt, vt = [t.transpose(1, 2) for t in args]
        if hp > 1:
            def kern():
                return fk.flash_fwd_hpack(q, k, v, hp, causal)
        else:
            def kern():
                return fk.flash_fwd(q, k, v, causal)
        with torch.no_grad():
            ms = time_cuda(torch, kern, 20, flush=flush)
            core_ms = time_cuda(
                torch, lambda: fk._cuda_core_fwd(q, k, v, causal, hp=hp), 20,
                flush=flush)
            plain_ms = time_cuda(
                torch, lambda: fk.flash_fwd_tc_reference(q, k, v, causal), 5,
                warmup=2, flush=flush)
            lib_ms = time_cuda(torch, lambda: sdpa(qt, kt, vt,
                                                   is_causal=causal), 20,
                               flush=flush)
        name = cell.split()[0]
        flops, nbytes = fk.kernel_work(name, B, H, S, S, 64, causal, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        r = {"ms": ms, "cuda_core_ms": core_ms, "plain_ms": plain_ms,
             "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "flops": flops, "bytes": nbytes,
             "tflops": flops / (ms * 1e-3) / 1e12,
             "cuda_core_tflops": flops / (core_ms * 1e-3) / 1e12,
             "max_abs_err": max(errs[model].values())}
        res[cell] = r
        print(f"[flash tc] {cell} bf16 {list(q.shape)} "
              f"{'causal' if causal else 'non-causal'}"
              f"{f' hp={hp}' if hp > 1 else ''}: kernel_ms={ms:.5f} "
              f"({r['tflops']:.1f} TFLOP/s) cuda_core_ms={core_ms:.5f} "
              f"({r['cuda_core_tflops']:.1f} TFLOP/s, "
              f"{core_ms / ms:.2f}x the tensor-core time) plain_ms="
              f"{plain_ms:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}"
              f": {flops} flop, {nbytes} bytes) library_ms (sdpa forward, "
              f"not used by the port)={lib_ms:.5f}", flush=True)
    return res


# ---------------------------------------------------------------------------
# the tensor-core split backward (csrc/flash_bwd_sm90.cu): 16-bit
# flash_bwd_dq and flash_bwd_dkv
# ---------------------------------------------------------------------------
TC_BWD_SOURCE = "paddle_tpu_torch/csrc/flash_bwd_sm90.cu"
# The 16-bit gradients are held element by element, in two parts.
# (1) |got - ref| <= rtol |ref| + (u |X| + e_X + eta) @ |B|, where X is
# the rounded factor of the product (dS for dq and dk, p for dv) and B
# the other (K, Q, dO): the kernel and the plain version round the same
# fp32 values to the output dtype (rtol: one ulp and margin, the LMCE
# gate's LMCE_GRAD_RTOL), after rounding dS and p from fp32 values that differ slightly,
# so a term may move by an ulp of X; u |X| bounds rounding every term
# once (u half an ulp, eta half the subnormal spacing), and e_X the fp32
# difference itself: S, dP and delta are sums of D products taken in
# other orders (each within g = D eps32 of the sum of their |terms| for
# the two sides together), and ex2 and exp differ by a few eps32, so
#   e_p  = p (scale g |Q||K|^T + 4 eps32)
#   e_dS = p scale (g (|dO||V|^T + sum|dO O|) + |dP - delta| (scale g
#          |Q||K|^T + 4 eps32)),
# which matters where dP - delta cancels (a row whose only key is
# itself: dS = 0 up to those sums).
# (2) That bound cannot tell a kernel that rounds dS from one that does
# not: leaving the rounding out moves each sum by less than it.  What
# tells them apart is how many elements come out the same: rounding the
# same values, the two sides part only where a sum or a term straddles a
# rounding boundary, so most elements are equal in the 16-bit dtype,
# while a missing rounding moves a sum by a fraction of an ulp of its
# own, and about half the elements change.  So at least
# TC_BWD_SAME_MIN of the elements must be equal.  delta (fp32 sums of D
# products in another order) is held within 2 D eps32 sum|dO O|.
TC_BWD_SAME_MIN = {"bfloat16": 0.95, "float16": 0.9}


def flash_bwd_terms(torch, fk, q, k, v, g, out, lse, delta, causal,
                    qseg=None, kseg=None):
    """The gate's spread ``(u |X| + e_X + eta) @ |B|`` of dq, dk and dv
    (the comment above), from the plain versions' p and dS."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    p, ds = fk._dsoftmax(q, k, v, g, lse, delta, causal, qseg, kseg, scale)
    fi, eps32 = torch.finfo(q.dtype), torch.finfo(torch.float32).eps
    u, eta, gam = fi.eps / 2, fi.tiny * fi.eps / 2, q.shape[-1] * eps32
    qk = torch.einsum("bqhd,bkhd->bhqk", q.float().abs(), k.float().abs())
    e_p = p * (qk.mul_(scale * gam).add_(4 * eps32))
    del qk
    dpv = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    dpd = (dpv - delta[..., None]).abs_()
    gv = torch.einsum("bqhd,bkhd->bhqk", g.float().abs(), v.float().abs())
    go = (g.float() * out.float()).abs().sum(-1).permute(0, 2, 1)
    gv.add_(go[..., None])
    e_ds = (gv.mul_(gam).mul_(p).add_(dpd.mul_(e_p))).mul_(scale)
    del dpv, dpd, gv
    x_ds = ds.abs_().mul_(u).add_(e_ds).add_(eta)
    x_p = e_p.add_(p.abs().mul_(u)).add_(eta)
    del ds, p, e_ds
    return {
        "dq": torch.einsum("bhqk,bkhd->bqhd", x_ds, k.float().abs()),
        "dk": torch.einsum("bhqk,bqhd->bkhd", x_ds, q.float().abs()),
        "dv": torch.einsum("bhqk,bqhd->bkhd", x_p, g.float().abs()),
    }


def flash_bwd_gate(torch, got, ref, spread):
    """``(max abs error, ratio, share equal)`` of a 16-bit gradient:
    ``ratio`` the largest ``|got - ref| / (rtol |ref| + spread)`` (part 1
    passes at <= 1) and the share of elements equal in the dtype (part 2
    passes at >= TC_BWD_SAME_MIN)."""
    rtol = LMCE_GRAD_RTOL[str(ref.dtype).rsplit(".", 1)[-1]]
    same = (got == ref).float().mean().item()
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / (rtol * ref.abs() + spread)).max().item()
    return diff.max().item(), ratio, same


def flash_bwd_passes(dtype, ratio, same):
    return ratio <= 1.0 and same >= TC_BWD_SAME_MIN[
        str(dtype).rsplit(".", 1)[-1]]


def tc_bwd_compare(torch, fk, tag, q, k, v, g, causal, qseg=None, kseg=None,
                   controls=False):
    """The tensor-core ``flash_bwd_dq`` + ``flash_bwd_dkv`` against their
    plain versions on the same 16-bit values (the tensor-core forward's
    out and lse), through :func:`flash_bwd_gate`; delta within 2 D eps32
    sum|dO O|; a second run bitwise equal.  ``controls``: a backward
    with delta = 0 and one with dS and p left unrounded must fail the
    gate (their old-gate errors are printed beside).  Returns the max abs
    errors, ratios and shares."""
    before = (fk.flash_bwd_dq.tc_launches, fk.flash_bwd_dkv.tc_launches)
    out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg, kseg)
    again = (*fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg),
             *fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg, kseg))
    torch.cuda.synchronize()
    check((fk.flash_bwd_dq.tc_launches, fk.flash_bwd_dkv.tc_launches)
          == (before[0] + 2, before[1] + 2),
          f"[flash tc bwd] {tag}: the tensor-core kernels did not launch")
    got = {"dq": dq, "dk": dk, "dv": dv}
    rdq, rdelta = fk.flash_bwd_dq_reference(q, k, v, out, lse, g, causal,
                                            qseg, kseg)
    rdk, rdv = fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal,
                                          qseg, kseg)
    ref = {"dq": rdq, "dk": rdk, "dv": rdv}
    spread = flash_bwd_terms(torch, fk, q, k, v, g, out, lse, delta,
                             causal, qseg, kseg)
    errs, ratios, shares = {}, {}, {}
    for name in ("dq", "dk", "dv"):
        check(got[name].dtype == q.dtype
              and bool(torch.isfinite(got[name].float()).all()),
              f"[flash tc bwd] {tag}: {name} dtype {got[name].dtype} or not "
              "finite")
        errs[name], ratios[name], shares[name] = flash_bwd_gate(
            torch, got[name], ref[name], spread[name])
    d_bound = (2 * q.shape[-1] * torch.finfo(torch.float32).eps
               * (g.float() * out.float()).abs().sum(-1).permute(0, 2, 1))
    d_err = (delta - rdelta).abs()
    errs["delta"] = d_err.max().item()
    d_ratio = (d_err / d_bound.clamp_min(1e-30)).max().item()
    same = all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), again))
    line = (f"[flash tc bwd] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + "; gate ratio " + " ".join(
        f"{n}={r:.3e}" for n, r in ratios.items()) + " (<= 1); equal " +
        " ".join(f"{n}={s:.5f}" for n, s in shares.items()) +
        f" (>= {TC_BWD_SAME_MIN[str(q.dtype).rsplit('.', 1)[-1]]}); delta "
        f"ratio {d_ratio:.3e} (<= 1); two runs bitwise equal: {same}")
    res = {"errs": errs, "ratios": ratios, "shares": shares}
    if controls:
        res["controls"] = bwd_controls(torch, fk, q, k, v, g, lse, delta,
                                       causal, qseg, kseg, ref, spread)
        line += controls_line(res["controls"])
    print(line, flush=True)
    for cname, (ratio, share, _) in res.get("controls", {}).items():
        check(not flash_bwd_passes(q.dtype, ratio, share),
              f"[flash tc bwd] {tag}: the gate passes the {cname} control "
              f"(ratio {ratio:.3e}, equal {share:.5f})")
    for name in ("dq", "dk", "dv"):
        check(flash_bwd_passes(q.dtype, ratios[name], shares[name]),
              f"[flash tc bwd] {tag}: {name} fails the gate (ratio "
              f"{ratios[name]:.3e}, equal {shares[name]:.5f})")
    check(d_ratio <= 1.0, f"[flash tc bwd] {tag}: delta error "
          f"{errs['delta']:.3e}, ratio {d_ratio:.3e}")
    check(same, f"[flash tc bwd] {tag}: two runs differ")
    return res, dq


def bwd_controls(torch, fk, q, k, v, g, lse, delta, causal, qseg, kseg, ref,
                 spread):
    """The gate on two broken backwards: delta = 0, and dS and p left
    unrounded (fp32 into the products).  Returns ``{"<control> <grad>":
    (ratio, share equal, old-gate relative error)}``."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    _, ds0 = fk._dsoftmax(q, k, v, g, lse, torch.zeros_like(delta),
                          causal, qseg, kseg, scale)
    p32 = fk._probs(q, k, lse, causal, qseg, kseg, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds32 = p32 * (dp - delta[..., None]) * scale
    del dp
    bad = {
        "delta=0": {
            "dq": torch.einsum("bhqk,bkhd->bqhd", ds0, k.float()),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds0, q.float())},
        "unrounded": {
            "dq": torch.einsum("bhqk,bkhd->bqhd", ds32, k.float()),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds32, q.float()),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p32, g.float())},
    }
    del ds0, ds32, p32
    out = {}
    for cname, grads in bad.items():
        for name, t in grads.items():
            t = t.to(q.dtype)
            _, ratio, share = flash_bwd_gate(torch, t, ref[name],
                                             spread[name])
            out[f"{cname} {name}"] = (ratio, share, _err(t, ref[name])[1])
    return out


def controls_line(controls):
    return "; controls (fail, as they must): " + "; ".join(
        f"{n} ratio {r:.3e} equal {sh:.5f} old-gate {o:.3e} "
        f"({'passes' if o <= FLASH_BF16_TOL else 'fails'} 2e-2 x "
        "max(|ref|, 1))" for n, (r, sh, o) in controls.items())


def device_ms(torch, fn, iters, groups):
    """Device milliseconds per call of ``fn`` by ``torch.profiler``:
    ``{group: ms}`` summed over the kernels whose name holds any of the
    group's substrings (``groups``: ``{name: (substrings,)}``; an empty
    tuple takes every kernel), host work not counted."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(groups, 0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for g, subs in groups.items():
            if not subs or any(x in e.key for x in subs):
                out[g] += us
    return {g: us / iters / 1e3 for g, us in out.items()}


def flash_tc_bwd_phase(torch, seed, nvcc_log):
    """``[flash tc bwd]``: the tensor-core split backward against its
    plain versions at the main path's shapes and awkward ones, in bf16
    and fp16, through :func:`flash_bwd_gate` and its controls; the SASS's
    ``HGMMA`` count, registers and spills; times at the main shape by
    events and by device time beside the CUDA-core pair it replaced for
    16-bit inputs and SDPA's backward alone."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 60)

    hgmma, regs, spills = sass_summary(_build.library_path("flash_bwd_sm90"),
                                       nvcc_log)
    print(f"[flash tc bwd] {TC_BWD_SOURCE}: {hgmma} HGMMA instructions in "
          f"the SASS; ptxas registers per kernel {regs}, spill store bytes "
          f"{spills}", flush=True)
    check(hgmma > 0, "[flash tc bwd] no HGMMA instruction in the SASS")
    check(not any(spills), f"[flash tc bwd] ptxas spills {spills}")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}

    B, S, H, D = TRAIN_B, TRAIN_S, 12, 64
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        qkv = rnd(B, S, 3, H, D)                       # GPT's layout
        main = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], rnd(B, S, H, D))
        r, _ = tc_bwd_compare(torch, fk, f"{dn} GPT [B,S,H,D] views B={B} "
                              f"S={S} H={H} D={D} causal", *main, True,
                              controls=True)
        res[dn] = {"main": r, "args": main}
        seg_rows = 2 * 4
        qseg = torch.zeros((seg_rows, 300), dtype=torch.int32, device=dev)
        qseg[:, 150:] = 1
        qseg[:, 7] = 9                                 # sees no key
        kseg = torch.zeros((seg_rows, 300), dtype=torch.int32, device=dev)
        kseg[:, 150:] = 1
        _, dq = tc_bwd_compare(
            torch, fk, f"{dn} [B*H,S,D] [8, 300, 64] segment ids + a "
            "fully-masked row", *[rnd(seg_rows, 300, 1, 64) for _ in
                                  range(4)], False, qseg, kseg)
        check(bool((dq[:, 7] == 0).all()),
              f"[flash tc bwd] {dn} masked row: dq not exactly 0")
        tc_bwd_compare(torch, fk, f"{dn} S=1000 causal (ragged) "
                       "[2, 1000, 4, 64]",
                       *[rnd(2, 1000, 4, 64) for _ in range(4)], True)
        tc_bwd_compare(torch, fk, f"{dn} non-causal Sq=384 Sk=640",
                       rnd(2, 384, 4, 64), rnd(2, 640, 4, 64),
                       rnd(2, 640, 4, 64), rnd(2, 384, 4, 64), False)
        tc_bwd_compare(torch, fk, f"{dn} D=128 causal S=512",
                       *[rnd(2, 512, 4, 128) for _ in range(4)], True)
        tc_bwd_compare(torch, fk, f"{dn} D=128 non-causal Sq=200 Sk=333",
                       rnd(2, 200, 3, 128), rnd(2, 333, 3, 128),
                       rnd(2, 333, 3, 128), rnd(2, 200, 3, 128), False)
    print("[flash tc bwd] fully-masked row: dq exactly 0", flush=True)

    # times at the main shape: the tensor-core pair, the CUDA-core pair it
    # replaced for 16-bit inputs, the plain versions and SDPA's backward
    # alone (a yardstick, not used by the port)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dn in ("bf16", "fp16"):
        q, k, v, g = res[dn].pop("args")
        out, lse = fk.flash_fwd(q, k, v, True)
        _, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, True)
        qt, kt, vt, gt = [t.transpose(1, 2) for t in (q, k, v, g)]
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        o = sdpa(*leaves, is_causal=True)

        def sdpa_bwd():
            torch.autograd.grad(o, leaves, gt, retain_graph=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(*leaves, is_causal=True), leaves, gt)

        def pair():
            fk.flash_bwd_dq(q, k, v, out, lse, g, True)
            fk.flash_bwd_dkv(q, k, v, g, lse, delta, True)

        def core_pair():
            fk._cuda_core_flash_bwd("dq", q, k, v, out, lse, g, True)
            fk._cuda_core_flash_bwd("dkv", q, k, v, g, lse, delta, True)

        calls = {
            "flash_bwd_dq": (
                lambda: fk.flash_bwd_dq(q, k, v, out, lse, g, True),
                lambda: fk._cuda_core_flash_bwd("dq", q, k, v, out, lse, g,
                                                True),
                lambda: fk.flash_bwd_dq_reference(q, k, v, out, lse, g,
                                                  True)),
            "flash_bwd_dkv": (
                lambda: fk.flash_bwd_dkv(q, k, v, g, lse, delta, True),
                lambda: fk._cuda_core_flash_bwd("dkv", q, k, v, g, lse,
                                                delta, True),
                lambda: fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                   True)),
        }
        with torch.no_grad():
            # flash_bwd_tc_kernel<T, D, mode>: mode 0 is dq, 1 dkv
            dev_ms = device_ms(torch, pair, 20, {
                "flash_bwd_dq": ("64, 0>", "128, 0>", "Li0EEEv"),
                "flash_bwd_dkv": ("64, 1>", "128, 1>", "Li1EEEv"),
                "all": ()})
            core_dev = device_ms(torch, core_pair, 5, {
                "flash_bwd_dq": ("flash_bwd_dq_kernel",),
                "flash_bwd_dkv": ("flash_bwd_dkv_kernel",)})
        lib_bwd_dev = device_ms(torch, sdpa_bwd, 20, {"all": ()})["all"]
        lib_bwd_ms = time_cuda(torch, sdpa_bwd, 20, flush=flush)
        lib_fb_ms = time_cuda(torch, sdpa_fwd_bwd, 20, flush=flush)
        with torch.no_grad():
            pair_ms = time_cuda(torch, pair, 20, flush=flush)
        for name, (kern, core, plain) in calls.items():
            with torch.no_grad():
                ms = time_cuda(torch, kern, 20, flush=flush)
                core_ms = time_cuda(torch, core, 5, warmup=2, flush=flush)
                plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
            flops, nbytes = fk.kernel_work(name, B, H, S, S, D, True, 2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            main = res[dn]["main"]
            errs = ([main["errs"]["dq"], main["errs"]["delta"]]
                    if name == "flash_bwd_dq" else
                    [main["errs"]["dk"], main["errs"]["dv"]])
            r = {"ms": ms, "device_ms": dev_ms[name],
                 "cuda_core_ms": core_ms,
                 "cuda_core_device_ms": core_dev[name],
                 "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "flops": flops, "bytes": nbytes,
                 "tflops": flops / (ms * 1e-3) / 1e12,
                 "device_tflops": flops / (dev_ms[name] * 1e-3) / 1e12,
                 "max_abs_err": max(errs)}
            res[dn][name] = r
            print(f"[flash tc bwd] {name}_tc {dn} B={B} S={S} H={H} D={D} "
                  f"causal: kernel_ms={ms:.5f} ({r['tflops']:.1f} TFLOP/s) "
                  f"device_ms={dev_ms[name]:.5f} "
                  f"({r['device_tflops']:.1f} TFLOP/s) cuda_core_ms="
                  f"{core_ms:.5f} (device {core_dev[name]:.5f}; "
                  f"{core_ms / ms:.2f}x the tensor-core time) plain_ms="
                  f"{plain_ms:.5f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}: {flops} flop, {nbytes} bytes)",
                  flush=True)
        res[dn].update({"pair_ms": pair_ms, "pair_device_ms": dev_ms["all"],
                        "library_bwd_ms": lib_bwd_ms,
                        "library_bwd_device_ms": lib_bwd_dev,
                        "library_fwd_bwd_ms": lib_fb_ms})
        print(f"[flash tc bwd] {dn} pair dq+dkv: {pair_ms:.5f} ms by events, "
              f"{dev_ms['all']:.5f} ms device; library yardstick (not used "
              f"by the port): sdpa backward alone {lib_bwd_ms:.5f} ms by "
              f"events, {lib_bwd_dev:.5f} ms device; sdpa forward+backward "
              f"{lib_fb_ms:.5f} ms", flush=True)
        del o, leaves
    return res


# ---------------------------------------------------------------------------
# the tensor-core fused backward (K4a)
# ---------------------------------------------------------------------------
# flash_bwd_fused_tc is held by flash_bwd_gate as the split pair is: dk
# and dv come from the same fp32 sums in one fixed order, so the same
# thresholds hold.  dq's partials (one per kv warpgroup of 64 rows) are
# added through fp32 atomics in an order that changes from run to run;
# that moves dq's fp32 sum by a few ulps of fp32, far inside the bound's
# e_dS term, and its 16-bit rounding only where the sum straddles a
# boundary, so dq is held to the same share of equal elements too.


def tc_fused_compare(torch, fk, tag, q, k, v, g, causal, qseg=None,
                     kseg=None, controls=False):
    """The tensor-core ``flash_bwd_fused`` against
    ``flash_bwd_fused_reference`` on the same 16-bit values (the
    tensor-core forward's out and lse), through :func:`flash_bwd_gate`;
    a second run's dk and dv bitwise equal (dq's atomics may reorder);
    ``controls``: the delta = 0 and unrounded backwards must fail the
    gate.  Returns the readings and the gradients."""
    before = fk.flash_bwd_fused.tc_launches
    out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    got = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qseg, kseg)
    again = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qseg, kseg)
    torch.cuda.synchronize()
    check(fk.flash_bwd_fused.tc_launches == before + 2,
          f"[flash tc fused] {tag}: the tensor-core sweep did not launch")
    ref = dict(zip(("dq", "dk", "dv"), fk.flash_bwd_fused_reference(
        q, k, v, out, lse, g, causal, qseg, kseg)))
    delta = fk._delta(out, g).contiguous()
    spread = flash_bwd_terms(torch, fk, q, k, v, g, out, lse, delta, causal,
                             qseg, kseg)
    errs, ratios, shares = {}, {}, {}
    for name, t in zip(("dq", "dk", "dv"), got):
        check(t.dtype == q.dtype and bool(torch.isfinite(t.float()).all()),
              f"[flash tc fused] {tag}: {name} dtype {t.dtype} or not "
              "finite")
        errs[name], ratios[name], shares[name] = flash_bwd_gate(
            torch, t, ref[name], spread[name])
    dkv_same = torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    dq_rerun = (got[0].float() - again[0].float()).abs().max().item()
    dq_rerun_equal = (got[0] == again[0]).float().mean().item()
    sm = TC_BWD_SAME_MIN[str(q.dtype).rsplit(".", 1)[-1]]
    line = (f"[flash tc fused] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + "; gate ratio " + " ".join(
        f"{n}={r:.3e}" for n, r in ratios.items()) + " (<= 1); equal " +
        " ".join(f"{n}={x:.5f}" for n, x in shares.items()) +
        f" (>= {sm}); two runs: dk, dv bitwise equal {dkv_same}, dq "
        f"max diff {dq_rerun:.3e} ({dq_rerun_equal:.5f} equal)")
    res = {"errs": errs, "ratios": ratios, "shares": shares,
           "dq_rerun_equal": dq_rerun_equal}
    if controls:
        res["controls"] = bwd_controls(torch, fk, q, k, v, g, lse, delta,
                                       causal, qseg, kseg, ref, spread)
        line += controls_line(res["controls"])
    print(line, flush=True)
    for cname, (ratio, share, _) in res.get("controls", {}).items():
        check(not flash_bwd_passes(q.dtype, ratio, share),
              f"[flash tc fused] {tag}: the gate passes the {cname} "
              f"control (ratio {ratio:.3e}, equal {share:.5f})")
    for name in ("dq", "dk", "dv"):
        check(flash_bwd_passes(q.dtype, ratios[name], shares[name]),
              f"[flash tc fused] {tag}: {name} fails the gate (ratio "
              f"{ratios[name]:.3e}, equal {shares[name]:.5f})")
    check(dkv_same, f"[flash tc fused] {tag}: two runs' dk or dv differ")
    return res, got


def flash_tc_fused_phase(torch, seed, nvcc_log):
    """``[flash tc fused]``: the tensor-core fused backward against its
    plain version at GPT's and ERNIE's ``[B*H, S, D]`` shapes and awkward
    ones, in bf16 and fp16, with the two controls; times at both main
    shapes by device time beside the CUDA-core sweep it replaced for
    16-bit inputs, SDPA's backward alone and the tensor-core split
    pair."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 70)
    hgmma, regs, spills = sass_summary(_build.library_path("flash_bwd_sm90"),
                                       nvcc_log)
    print(f"[flash tc fused] {TC_BWD_SOURCE} (dq, dkv and the fused sweep): "
          f"{hgmma} HGMMA instructions in the SASS; ptxas registers per "
          f"kernel {regs}, spill store bytes {spills}", flush=True)
    check(not any(spills), f"[flash tc fused] ptxas spills {spills}")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}
    shapes = {"gpt": (TRAIN_B * 12, TRAIN_S, True),
              "ernie": (ERNIE_B * 12, ERNIE_S, False)}
    main = {}
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        for model, (BH, S, causal) in shapes.items():
            args = [rnd(BH, S, 1, 64) for _ in range(4)]
            r, _ = tc_fused_compare(
                torch, fk, f"{dn} {model} [{BH}, {S}, 64] "
                f"{'causal' if causal else 'non-causal'}", *args, causal,
                controls=model == "gpt")
            res[f"{dn} {model}"] = r
            main[(dn, model)] = args
        qseg = torch.zeros((8, 300), dtype=torch.int32, device=dev)
        qseg[:, 150:] = 1
        qseg[:, 7] = 9                                 # sees no key
        kseg = torch.zeros((8, 300), dtype=torch.int32, device=dev)
        kseg[:, 150:] = 1
        _, got = tc_fused_compare(
            torch, fk, f"{dn} [8, 300, 64] segment ids + a fully-masked "
            "row", *[rnd(8, 300, 1, 64) for _ in range(4)], False, qseg,
            kseg)
        check(bool((got[0][:, 7] == 0).all()),
              f"[flash tc fused] {dn} masked row: dq not exactly 0")
        tc_fused_compare(torch, fk, f"{dn} S=1000 causal (ragged) "
                         "[8, 1000, 64]",
                         *[rnd(8, 1000, 1, 64) for _ in range(4)], True)
        tc_fused_compare(torch, fk, f"{dn} non-causal Sq=384 Sk=640 H=4",
                         rnd(2, 384, 4, 64), rnd(2, 640, 4, 64),
                         rnd(2, 640, 4, 64), rnd(2, 384, 4, 64), False)
        tc_fused_compare(torch, fk, f"{dn} D=128 causal S=512 H=4",
                         *[rnd(2, 512, 4, 128) for _ in range(4)], True)
        tc_fused_compare(torch, fk, f"{dn} D=128 non-causal Sq=200 Sk=333",
                         rnd(2, 200, 3, 128), rnd(2, 333, 3, 128),
                         rnd(2, 333, 3, 128), rnd(2, 200, 3, 128), False)
    print("[flash tc fused] fully-masked row: dq exactly 0", flush=True)

    # device times at both main shapes (bf16; fp16 at GPT's)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (dn, model), (q, k, v, g) in main.items():
        if dn == "fp16" and model == "ernie":
            continue
        BH, S, causal = shapes[model]
        out, lse = fk.flash_fwd(q, k, v, causal)
        _, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
        leaves = [t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v)]
        o_lib = sdpa(*leaves, is_causal=causal)
        gt = g.transpose(1, 2)

        def fused():
            fk.flash_bwd_fused(q, k, v, out, lse, g, causal)

        def core():
            fk._cuda_core_flash_bwd("fused", q, k, v, out, lse, g, causal)

        def pair():
            fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
            fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)

        with torch.no_grad():
            dev_ms = device_ms(torch, fused, 20, {
                "sweep": ("flash_bwd_tc_kernel",), "all": ()})
            core_dev = device_ms(torch, core, 5, {
                "sweep": ("flash_bwd_fused_kernel",), "all": ()})
            pair_dev = device_ms(torch, pair, 20, {"all": ()})["all"]
            ms = time_cuda(torch, fused, 20, flush=flush)
            core_ms = time_cuda(torch, core, 5, warmup=2, flush=flush)
            plain_ms = time_cuda(torch, lambda: fk.flash_bwd_fused_reference(
                q, k, v, out, lse, g, causal), 5, warmup=2, flush=flush)
        lib_bwd_dev = device_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, gt, retain_graph=True), 20, {"all": ()})["all"]
        del o_lib
        flops, nbytes = fk.kernel_work("flash_bwd_fused", BH, 1, S, S, 64,
                                       causal, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        r = {"ms": ms, "device_ms": dev_ms["all"],
             "sweep_device_ms": dev_ms["sweep"], "cuda_core_ms": core_ms,
             "cuda_core_device_ms": core_dev["all"],
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_bwd_device_ms": lib_bwd_dev,
             "pair_device_ms": pair_dev, "flops": flops, "bytes": nbytes,
             "device_tflops": flops / (dev_ms["all"] * 1e-3) / 1e12,
             "max_abs_err": max(res[f"{dn} {model}"]["errs"].values())}
        res[f"{dn} {model}"].update(r)
        print(f"[flash tc fused] flash_bwd_fused_tc {dn} {model} [{BH}, {S}, "
              f"64] {'causal' if causal else 'non-causal'}: device_ms="
              f"{r['device_ms']:.5f} (sweep {r['sweep_device_ms']:.5f}; "
              f"{r['device_tflops']:.1f} TFLOP/s) kernel_ms={ms:.5f} "
              f"cuda_core device_ms={r['cuda_core_device_ms']:.5f} "
              f"({r['cuda_core_device_ms'] / r['device_ms']:.2f}x; events "
              f"{core_ms:.5f}) plain_ms={plain_ms:.5f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}: {flops} flop, {nbytes} "
              f"bytes); tensor-core split pair device_ms={pair_dev:.5f}; "
              f"library yardstick (not used by the port): sdpa backward "
              f"alone device_ms={lib_bwd_dev:.5f} "
              f"({r['device_ms'] / lib_bwd_dev:.2f}x)", flush=True)
    return res


# ---------------------------------------------------------------------------
# [B*H, S, D] flash configuration: head-packed forward, fused backward
# ---------------------------------------------------------------------------
class knobs_set:
    """Set environment knobs for a ``with`` block, restoring them after."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bh_compare(torch, fk, tag, tol, q, k, v, g, causal, hp=2, qseg=None,
               kseg=None):
    """The head-packed forward (or, with segment ids, ``flash_fwd``)
    and the fused backward against their plain versions; in fp32 also
    against ``flash_fwd`` and the split pair on the same inputs."""
    if qseg is None:
        out, lse = fk.flash_fwd_hpack(q, k, v, hp, causal)
    else:
        out, lse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
    dq, dk, dv = fk.flash_bwd_fused(q, k, v, out, lse, g, causal, qseg, kseg)
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    rout, rlse = fk.flash_attention_reference(
        *[t.float() for t in (q, k, v)], causal, qseg, kseg)
    rdq, rdk, rdv = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal,
                                                 qseg, kseg)
    ref = {"out": rout, "lse": rlse, "dq": rdq, "dk": rdk, "dv": rdv}
    pair = {}
    if q.dtype == torch.float32:
        fout, flse = fk.flash_fwd(q, k, v, causal, qseg, kseg)
        sdq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal, qseg, kseg)
        sdk, sdv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal, qseg,
                                    kseg)
        pair = {"out": fout, "lse": flse, "dq": sdq, "dk": sdk, "dv": sdv}
    torch.cuda.synchronize()
    errs, pair_errs = {}, {}
    for name in got:
        check(got[name].dtype == (torch.float32 if name == "lse" else q.dtype),
              f"[flash bh] {tag}: {name} dtype {got[name].dtype}")
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[flash bh] {tag}: {name} not finite")
        err, rel = _err(got[name], ref[name])
        check(rel <= tol, f"[flash bh] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name] = err
        if pair:
            err, rel = _err(got[name], pair[name])
            check(rel <= FLASH_PAIR_TOL, f"[flash bh] {tag}: {name} vs "
                  f"flash_fwd / split pair {err:.3e} > {FLASH_PAIR_TOL}")
            pair_errs[name] = err
    line = (f"[flash bh] {tag}: vs plain max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + f" (tol {tol} x "
        "max(|ref|, 1))")
    if pair:
        same = torch.equal(out, pair["out"]) and torch.equal(lse, pair["lse"])
        line += ("; vs flash_fwd + split pair " + " ".join(
            f"{n}={e:.3e}" for n, e in pair_errs.items())
            + f" (tol {FLASH_PAIR_TOL}; forward bitwise equal: {same})")
    print(line, flush=True)
    return got, errs


def flash_bh_phase(torch, seed):
    from paddle_tpu_torch.nn.functional import flash_attention
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # the main path's shapes, as the public function hands them over:
    # contiguous [B*H, S, 1, D]
    shapes = {"gpt": (TRAIN_B * 12, TRAIN_S, True),
              "ernie": (ERNIE_B * 12, ERNIE_S, False)}
    res, main = {"bf16": {}, "fp32": {}}, {}
    for dtype, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                       (torch.float32, FLASH_FP32_TOL)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for model, (BH, S, causal) in shapes.items():
            args = [rnd(BH, S, 1, 64, dtype=dtype) for _ in range(4)]
            _, errs = bh_compare(
                torch, fk, f"{name} {model} [{BH}, {S}, 64] "
                f"{'causal' if causal else 'non-causal'} hp=2", tol, *args,
                causal)
            for n, e in errs.items():
                res[name][n] = max(res[name].get(n, 0.0), e)
            if dtype == torch.bfloat16:
                main[model] = args

    tol = FLASH_FP32_TOL
    bh_compare(torch, fk, "S=1000 causal (ragged) hp=2", tol,
               *[rnd(8, 1000, 1, 64) for _ in range(4)], True)
    q = rnd(2, 300, 3, 64)
    bh_compare(torch, fk, "[2, 300, 3, 64] odd H, hp=2 pairs straddle "
               "batches", tol, q, *[rnd(2, 300, 3, 64) for _ in range(3)],
               False)
    bh_compare(torch, fk, "hp=4 non-causal [8, 256, 64]", tol,
               *[rnd(8, 256, 1, 64) for _ in range(4)], False, hp=4)
    qseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    qseg[:, 150:] = 1
    qseg[:, 7] = 9                                   # sees no key
    kseg = torch.zeros((2, 300), dtype=torch.int32, device=dev)
    kseg[:, 150:] = 1
    got, _ = bh_compare(torch, fk, "segment ids + fully-masked row through "
                        "the fused backward", tol,
                        *[rnd(2, 300, 4, 64) for _ in range(4)], False,
                        qseg=qseg, kseg=kseg)
    check(bool((got["out"][:, 7] == 0).all())
          and bool((got["dq"][:, 7] == 0).all()),
          "[flash bh] masked row: out or dq not exactly 0")
    # D=128 under HEADPACK=2: the rule sends it to flash_fwd
    q, k, v = [rnd(2, 256, 4, 128).requires_grad_() for _ in range(3)]
    g = rnd(2, 256, 4, 128)
    fk.reset_counts()
    with knobs_set(BH_KNOBS):
        out, _ = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, [q, k, v], g)
    counts = {f.__name__: f.launches for f in fk.ALL_WRAPPERS}
    check(counts == {"flash_fwd": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                     "flash_fwd_hpack": 0, "flash_bwd_fused": 1},
          f"[flash bh] D=128 under HEADPACK=2 launched {counts}")
    ref, _ = fk.flash_attention_reference(q, k, v, True)
    rgrads = torch.autograd.grad(ref, [q, k, v], g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (ref, *rgrads)):
        err, rel = _err(a, b)
        check(rel <= tol, f"[flash bh] D=128 {name} error {err:.3e}")
    print(f"[flash bh] D=128 through flash_attention under the knobs: "
          f"launches {counts}; out and grads within {tol}", flush=True)

    # times at both main shapes, bf16; the GPT shape's go in the JSON
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for model, (BH, S, causal) in shapes.items():
        q, k, v, g = main[model]
        out, lse = fk.flash_fwd_hpack(q, k, v, 2, causal)
        qt, kt, vt, gt = [t.transpose(1, 2) for t in (q, k, v, g)]
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

        def sdpa_fwd_bwd():
            o = sdpa(*leaves, is_causal=causal)
            torch.autograd.grad(o, leaves, gt)

        o_lib = sdpa(*leaves, is_causal=causal)
        # device times of the fused backward (its three launches) and of
        # SDPA's backward alone, host work not counted
        with torch.no_grad():
            fused_dev = device_ms(torch, lambda: fk.flash_bwd_fused(
                q, k, v, out, lse, g, causal), 20, {"all": ()})["all"]
        lib_bwd_dev = device_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, gt, retain_graph=True), 20, {"all": ()})["all"]
        del o_lib
        calls = {
            "flash_fwd_hpack": (
                lambda: fk.flash_fwd_hpack(q, k, v, 2, causal),
                lambda: fk.flash_attention_reference(q, k, v, causal),
                lambda: sdpa(qt, kt, vt, is_causal=causal)),
            "flash_bwd_fused": (
                lambda: fk.flash_bwd_fused(q, k, v, out, lse, g, causal),
                lambda: fk.flash_bwd_fused_reference(q, k, v, out, lse, g,
                                                     causal),
                sdpa_fwd_bwd),
        }
        for name, (kern, plain, lib) in calls.items():
            with torch.no_grad():
                ms = time_cuda(torch, kern, 20, flush=flush)
                plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
            lib_ms = time_cuda(torch, lib, 20, flush=flush)
            flops, nbytes = fk.kernel_work(name, BH, 1, S, S, 64, causal, 2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            r = {"ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
                 "tflops": flops / (ms * 1e-3) / 1e12}
            if name == "flash_bwd_fused":
                r.update({"device_ms": fused_dev,
                          "library_bwd_device_ms": lib_bwd_dev})
            res.setdefault(name, {})[model] = r
            print(f"[flash bh] {name} bf16 {model} [{BH}, {S}, 64] "
                  f"{'causal' if causal else 'non-causal'}: kernel_ms="
                  f"{ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
                  f"{r['bound_ms']:.5f} ({r['bound_by']}: {flops} flop, "
                  f"{nbytes} bytes) achieved {r['tflops']:.2f} TFLOP/s; "
                  f"library_ms (sdpa "
                  f"{'forward' if name == 'flash_fwd_hpack' else 'forward+backward'}"
                  f", not used by the port)={lib_ms:.5f}"
                  + (f"; device_ms={fused_dev:.5f}, sdpa backward alone "
                     f"device_ms={lib_bwd_dev:.5f}"
                     if name == "flash_bwd_fused" else ""), flush=True)
    # the layout's cost: one [B, S, H, D] <-> [B*H, S, D] copy at GPT's
    # training shape; a layer makes eight (q, k, v, out; dO, dq, dk, dv)
    qkv = rnd(TRAIN_B, TRAIN_S, 3, 12, 64, dtype=torch.bfloat16)
    copy_ms = time_cuda(torch, lambda: qkv[:, :, 0].transpose(1, 2)
                        .contiguous(), 50, flush=flush)
    res["layout_copy_ms"] = copy_ms
    print(f"[flash bh] layout copy [8, 1024, 12, 64] bf16 view -> contiguous "
          f"[96, 1024, 64]: {copy_ms:.5f} ms; x 8 per layer x 12 layers = "
          f"{copy_ms * 96:.3f} ms per GPT-2-small step", flush=True)
    return res


# ---------------------------------------------------------------------------
# fused lm-head cross-entropy: the three kernels against their plain versions
# ---------------------------------------------------------------------------
LMCE_KERNELS = ("lmce_fwd", "lmce_bwd_dh", "lmce_bwd_dw")
LMCE_REPLACES = {
    "lmce_fwd": "paddle_tpu/ops/pallas_lmce.py:58",
    "lmce_bwd_dh": "paddle_tpu/ops/pallas_lmce.py:108",
    "lmce_bwd_dw": "paddle_tpu/ops/pallas_lmce.py:138",
}
LMCE_V, LMCE_D = 50304, 768      # GPT-2-small's vocabulary and width


def lmce_compare(torch, lk, tag, tol, h, w, labels, g):
    """The three kernels against the plain versions computed in fp32 on
    the same values (the backward from the plain forward's lse);
    ignored rows must give exactly 0 loss and 0 dh."""
    loss, lse = lk.lmce_fwd(h, w, labels)
    got = {"loss": loss, "lse": lse,
           "dh": lk.lmce_bwd_dh(h, w, labels, lse, g),
           "dw": lk.lmce_bwd_dw(h, w, labels, lse, g)}
    hf, wf = h.float(), w.float()
    rloss, rlse = lk.lmce_reference(hf, wf, labels)
    ref = {"loss": rloss, "lse": rlse,
           "dh": lk.lmce_bwd_dh_reference(hf, wf, labels, rlse, g),
           "dw": lk.lmce_bwd_dw_reference(hf, wf, labels, rlse, g)}
    torch.cuda.synchronize()
    check(got["dh"].dtype == got["dw"].dtype == h.dtype,
          f"[lmce] {tag}: gradient dtypes {got['dh'].dtype}")
    errs, rels = {}, {}
    for name in ("loss", "lse", "dh", "dw"):
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[lmce] {tag}: {name} not finite")
        err, rel = _err(got[name], ref[name])
        check(rel <= tol, f"[lmce] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name], rels[name] = err, rel
    ignored = labels < 0
    n_ignored = int(ignored.sum().item())
    if n_ignored:
        check(bool((got["loss"][ignored] == 0).all())
              and bool((got["dh"][ignored] == 0).all()),
              f"[lmce] {tag}: ignored rows not exactly 0")
    print(f"[lmce] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + "; / max(|ref|, 1) "
          + " ".join(f"{n}={r:.3e}" for n, r in rels.items())
          + f" (tol {tol}); {n_ignored} ignored rows exactly 0",
          flush=True)
    return errs


def lmce_phase(torch, seed):
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def inputs(N, V, D, dtype, ignore=False):
        h = torch.randn((N, D), generator=gen, device=dev)
        w = torch.randn((V, D), generator=gen, device=dev) * 0.05
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if ignore:
            labels[::4] = -100
        g = torch.rand((N,), generator=gen, device=dev)
        return h.to(dtype), w.to(dtype), labels, g

    N, V, D = TRAIN_B * TRAIN_S, LMCE_V, LMCE_D
    res = {}
    for dtype, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                       (torch.float32, FLASH_FP32_TOL)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        args = inputs(N, V, D, dtype)
        res[name] = lmce_compare(torch, lk, f"{name} N={N} V={V} D={D}",
                                 tol, *args)
        if dtype == torch.bfloat16:
            main = args
        del args
    tol = FLASH_FP32_TOL
    lmce_compare(torch, lk, "N=1000 V=1000 D=64, every 4th label -100",
                 tol, *inputs(1000, 1000, 64, torch.float32, True))
    lmce_compare(torch, lk, "N=1000 V=786 D=2048, every 4th label -100",
                 tol, *inputs(1000, 786, 2048, torch.float32, True))
    lmce_compare(torch, lk, "N=333 V=786 D=200", tol,
                 *inputs(333, 786, 200, torch.float32))

    # times at the main shape, bf16
    h, w, labels, g = main
    _, lse = lk.lmce_fwd(h, w, labels)
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    # the backward's times are [lmce tc]'s (both bodies)
    calls = {
        "lmce_fwd": (lambda: lk.lmce_fwd(h, w, labels),
                     lambda: lk.lmce_reference(h, w, labels)),
    }
    # yardstick only, never called by the port: the unfused lm head
    ce = torch.nn.functional.cross_entropy
    leaves = [t.detach().requires_grad_() for t in (h, w)]

    def library_fwd():
        return ce(torch.matmul(h, w.t()).float(), labels, reduction="none")

    def library_fwd_bwd():
        loss = ce(torch.matmul(leaves[0], leaves[1].t()).float(), labels,
                  reduction="none")
        torch.autograd.grad(loss, leaves, g)

    with torch.no_grad():
        lib_ms = time_cuda(torch, library_fwd, 10, warmup=2, flush=flush)
    lib_fb_ms = time_cuda(torch, library_fwd_bwd, 10, warmup=2, flush=flush)
    for name, (kern, plain) in calls.items():
        with torch.no_grad():
            ms = time_cuda(torch, kern, 5, warmup=2, flush=flush)
            plain_ms = time_cuda(torch, plain, 5, warmup=2, flush=flush)
        flops, nbytes = lk.kernel_work(name, N, V, D, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        err_keys = ("loss", "lse")
        res[name] = {
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms if name == "lmce_fwd" else None,
            "library_fwd_bwd_ms": lib_fb_ms,
            "max_abs_err": max(res["bf16"][k] for k in err_keys),
            "fp32_max_abs_err": max(res["fp32"][k] for k in err_keys),
            "flops": flops, "bytes": nbytes,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        r = res[name]
        print(f"[lmce] {name} bf16 N={N} V={V} D={D}: kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}: {flops} flop, {nbytes} bytes) achieved "
              f"{r['tflops']:.2f} TFLOP/s", flush=True)
    print(f"[lmce] library yardstick (not used by the port): matmul + fp32 "
          f"cross_entropy forward {lib_ms:.5f} ms, forward+backward "
          f"{lib_fb_ms:.5f} ms", flush=True)
    return res


LMCE_SOURCE = "paddle_tpu_torch/csrc/lmce.cu"
LMCE_TC_SOURCE = "paddle_tpu_torch/csrc/lmce_sm90.cu"
LMCE_TC_KERNELS = ("lmce_bwd_dh_tc", "lmce_bwd_dw_tc")
LMCE_RAGGED = (("N=333 V=786 D=200", 333, 786, 200, False),
               ("N=1000 V=1000 D=64, every 4th label -100", 1000, 1000, 64,
                True),
               ("N=1000 V=786 D=2048 (three D windows), every 4th label "
                "-100", 1000, 786, 2048, True))
# The 16-bit LMCE gradients are held element by element:
#   |got - ref| <= rtol |ref| + (u |dL| + eta) @ |B|
# where B is the other factor (W for dh, h for dW).  The kernel and the
# plain version round the same fp32 sums, so the outputs may part by one
# ulp of the value: rtol is 2^-7 of it in bf16, 2^-10 in fp16, plus
# margin.  Before that, each side rounds dL to the operand dtype from
# fp32 values that differ slightly (S summed in another order by the
# tensor cores): where they straddle a rounding boundary a term moves
# by one ulp of dL, and an element whose terms cancel can move by much
# more than an ulp of its own value.  (u |dL| + eta) @ |B| is the
# forward bound of rounding every dL once (u = eps / 2, half an ulp;
# eta = half the subnormal spacing, which fp16's dL of ~1e-5 reaches).
# A gate scaled by max|ref| alone could not see the softmax part of the
# gradient, ~1% of the one-hot part at GPT-2-small's shape.
LMCE_GRAD_RTOL = {"bfloat16": 1e-2, "float16": 2e-3}


def lmce_grad_gate(torch, lk, which, got, ref, h, w, labels, lse, g):
    """``(max abs error, ratio)`` of a 16-bit LMCE gradient (``which``
    ``"dh"`` or ``"dw"``) against its plain version ``ref`` on the same
    inputs: ``ratio`` is the largest ``|got - ref| / (rtol |ref| + (u |dL|
    + eta) @ |B|)`` over the elements, and the gate passes at ``ratio
    <= 1``."""
    fi = torch.finfo(got.dtype)
    rtol = LMCE_GRAD_RTOL[str(got.dtype).rsplit(".", 1)[-1]]
    dl = lk._dlogits(h, w, labels, lse, g, h.dtype).abs_()
    dl.mul_(fi.eps / 2).add_(fi.tiny * fi.eps / 2)
    spread = (dl @ w.float().abs() if which == "dh"
              else dl.t() @ h.float().abs())
    del dl
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    bound = rtol * ref.abs()
    ratio = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / (bound + spread)).max().item()
    return diff.max().item(), ratio


def lmce_s_free(torch, which, h, w, labels, lse, g):
    """The plain gradient of a backward that drops the S product (S = 0,
    p = exp(-lse)): the gate's negative control, which must fail it."""
    lab = labels.long()
    cols = torch.arange(w.shape[0], device=h.device)
    gv = torch.where(lab >= 0, g.float(), torch.zeros_like(g.float()))
    dl = ((torch.exp(-lse.float())[:, None]
           - (cols[None, :] == lab[:, None]).float()) * gv[:, None])
    dl = dl.to(h.dtype).float()
    if which == "dh":
        return (dl @ w.float()).to(h.dtype)
    return (dl.t() @ h.float()).to(w.dtype)


def lmce_tc_compare(torch, lk, tag, h, w, labels, g, control=False):
    """The tensor-core backward (``lmce_bwd_dh`` / ``lmce_bwd_dw`` on
    16-bit operands) against the plain versions on the same values (dL
    rounded to the operand dtype, products summed in fp32) from the
    plain lse, element by element (:func:`lmce_grad_gate`); rows with an
    ignored label exactly 0 in dh; a second run bitwise equal.
    ``control``: the S-free gradient (:func:`lmce_s_free`) must fail
    the same gate.  Returns the max abs errors and the gate's ratios."""
    _, lse = lk.lmce_reference(h, w, labels)
    bwd = (lk.lmce_bwd_dh, lk.lmce_bwd_dw)
    before = [f.tc_launches for f in bwd]
    got = {"dh": lk.lmce_bwd_dh(h, w, labels, lse, g),
           "dw": lk.lmce_bwd_dw(h, w, labels, lse, g)}
    again = {"dh": lk.lmce_bwd_dh(h, w, labels, lse, g),
             "dw": lk.lmce_bwd_dw(h, w, labels, lse, g)}
    torch.cuda.synchronize()
    check([f.tc_launches for f in bwd] == [b + 2 for b in before],
          f"[lmce tc] {tag}: the tensor-core kernels did not launch")
    errs, ratios, controls = {}, {}, {}
    for name, plain in (("dh", lk.lmce_bwd_dh_reference),
                        ("dw", lk.lmce_bwd_dw_reference)):
        ref = plain(h, w, labels, lse, g)
        check(got[name].dtype == h.dtype,
              f"[lmce tc] {tag}: {name} dtype {got[name].dtype}")
        check(bool(torch.isfinite(got[name].float()).all()),
              f"[lmce tc] {tag}: {name} not finite")
        err, ratio = lmce_grad_gate(torch, lk, name, got[name], ref, h, w,
                                    labels, lse, g)
        check(ratio <= 1.0, f"[lmce tc] {tag}: {name} error {err:.3e}, "
              f"gate ratio {ratio:.3e} > 1")
        errs[name], ratios[name] = err, ratio
        if control:
            controls[name] = lmce_grad_gate(
                torch, lk, name, lmce_s_free(torch, name, h, w, labels, lse,
                                             g), ref, h, w, labels, lse, g)[1]
            check(controls[name] > 1.0, f"[lmce tc] {tag}: the gate passes "
                  f"the S-free {name} (ratio {controls[name]:.3e})")
        del ref
    same = all(torch.equal(got[k], again[k]) for k in got)
    check(same, f"[lmce tc] {tag}: two runs differ")
    ignored = labels < 0
    n_ignored = int(ignored.sum().item())
    if n_ignored:
        check(bool((got["dh"][ignored] == 0).all()),
              f"[lmce tc] {tag}: ignored rows of dh not exactly 0")
    dn = str(h.dtype).rsplit(".", 1)[-1]
    print(f"[lmce tc] {tag}: max_abs_err dh={errs['dh']:.3e} "
          f"dw={errs['dw']:.3e}; gate ratio dh={ratios['dh']:.3e} "
          f"dw={ratios['dw']:.3e} (per element |err| <= "
          f"{LMCE_GRAD_RTOL[dn]} |ref| + (u |dL| + eta) @ |B|, passes <= 1)"
          + (f"; the S-free control's ratio dh={controls['dh']:.3e} "
             f"dw={controls['dw']:.3e} (fails, as it must)"
             if control else "")
          + f"; two runs bitwise equal: {same}; {n_ignored} ignored rows "
          "of dh exactly 0", flush=True)
    return errs, ratios


def lmce_tc_phase(torch, seed, nvcc_log):
    """``[lmce tc]``: the tensor-core backward (``csrc/lmce_sm90.cu``)
    against its plain versions at the main shape in bf16 and fp16 and at
    the ragged shapes in both, the SASS's ``HGMMA`` count, and times at
    the main shape beside the CUDA-core backward it replaced for 16-bit
    operands and the plain versions."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 30)

    def inputs(N, V, D, dtype, ignore=False):
        h = torch.randn((N, D), generator=gen, device=dev)
        w = torch.randn((V, D), generator=gen, device=dev) * 0.05
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if ignore:
            labels[::4] = -100
        g = torch.rand((N,), generator=gen, device=dev)
        return h.to(dtype), w.to(dtype), labels, g

    hgmma, regs, spills = sass_summary(_build.library_path("lmce_sm90"),
                                       nvcc_log)
    print(f"[lmce tc] {LMCE_TC_SOURCE}: {hgmma} HGMMA instructions in the "
          f"SASS; ptxas registers per kernel {regs}, spill store bytes "
          f"{spills}", flush=True)
    check(hgmma > 0, "[lmce tc] no HGMMA instruction in the SASS")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}

    N, V, D = TRAIN_B * TRAIN_S, LMCE_V, LMCE_D
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"
        h, w, labels, g = inputs(N, V, D, dtype)
        errs, ratios = lmce_tc_compare(torch, lk, f"{dn} N={N} V={V} D={D}",
                                       h, w, labels, g, control=True)
        for tag, n, v, d, ignore in LMCE_RAGGED:
            e, r = lmce_tc_compare(torch, lk, f"{dn} {tag}",
                                   *inputs(n, v, d, dtype, ignore))
            errs = {k: max(x, e[k]) for k, x in errs.items()}
            ratios = {k: max(x, r[k]) for k, x in ratios.items()}
        _, lse = lk.lmce_fwd(h, w, labels)
        for which, name in (("dh", "lmce_bwd_dh"), ("dw", "lmce_bwd_dw")):
            fn = getattr(lk, name)
            plain = getattr(lk, f"{name}_reference")
            with torch.no_grad():
                ms = time_cuda(torch, lambda: fn(h, w, labels, lse, g), 10,
                               warmup=2, flush=flush)
                core_ms = time_cuda(
                    torch, lambda: lk._cuda_core_bwd(which, h, w, labels, lse,
                                                     g), 3, warmup=1,
                    flush=flush)
                plain_ms = time_cuda(
                    torch, lambda: plain(h, w, labels, lse, g), 3, warmup=1,
                    flush=flush)
            flops, nbytes = lk.kernel_work(name, N, V, D, 2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            r = {"ms": ms, "cuda_core_ms": core_ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "flops": flops, "bytes": nbytes,
                 "tflops": flops / (ms * 1e-3) / 1e12,
                 "cuda_core_tflops": flops / (core_ms * 1e-3) / 1e12,
                 "max_abs_err": errs[which], "gate_ratio": ratios[which]}
            res[f"{name}_tc {dn}"] = r
            print(f"[lmce tc] {name}_tc {dn} N={N} V={V} D={D}: kernel_ms="
                  f"{ms:.5f} ({r['tflops']:.1f} TFLOP/s) cuda_core_ms="
                  f"{core_ms:.5f} ({r['cuda_core_tflops']:.1f} TFLOP/s, "
                  f"{core_ms / ms:.2f}x the tensor-core time) plain_ms="
                  f"{plain_ms:.5f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}: {flops} flop, {nbytes} bytes)",
                  flush=True)
        del h, w, labels, g, lse
    return res


LMCE_FWD_TC_SOURCE = "paddle_tpu_torch/csrc/lmce_fwd_sm90.cu"
# The tensor-core forward's loss and lse are held per row against the
# plain version on the same 16-bit values:
#   |lse - ref| <= D eps32 A + V eps32 + 4 eps32 |ref|
#   |loss - ref| <= 2 D eps32 A + V eps32 + 4 eps32 |ref|
# with A = max_v sum_d |h_d| |w_vd|: both sides sum each logit's D
# products in fp32 in other orders (each within (D - 1) eps32 / 2 of
# sum|terms|, and lse moves by at most the largest logit's error, the
# loss by that and the picked logit's), the sum-exp over V terms in
# another order and with ex2.approx (a relative error of at most V eps32
# between the two), and the final log and subtraction round once or
# twice.  Ignored rows must be exactly 0.
LMCE_FWD_RAGGED = (("N=333 V=786 D=200", 333, 786, 200, False),
                   ("N=1000 V=1000 D=64, every 4th label -100", 1000, 1000,
                    64, True),
                   ("N=1000 V=786 D=2048 (h streamed), every 4th label "
                    "-100", 1000, 786, 2048, True))


def lmce_fwd_gate(torch, got, ref, h, w, labels):
    """The largest ``|err| / bound`` of a forward's ``(loss, lse)``
    against the plain ``ref`` over the rows (the bound above); passes at
    ``<= 1``.  Rows whose plain loss is the unmatched-label ``-NEG`` are
    held to the same relative bound."""
    eps = torch.finfo(torch.float32).eps
    D, V = h.shape[1], w.shape[0]
    a = (h.float().abs() @ w.float().abs().t()).amax(dim=-1)
    base = D * eps * a + V * eps
    ratio = 0.0
    for t, r, extra in ((got[1], ref[1], 0.0), (got[0], ref[0], D * eps * a)):
        diff = (t.float() - r.float()).abs()
        bound = base + extra + 4 * eps * r.float().abs()
        ratio = max(ratio, torch.where(diff == 0, torch.zeros_like(diff),
                                       diff / bound).max().item())
    return ratio


def lmce_fwd_controls(torch, lk, slices, h, w, labels):
    """Three broken forwards the gate must fail: the ragged vocabulary
    edge left out, the label column off by one, and the split forward's
    combine without one slice's partial."""
    V = w.shape[0]
    lab = labels.long()
    part = lk.lmce_fwd_partials(h, w, labels, slices)
    keep = [k for k in range(slices) if k != slices // 2]
    return {
        "ragged edge dropped": lk.lmce_reference(
            h, w[:V - V % lk.FWD_VOCAB_TILE], labels),
        "label column + 1": lk.lmce_reference(
            h, w, torch.where(lab >= 0, lab + 1, lab)),
        "one slice not combined": lk.lmce_fwd_combine(part[:, keep], labels),
    }


def lmce_tc_fwd_compare(torch, lk, tag, h, w, labels, controls=False):
    """The tensor-core ``lmce_fwd`` against ``lmce_reference`` on the same
    16-bit values through :func:`lmce_fwd_gate`; ignored rows exactly 0;
    a second run bitwise equal; ``controls`` (a ragged V): the three
    broken forwards of :func:`lmce_fwd_controls` fail the gate."""
    before = lk.lmce_fwd.tc_launches
    got = lk.lmce_fwd(h, w, labels)
    again = lk.lmce_fwd(h, w, labels)
    torch.cuda.synchronize()
    check(lk.lmce_fwd.tc_launches == before + 2,
          f"[lmce tc fwd] {tag}: the tensor-core forward did not launch")
    ref = lk.lmce_reference(h, w, labels)
    for name, t in zip(("loss", "lse"), got):
        check(t.dtype == torch.float32 and bool(torch.isfinite(t).all()),
              f"[lmce tc fwd] {tag}: {name} dtype {t.dtype} or not finite")
    ratio = lmce_fwd_gate(torch, got, ref, h, w, labels)
    errs = {n: (a - b).abs().max().item()
            for n, a, b in zip(("loss", "lse"), got, ref)}
    same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ignored = labels < 0
    n_ignored = int(ignored.sum().item())
    line = (f"[lmce tc fwd] {tag}: max_abs_err loss={errs['loss']:.3e} "
            f"lse={errs['lse']:.3e}; gate ratio {ratio:.3e} (<= 1); two runs "
            f"bitwise equal: {same}; {n_ignored} ignored rows exactly 0")
    ctl = {}
    if controls:
        sms = torch.cuda.get_device_properties(h.device).multi_processor_count
        slices = lk.vocab_slices(h.shape[0], w.shape[0], sms)
        check(slices > 1 and w.shape[0] % lk.FWD_VOCAB_TILE,
              f"[lmce tc fwd] {tag}: the controls need a ragged V and "
              "several slices")
        for name, bad in lmce_fwd_controls(torch, lk, slices, h, w,
                                           labels).items():
            ctl[name] = lmce_fwd_gate(torch, bad, ref, h, w, labels)
        line += "; controls (fail, as they must): " + "; ".join(
            f"{n} ratio {r:.3e}" for n, r in ctl.items())
    print(line, flush=True)
    for name, r in ctl.items():
        check(r > 1.0, f"[lmce tc fwd] {tag}: the gate passes the {name} "
              f"control (ratio {r:.3e})")
    check(ratio <= 1.0, f"[lmce tc fwd] {tag}: gate ratio {ratio:.3e} > 1")
    check(same, f"[lmce tc fwd] {tag}: two runs differ")
    if n_ignored:
        check(bool((got[0][ignored] == 0).all()),
              f"[lmce tc fwd] {tag}: ignored rows not exactly 0")
    return errs, ratio


def lmce_tc_fwd_phase(torch, seed, nvcc_log):
    """``[lmce tc fwd]``: the tensor-core forward (``csrc/lmce_fwd_sm90.cu``)
    against its plain version at the main shape and the ragged shapes, in
    bf16 and fp16, with the controls; the SASS's ``HGMMA`` count; times
    at the main shape (device time and events) beside the CUDA-core
    forward it replaced for 16-bit operands, the bound and the library
    call."""
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 80)

    def inputs(N, V, D, dtype, ignore=False):
        h = torch.randn((N, D), generator=gen, device=dev)
        w = torch.randn((V, D), generator=gen, device=dev) * 0.05
        labels = torch.randint(0, V, (N,), generator=gen, device=dev)
        if ignore:
            labels[::4] = -100
        return h.to(dtype), w.to(dtype), labels

    hgmma, regs, spills = sass_summary(_build.library_path("lmce_fwd_sm90"),
                                       nvcc_log)
    print(f"[lmce tc fwd] {LMCE_FWD_TC_SOURCE}: {hgmma} HGMMA instructions "
          f"in the SASS; ptxas registers per kernel {regs}, spill store "
          f"bytes {spills}", flush=True)
    check(hgmma > 0, "[lmce tc fwd] no HGMMA instruction in the SASS")
    check(not any(spills), f"[lmce tc fwd] ptxas spills {spills}")
    res = {"hgmma": hgmma, "registers": regs, "spill_bytes": spills}
    N, V, D = TRAIN_B * TRAIN_S, LMCE_V, LMCE_D
    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    ce = torch.nn.functional.cross_entropy
    for dtype in (torch.bfloat16, torch.float16):
        dn = "bf16" if dtype == torch.bfloat16 else "fp16"
        h, w, labels = inputs(N, V, D, dtype)
        errs, ratio = lmce_tc_fwd_compare(torch, lk, f"{dn} N={N} V={V} "
                                          f"D={D}", h, w, labels)
        err_main = max(errs.values())
        for tag, n, v, d, ignore in LMCE_FWD_RAGGED:
            e, r = lmce_tc_fwd_compare(torch, lk, f"{dn} {tag}",
                                       *inputs(n, v, d, dtype, ignore),
                                       controls=d == 200)
            errs = {k: max(x, e[k]) for k, x in errs.items()}
            ratio = max(ratio, r)
        with torch.no_grad():
            dev_ms = device_ms(torch, lambda: lk.lmce_fwd(h, w, labels), 10, {
                "sweep": ("lmce_fwd_tc_kernel",),
                "combine": ("lmce_fwd_combine",), "all": ()})
            core_dev = device_ms(torch, lambda: lk._cuda_core_fwd(
                h, w, labels), 3, {"all": ()})["all"]
            ms = time_cuda(torch, lambda: lk.lmce_fwd(h, w, labels), 10,
                           warmup=2, flush=flush)
            core_ms = time_cuda(torch, lambda: lk._cuda_core_fwd(
                h, w, labels), 3, warmup=1, flush=flush)
            plain_ms = time_cuda(torch, lambda: lk.lmce_reference(
                h, w, labels), 3, warmup=1, flush=flush)
            lib_ms = time_cuda(torch, lambda: ce(
                torch.matmul(h, w.t()).float(), labels, reduction="none"),
                10, warmup=2, flush=flush)
            lib_dev = device_ms(torch, lambda: ce(
                torch.matmul(h, w.t()).float(), labels, reduction="none"),
                10, {"all": ()})["all"]
        flops, nbytes = lk.kernel_work("lmce_fwd", N, V, D, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        r = {"ms": ms, "device_ms": dev_ms["all"],
             "sweep_device_ms": dev_ms["sweep"],
             "combine_device_ms": dev_ms["combine"],
             "cuda_core_ms": core_ms, "cuda_core_device_ms": core_dev,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": lib_ms, "library_device_ms": lib_dev,
             "flops": flops, "bytes": nbytes,
             "tflops": flops / (ms * 1e-3) / 1e12,
             "device_tflops": flops / (dev_ms["all"] * 1e-3) / 1e12,
             "max_abs_err": err_main, "ragged_max_abs_err":
                 max(errs.values()), "gate_ratio": ratio}
        res[dn] = r
        print(f"[lmce tc fwd] lmce_fwd_tc {dn} N={N} V={V} D={D}: device_ms="
              f"{r['device_ms']:.5f} (sweep {r['sweep_device_ms']:.5f}, "
              f"combine {r['combine_device_ms']:.5f}; "
              f"{r['device_tflops']:.1f} TFLOP/s) kernel_ms={ms:.5f} "
              f"cuda_core_ms={core_ms:.5f} (device {core_dev:.5f}; "
              f"{core_dev / r['device_ms']:.2f}x) plain_ms={plain_ms:.5f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}: {flops} "
              f"flop, {nbytes} bytes); library yardstick (not used by the "
              f"port): matmul + fp32 cross_entropy {lib_ms:.5f} ms "
              f"(device {lib_dev:.5f})", flush=True)
        del h, w, labels
    return res


# ---------------------------------------------------------------------------
# fp16 and head dims 16 / 32 on the card
# ---------------------------------------------------------------------------
FP16_TOL = 1e-2                  # x max(|ref|, 1); fp16 inputs and outputs
                                 # (11 bits), at most the bf16 gate
DTYPE_TOLS = {"fp32": FLASH_FP32_TOL, "bf16": FLASH_BF16_TOL,
              "fp16": FP16_TOL}


def hold(torch, phase, tag, tol, pairs):
    """Each ``(name, got, ref)``: finite and within ``tol`` x max(|ref|,
    1) of the plain version; prints and returns the max abs errors."""
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in pairs:
        check(bool(torch.isfinite(got.float()).all()),
              f"[{phase}] {tag}: {name} not finite")
        err, rel = _err(got, ref)
        check(rel <= tol, f"[{phase}] {tag}: {name} error {err:.3e} "
                          f"(relative {rel:.3e}) > {tol}")
        errs[name] = err
    print(f"[{phase}] {tag}: max_abs_err " + " ".join(
        f"{n}={e:.3e}" for n, e in errs.items()) + f" (tol {tol} x "
          "max(|ref|, 1))", flush=True)
    return errs


def flash_hold(torch, fk, phase, tag, tol, q, k, v, g, causal, hps=(2,)):
    """Every flash kernel on these inputs against its plain version on
    the same values: the routed forward and the CUDA-core forward
    (p rounded to the input dtype, ``flash_fwd_tc_reference``), the
    routed and the CUDA-core split backward (dS and p rounded as the
    plain versions round them), the fused backward, and the head-packed
    forward for each
    ``hp`` in the ``[B*H, S, D]`` layout (its routed body and its
    CUDA-core body).  Returns the max abs error per kernel."""
    B, S, H, D = q.shape
    out, lse = fk.flash_fwd(q, k, v, causal)
    ref = fk.flash_fwd_tc_reference(q, k, v, causal)
    core = fk._cuda_core_fwd(q, k, v, causal)
    e = hold(torch, phase, f"{tag} flash_fwd (tensor-core: "
             f"{fk._is_tc(q)}) and the CUDA-core forward", tol,
             [("out", out, ref[0]), ("lse", lse, ref[1]),
              ("core out", core[0], ref[0]), ("core lse", core[1], ref[1])])
    errs = {"flash_fwd": max(e["out"], e["lse"]),
            "flash_fwd cuda_core": max(e["core out"], e["core lse"])}
    dq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    cdq, cdelta = fk._cuda_core_flash_bwd("dq", q, k, v, out, lse, g, causal)
    cdk, cdv = fk._cuda_core_flash_bwd("dkv", q, k, v, g, lse, delta, causal)
    rdq, rdelta = fk.flash_bwd_dq_reference(q, k, v, out, lse, g, causal)
    rdk, rdv = fk.flash_bwd_dkv_reference(q, k, v, g, lse, delta, causal)
    e = hold(torch, phase, f"{tag} flash_bwd_dq + flash_bwd_dkv "
             f"(tensor-core: {fk._is_tc(q)}) and the CUDA-core pair", tol,
             [("dq", dq, rdq), ("delta", delta, rdelta), ("dk", dk, rdk),
              ("dv", dv, rdv), ("core dq", cdq, rdq),
              ("core delta", cdelta, rdelta), ("core dk", cdk, rdk),
              ("core dv", cdv, rdv)])
    errs["flash_bwd_dq"] = max(e["dq"], e["delta"])
    errs["flash_bwd_dkv"] = max(e["dk"], e["dv"])
    errs["flash_bwd_dq cuda_core"] = max(e["core dq"], e["core delta"])
    errs["flash_bwd_dkv cuda_core"] = max(e["core dk"], e["core dv"])
    got = fk.flash_bwd_fused(q, k, v, out, lse, g, causal)
    core = fk._cuda_core_flash_bwd("fused", q, k, v, out, lse, g, causal)
    rf = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal)
    e = hold(torch, phase, f"{tag} flash_bwd_fused (tensor-core: "
             f"{fk._is_tc(q)}) and the CUDA-core sweep", tol,
             list(zip(("dq", "dk", "dv"), got, rf))
             + list(zip(("core dq", "core dk", "core dv"), core, rf)))
    errs["flash_bwd_fused"] = max(e["dq"], e["dk"], e["dv"])
    errs["flash_bwd_fused cuda_core"] = max(e["core dq"], e["core dk"],
                                            e["core dv"])

    def bh(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, S, 1, D).contiguous()
    qb, kb, vb = bh(q), bh(k), bh(v)
    rb = fk.flash_fwd_tc_reference(qb, kb, vb, causal)
    errs["flash_fwd_hpack"] = errs["flash_fwd_hpack cuda_core"] = 0.0
    for hp in hps:
        o, l = fk.flash_fwd_hpack(qb, kb, vb, hp, causal)
        co, cl = fk._cuda_core_fwd(qb, kb, vb, causal, hp=hp)
        e = hold(torch, phase, f"{tag} flash_fwd_hpack hp={hp} "
                 f"(tensor-core: {fk._is_tc(qb, (64,))}) and its CUDA-core "
                 "body", tol, [("out", o, rb[0]), ("lse", l, rb[1]),
                               ("core out", co, rb[0]),
                               ("core lse", cl, rb[1])])
        errs["flash_fwd_hpack"] = max(errs["flash_fwd_hpack"], e["out"],
                                      e["lse"])
        errs["flash_fwd_hpack cuda_core"] = max(
            errs["flash_fwd_hpack cuda_core"], e["core out"], e["core lse"])
    return errs


def paged_hold(torch, pak, phase, tag, tol, dtype, Dh, seed):
    """The paged kernel against its plain version (fp32 on the same
    values) at decode shapes with ragged lengths, scattered pages and an
    empty row (exactly 0)."""
    B, H, BS, NB, MAXNB = 8, 12, 16, 512, 64
    lengths_l = [0, 1, 16, 17, 500, 1024, 333, 64]
    rng = np.random.default_rng(seed)
    table = np.zeros((B, MAXNB), dtype=np.int32)
    free = rng.permutation(np.arange(1, NB)).tolist()
    for b, n in enumerate(lengths_l):
        table[b, :-(-n // BS)] = [free.pop() for _ in range(-(-n // BS))]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pk, pv = [torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
              .to(dtype) for _ in range(2)]
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
    table_t = torch.as_tensor(table, device=dev)
    lengths = torch.as_tensor(np.array(lengths_l, np.int32), device=dev)
    before = pak.paged_ragged_attention.launches
    out = pak.paged_ragged_attention(pk, pv, table_t, lengths, q)
    ref = pak.paged_ragged_attention_reference(pk.float(), pv.float(),
                                               table_t, lengths, q.float())
    check(pak.paged_ragged_attention.launches == before + 1,
          f"[{phase}] {tag}: the paged kernel did not launch")
    check(out.dtype == dtype and bool((out[0] == 0).all()),
          f"[{phase}] {tag}: dtype {out.dtype} or the empty row not 0")
    return hold(torch, phase, f"{tag} paged_ragged_attention B={B} H={H} "
                f"Dh={Dh} lengths={lengths_l}", tol, [("out", out, ref)])


def fp16_phase(torch, seed):
    """``[fp16]``: every kernel against its plain version in fp16 (fault
    C1): K1, the flash forwards (tensor-core and CUDA-core), dq/dkv, the
    fused backward and the head-packed forward at ``[train fp16]``'s
    shapes, and the three LMCE kernels (the backward's tensor-core and
    CUDA-core bodies, held by :func:`lmce_grad_gate`)."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    f16 = torch.float16
    res = {"paged_ragged_attention": paged_hold(
        torch, pak, "fp16", "fp16", FP16_TOL, f16, 64, seed)["out"]}
    B, S, H, D = TRAIN_B, TRAIN_S, 12, 64     # [train fp16]'s shapes
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev).to(f16)
    g = torch.randn((B, S, H, D), generator=gen, device=dev).to(f16)
    res.update(flash_hold(torch, fk, "fp16", f"fp16 [B,S,H,D] views B={B} "
                          f"S={S} H={H} D={D} causal", FP16_TOL,
                          qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], g, True))
    N, V = 1024, LMCE_V
    h = torch.randn((N, LMCE_D), generator=gen, device=dev).to(f16)
    w = (torch.randn((V, LMCE_D), generator=gen, device=dev) * 0.05).to(f16)
    labels = torch.randint(0, V, (N,), generator=gen, device=dev)
    labels[::4] = -100
    gg = torch.rand((N,), generator=gen, device=dev)
    loss, lse = lk.lmce_fwd(h, w, labels)
    closs, clse = lk._cuda_core_fwd(h, w, labels)
    rloss, rlse = lk.lmce_reference(h, w, labels)
    got = [lk.lmce_bwd_dh(h, w, labels, lse, gg),
           lk.lmce_bwd_dw(h, w, labels, lse, gg),
           lk._cuda_core_bwd("dh", h, w, labels, lse, gg),
           lk._cuda_core_bwd("dw", h, w, labels, lse, gg)]
    tag = f"fp16 lmce N={N} V={V} D={LMCE_D}, every 4th label -100"
    e = hold(torch, "fp16", f"{tag}: lmce_fwd (tensor-core) and the "
             "CUDA-core forward", FP16_TOL,
             [("loss", loss, rloss), ("lse", lse, rlse),
              ("core loss", closs, rloss), ("core lse", clse, rlse)])
    fwd_ratio = lmce_fwd_gate(torch, (loss, lse), (rloss, rlse), h, w, labels)
    check(fwd_ratio <= 1.0, f"[fp16] {tag}: lmce_fwd gate ratio "
          f"{fwd_ratio:.3e} > 1")
    refs = {"dh": lk.lmce_bwd_dh_reference(h, w, labels, lse, gg),
            "dw": lk.lmce_bwd_dw_reference(h, w, labels, lse, gg)}
    torch.cuda.synchronize()
    ratios = {}
    for name, t in zip(("dh_tc", "dw_tc", "dh", "dw"), got):
        e[name], ratios[name] = lmce_grad_gate(
            torch, lk, name[:2], t, refs[name[:2]], h, w, labels, lse, gg)
        check(bool(torch.isfinite(t.float()).all()) and ratios[name] <= 1.0,
              f"[fp16] {tag}: {name} error {e[name]:.3e}, gate ratio "
              f"{ratios[name]:.3e} > 1 (or not finite)")
    print(f"[fp16] {tag}: the tensor-core and the CUDA-core backward: "
          "max_abs_err " + " ".join(f"{n}={e[n]:.3e}" for n in ratios)
          + "; gate ratio " + " ".join(f"{n}={r:.3e}" for n, r in
                                       ratios.items())
          + f" (per element |err| <= {LMCE_GRAD_RTOL['float16']} |ref| + "
          "(u |dL| + eta) @ |B|, passes <= 1)", flush=True)
    check(all(t.dtype == f16 for t in got), "[fp16] lmce gradient dtypes")
    check(bool((got[0][labels < 0] == 0).all()),
          "[fp16] lmce ignored rows of dh not exactly 0")
    res.update({"lmce_fwd": max(e["loss"], e["lse"]),
                "lmce_fwd cuda_core": max(e["core loss"], e["core lse"]),
                "lmce_bwd_dh_tc": e["dh_tc"], "lmce_bwd_dw_tc": e["dw_tc"],
                "lmce_bwd_dh": e["dh"], "lmce_bwd_dw": e["dw"]})
    return res


def headdim_phase(torch, seed):
    """``[headdim]``: the flash kernels (forward, split and fused
    backward, head-packed forward at hp 2 and 4) at head dims 16 and 32
    in fp32, bf16 and fp16, and the paged kernel at Dh = 16 (gpt_tiny's
    head dim; half a warp per row), each against its plain version
    (fault C2).  Below 64 every forward is the CUDA-core kernel."""
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 50)
    res = {}
    for D in (16, 32):
        for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                          ("fp16", torch.float16)):
            args = [torch.randn((2, 300, 4, D), generator=gen,
                                device=dev).to(dtype) for _ in range(4)]
            before = sum(f.tc_launches for f in fk.TC_WRAPPERS)
            for causal in (True, False):
                res[f"D={D} {dn} {'causal' if causal else 'non-causal'}"] = \
                    flash_hold(torch, fk, "headdim", f"{dn} D={D} "
                               f"[2, 300, 4, {D}] "
                               f"{'causal' if causal else 'non-causal'}",
                               DTYPE_TOLS[dn], *args, causal, hps=(2, 4))
            check(sum(f.tc_launches for f in fk.TC_WRAPPERS) == before,
                  f"[headdim] D={D} {dn} launched a tensor-core kernel")
    for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                      ("fp16", torch.float16)):
        res[f"paged Dh=16 {dn}"] = paged_hold(
            torch, pak, "headdim", dn, DTYPE_TOLS[dn] if dn != "fp32" else
            FP32_TOL, dtype, 16, seed)["out"]
    return res


# ---------------------------------------------------------------------------
# training: GPT-2-small through Model.fit
# ---------------------------------------------------------------------------
def _train_model(torch, cfg, device, seed, o2, bert=False,
                 amp_dtype="bfloat16"):
    """GPT (or, with ``bert``, BertForPretraining) from ``seed`` and its
    AdamW(1e-4, multi_precision), cast to ``amp_dtype`` O2 if ``o2``
    (``amp_dtype`` None: ``amp.decorate``'s default, float16)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertForPretraining, GPTForCausalLM
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = (BertForPretraining if bert else GPTForCausalLM)(
        cfg, device=device, generator=gen)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=net.parameters(),
                                 multi_precision=True)
    if o2 and amp_dtype is None:
        paddle.amp.decorate(net, opt, level="O2")
    elif o2:
        paddle.amp.decorate(net, opt, level="O2", dtype=amp_dtype)
    return net, opt


def _mlm_batch(torch, vocab, b, s, seed):
    """Tokens and MLM labels: the token on 15% of positions, -100
    elsewhere (bench.py's ERNIE batch), from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (b, s)).astype(np.int64)
    labels = np.where(rng.random((b, s)) < 0.15, x, -100).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(labels)


def fit_and_check(torch, tag, desc, model, net, batch, want, tokens,
                  low=None):
    """``Model.fit`` for TRAIN_STEPS steps on one repeated batch, every
    launch count set to 0 just before and read just after; checks
    finite, falling losses, the launch counts against ``want`` (every
    flash and lmce kernel and the fused backward's helpers), no plain
    call and the O2 dtypes (``low``: the 16-bit one, bf16 by default);
    prints step ms, tokens/s, peak memory and a profile of two more
    steps."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk

    class StepClock(Callback):
        """Waits for the device at each step end and stamps it (the
        measurement's sync, not the library's); keeps the losses."""

        def __init__(self):
            super().__init__()
            self.stamps, self.losses = [], []

        def on_train_begin(self, logs=None):
            torch.cuda.synchronize()
            self.stamps.append(time.monotonic())

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.stamps.append(time.monotonic())
            self.losses.append(float(logs["loss"][0]))

    clock = StepClock()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    lk.reset_counts()
    model.fit([batch] * TRAIN_STEPS, epochs=1, num_iters=TRAIN_STEPS,
              verbose=0, callbacks=[clock])
    wrappers = fk.ALL_WRAPPERS + lk.WRAPPERS
    launches = {f.__name__: f.launches for f in wrappers}
    launches.update({f"{f.__name__}.tc": f.tc_launches
                     for f in fk.TC_WRAPPERS + lk.TC_WRAPPERS})
    launches["_cuda_core_fwd"] = fk._cuda_core_fwd.launches
    launches["_cuda_core_flash_bwd"] = fk._cuda_core_flash_bwd.launches
    launches["_cuda_core_bwd"] = lk._cuda_core_bwd.launches
    launches["_cuda_core_lmce_fwd"] = lk._cuda_core_fwd.launches
    launches.update(fk.flash_bwd_fused.helper_launches)
    plain = {f.__name__: f.plain_calls for f in wrappers}
    peak = torch.cuda.max_memory_allocated()
    losses = clock.losses
    check(len(losses) == TRAIN_STEPS, f"[{tag}] {len(losses)} steps")
    check(all(np.isfinite(losses)), f"[{tag}] loss not finite: {losses}")
    check(losses[-1] < losses[0], f"[{tag}] loss did not fall: {losses}")
    check(launches == want, f"[{tag}] launches {launches}, expected {want}")
    check(not any(plain.values()), f"[{tag}] plain calls {plain}")
    dtypes = {p.dtype for p in net.parameters()}
    check(dtypes == {low or torch.bfloat16, torch.float32},
          f"[{tag}] O2 parameter dtypes {dtypes}")
    steps_ms = np.diff(clock.stamps) * 1e3
    step_ms = float(np.median(steps_ms[2:]))
    tok_s = tokens / (step_ms * 1e-3)
    print(f"[{tag}] {desc}: {TRAIN_STEPS} steps, losses "
          f"{[round(v, 6) for v in losses]}; step_ms first="
          f"{steps_ms[0]:.3f} median(steps 3+)={step_ms:.3f} -> "
          f"{tok_s:.1f} tokens/s; peak_mem_gib="
          f"{peak / 2**30:.3f} (resident before fit "
          f"{resident / 2**30:.3f}); launches {launches}; plain calls "
          f"{plain}", flush=True)
    profile_steps(torch, model, batch, 2, tag)
    return {"launches": launches, "losses": losses, "peak": peak,
            "step_ms": step_ms, "tokens_per_s": tok_s}


def _want_launches(layer_calls, bh=False, fused_lmce_steps=0):
    """Expected launch counts: the default path's three flash kernels,
    or under the [B*H, S, D] knobs the head-packed forward, the fused
    backward and its helpers (bf16: the dq epilogue runs too),
    ``layer_calls`` times each; every 16-bit forward, split and fused
    backward launch the tensor-core body's (``.tc``), none the CUDA-core
    comparison entries'; each 16-bit lmce launch (forward, dh, dW) the
    tensor-core body's, none the CUDA-core forward's or backward's."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    want = {f.__name__: 0 if bh else layer_calls for f in fk.WRAPPERS}
    want.update({f.__name__: layer_calls if bh else 0
                 for f in fk.BH_WRAPPERS})
    want.update({f"{f.__name__}.tc": want[f.__name__]
                 for f in fk.TC_WRAPPERS})
    want["_cuda_core_fwd"] = 0
    want["_cuda_core_flash_bwd"] = 0
    want["flash_bwd_fused_prep"] = layer_calls if bh else 0
    want["flash_bwd_fused_dq_cast"] = layer_calls if bh else 0
    want.update({f.__name__: fused_lmce_steps for f in lk.WRAPPERS})
    want.update({f"{f.__name__}.tc": fused_lmce_steps
                 for f in lk.TC_WRAPPERS})
    want["_cuda_core_bwd"] = 0
    want["_cuda_core_lmce_fwd"] = 0
    return want


def train_phase(torch, seed, fused=False, bh=False, fp16=False):
    """``[train]``, with ``fused`` the same run with ``enable_fused_lmce``
    (``[train fused lmce]``), with ``bh`` under the [B*H, S, D] knobs
    (``[train bh]``), with ``fp16`` after ``amp.decorate(level="O2")``
    with its default dtype, float16 (``[train fp16]``)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                         enable_fused_lmce, gpt2_small)
    tag = ("train fused lmce" if fused else "train bh" if bh else
           "train fp16" if fp16 else "train")
    gc.collect()                # the previous phase's model, if any
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=True,
                            amp_dtype=None if fp16 else "bfloat16")
    crit = GPTPretrainingCriterion()
    if fused:
        enable_fused_lmce(net, crit)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, crit)
    rng = np.random.default_rng(seed + 2)
    x = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(np.int64)
    batch = (torch.from_numpy(x).pin_memory(),
             torch.from_numpy(np.roll(x, -1, axis=1)).pin_memory())
    L = cfg.num_hidden_layers
    want = _want_launches(TRAIN_STEPS * L, bh=bh,
                          fused_lmce_steps=TRAIN_STEPS if fused else 0)
    with knobs_set(BH_KNOBS if bh else {}):
        return fit_and_check(
            torch, tag, f"GPT-2-small L=12 D=768 H=12 V=50304 B={TRAIN_B} "
            f"S={TRAIN_S} {'fp16 (the default)' if fp16 else 'bf16'} O2 "
            "AdamW", model, net, batch, want, TRAIN_B * TRAIN_S,
            low=torch.float16 if fp16 else torch.bfloat16)


def bh_train_phase(torch, seed, base):
    """``[train bh]``: the ``[train]`` run under the [B*H, S, D] knobs,
    first loss within BH_FIRST_LOSS_TOL relative of ``base``'s (same
    weights and batch)."""
    res = train_phase(torch, seed, bh=True)
    first, base_first = res["losses"][0], base["losses"][0]
    rel = abs(first - base_first) / abs(base_first)
    check(rel <= BH_FIRST_LOSS_TOL,
          f"[train bh] first loss {first} vs [train] {base_first} "
          f"(relative {rel:.3e} > {BH_FIRST_LOSS_TOL})")
    print("[train bh] step losses bh vs default: " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(res["losses"], base["losses"]))
        + f"; first-loss relative diff {rel:.3e} (tol {BH_FIRST_LOSS_TOL}); "
        f"step_ms {res['step_ms']:.3f} vs {base['step_ms']:.3f}; "
        f"peak_mem_gib {res['peak'] / 2**30:.3f} vs "
        f"{base['peak'] / 2**30:.3f}", flush=True)
    return res


def ernie_train_phase(torch, seed):
    """``[train ernie bh]``: ERNIE-3.0-base MLM pretraining at B=16,
    S=512, bf16 O2, AdamW, under the [B*H, S, D] knobs.  The first
    loss is held against the default path's loss on the same weights
    and batch, taken before the fit by a step that updates nothing."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_3_base
    tag = "train ernie bh"
    gc.collect()
    cfg = ernie_3_base(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=True, bert=True)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, BertPretrainingCriterion(cfg.vocab_size))
    x, labels = _mlm_batch(torch, cfg.vocab_size, ERNIE_B, ERNIE_S, seed + 4)
    batch = (x.pin_memory(), labels.pin_memory())
    base_first = float(model.train_batch([batch[0]], [batch[1]],
                                         update=False)[0][0])
    want = _want_launches(TRAIN_STEPS * cfg.num_hidden_layers, bh=True)
    with knobs_set(BH_KNOBS):
        res = fit_and_check(
            torch, tag, f"ERNIE-3.0-base L=12 D=768 H=12 V=40000 "
            f"B={ERNIE_B} S={ERNIE_S} bf16 O2 AdamW, MLM 15%", model, net,
            batch, want, ERNIE_B * ERNIE_S)
    rel = abs(res["losses"][0] - base_first) / abs(base_first)
    check(rel <= BH_FIRST_LOSS_TOL,
          f"[{tag}] first loss {res['losses'][0]} vs default path "
          f"{base_first} (relative {rel:.3e} > {BH_FIRST_LOSS_TOL})")
    print(f"[{tag}] first loss {res['losses'][0]:.6f} vs the default "
          f"path's {base_first:.6f} on the same weights and batch: relative "
          f"diff {rel:.3e} (tol {BH_FIRST_LOSS_TOL})", flush=True)
    return res


def fp16_train_phase(torch, seed, base):
    """``[train fp16]``: the ``[train]`` run after ``amp.decorate(level=
    "O2")`` with its default dtype, float16, and no GradScaler (as the
    JAX reference trains): finite losses, each flash kernel 12 times a
    step with the tensor-core forward, no plain call, the first loss
    within 1e-2 relative of ``base``'s (bf16, same weights and batch)."""
    res = train_phase(torch, seed, fp16=True)
    first, base_first = res["losses"][0], base["losses"][0]
    rel = abs(first - base_first) / abs(base_first)
    check(rel <= FP16_FIRST_LOSS_TOL,
          f"[train fp16] first loss {first} vs [train] {base_first} "
          f"(relative {rel:.3e} > {FP16_FIRST_LOSS_TOL})")
    print("[train fp16] step losses fp16 vs bf16: " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(res["losses"], base["losses"]))
        + f"; first-loss relative diff {rel:.3e} (tol "
        f"{FP16_FIRST_LOSS_TOL}); step_ms {res['step_ms']:.3f} vs "
        f"{base['step_ms']:.3f}; peak_mem_gib {res['peak'] / 2**30:.3f} "
        f"vs {base['peak'] / 2**30:.3f}", flush=True)
    return res


def fused_train_phase(torch, seed, base):
    """``[train fused lmce]``: the ``[train]`` run with the fused lm-head
    cross-entropy, held against ``base`` (``train_phase``'s result):
    first loss within 1e-2 relative (same weights and batch; the
    unfused path rounds the logits to bf16) and a lower peak."""
    res = train_phase(torch, seed, fused=True)
    first, base_first = res["losses"][0], base["losses"][0]
    rel = abs(first - base_first) / abs(base_first)
    check(rel <= FUSED_FIRST_LOSS_TOL,
          f"[train fused lmce] first loss {first} vs [train] {base_first}"
          f" (relative {rel:.3e} > {FUSED_FIRST_LOSS_TOL})")
    check(res["peak"] < base["peak"],
          f"[train fused lmce] peak {res['peak']} bytes not below "
          f"[train]'s {base['peak']}")
    print("[train fused lmce] step losses fused vs unfused: " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in zip(res["losses"], base["losses"]))
        + f"; first-loss relative diff {rel:.3e} (tol "
        f"{FUSED_FIRST_LOSS_TOL}); step_ms {res['step_ms']:.3f} vs "
        f"{base['step_ms']:.3f}; peak_mem_gib {res['peak'] / 2**30:.3f} "
        f"vs {base['peak'] / 2**30:.3f}", flush=True)
    return res


def _kernel_group(name):
    if any(k in name for k in ("flash_fwd_kernel", "flash_fwd_tc_kernel",
                                "flash_bwd_tc_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkv_kernel",
                                "flash_fwd_hpack_kernel",
                                "flash_bwd_fused", "fused_prep_kernel",
                                "fused_dq_cast_kernel")):
        return "flash kernels"
    if any(k in name for k in ("lmce_fwd_kernel", "lmce_bwd_kernel",
                                "lmce_bwd_tc_kernel", "lmce_fwd_tc_kernel",
                                "lmce_fwd_combine_kernel")):
        return "lmce kernels"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    return "other (elementwise, norms, loss, copies)"


def profile_steps(torch, model, batch, steps, tag="train"):
    """``torch.profiler`` over ``steps`` more train steps: device time
    by kernel group, the busiest kernels, and the share of the wall
    time the device sat idle (1 - kernel time / wall; one stream, so
    kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            model.train_batch([batch[0]], [batch[1]])
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernels[e.key] = kernels.get(e.key, 0.0) + us
    busy = sum(kernels.values())
    groups = {}
    for name, us in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
    if busy <= 0:
        print(f"[{tag} profile] torch.profiler recorded no device time",
              flush=True)
        return
    print(f"[{tag} profile] {steps} steps: wall {wall_us / steps / 1e3:.3f}"
          f" ms/step, device busy {busy / steps / 1e3:.3f} ms/step, idle "
          f"share {1 - busy / wall_us:.4f}", flush=True)
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag} profile]   {g}: {us / steps / 1e3:.3f} ms/step "
              f"({us / busy:.4f} of device time)", flush=True)
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag} profile]   top: {us / steps / 1e3:.3f} ms/step "
              f"{name[:110]}", flush=True)


def _loss_keeper():
    """A callback that keeps each step's loss."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Keep(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))

    return Keep()


def _gpt_batches(torch, cfg, seed):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(3):
        x = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
        batches.append((torch.from_numpy(x),
                        torch.from_numpy(np.roll(x, -1, axis=1))))
    return batches


def _small_gpt():
    from paddle_tpu_torch.models import gpt_tiny
    return gpt_tiny(hidden_size=128, num_attention_heads=2,
                    intermediate_size=256, max_position_embeddings=256)


def train_parity_phase(torch, seed):
    """Three fp32 steps of a small GPT on the card (kernels) and on the
    CPU (plain versions) from the same weights, unfused and with
    ``enable_fused_lmce``; losses within PARITY_TOL relative (cuBLAS,
    the kernels and the CPU sum in other orders; TF32 is off).  fp32
    runs the CUDA-core lmce kernels; returns their launches in the fused
    run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                         enable_fused_lmce)
    from paddle_tpu_torch.ops import lmce_kernel as lk
    cfg = _small_gpt()
    batches = _gpt_batches(torch, cfg, seed + 3)
    cpu_net, _ = _train_model(torch, cfg, "cpu", seed, o2=False)
    for fused in (False, True):
        tag = "train fp32 parity" + (" fused lmce" if fused else "")
        losses = {}
        lk.reset_counts()
        for device in ("cpu", "cuda"):
            net, opt = _train_model(torch, cfg, device, seed, o2=False)
            net.load_state_dict(cpu_net.state_dict())
            crit = GPTPretrainingCriterion()
            if fused:
                enable_fused_lmce(net, crit)
            model = paddle.Model(net, device=device)
            model.prepare(opt, crit)
            keep = _loss_keeper()
            model.fit(batches, epochs=1, verbose=0, callbacks=[keep])
            losses[device] = keep.losses
        counts = [(f.launches, f.plain_calls) for f in lk.WRAPPERS]
        want = [(3, 3)] * 3 if fused else [(0, 0)] * 3
        check(counts == want, f"[{tag}] lmce (launches, plain calls) "
              f"{counts}, expected {want}")
        check(not any(f.tc_launches for f in lk.TC_WRAPPERS),
              f"[{tag}] fp32 launched the tensor-core lmce backward")
        if fused:
            res = {f.__name__: f.launches for f in lk.WRAPPERS}
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"])]
        check(len(rel) == 3 and max(rel) <= PARITY_TOL,
              f"[{tag}] losses cuda {losses['cuda']} vs cpu "
              f"{losses['cpu']}")
        print(f"[{tag}] GPT L=2 D=128 H=2 Dh=64 S=256: losses cuda "
              f"{losses['cuda']} cpu {losses['cpu']} (max relative diff "
              f"{max(rel):.3e}, tol {PARITY_TOL}); lmce (launches, plain "
              f"calls) {counts}", flush=True)
    return res


def bh_parity_phase(torch, seed):
    """``[train fp32 parity bh]``: three fp32 steps of a small GPT
    (causal) and a small BERT (non-causal MLM) under the [B*H, S, D]
    knobs on the card (the head-packed forward and the fused backward)
    and on the CPU (their plain versions) from the same weights; losses
    within PARITY_TOL relative."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (BertConfig, BertPretrainingCriterion,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    bcfg = BertConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      max_position_embeddings=256, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    runs = {
        "GPT L=2 D=128 H=2 Dh=64 S=256 causal": (
            _small_gpt(), False, _gpt_batches(torch, _small_gpt(), seed + 5),
            GPTPretrainingCriterion),
        "BERT L=2 D=128 H=2 Dh=64 S=256 non-causal MLM": (
            bcfg, True, [_mlm_batch(torch, 256, 2, 256, seed + 6 + i)
                         for i in range(3)],
            lambda: BertPretrainingCriterion(bcfg.vocab_size)),
    }
    layer_calls = 3 * 2                     # three steps x two layers
    want = {"cpu": [(0, 0)] * 3 + [(0, layer_calls)] * 2,
            "cuda": [(0, 0)] * 3 + [(layer_calls, 0)] * 2}
    for desc, (cfg, bert, batches, crit) in runs.items():
        cpu_net, _ = _train_model(torch, cfg, "cpu", seed, o2=False,
                                  bert=bert)
        losses, counts = {}, {}
        with knobs_set(BH_KNOBS):
            for device in ("cpu", "cuda"):
                net, opt = _train_model(torch, cfg, device, seed, o2=False,
                                        bert=bert)
                net.load_state_dict(cpu_net.state_dict())
                model = paddle.Model(net, device=device)
                model.prepare(opt, crit())
                keep = _loss_keeper()
                fk.reset_counts()
                model.fit(batches, epochs=1, verbose=0, callbacks=[keep])
                losses[device] = keep.losses
                counts[device] = [(f.launches, f.plain_calls)
                                  for f in fk.ALL_WRAPPERS]
                check(not any(f.tc_launches for f in fk.TC_WRAPPERS),
                      f"[train fp32 parity bh] {desc}: fp32 launched the "
                      "tensor-core forward")
        check(counts == want, f"[train fp32 parity bh] {desc}: flash "
              f"(launches, plain calls) {counts}, expected {want}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"])]
        check(len(rel) == 3 and max(rel) <= PARITY_TOL,
              f"[train fp32 parity bh] {desc}: losses cuda "
              f"{losses['cuda']} vs cpu {losses['cpu']}")
        print(f"[train fp32 parity bh] {desc}: losses cuda {losses['cuda']}"
              f" cpu {losses['cpu']} (max relative diff {max(rel):.3e}, tol "
              f"{PARITY_TOL}); flash (launches, plain calls) cuda "
              f"{counts['cuda']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from paddle_tpu_torch import _build

    card = card_line()
    print(f"[env] card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    built = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; kernels built in "
          f"{build_s:.2f} s: {sorted(built)}", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    kres = kernel_phase(torch, args.seed,
                        built.get("paged_attention_sm90", {}).get("log", ""))
    klong = kernel_long_phase(torch, args.seed)
    fres = flash_phase(torch, args.seed)
    lres = lmce_phase(torch, args.seed)
    s32 = serving_phase(torch, args.seed, torch.float32, "fp32", True)
    s16 = serving_phase(torch, args.seed, torch.bfloat16, "bf16", False)
    tres = train_phase(torch, args.seed)
    lmce_train = fused_train_phase(torch, args.seed, tres)
    fp16_train = fp16_train_phase(torch, args.seed, tres)
    fp32_lmce = train_parity_phase(torch, args.seed)
    bhres = flash_bh_phase(torch, args.seed)
    tcres = flash_tc_phase(torch, args.seed,
                           built.get("flash_fwd_sm90", {}).get("log", ""))
    tcb = flash_tc_bwd_phase(torch, args.seed,
                             built.get("flash_bwd_sm90", {}).get("log", ""))
    tcf = flash_tc_fused_phase(torch, args.seed,
                               built.get("flash_bwd_sm90", {}).get("log", ""))
    bh_train = bh_train_phase(torch, args.seed, tres)
    ernie_train = ernie_train_phase(torch, args.seed)
    bh_parity_phase(torch, args.seed)
    ltc = lmce_tc_phase(torch, args.seed,
                        built.get("lmce_sm90", {}).get("log", ""))
    ltf = lmce_tc_fwd_phase(torch, args.seed,
                            built.get("lmce_fwd_sm90", {}).get("log", ""))
    f16 = fp16_phase(torch, args.seed)
    hd = headdim_phase(torch, args.seed)

    k32, k16 = kres["fp32"], kres["bf16"]
    kernels = [{
        "name": "paged_ragged_attention", "route": "cuda",
        "source": K1_SOURCE, "cuda_core_source": K1_CORE_SOURCE,
        "replaces": K1_REPLACES,
        "launches": s32["launches"], "max_abs_err": k32["max_abs_err"],
        "ms": k32["ms"], "device_ms": k32["device_ms"],
        "plain_ms": k32["plain_ms"], "bound_ms": k32["bound_ms"],
        "bound_by": k32["bound_by"], "library_ms": k32["library_ms"],
        "library_device_ms": k32["library_device_ms"],
        "cuda_core_ms": k32["cuda_core_ms"],
        "cuda_core_device_ms": k32["cuda_core_device_ms"],
        "host_us": k32["host_us"],
        "cuda_core_host_us": k32["cuda_core_host_us"],
        "plan": list(k32["plan"]), "bf16_plan": list(k16["plan"]),
        "bf16_ms": k16["ms"], "bf16_device_ms": k16["device_ms"],
        "bf16_bound_ms": k16["bound_ms"],
        "bf16_cuda_core_device_ms": k16["cuda_core_device_ms"],
        "bf16_library_device_ms": k16["library_device_ms"],
        "bf16_max_abs_err": k16["max_abs_err"],
        "bf16_launches": s16["launches"],
        "cuda_core_serving_launches": s32["core_launches"]
        + s16["core_launches"],
        "gate_ratio": max(r["gate_ratio"] for r in
                          list(kres.values()) + list(klong.values())),
        "equal_share": min(r["equal_share"] for k, r in
                           list(kres.items()) + list(klong.items())
                           if not k.startswith("fp32")),
        "fp16_max_abs_err": max(kres["fp16"]["max_abs_err"],
                                f16["paged_ragged_attention"]),
        "dh16_max_abs_err": max(v for k, v in hd.items()
                                if k.startswith("paged")),
        "long": {k: {x: (list(r[x]) if x == "plan" else r[x])
                     for x in ("device_ms", "ms", "cuda_core_device_ms",
                               "cuda_core_ms", "plain_ms", "bound_ms",
                               "library_ms", "library_device_ms",
                               "tb_per_s", "max_abs_err", "plan")
                     if x in r}
                 for k, r in klong.items()},
    }]
    for name in FLASH_KERNELS:
        r = fres[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CORE_SOURCE,
            "replaces": FLASH_REPLACES[name],
            "launches": tres["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "fp32_max_abs_err": max(fres["fp32"].values()),
        })
    for name in BH_KERNELS:
        r, e = bhres[name]["gpt"], bhres[name]["ernie"]
        errs = ("out", "lse") if name == "flash_fwd_hpack" else \
            ("dq", "dk", "dv")
        fwd = name == "flash_fwd_hpack"
        kernels.append({
            "name": name, "route": "cuda", "source": CORE_SOURCE,
            "replaces": FLASH_REPLACES[name],
            "launches": (bh_train["launches"][name]
                         + ernie_train["launches"][name]),
            "gpt_launches": bh_train["launches"][name],
            "ernie_launches": ernie_train["launches"][name],
            "max_abs_err": max(bhres["bf16"][k] for k in errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"] if fwd else None,
            "library_fwd_bwd_ms": None if fwd else r["library_ms"],
            "fp32_max_abs_err": max(bhres["fp32"][k] for k in errs),
            "ernie_ms": e["ms"], "ernie_plain_ms": e["plain_ms"],
            "ernie_bound_ms": e["bound_ms"],
            "ernie_library_ms": e["library_ms"],
        })
        if not fwd:
            kernels[-1].update({
                "device_ms": r["device_ms"],
                "library_bwd_device_ms": r["library_bwd_device_ms"],
                "ernie_device_ms": e["device_ms"],
                "ernie_library_bwd_device_ms": e["library_bwd_device_ms"]})
            kernels[-1]["helper_launches"] = {
                k: bh_train["launches"][k] + ernie_train["launches"][k]
                for k in ("flash_bwd_fused_prep", "flash_bwd_fused_dq_cast")}
    # the bf16 forwards run the tensor-core kernel: its numbers, with the
    # CUDA-core kernel's (the fp32 body) beside them
    for entry in kernels:
        cell = {"flash_fwd": "flash_fwd",
                "flash_fwd_hpack": "flash_fwd_hpack"}.get(entry["name"])
        if cell is None:
            continue
        r = tcres[cell]
        entry.update({
            "source": TC_SOURCE, "fp32_source": CORE_SOURCE,
            "tc_launches": (tres["launches"][f"{cell}.tc"]
                            if cell == "flash_fwd" else
                            bh_train["launches"][f"{cell}.tc"]
                            + ernie_train["launches"][f"{cell}.tc"]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "tflops": r["tflops"], "cuda_core_ms": r["cuda_core_ms"],
            "hgmma": tcres["hgmma"]})
        if cell == "flash_fwd_hpack":
            e = tcres["flash_fwd_hpack ernie"]
            entry.update({"ernie_ms": e["ms"],
                          "ernie_plain_ms": e["plain_ms"],
                          "ernie_bound_ms": e["bound_ms"],
                          "ernie_library_ms": e["library_ms"],
                          "ernie_cuda_core_ms": e["cuda_core_ms"]})
    # the 16-bit split backward runs the tensor-core pair: its numbers,
    # with the CUDA-core pair's (the fp32 body) beside them
    for entry in kernels:
        if entry["name"] not in ("flash_bwd_dq", "flash_bwd_dkv"):
            continue
        r, r16 = tcb["bf16"][entry["name"]], tcb["fp16"][entry["name"]]
        pair = tcb["bf16"]
        entry.update({
            "source": TC_BWD_SOURCE, "fp32_source": CORE_SOURCE,
            "tc_launches": tres["launches"][f"{entry['name']}.tc"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "library_bwd_pair_ms": pair["library_bwd_ms"],
            "library_bwd_pair_device_ms": pair["library_bwd_device_ms"],
            "library_fwd_bwd_ms": pair["library_fwd_bwd_ms"],
            "pair_ms": pair["pair_ms"],
            "pair_device_ms": pair["pair_device_ms"],
            "tflops": r["tflops"], "device_tflops": r["device_tflops"],
            "cuda_core_ms": r["cuda_core_ms"],
            "cuda_core_device_ms": r["cuda_core_device_ms"],
            "hgmma": tcb["hgmma"], "fp16_ms": r16["ms"],
            "fp16_device_ms": r16["device_ms"],
            "gate_ratio": max(tcb["bf16"]["main"]["ratios"][n] for n in (
                ("dq",) if entry["name"] == "flash_bwd_dq" else
                ("dk", "dv"))),
            "equal_share": min(tcb["bf16"]["main"]["shares"][n] for n in (
                ("dq",) if entry["name"] == "flash_bwd_dq" else
                ("dk", "dv")))})
    # the 16-bit fused backward runs the tensor-core sweep: its numbers
    # (GPT's shape; ERNIE's beside), with the CUDA-core sweep's (the fp32
    # body) beside them
    for entry in kernels:
        if entry["name"] != "flash_bwd_fused":
            continue
        r, e, r16 = tcf["bf16 gpt"], tcf["bf16 ernie"], tcf["fp16 gpt"]
        entry.update({
            "source": TC_BWD_SOURCE, "fp32_source": CORE_SOURCE,
            "tc_launches": (bh_train["launches"]["flash_bwd_fused.tc"]
                            + ernie_train["launches"]["flash_bwd_fused.tc"]),
            "max_abs_err": max(r["max_abs_err"], e["max_abs_err"]),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "sweep_device_ms": r["sweep_device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_bwd_device_ms": r["library_bwd_device_ms"],
            "pair_device_ms": r["pair_device_ms"],
            "device_tflops": r["device_tflops"],
            "cuda_core_ms": r["cuda_core_ms"],
            "cuda_core_device_ms": r["cuda_core_device_ms"],
            "hgmma": tcf["hgmma"], "fp16_device_ms": r16["device_ms"],
            "gate_ratio": max(r["ratios"].values()),
            "equal_share": min(r["shares"].values()),
            "ernie_ms": e["ms"], "ernie_device_ms": e["device_ms"],
            "ernie_plain_ms": e["plain_ms"], "ernie_bound_ms": e["bound_ms"],
            "ernie_library_bwd_device_ms": e["library_bwd_device_ms"],
            "ernie_pair_device_ms": e["pair_device_ms"],
            "ernie_cuda_core_device_ms": e["cuda_core_device_ms"]})
    # the 16-bit forward runs the tensor-core kernel: its numbers, with the
    # CUDA-core forward's (the fp32 body) beside them
    r, r16, lf = ltf["bf16"], ltf["fp16"], lres["lmce_fwd"]
    kernels.append({
        "name": "lmce_fwd", "route": "cuda", "source": LMCE_FWD_TC_SOURCE,
        "fp32_source": LMCE_SOURCE, "replaces": LMCE_REPLACES["lmce_fwd"],
        "launches": lmce_train["launches"]["lmce_fwd"],
        "tc_launches": lmce_train["launches"]["lmce_fwd.tc"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "library_device_ms": r["library_device_ms"],
        "library_fwd_bwd_ms": lf["library_fwd_bwd_ms"],
        "tflops": r["tflops"], "device_tflops": r["device_tflops"],
        "cuda_core_ms": r["cuda_core_ms"],
        "cuda_core_device_ms": r["cuda_core_device_ms"],
        "hgmma": ltf["hgmma"], "gate_ratio": max(r["gate_ratio"],
                                                 r16["gate_ratio"]),
        "fp16_ms": r16["ms"], "fp16_device_ms": r16["device_ms"],
        "fp16_max_abs_err": r16["max_abs_err"],
        "fp32_max_abs_err": lf["fp32_max_abs_err"],
    })
    # the backward: the tensor-core kernels (bf16 and fp16, the main
    # path), and the CUDA-core ones (fp32: the [train fp32 parity] fused
    # run's launches; timed in bf16 beside the tensor-core kernels)
    for name in ("lmce_bwd_dh", "lmce_bwd_dw"):
        which = name[-2:]
        tc, tc16 = ltc[f"{name}_tc bf16"], ltc[f"{name}_tc fp16"]
        kernels.append({
            "name": f"{name}_tc", "route": "cuda", "source": LMCE_TC_SOURCE,
            "replaces": LMCE_REPLACES[name],
            "launches": lmce_train["launches"][f"{name}.tc"],
            "max_abs_err": tc["max_abs_err"], "ms": tc["ms"],
            "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
            "bound_by": tc["bound_by"], "library_ms": None,
            "library_fwd_bwd_ms": lres["lmce_fwd"]["library_fwd_bwd_ms"],
            "tflops": tc["tflops"], "cuda_core_ms": tc["cuda_core_ms"],
            "hgmma": ltc["hgmma"], "fp16_ms": tc16["ms"],
            "fp16_max_abs_err": max(tc16["max_abs_err"], f16[f"{name}_tc"]),
        })
        kernels.append({
            "name": name, "route": "cuda", "source": LMCE_SOURCE,
            "replaces": LMCE_REPLACES[name],
            "launches": fp32_lmce[name],
            "max_abs_err": lres["fp32"][which], "ms": tc["cuda_core_ms"],
            "plain_ms": tc["plain_ms"], "bound_ms": tc["bound_ms"],
            "bound_by": tc["bound_by"], "library_ms": None,
            "library_fwd_bwd_ms": lres["lmce_fwd"]["library_fwd_bwd_ms"],
            "fp16_max_abs_err": f16[name],
        })
    # fp16 ([fp16]) and head dims 16 / 32 ([headdim]) errors on every
    # flash and lmce entry
    hd_flash = [v for k, v in hd.items() if k.startswith("D=")]
    for entry in kernels:
        name = entry["name"]
        if name in f16 and "fp16_max_abs_err" not in entry:
            entry["fp16_max_abs_err"] = f16[name]
        if f"{name} cuda_core" in f16:
            entry["cuda_core_fp16_max_abs_err"] = f16[f"{name} cuda_core"]
        if name in FLASH_KERNELS + BH_KERNELS:
            entry["d16_d32_max_abs_err"] = max(e[name] for e in hd_flash)
        if name in FLASH_KERNELS:
            entry["fp16_launches"] = fp16_train["launches"][name]
            entry["fp16_tc_launches"] = fp16_train["launches"][f"{name}.tc"]
            entry["fused_lmce_launches"] = lmce_train["launches"][name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
