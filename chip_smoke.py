"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with a CUDA card.  It
builds the port's CUDA kernels from ``paddle_tpu_torch/csrc`` with
``nvcc`` (one process per source, all at once, into the git-ignored
``paddle_tpu_torch/_build/``) and then:

1. prints the card (``nvidia-smi`` name and power limit), the CUDA
   version and the kernel build time; turns TF32 off for the fp32
   phases;
2. ``[kernel]`` holds the paged-attention kernel against its plain
   PyTorch version at GPT-2-small decode shapes with ragged lengths and
   scattered page tables: fp32 within 1e-5 max abs error, bf16 within
   2e-2 of the plain version computed in fp32 on the same bf16 values;
   the empty row must be exactly 0.  Times the kernel, the plain
   version and, as a yardstick only, ``scaled_dot_product_attention`` on
   pre-gathered K/V (CUDA events, median per launch, L2 flushed
   between launches);
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
   (forward, dh, dW) against their plain versions computed in fp32 on
   the same values: at the training path's shape (N=8192, V=50304,
   D=768) in bf16 (within 2e-2 x max(|ref|, 1)) and fp32 (within
   1e-4 x max(|ref|, 1)), then in fp32 at N=1000 (ragged rows) with
   V=1000 and V=786 (ragged vocab), every fourth label -100 (loss and
   dh rows exactly 0), D=64, 200 and 2048.  Times each kernel, its
   plain version and, as a yardstick only, ``h @ W.T`` with fp32
   ``F.cross_entropy``, forward and forward+backward, in bf16;
5. serves GPT-2-small (12 layers, hidden 768, 12 heads, vocab 50304,
   random weights from ``--seed``) through ``LLMServer`` in fp32:
   12 greedy requests over 8 slots; checks every token count, that
   the kernel launched exactly 12 times per decode dispatch, and that
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
   step, the first loss within 1e-2 relative of 7's and a lower peak;
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
11. ``[train bh]`` repeats 7 with ``PADDLE_TORCH_FLASH_NO_PACKED=1``,
    ``HEADPACK=2`` and ``FUSED_BWD=1``: the two kernels launched 12
    times per step (the fused backward's pre-pass and bf16 epilogue as
    often), the default path's three flash kernels never, no plain
    call, the first loss within 1e-2 relative of 7's;
12. ``[train ernie bh]`` trains ERNIE-3.0-base MLM (12 layers, hidden
    768, 12 heads, vocab 40000, random weights from ``--seed``) at
    B=16, S=512, bf16 O2, AdamW, dropout 0, under the same knobs,
    labels = the tokens on 15% of positions and -100 elsewhere, with
    the checks of 11 (the first loss against the default path's loss
    on the same weights and batch) and a profile;
13. ``[train fp32 parity bh]`` trains a small GPT and a small BERT
    (2 layers, hidden 128, head dim 64, S=256) for three fp32 steps on
    the card and on the CPU under the knobs and compares the losses;
14. prints the kernels' JSON line, the card line, and last the line
    ``{"ok": true, "device": {...}}``.

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


def kernel_phase(torch, seed):
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    B, H, Dh, BS, NB, MAXNB = 8, 12, 64, 16, 512, 64
    lengths_l = [0, 1, 16, 17, 500, 1024, 333, 64]
    rng = np.random.default_rng(seed)
    table = np.zeros((B, MAXNB), dtype=np.int32)      # 0 = scratch
    free = rng.permutation(np.arange(1, NB)).tolist()  # scattered pages
    for b, n in enumerate(lengths_l):
        nb = -(-n // BS)
        table[b, :nb] = [free.pop() for _ in range(nb)]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pool_k = torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
    pool_v = torch.randn((NB, BS, H, Dh), generator=gen, device=dev)
    q = torch.randn((B, H, Dh), generator=gen, device=dev)
    table_t = torch.as_tensor(table, device=dev)
    lengths = torch.as_tensor(np.array(lengths_l, np.int32), device=dev)
    empty_row = lengths_l.index(0)

    def kern(pk, pv, qq):
        return pak.paged_ragged_attention(pk, pv, table_t, lengths, qq)

    def plain(pk, pv, qq):
        return pak.paged_ragged_attention_reference(pk, pv, table_t,
                                                    lengths, qq)

    res = {}
    out_k = kern(pool_k, pool_v, q)
    out_p = plain(pool_k, pool_v, q)
    torch.cuda.synchronize()
    err32 = (out_k - out_p).abs().max().item()
    check(err32 <= FP32_TOL, f"fp32 kernel vs plain {err32} > {FP32_TOL}")
    check(bool((out_k[empty_row] == 0).all()), "fp32 empty row not 0")
    check(bool(torch.isfinite(out_k).all()), "fp32 kernel not finite")

    kb, vb, qb = pool_k.bfloat16(), pool_v.bfloat16(), q.bfloat16()
    out_kb = kern(kb, vb, qb)
    out_pb = plain(kb.float(), vb.float(), qb.float())
    torch.cuda.synchronize()
    check(out_kb.dtype == torch.bfloat16, "bf16 kernel output dtype")
    err16 = (out_kb.float() - out_pb).abs().max().item()
    check(err16 <= BF16_TOL, f"bf16 kernel vs plain {err16} > {BF16_TOL}")
    check(bool((out_kb[empty_row] == 0).all()), "bf16 empty row not 0")

    flush_buf = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    flush = flush_buf.zero_
    res["ms"] = time_cuda(torch, lambda: kern(pool_k, pool_v, q), 100,
                          flush=flush)
    res["bf16_ms"] = time_cuda(torch, lambda: kern(kb, vb, qb), 100,
                               flush=flush)
    res["plain_ms"] = time_cuda(torch, lambda: plain(pool_k, pool_v, q),
                                50, flush=flush)
    # yardstick only: SDPA over K/V gathered beforehand (the gather is
    # NOT timed: no PyTorch call attends through a page table)
    kg, vg = pak.gather_pages(torch.stack([pool_k, pool_v])[None], 0,
                              table_t)
    kg = kg.permute(0, 2, 1, 3).contiguous()              # [B, H, T, Dh]
    vg = vg.permute(0, 2, 1, 3).contiguous()
    T = kg.shape[2]
    mask = (torch.arange(T, device=dev)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = time_cuda(
        torch, lambda: sdpa(q[:, :, None], kg, vg, attn_mask=mask), 50,
        flush=flush)
    nbytes = pak.attention_bytes(lengths_l, BS, H, Dh, 4)
    flops = 4 * sum(lengths_l) * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["bf16_bound_ms"] = pak.attention_bytes(
        lengths_l, BS, H, Dh, 2) / HBM_BYTES_PER_S * 1e3
    res["max_abs_err"] = err32
    res["bf16_max_abs_err"] = err16
    print(f"[kernel] paged_attention B={B} H={H} Dh={Dh} BS={BS} NB={NB} "
          f"MAXNB={MAXNB} lengths={lengths_l}: fp32 max_abs_err={err32:.3e}"
          f" (tol {FP32_TOL}), bf16 max_abs_err={err16:.3e} (tol "
          f"{BF16_TOL}), empty row exact 0; kernel_ms={res['ms']:.5f} "
          f"bf16_kernel_ms={res['bf16_ms']:.5f} plain_ms="
          f"{res['plain_ms']:.5f} bound_ms={res['bound_ms']:.5f} "
          f"({res['bound_by']}, {nbytes} bytes) bf16_bound_ms="
          f"{res['bf16_bound_ms']:.5f} library_ms(sdpa, gather "
          f"excluded)={res['library_ms']:.5f}", flush=True)
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
        server.start()
        t0 = time.monotonic()
        futs = [server.submit(p, max_tokens=m)
                for p, m in zip(prompts, REQ_MAX)]
        results = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        launches = pak.paged_ragged_attention.launches
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
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve {tag}] GPT-2-small L=12 D=768 H=12 V=50304: "
          f"{len(results)} requests, {n_tok} tokens in {wall:.4f} s = "
          f"{n_tok / wall:.2f} tokens/s; dispatches={dispatches} "
          f"kernel_launches={launches}; ttft_p50_s={st['ttft_p50_s']:.6f}"
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
            "tokens_per_s": n_tok / wall}


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
            res.setdefault(name, {})[model] = r
            print(f"[flash bh] {name} bf16 {model} [{BH}, {S}, 64] "
                  f"{'causal' if causal else 'non-causal'}: kernel_ms="
                  f"{ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
                  f"{r['bound_ms']:.5f} ({r['bound_by']}: {flops} flop, "
                  f"{nbytes} bytes) achieved {r['tflops']:.2f} TFLOP/s; "
                  f"library_ms (sdpa "
                  f"{'forward' if name == 'flash_fwd_hpack' else 'forward+backward'}"
                  f", not used by the port)={lib_ms:.5f}", flush=True)
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
    calls = {
        "lmce_fwd": (lambda: lk.lmce_fwd(h, w, labels),
                     lambda: lk.lmce_reference(h, w, labels)),
        "lmce_bwd_dh": (
            lambda: lk.lmce_bwd_dh(h, w, labels, lse, g),
            lambda: lk.lmce_bwd_dh_reference(h, w, labels, lse, g)),
        "lmce_bwd_dw": (
            lambda: lk.lmce_bwd_dw(h, w, labels, lse, g),
            lambda: lk.lmce_bwd_dw_reference(h, w, labels, lse, g)),
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
        err_keys = ("loss", "lse") if name == "lmce_fwd" else \
            (("dh",) if name == "lmce_bwd_dh" else ("dw",))
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
          f"{lib_fb_ms:.5f} ms; lmce kernels forward+dh+dW "
          f"{sum(res[n]['ms'] for n in LMCE_KERNELS):.5f} ms", flush=True)
    return res


# ---------------------------------------------------------------------------
# training: GPT-2-small through Model.fit
# ---------------------------------------------------------------------------
def _train_model(torch, cfg, device, seed, o2, bert=False):
    """GPT (or, with ``bert``, BertForPretraining) from ``seed`` and its
    AdamW(1e-4, multi_precision), cast to bf16 O2 if ``o2``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertForPretraining, GPTForCausalLM
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = (BertForPretraining if bert else GPTForCausalLM)(
        cfg, device=device, generator=gen)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=net.parameters(),
                                 multi_precision=True)
    if o2:
        paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    return net, opt


def _mlm_batch(torch, vocab, b, s, seed):
    """Tokens and MLM labels: the token on 15% of positions, -100
    elsewhere (bench.py's ERNIE batch), from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (b, s)).astype(np.int64)
    labels = np.where(rng.random((b, s)) < 0.15, x, -100).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(labels)


def fit_and_check(torch, tag, desc, model, net, batch, want, tokens):
    """``Model.fit`` for TRAIN_STEPS steps on one repeated batch, every
    launch count set to 0 just before and read just after; checks
    finite, falling losses, the launch counts against ``want`` (every
    flash and lmce kernel and the fused backward's helpers), no plain
    call and the O2 dtypes; prints step ms, tokens/s, peak memory and a
    profile of two more steps."""
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
    check(dtypes == {torch.bfloat16, torch.float32},
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
    ``layer_calls`` times each."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    from paddle_tpu_torch.ops import lmce_kernel as lk
    want = {f.__name__: 0 if bh else layer_calls for f in fk.WRAPPERS}
    want.update({f.__name__: layer_calls if bh else 0
                 for f in fk.BH_WRAPPERS})
    want["flash_bwd_fused_prep"] = layer_calls if bh else 0
    want["flash_bwd_fused_dq_cast"] = layer_calls if bh else 0
    want.update({f.__name__: fused_lmce_steps for f in lk.WRAPPERS})
    return want


def train_phase(torch, seed, fused=False, bh=False):
    """``[train]``, with ``fused`` the same run with ``enable_fused_lmce``
    (``[train fused lmce]``), with ``bh`` under the [B*H, S, D] knobs
    (``[train bh]``)."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (GPTPretrainingCriterion,
                                         enable_fused_lmce, gpt2_small)
    tag = "train fused lmce" if fused else ("train bh" if bh else "train")
    gc.collect()                # the previous phase's model, if any
    cfg = gpt2_small(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    net, opt = _train_model(torch, cfg, "cuda", seed, o2=True)
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
            f"S={TRAIN_S} bf16 O2 AdamW", model, net, batch, want,
            TRAIN_B * TRAIN_S)


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
    if any(k in name for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkv_kernel",
                                "flash_fwd_hpack_kernel",
                                "flash_bwd_fused")):
        return "flash kernels"
    if "lmce_fwd_kernel" in name or "lmce_bwd_kernel" in name:
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
    the kernels and the CPU sum in other orders; TF32 is off)."""
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
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                    losses["cpu"])]
        check(len(rel) == 3 and max(rel) <= PARITY_TOL,
              f"[{tag}] losses cuda {losses['cuda']} vs cpu "
              f"{losses['cpu']}")
        print(f"[{tag}] GPT L=2 D=128 H=2 Dh=64 S=256: losses cuda "
              f"{losses['cuda']} cpu {losses['cpu']} (max relative diff "
              f"{max(rel):.3e}, tol {PARITY_TOL}); lmce (launches, plain "
              f"calls) {counts}", flush=True)


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

    kres = kernel_phase(torch, args.seed)
    fres = flash_phase(torch, args.seed)
    lres = lmce_phase(torch, args.seed)
    s32 = serving_phase(torch, args.seed, torch.float32, "fp32", True)
    s16 = serving_phase(torch, args.seed, torch.bfloat16, "bf16", False)
    tres = train_phase(torch, args.seed)
    lmce_train = fused_train_phase(torch, args.seed, tres)
    train_parity_phase(torch, args.seed)
    bhres = flash_bh_phase(torch, args.seed)
    bh_train = bh_train_phase(torch, args.seed, tres)
    ernie_train = ernie_train_phase(torch, args.seed)
    bh_parity_phase(torch, args.seed)

    kernels = [{
        "name": "paged_ragged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/inference/serving/"
                    "paged_attention_kernel.py:62",
        "launches": s32["launches"], "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"], "bound_by": kres["bound_by"],
        "library_ms": kres["library_ms"],
        "bf16_ms": kres["bf16_ms"], "bf16_bound_ms": kres["bf16_bound_ms"],
        "bf16_max_abs_err": kres["bf16_max_abs_err"],
        "bf16_launches": s16["launches"],
    }]
    for name in FLASH_KERNELS:
        r = fres[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
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
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
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
            kernels[-1]["helper_launches"] = {
                k: bh_train["launches"][k] + ernie_train["launches"][k]
                for k in ("flash_bwd_fused_prep", "flash_bwd_fused_dq_cast")}
    for name in LMCE_KERNELS:
        r = lres[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/lmce.cu",
            "replaces": LMCE_REPLACES[name],
            "launches": lmce_train["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_fwd_bwd_ms": r["library_fwd_bwd_ms"],
            "fp32_max_abs_err": r["fp32_max_abs_err"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
