"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with a CUDA card.  It
builds the port's CUDA kernels from ``paddle_tpu_torch/csrc`` with
``nvcc`` (into the git-ignored ``paddle_tpu_torch/_build/``) and then:

1. prints the card (``nvidia-smi`` name and power limit), the CUDA
   version and the kernel build time; turns TF32 off for the fp32
   phases;
2. holds the paged-attention kernel against its plain PyTorch version
   at GPT-2-small decode shapes with ragged lengths and scattered page
   tables: fp32 within 1e-5 max abs error, bf16 within 2e-2 of the
   plain version computed in fp32 on the same bf16 values; the empty
   row must be exactly 0.  Times the kernel, the plain version and,
   as a yardstick only, ``scaled_dot_product_attention`` on
   pre-gathered K/V (CUDA events, median per launch, L2 flushed
   between launches);
3. serves GPT-2-small (12 layers, hidden 768, 12 heads, vocab 50304,
   random weights from ``--seed``) through ``LLMServer`` in fp32:
   12 greedy requests over 8 slots; checks every token count, that
   the kernel launched exactly 12 times per decode dispatch, and that
   two requests' tokens equal the sequential ``reference_decode``;
4. serves the same model in bf16 and checks counts and launches;
5. prints the kernels' JSON line, the card line, and last the line
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
FP32_TOL = 1e-5
BF16_TOL = 2e-2


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
    s32 = serving_phase(torch, args.seed, torch.float32, "fp32", True)
    s16 = serving_phase(torch, args.seed, torch.bfloat16, "bf16", False)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
