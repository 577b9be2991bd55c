"""Training step times, serving throughput and the paged kernel's device
time of two checkouts of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR] [--seed 0]
        [--phases train,serve fp32,...] [--rounds 1]

Runs phases of the ``chip_smoke.py`` found in each checkout: the five
training phases (``train``, ``train fp16``, ``train fused lmce``,
``train bh``, ``train ernie bh``: GPT-2-small B=8 S=1024 default, in
fp16, with the fused lm-head cross-entropy and under the ``[B*H, S, D]``
knobs, and ERNIE-3.0-base B=16 S=512 under the knobs, bf16 O2 unless
named, ``Model.fit``), the two serving phases (``serve fp32``, ``serve
bf16``: GPT-2-small through ``LLMServer``, 12 requests), ``k1``: the
paged-attention kernel's device time per launch from ``torch.profiler``
(200 calls at ``[kernel]``'s shapes, fp32 and bf16, the mean over the
launches the profiler kept, the split and the combine summed where a
call runs both; host work not counted; the 12 MB of K/V stay in L2
between calls), ``k1 long``: the same at the long-context shape (B=8,
H=12, Dh=64, every request 32768 tokens in pages of 16; 20 calls, K/V
far above L2), ``k1 host``: the host microseconds a call of the
paged-attention wrapper takes at ``[kernel]``'s shapes, fp32 and bf16
(the median of 7 loops of 200 calls with nothing waited on; the device
keeps up), and ``bwd``: the
split flash backward's device time per ``flash_bwd_dq`` +
``flash_bwd_dkv`` pair from ``torch.profiler`` (every kernel the two
wrappers launch, 20 pairs at the training shape B=8 S=1024 H=12 D=64
causal on ``[B, S, H, D]`` views, bf16 and fp16; host work not
counted); ``bwd fused bf16`` and ``bwd fused ernie bf16``: the fused
flash backward's device time per ``flash_bwd_fused`` call (its pre-pass,
sweep and dq cast; 20 calls at GPT-2-small's ``[96, 1024, 64]`` causal
and ERNIE-3.0-base's ``[192, 512, 64]`` non-causal ``[B*H, S, D]``
shapes); ``lmce fwd bf16``: the fused lm-head cross-entropy forward's
device time per ``lmce_fwd`` call (10 calls at N=8192 V=50304 D=768).
``--phases`` picks a comma-separated subset (default: the training and
serving phases); ``--profile`` runs the serving phases under
``torch.profiler`` and adds their device-busy ms and top kernels (the
profiler's cost then counts in tokens/s).  Each round runs parent, change, change, parent, each
run in a fresh process started in its checkout, which builds that
checkout's kernels first.  Each phase keeps its own gates (launch
counts, losses, tokens).  Prints every run's readings (median step ms,
tokens/s, device us), the mean per checkout and the change's
difference, and last a JSON line of the same.  ``CHANGE_DIR`` defaults
to the directory of this script.  Needs one CUDA card; exits non-zero
when a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("train", "train fp16", "train fused lmce", "train bh",
          "train ernie bh")
SERVING = ("serve fp32", "serve bf16")
K1 = ("k1 fp32", "k1 bf16", "k1 long fp32", "k1 long bf16")
K1_HOST = ("k1 host fp32", "k1 host bf16")
BWD = ("bwd bf16", "bwd fp16", "bwd fused bf16", "bwd fused ernie bf16",
       "lmce fwd bf16")
UNITS = {**{p: "step_ms" for p in PHASES},
         **{p: "tokens_per_s" for p in SERVING},
         **{p: "device_us" for p in K1},
         **{p: "host_us" for p in K1_HOST},
         **{p: "device_ms" for p in BWD}}
RUN = """
import json, sys, torch
sys.path.insert(0, {dir!r})
import chip_smoke as c
from paddle_tpu_torch import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
want, seed, out = {want!r}, {seed}, {{}}


def k1_args(dtype, long=False):
    import numpy as np
    B, H, Dh, BS = 8, 12, 64, 16
    if long:
        MAXNB, lengths_l, calls = 2048, [32768] * 8, 20
    else:
        MAXNB, lengths_l, calls = 64, [0, 1, 16, 17, 500, 1024, 333, 64], 200
    NB = 512 if not long else B * MAXNB + 1
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
    return calls, (pk, pv, torch.as_tensor(table, device=dev),
                   torch.as_tensor(np.array(lengths_l, np.int32),
                                   device=dev), q)


def k1_host_us(dtype):
    import time
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    _, args = k1_args(dtype)
    reads = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            pak.paged_ragged_attention(*args)
        reads.append((time.perf_counter() - t0) / 200 * 1e6)
    torch.cuda.synchronize()
    return sorted(reads)[3]


def k1_device_us(dtype, long=False):
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
    calls, args = k1_args(dtype, long)
    for _ in range(10):
        pak.paged_ragged_attention(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            pak.paged_ragged_attention(*args)
        torch.cuda.synchronize()
    # one kernel a call (the parent's paged_attn_kernel) or two (the
    # split and the combine); the profiler may drop some records, so a
    # call's time is the sum over the kernels of the mean of each
    ev = [e for e in prof.key_averages()
          if any(n in e.key for n in ("paged_attn", "paged_split",
                                      "paged_combine"))]
    for e in ev:
        assert e.count >= calls // 2, (
            f"torch.profiler kept {{e.count}} of {{calls}} launches")
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / e.count
               for e in ev)


def bwd_device_ms(dtype):
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qkv = torch.randn((8, 1024, 3, 12, 64), generator=gen,
                      device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    g = torch.randn((8, 1024, 12, 64), generator=gen, device=dev).to(dtype)
    out, lse = fk.flash_fwd(q, k, v, True)

    def pair():
        _, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, True)
        fk.flash_bwd_dkv(q, k, v, g, lse, delta, True)

    for _ in range(5):
        pair()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            pair()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages())
    return total / 20 / 1e3


def device_ms_per(fn, iters):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages())
    return total / iters / 1e3


def fused_device_ms(bh, s, causal):
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, g = [torch.randn((bh, s, 1, 64), generator=gen,
                              device=dev).bfloat16() for _ in range(4)]
    out, lse = fk.flash_fwd(q, k, v, causal)
    return device_ms_per(
        lambda: fk.flash_bwd_fused(q, k, v, out, lse, g, causal), 20)


def lmce_fwd_device_ms():
    from paddle_tpu_torch.ops import lmce_kernel as lk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h = torch.randn((8192, 768), generator=gen, device=dev).bfloat16()
    w = (torch.randn((50304, 768), generator=gen, device=dev)
         * 0.05).bfloat16()
    labels = torch.randint(0, 50304, (8192,), generator=gen, device=dev)
    return device_ms_per(lambda: lk.lmce_fwd(h, w, labels), 10)


def serve(dtype, dn):
    if not {profile}:
        return c.serving_phase(torch, seed, dtype, dn, False), {{}}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = c.serving_phase(torch, seed, dtype, dn, False)
        torch.cuda.synchronize()
    ev = sorted(((getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)), e.count,
                  e.key) for e in prof.key_averages()), reverse=True)
    ev = [x for x in ev if x[0] > 0]
    return r, {{"device_ms": sum(x[0] for x in ev) / 1e3,
               "top": [(k[:80], us / 1e3, n) for us, n, k in ev[:6]]}}


for dn, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
    if "bwd " + dn in want:
        out["bwd " + dn] = {{"device_ms": bwd_device_ms(dtype)}}
if "bwd fused bf16" in want:
    out["bwd fused bf16"] = {{"device_ms": fused_device_ms(96, 1024, True)}}
if "bwd fused ernie bf16" in want:
    out["bwd fused ernie bf16"] = {{
        "device_ms": fused_device_ms(192, 512, False)}}
if "lmce fwd bf16" in want:
    out["lmce fwd bf16"] = {{"device_ms": lmce_fwd_device_ms()}}
for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
    if "k1 " + dn in want:
        out["k1 " + dn] = {{"device_us": k1_device_us(dtype)}}
    if "k1 long " + dn in want:
        out["k1 long " + dn] = {{"device_us": k1_device_us(dtype, True)}}
    if "k1 host " + dn in want:
        out["k1 host " + dn] = {{"host_us": k1_host_us(dtype)}}
    if "serve " + dn in want:
        r, prof = serve(dtype, dn)
        out["serve " + dn] = {{"tokens_per_s": r["tokens_per_s"], **prof}}
res = {{}}
if set(want) & {{"train", "train fp16", "train fused lmce", "train bh"}}:
    t = res["train"] = c.train_phase(torch, seed)
    if "train fp16" in want:
        res["train fp16"] = c.fp16_train_phase(torch, seed, t)
    if "train fused lmce" in want:
        res["train fused lmce"] = c.fused_train_phase(torch, seed, t)
    if "train bh" in want:
        res["train bh"] = c.bh_train_phase(torch, seed, t)
if "train ernie bh" in want:
    res["train ernie bh"] = c.ernie_train_phase(torch, seed)
out.update({{k: {{"step_ms": r["step_ms"], "first_loss": r["losses"][0],
                 "peak_gib": r["peak"] / 2**30}}
            for k, r in res.items() if k in want}})
print("AB " + json.dumps(out), flush=True)
"""


def run(checkout, seed, want, profile=False):
    proc = subprocess.run([sys.executable, "-c",
                           RUN.format(dir=checkout, seed=seed, want=want,
                                      profile=profile)],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=1200)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"chip_ab: the run in {checkout} exited "
                         f"{proc.returncode}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    return json.loads(line[-1][3:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES + SERVING),
                    help=f"comma-separated, of {', '.join(UNITS)}")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times to run parent, change, change, parent")
    ap.add_argument("--profile", action="store_true",
                    help="run the serving phases under torch.profiler and "
                    "report their device-busy ms and top kernels")
    args = ap.parse_args(argv)
    want = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = [p for p in want if p not in UNITS]
    if unknown or not want:
        ap.error(f"unknown phases {unknown}; choose from {list(UNITS)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[ab] card: {card}", flush=True)
    dirs = {"parent": os.path.abspath(args.parent),
            "change": os.path.abspath(args.change)}
    runs = []
    for side in ("parent", "change", "change", "parent") * args.rounds:
        runs.append((side, run(dirs[side], args.seed, want, args.profile)))
        print(f"[ab] {side} run {len(runs)}: " + ", ".join(
            f"{p} {runs[-1][1][p][UNITS[p]]:.3f} {UNITS[p]}" for p in want),
            flush=True)
        for p in want:
            r = runs[-1][1][p]
            if "top" in r:
                print(f"[ab profile] {side} {p}: device busy "
                      f"{r['device_ms']:.3f} ms; top kernels (ms, calls) "
                      + "; ".join(f"{k} {ms:.3f} {n}" for k, ms, n in
                                  r["top"]), flush=True)
    summary = {}
    for p in want:
        unit = UNITS[p]
        mean = {side: sum(r[p][unit] for s, r in runs if s == side)
                / (2 * args.rounds) for side in dirs}
        summary[p] = {f"parent_{unit}": mean["parent"],
                      f"change_{unit}": mean["change"],
                      "runs": [(s, r[p][unit]) for s, r in runs]}
        if all("top" in r[p] for _, r in runs):
            summary[p]["device_ms"] = [(s, r[p]["device_ms"])
                                       for s, r in runs]
        if unit == "step_ms":
            summary[p]["first_loss"] = [(s, r[p]["first_loss"])
                                        for s, r in runs]
            summary[p]["peak_gib"] = [(s, r[p]["peak_gib"]) for s, r in runs]
        print(f"[ab] {p}: parent {mean['parent']:.3f}, change "
              f"{mean['change']:.3f} {unit} "
              f"({mean['change'] / mean['parent'] - 1:+.2%})", flush=True)
    print(json.dumps({"card": card, "phases": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
