"""Where the tensor-core LMCE backward's time goes, and what its gate in
``chip_smoke.py`` sees, on the card.

    python3 chip_lmce_ablation.py [--rounds 2] [--seed 0]

Run from the root of a checkout.  Builds five variants of
``paddle_tpu_torch/csrc/lmce_sm90.cu`` from a copy written to a
temporary directory (the checkout's source is not touched), each with a
part of every tile's work removed:

0. the kernel as it is;
1. no gradient product (the ``wgmma`` of dL with the streamed tile);
2. no S product (the ``wgmma`` of the owner with the streamed tile:
   S = 0, so p = exp(-lse));
3. no dL arithmetic (the partial S stands in for dL);
4. no ``wgmma`` at all: what is left is the TMA ring, the barriers, the
   partials' exchange and the epilogue.

At GPT-2-small's training shape (N=8192, V=50304, D=768) it then

- holds each variant's ``lmce_bwd_dh_tc`` / ``lmce_bwd_dw_tc`` in bf16
  and fp16 against the plain versions, printing the max abs error, the
  old gate's reading (error / max(|ref|, 1) against 2e-2) and the
  ratio of ``chip_smoke.lmce_grad_gate`` (passes at <= 1): variant 0
  must pass the gate and every other variant must fail it, or the
  script exits 1;
- times both kernels of every variant in bf16 (CUDA events, L2 flushed
  between calls, median of 10), ``--rounds`` times.  A removed part's
  cost is the full kernel's time less the variant's; when the parts'
  costs add up to the full time, the tile's steps run one after
  another rather than overlapped.

The variants are made by editing the source at three fixed anchors; a
rewrite of the kernel that drops one makes this script stop with the
anchor's name.  Prints each variant's ptxas register line, and the
card's name, power limit and SM clock.  Needs one CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

VARIANTS = {0: "the kernel as it is", 1: "no gradient product",
            2: "no S product", 3: "no dL arithmetic",
            4: "no wgmma (TMA ring, barriers, exchange, epilogue)"}
# (anchor in the source, what it becomes); each anchor occurs once
EDITS = (
    ("wgmma_rs_n64_tb<T>(acc[j],",
     "if (ABLATE != 1 && ABLATE != 4) wgmma_rs_n64_tb<T>(acc[j],"),
    ("wgmma_ss<T, kBN>(",
     "if (ABLATE != 2 && ABLATE != 4) wgmma_ss<T, kBN>("),
    ("d[u] = (p - (v == lab_s[t] ? 1.f : 0.f)) * g_s[t];",
     "d[u] = ABLATE == 3 ? s[e + u] : (p - (v == lab_s[t] ? 1.f : 0.f))"
     " * g_s[t];"),
)
OLD_GATE = 2e-2     # x max(|ref|, 1): scaled by the largest value alone,
                    # printed to show what the element-wise gate adds


def _ablated_source(text):
    for anchor, new in EDITS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"lmce_sm90.cu no longer has one {anchor!r}")
        text = text.replace(anchor, new)
    return text


def _build(out_dir):
    """One nvcc per variant, all at once; returns ``{variant: (lib
    path, ptxas register lines)}``."""
    from paddle_tpu_torch import _build as build
    src = out_dir / "lmce_ablation.cu"
    src.write_text(_ablated_source(
        (build.CSRC_DIR / "lmce_sm90.cu").read_text()))
    for header in build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    procs = {}
    for k in VARIANTS:
        lib = out_dir / f"liblmce_ablation{k}.so"
        procs[k] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-DABLATE={k}", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for k, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {k}: nvcc exited "
                               f"{proc.returncode}\n{log}")
        built[k] = (lib, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln])
    return built


def _gate(torch, lk, smoke, libs, gen, N, V, D):
    """Every variant through ``chip_smoke``'s gate in bf16 and fp16;
    returns False when variant 0 fails it or another variant passes."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for dtype in (torch.bfloat16, torch.float16):
        h = torch.randn((N, D), generator=gen, device=dev).to(dtype)
        w = (torch.randn((V, D), generator=gen, device=dev)
             * 0.05).to(dtype)
        labels = torch.randint(0, V, (N,), generator=gen, device=dev).int()
        g = torch.rand((N,), generator=gen, device=dev)
        _, lse = lk.lmce_reference(h, w, labels)
        for which, plain in (("dh", lk.lmce_bwd_dh_reference),
                             ("dw", lk.lmce_bwd_dw_reference)):
            ref = plain(h, w, labels, lse, g)
            for k in VARIANTS:
                got = lk._launch_bwd(libs[k], stream, f"lmce_bwd_{which}_tc",
                                     h, w, labels, lse, g)
                torch.cuda.synchronize()
                err, ratio = smoke.lmce_grad_gate(torch, lk, which, got, ref,
                                                  h, w, labels, lse, g)
                old = err / max(ref.float().abs().max().item(), 1.0)
                passes = ratio <= 1.0
                ok &= passes == (k == 0)
                print(f"[ablation gate] variant {k} ({VARIANTS[k]}) "
                      f"lmce_bwd_{which}_tc {str(dtype)[6:]} N={N} V={V} "
                      f"D={D}: max_abs_err {err:.3e}; old gate {old:.3e} "
                      f"({'passes' if old <= OLD_GATE else 'fails'} at "
                      f"{OLD_GATE}); gate ratio {ratio:.3e} "
                      f"({'passes' if passes else 'fails'})", flush=True)
                del got
            del ref
    return ok


def _time_ms(torch, fn, iters=10, warmup=2, flush=None):
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
    return sorted(times)[len(times) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_lmce_ablation: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_lmce_ablation: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    import chip_smoke as smoke
    from paddle_tpu_torch.ops import lmce_kernel as lk
    torch.backends.cuda.matmul.allow_tf32 = False
    N, V, D = 8192, 50304, 768
    with tempfile.TemporaryDirectory() as tmp:
        built = _build(Path(tmp))
        libs = {}
        for k, (lib, regs) in built.items():
            libs[k] = lk.bind_tc(ctypes.CDLL(str(lib)))
            print(f"[ablation] variant {k} ({VARIANTS[k]}): {regs}",
                  flush=True)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        ok = _gate(torch, lk, smoke, libs, gen, N, V, D)
        h = torch.randn((N, D), generator=gen, device=dev).bfloat16()
        w = (torch.randn((V, D), generator=gen, device=dev)
             * 0.05).bfloat16()
        labels = torch.randint(0, V, (N,), generator=gen,
                               device=dev).int()
        g = torch.rand((N,), generator=gen, device=dev)
        _, lse = lk.lmce_reference(h, w, labels)
        flush = torch.empty(128 * 1024 * 1024 // 4, device=dev).zero_
        stream = torch.cuda.current_stream().cuda_stream
        for rnd in range(args.rounds):
            for k in VARIANTS:
                for which in ("lmce_bwd_dh_tc", "lmce_bwd_dw_tc"):
                    ms = _time_ms(torch, lambda: lk._launch_bwd(
                        libs[k], stream, which, h, w, labels, lse, g),
                        flush=flush)
                    print(f"[ablation] round {rnd} variant {k} "
                          f"({VARIANTS[k]}) {which} bf16 N={N} V={V} "
                          f"D={D}: {ms:.5f} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[ablation] card: {card}", flush=True)
    if not ok:
        print("chip_lmce_ablation: the gate passed a broken variant or "
              "failed the kernel as it is", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
