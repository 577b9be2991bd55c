"""Design variants of the tensor-core fused flash backward, timed on one
NVIDIA GPU.

    python3 chip_fused_variants.py [--seed 0]

Run from the root of a checkout on a machine with a CUDA card.  Builds
four variants of a temporary copy of ``paddle_tpu_torch/csrc/
flash_bwd_sm90.cu`` (one ``nvcc`` each, all at once), each edited at text
anchors:

- ``kept``: the source as it is (32-row q tiles, dq's partials added by a
  TMA reduce-add per warpgroup);
- ``64-row tiles``: the fused sweep's q tiles at 64 rows;
- ``64-row tiles, dq late``: that, with dq's product issued after dk's
  and dv's have completed (fewer registers live at once);
- ``red.global``: 32-row tiles, dq's partials added element by element
  with ``atomicAdd`` (``red.global.add.f32``) instead of the reduce-add.

For each it prints ptxas's registers and spill bytes of the fused
kernels, holds ``flash_bwd_fused`` on bf16 against
``flash_bwd_fused_reference`` through ``chip_smoke.flash_bwd_gate`` at
GPT-2-small's ``[96, 1024, 64]`` causal and ERNIE-3.0-base's ``[192, 512,
64]`` non-causal ``[B*H, S, D]`` shapes and times one call (its three
launches) and the sweep alone by device time (``torch.profiler``, 20
calls).  Exits 1 if an anchor is missing (a rewrite of the kernel
updates the anchors or drops this script), a build fails, or a variant
fails the gate; prints a JSON line of the readings last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

BN_KEPT = "constexpr int kBN = D == 128 || kMode == 2 ? 32 : 64;"
BN_64 = "constexpr int kBN = D == 128 ? 32 : 64;"
DQ_PRODUCT_START = ("      if constexpr (kFused) {\n"
                    "        // dq^T[out box cols, q] = K^T dS^T")
DQ_PRODUCT_END = "      }\n      wgmma_commit();\n"
STAGE_START = ("      if constexpr (kFused) {\n"
               "        // stage the partial as [BN q][64 d] fp32")
STAGE_BODY_START = "        float* stg = "
STAGE_BODY_END = "out0 * kAtom, h, s0, b);\n"
RED_GLOBAL = """        float* wsb = dq_ws + (static_cast<int64_t>(b) * Sq * H + h) * D +
                     out0 * kAtom;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int qpos = s0 + 8 * (e >> 2) + cq + (e & 1);
          if (qpos < nB)
            atomicAdd(wsb + static_cast<int64_t>(qpos) * H * D + dcol +
                          8 * ((e >> 1) & 1),
                      dqt[e]);
        }
"""


def _cut(src, start, end):
    """``(before, block, after)`` around the first ``start`` .. ``end``."""
    i = src.index(start)
    j = src.index(end, i) + len(end)
    return src[:i], src[i:j], src[j:]


def variants(src):
    for anchor in (BN_KEPT, DQ_PRODUCT_START, DQ_PRODUCT_END, STAGE_START,
                   STAGE_BODY_START, STAGE_BODY_END):
        if anchor not in src:
            raise SystemExit(f"chip_fused_variants: anchor not found: "
                             f"{anchor!r}")
    out = {"kept": src, "64-row tiles": src.replace(BN_KEPT, BN_64)}
    before, block, after = _cut(src.replace(BN_KEPT, BN_64),
                                DQ_PRODUCT_START, DQ_PRODUCT_END)
    dq_product = block[:-len("      wgmma_commit();\n")]
    after = after.replace(
        STAGE_START, "      wgmma_fence();\n" + dq_product
        + "      wgmma_commit();\n      wgmma_wait_all();\n" + STAGE_START,
        1)
    out["64-row tiles, dq late"] = (before + "      wgmma_commit();\n"
                                    + after)
    before, _, after = _cut(src, STAGE_BODY_START, STAGE_BODY_END)
    out["red.global"] = before + RED_GLOBAL + after
    return out


def build(args):
    name, path, nvcc, flags = args
    lib = path[:-3] + ".so"
    proc = subprocess.run([nvcc, *flags, "-o", lib, path],
                          capture_output=True, text=True)
    return name, lib, proc.returncode, proc.stdout + proc.stderr


def fused_lines(log):
    """ptxas's (registers, spill store bytes) of the fused kernels
    (``flash_bwd_tc_kernel<T, D, 2>``)."""
    out, fused = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fused = "flash_bwd_tc_kernel" in line and "Li2EEEv" in line
        elif fused and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif fused and "Used" in line and "registers" in line:
            out.append((int(line.split("Used")[1].split("registers")[0]),
                        spill))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_fused_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as c
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    print(f"[variants] card: {c.card_line()}", flush=True)
    src = (_build.CSRC_DIR / "flash_bwd_sm90.cu").read_text()
    with tempfile.TemporaryDirectory(prefix="fused_variants_") as tmp:
        with open(os.path.join(tmp, "sm90.cuh"), "w") as f:
            f.write((_build.CSRC_DIR / "sm90.cuh").read_text())
        jobs = []
        for i, (name, text) in enumerate(variants(src).items()):
            path = os.path.join(tmp, f"variant{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            jobs.append((name, path, _build._nvcc(),
                         list(_build.NVCC_FLAGS)))
        with ThreadPoolExecutor(len(jobs)) as ex:
            built = list(ex.map(build, jobs))
        # loaded now, so the directory can go
        libs = {n: ctypes.CDLL(lib) for n, lib, rc, _ in built if rc == 0}
    _build.build_all(["flash_fwd_sm90"])
    failed = [n for n, _, rc, log in built if rc]
    for n, _, rc, log in built:
        if rc:
            print(f"[variants] {n}: nvcc exited {rc}\n{log[-3000:]}")
    if failed:
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    shapes = {"gpt": (96, 1024, True), "ernie": (192, 512, False)}
    data = {}
    for model, (bh, s, causal) in shapes.items():
        q, k, v, g = [torch.randn((bh, s, 1, 64), generator=gen,
                                  device=dev).bfloat16() for _ in range(4)]
        out, lse = fk.flash_fwd(q, k, v, causal)
        ref = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal)
        spread = c.flash_bwd_terms(torch, fk, q, k, v, g, out, lse,
                                   fk._delta(out, g), causal)
        data[model] = (q, k, v, g, out, lse, causal, ref, spread)
    readings, ok = {}, True
    for name, _, _, log in built:
        fk._bwd_tc_lib = fk.bind_bwd_tc(libs[name])
        r = {"ptxas_registers_spill_bytes": fused_lines(log)}
        for model, (q, k, v, g, out, lse, causal, ref, spread) in \
                data.items():
            got = fk.flash_bwd_fused(q, k, v, out, lse, g, causal)
            torch.cuda.synchronize()
            gate = [c.flash_bwd_gate(torch, a, b, spread[n])[1:]
                    for n, a, b in zip(("dq", "dk", "dv"), got, ref)]
            passes = all(c.flash_bwd_passes(q.dtype, *x) for x in gate)
            ok &= passes
            ms = c.device_ms(torch, lambda: fk.flash_bwd_fused(
                q, k, v, out, lse, g, causal), 20,
                {"sweep": ("flash_bwd_tc_kernel",), "all": ()})
            r[model] = {"device_ms": ms["all"], "sweep_device_ms":
                        ms["sweep"], "gate_passes": passes}
        readings[name] = r
        print(f"[variants] {name}: ptxas (registers, spill bytes) "
              f"{r['ptxas_registers_spill_bytes']}; " + "; ".join(
                  f"{m} device_ms={r[m]['device_ms']:.5f} (sweep "
                  f"{r[m]['sweep_device_ms']:.5f}), gate "
                  f"{'passes' if r[m]['gate_passes'] else 'FAILS'}"
                  for m in shapes), flush=True)
    print(json.dumps({"card": c.card_line(), "variants": readings}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
