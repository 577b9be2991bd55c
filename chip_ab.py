"""Training step times of two checkouts of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR] [--seed 0]

Runs the four training phases of the ``chip_smoke.py`` found in each
checkout (``[train]``, ``[train fused lmce]``, ``[train bh]``,
``[train ernie bh]``: GPT-2-small B=8 S=1024 default, with the fused
lm-head cross-entropy and under the ``[B*H, S, D]`` knobs, and
ERNIE-3.0-base B=16 S=512 under the knobs, bf16 O2 ``Model.fit``) in
the order parent, change, change, parent, each run in a fresh process
started in its checkout, which builds that checkout's kernels first.
Each phase keeps its own gates (launch counts, losses).  Prints every
run's median step ms per phase, the mean per checkout and the change's
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

PHASES = ("train", "train fused lmce", "train bh", "train ernie bh")
RUN = """
import json, sys, torch
sys.path.insert(0, {dir!r})
import chip_smoke as c
from paddle_tpu_torch import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
t = c.train_phase(torch, {seed})
res = {{"train": t,
        "train fused lmce": c.fused_train_phase(torch, {seed}, t),
        "train bh": c.bh_train_phase(torch, {seed}, t),
        "train ernie bh": c.ernie_train_phase(torch, {seed})}}
print("AB " + json.dumps({{k: {{"step_ms": r["step_ms"],
                               "first_loss": r["losses"][0],
                               "peak_gib": r["peak"] / 2**30}}
                          for k, r in res.items()}}), flush=True)
"""


def run(checkout, seed):
    proc = subprocess.run([sys.executable, "-c",
                           RUN.format(dir=checkout, seed=seed)],
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
    args = ap.parse_args(argv)
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
    for side in ("parent", "change", "change", "parent"):
        runs.append((side, run(dirs[side], args.seed)))
        print(f"[ab] {side} run {len(runs)}: " + ", ".join(
            f"{p} {runs[-1][1][p]['step_ms']:.3f} ms" for p in PHASES),
            flush=True)
    summary = {}
    for p in PHASES:
        mean = {side: sum(r[p]["step_ms"] for s, r in runs if s == side) / 2
                for side in dirs}
        summary[p] = {"parent_ms": mean["parent"], "change_ms": mean["change"],
                      "runs": [(s, r[p]["step_ms"]) for s, r in runs],
                      "first_loss": [(s, r[p]["first_loss"]) for s, r in runs],
                      "peak_gib": [(s, r[p]["peak_gib"]) for s, r in runs]}
        print(f"[ab] {p}: parent {mean['parent']:.3f} ms, change "
              f"{mean['change']:.3f} ms ({mean['change'] - mean['parent']:+.3f}"
              f" ms, {mean['change'] / mean['parent'] - 1:+.2%})", flush=True)
    print(json.dumps({"card": card,
                      "phases": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
