"""How many kernel records ``torch.profiler`` loses at the start of a
window, and whether ``chip_smoke.profile_window``'s primers take that
loss.

The profiler loses the first kernel records of some windows, the more
the longer since the process's first profiled window.  Every
``--every`` seconds for ``--seconds`` this script profiles three
windows of ``KERNELS`` small kernels (``x.add_(1)``) launched back to
back: primed (through ``chip_smoke.profile_window``), bare (no
primers), primed again, so that each kind falls on every parity of the
profiler's windows.  It prints one line per round and, last, one JSON
object with every round.  It exits with 1 if a primed window kept fewer
than ``KERNELS``.

    python3 chip_profiler_lag.py [--seconds 150] [--every 10]
"""

import argparse
import json
import os
import sys
import time

KERNELS = 200


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--every", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_profiler_lag: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(16, device="cuda")

    def kept(prof):
        return sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA and
                   chip_smoke.SPIN_KEY not in e.name)

    def burst():
        for _ in range(KERNELS):
            x.add_(1)
        torch.cuda.synchronize()

    def primed():
        with chip_smoke.profile_window(torch) as prof:
            burst()
        return kept(prof)

    def bare():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            burst()
        return kept(prof)

    card = chip_smoke.card_line()
    print(f"[lag] card: {card}; torch {torch.__version__}; "
          f"{KERNELS} kernels a window, {chip_smoke.PROFILE_PRIMERS} "
          "primers", flush=True)
    rounds = []
    t0 = time.monotonic()
    while True:
        age = time.monotonic() - t0
        r = {"age_s": age, "primed_kept": [primed()], "bare_kept": bare()}
        r["primed_kept"].append(primed())
        rounds.append(r)
        print(f"[lag] {age:.1f} s after the first window: kept primed "
              f"{r['primed_kept'][0]}, bare {r['bare_kept']}, primed "
              f"{r['primed_kept'][1]} of {KERNELS}", flush=True)
        if age + args.every > args.seconds:
            break
        time.sleep(args.every)
    print(json.dumps({"card": card, "kernels": KERNELS,
                      "primers": chip_smoke.PROFILE_PRIMERS,
                      "rounds": rounds}), flush=True)
    return 0 if all(k == KERNELS for r in rounds
                    for k in r["primed_kept"]) else 1


if __name__ == "__main__":
    sys.exit(main())
