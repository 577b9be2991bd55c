"""Whether the detector's class scores tie, and whether the card and the
CPU order tied scores alike, in ``multiclass_nms``'s pre-selection.

For each of ``--seeds`` seeded ``ppyoloe_crn_s`` detectors (untrained,
``[detect eval]``'s inputs and threshold from ``chip_smoke.py``) it
counts, over every image and class: tied neighbours among the
candidates (scores above the threshold, sorted), the class lists whose
``torch.topk`` indices differ between the card and the CPU, and the
images whose ``multiclass_nms`` rows differ between the two.  It prints
the card's name and power limit, one line per seed and, last, one JSON
object with every seed.  It exits with 1 if any image's rows differ.

    python3 chip_nms_ties.py [--seeds 4]
"""

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_nms_ties: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as c
    from paddle_tpu_torch.vision import ops as vops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    out = []
    for seed in range(args.seeds):
        net, tr = c._det_model(torch, seed)
        imgs = c._det_batches(torch, seed)[c.DET_SIZES[0]][0]
        net.eval()
        with torch.no_grad():
            scores, boxes = net(imgs)
        thr = float(torch.quantile(scores.flatten(), 1 - c.DET_EVAL_SHARE))
        rec = {"seed": seed, "threshold": thr, "ties": 0, "lists": 0,
               "topk_differs": 0, "rows_differ": 0}
        for b in range(scores.shape[0]):
            s = scores[b].t().contiguous()
            k = min(int((s > thr).sum(1).max()), 400)
            card = torch.topk(s, k, dim=1)[1].cpu()
            host = torch.topk(s.cpu(), k, dim=1)[1]
            rec["lists"] += s.shape[0]
            rec["topk_differs"] += int((card != host).any(1).sum())
            top = torch.sort(s.cpu(), 1, descending=True)[0][:, :k]
            rec["ties"] += int(((top[:, 1:] == top[:, :-1])
                                & (top[:, 1:] > thr)).sum())
            got = vops.multiclass_nms(boxes[b], s, thr, 0.6, 100).cpu()
            ref = vops.multiclass_nms(boxes[b].cpu(), s.cpu(), thr, 0.6,
                                      100)
            rec["rows_differ"] += int(not (got.shape == ref.shape
                                           and torch.equal(got, ref)))
        print(f"seed {seed}: threshold {thr:.6e}; tied neighbours among "
              f"the candidates {rec['ties']}; class lists whose topk "
              f"order differs card vs CPU {rec['topk_differs']} of "
              f"{rec['lists']}; images whose multiclass_nms rows differ "
              f"{rec['rows_differ']} of {scores.shape[0]}", flush=True)
        out.append(rec)
        tr.close()
        del net, tr
    print(json.dumps({"seeds": out}))
    return 1 if any(r["rows_differ"] for r in out) else 0


if __name__ == "__main__":
    sys.exit(main())
