"""Detection operators of the port (counterpart of the NMS part of
``paddle_tpu/vision/ops.py``): box IoU and greedy non-maximum
suppression as a fixed-shape masked loop.

The IoU matrix and the greedy loop run on the tensors' device: one
step per candidate, each a few elementwise launches that read no value
back, so :func:`nms_padded` holds no host sync (a captured graph can
take it).  :func:`nms` and :func:`multiclass_nms` trim to the dynamic
result as the JAX functions' ``np.asarray`` does, which waits for the
device.  The candidates' order is a stable descending sort of the
scores, as ``jnp.argsort(-scores)`` is; :func:`multiclass_nms` takes
each class's ``nms_top_k`` best by that stable sort too (tied scores in
index order, the same on the CPU and the card), where the JAX function
uses numpy's (unstable) sort once a class has more than ``nms_top_k``
candidates, so there the two agree where scores are distinct.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..amp.auto_cast import cast_inputs


def _box_area(b):
    return (b[..., 2] - b[..., 0]).clamp_min(0) * \
        (b[..., 3] - b[..., 1]).clamp_min(0)


def _pairwise_iou(a, b):
    """a: ``[..., N, 4]``, b: ``[..., M, 4]`` (x1, y1, x2, y2) ->
    ``[..., N, M]``; the union clamped at 1e-9."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a)[..., :, None] + _box_area(b)[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def box_iou(boxes1, boxes2):
    """``[N, 4]`` x ``[M, 4]`` boxes -> their ``[N, M]`` IoU."""
    boxes1, boxes2 = cast_inputs("box_iou", boxes1, boxes2)
    return _pairwise_iou(boxes1, boxes2)


def _nms_mask(boxes, scores, iou_threshold: float):
    """Greedy NMS over the last axis of ``scores`` (``boxes`` ``[..., N,
    4]``, leading axes independent problems): candidates in stable
    descending score order, each one still alive suppressing every
    later one whose IoU with it exceeds ``iou_threshold``.  Returns
    ``(keep, order, alive)``: the keep mask in input order, the order,
    and the mask in that order."""
    n = scores.shape[-1]
    order = torch.argsort(-scores, dim=-1, stable=True)
    sorted_boxes = torch.gather(boxes, -2,
                                order[..., None].expand(*order.shape, 4))
    iou = _pairwise_iou(sorted_boxes, sorted_boxes)
    later = torch.ones((n, n), dtype=torch.bool,
                       device=boxes.device).triu(1)
    suppress = (iou > iou_threshold) & later
    alive = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    for i in range(n - 1):
        alive &= ~(suppress[..., i, :] & alive[..., i:i + 1])
    keep = torch.zeros_like(alive).scatter_(-1, order, alive)
    return keep, order, alive


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None):
    """Indices (int64) of the boxes NMS keeps, by descending score
    (``scores`` None: the input order).  With ``category_idxs`` boxes of
    different categories never suppress each other (each category is
    shifted past the others).  Waits for the device once, to trim."""
    b = boxes
    s = scores
    if s is None:
        s = torch.arange(b.shape[0], 0, -1, dtype=b.dtype, device=b.device)
    if category_idxs is not None:
        c = category_idxs.to(device=b.device, dtype=b.dtype)
        b = b + (c * (b.max() + 1.0))[:, None]
    _, order, alive = _nms_mask(b, s, iou_threshold)
    kept = order[alive]
    if top_k is not None:
        kept = kept[:top_k]
    return kept.to(torch.int64)


def nms_padded(boxes, scores, iou_threshold: float, max_out: int):
    """NMS with a fixed-shape result and no host sync: ``(indices
    [max_out] int64, padded with -1, count)``, the kept indices by
    descending score and how many there are (at most ``max_out``)."""
    _, order, alive = _nms_mask(boxes, scores, iou_threshold)
    rank = torch.cumsum(alive.to(torch.int32), 0) - 1
    valid = alive & (rank < max_out)
    buf = torch.full((max_out + 1,), -1, dtype=torch.int64,
                     device=boxes.device)
    tgt = torch.where(valid, rank, torch.full_like(rank, max_out))
    buf.scatter_(0, tgt.to(torch.int64),
                 torch.where(valid, order, torch.full_like(order, -1)))
    count = alive.to(torch.int32).sum().clamp_max(max_out)
    return buf[:max_out], count


def multiclass_nms(bboxes, scores, score_threshold: float = 0.05,
                   nms_threshold: float = 0.45, keep_top_k: int = 100,
                   nms_top_k: int = 400):
    """Per-class NMS, then the ``keep_top_k`` best rows overall.
    ``bboxes`` ``[N, 4]``, ``scores`` ``[C, N]``; returns fp32 ``[M,
    6]`` rows ``(label, score, x1, y1, x2, y2)`` by descending score.
    A class keeps its boxes scoring above ``score_threshold``, at most
    its ``nms_top_k`` best (all of them if ``nms_top_k <= 0``).  Every
    class runs in one batched loop on the device; the host waits twice:
    for the longest candidate list, and for the trimmed rows."""
    c, n = scores.shape
    above = scores > score_threshold
    k = int(above.sum(1).max())
    if nms_top_k > 0:
        k = min(k, nms_top_k)
    if k == 0:
        return torch.zeros((0, 6), dtype=torch.float32, device=bboxes.device)
    # a stable sort, not topk: topk orders tied scores differently on
    # the CPU and the card, and the order decides which box survives
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]                 # [C, k]
    cand = top_s > score_threshold
    cand_boxes = bboxes[top_i]                                # [C, k, 4]
    keep, _, _ = _nms_mask(cand_boxes, top_s, nms_threshold)
    keep &= cand
    labels = torch.arange(c, dtype=torch.float32,
                          device=bboxes.device)[:, None].expand(c, k)
    rows = torch.cat([labels[..., None], top_s.float()[..., None],
                      cand_boxes.float()], -1)[keep]          # class order
    rows = rows[torch.argsort(-rows[:, 1], stable=True)]
    return rows[:keep_top_k]
