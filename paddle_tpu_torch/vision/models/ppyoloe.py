"""PP-YOLOE-class anchor-free detector (counterpart of
``paddle_tpu/vision/models/ppyoloe.py``): CSPResNet backbone, CSPPAN
neck and a decoupled head with DFL regression, trained with the dense
task-aligned assignment and varifocal-style BCE + GIoU + DFL losses.

Everything in the training step is statically shaped and stays on the
device: the assignment is a ``[B, A, G]`` mask computation (top-k,
argmax, gathers) over padded ground-truth boxes with a validity mask,
and no value is read back, so the fold engine can capture the whole
step once per image-size bucket.  The JAX loss is one tape node
(``apply_closure``); here it is plain autograd.  NMS runs in eval only
(:meth:`PPYOLOE.postprocess`, ``vision/ops.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ... import nn
from ...nn.layer import Layer
from ...ops import activation as A
from ...ops import manipulation as M
from ...ops import nn_ops
from .. import ops as vops
from ._utils import layer_kw


class ConvBNAct(Layer):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act=True, **kw):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False, **kw)
        self.bn = nn.BatchNorm2D(cout, **kw)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return A.silu(x) if self.act else x


class ESEAttn(Layer):
    """Effective squeeze-excitation (PaddleDetection's
    EffectiveSELayer)."""

    def __init__(self, ch, **kw):
        super().__init__()
        self.fc = nn.Conv2D(ch, ch, 1, **kw)

    def forward(self, feat, avg_feat=None):
        if avg_feat is None:
            avg_feat = nn_ops.adaptive_avg_pool2d(feat, 1)
        return feat * A.sigmoid(self.fc(avg_feat))


class BasicBlock(Layer):
    def __init__(self, ch, shortcut=True, **kw):
        super().__init__()
        self.conv1 = ConvBNAct(ch, ch, 3, **kw)
        self.conv2 = ConvBNAct(ch, ch, 3, **kw)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.shortcut else y


class CSPResStage(Layer):
    """CSP stage: downsample, split 1x1, residual tower, fuse."""

    def __init__(self, cin, cout, n, **kw):
        super().__init__()
        self.down = ConvBNAct(cin, cout, 3, stride=2, **kw)
        mid = cout // 2
        self.conv1 = ConvBNAct(cout, mid, 1, **kw)
        self.conv2 = ConvBNAct(cout, mid, 1, **kw)
        self.blocks = nn.Sequential(*[BasicBlock(mid, **kw)
                                      for _ in range(n)])
        self.attn = ESEAttn(mid * 2, **kw)
        self.conv3 = ConvBNAct(mid * 2, cout, 1, **kw)

    def forward(self, x):
        x = self.down(x)
        y = M.concat([self.conv1(x), self.blocks(self.conv2(x))], axis=1)
        return self.conv3(self.attn(y))


class CSPResNet(Layer):
    """The backbone, lite: a stem and three CSP stages giving (C3, C4,
    C5) at strides 8, 16, 32."""

    def __init__(self, width=(32, 64, 128, 256), depth=(1, 1, 1), *,
                 device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.stem = nn.Sequential(
            ConvBNAct(3, width[0] // 2, 3, stride=2, **kw),
            ConvBNAct(width[0] // 2, width[0], 3, stride=2, **kw))
        self.stages = nn.LayerList([
            CSPResStage(width[i], width[i + 1], depth[i], **kw)
            for i in range(3)])
        self.out_channels = list(width[1:])

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for st in self.stages:
            x = st(x)
            outs.append(x)
        return outs


class CSPPAN(Layer):
    """Top-down FPN and bottom-up PAN with CSP fuse blocks over 1x1
    laterals of one width."""

    def __init__(self, in_channels: Sequence[int], out_ch=96, *,
                 device=None, generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        n = len(in_channels)
        self.lateral = nn.LayerList(
            [ConvBNAct(c, out_ch, 1, **kw) for c in in_channels])
        self.td_blocks = nn.LayerList(
            [ConvBNAct(out_ch * 2, out_ch, 3, **kw) for _ in range(n - 1)])
        self.down = nn.LayerList(
            [ConvBNAct(out_ch, out_ch, 3, stride=2, **kw)
             for _ in range(n - 1)])
        self.bu_blocks = nn.LayerList(
            [ConvBNAct(out_ch * 2, out_ch, 3, **kw) for _ in range(n - 1)])
        self.out_channels = [out_ch] * n

    def forward(self, feats):
        lat = [l(f) for l, f in zip(self.lateral, feats)]
        td = [None] * len(lat)
        td[-1] = lat[-1]
        for i in range(len(lat) - 2, -1, -1):
            up = nn_ops.interpolate(td[i + 1], scale_factor=2,
                                    mode="nearest")
            td[i] = self.td_blocks[i](M.concat([lat[i], up], axis=1))
        out = [td[0]]
        for i in range(len(lat) - 1):
            d = self.down[i](out[-1])
            out.append(self.bu_blocks[i](M.concat([td[i + 1], d], axis=1)))
        return out


# ---------------------------------------------------------------------------
# head and losses
# ---------------------------------------------------------------------------

def _make_anchors(feat_shapes, strides, offset=0.5, device=None):
    """Cell-centre anchor points ``[A, 2]`` (x, y in image pixels) and
    each one's stride ``[A]``, level after level, row-major in each."""
    pts, sts = [], []
    for (h, w), s in zip(feat_shapes, strides):
        xs = (torch.arange(w, dtype=torch.float32, device=device)
              + offset) * s
        ys = (torch.arange(h, dtype=torch.float32, device=device)
              + offset) * s
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        sts.append(torch.full((h * w,), float(s), dtype=torch.float32,
                              device=device))
    return torch.cat(pts, 0), torch.cat(sts, 0)


def _dist2bbox(points, ltrb):
    """(l, t, r, b) distances -> x1y1x2y2 boxes."""
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x - ltrb[..., 0], y - ltrb[..., 1],
                        x + ltrb[..., 2], y + ltrb[..., 3]], -1)


def _bbox2dist(points, boxes, reg_max):
    x, y = points[..., 0], points[..., 1]
    d = torch.stack([x - boxes[..., 0], y - boxes[..., 1],
                     boxes[..., 2] - x, boxes[..., 3] - y], -1)
    return d.clamp(0, reg_max - 0.01)


def _pairwise_iou(a, b, eps=1e-9):
    """a: ``[..., A, 4]``, b: ``[..., G, 4]`` -> ``[..., A, G]``; eps
    added to the union (``vision/ops.py``'s clamps it instead)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / (area_a + area_b - inter + eps)


def _giou(a, b, eps=1e-9):
    """Elementwise GIoU of boxes ``[..., 4]``."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    iou = inter / (union + eps)
    cwh = (torch.maximum(a[..., 2:], b[..., 2:])
           - torch.minimum(a[..., :2], b[..., :2])).clamp_min(0)
    carea = cwh[..., 0] * cwh[..., 1]
    return iou - (carea - union) / (carea + eps)


def task_aligned_assign(scores, pred_boxes, points, gt_boxes, gt_labels,
                        gt_mask, topk=9, alpha=1.0, beta=6.0, eps=1e-9):
    """Task-aligned assignment, dense.

    scores ``[B, A, C]`` (sigmoid), pred_boxes ``[B, A, 4]``, points
    ``[A, 2]``, gt_boxes ``[B, G, 4]``, gt_labels ``[B, G]`` (integer),
    gt_mask ``[B, G]`` (1: a real box).  Each gt takes the ``topk``
    anchors inside it with the largest ``score^alpha * iou^beta``; an
    anchor several gts take goes to the one it overlaps most (the first
    on a tie).  Returns pos_mask ``[B, A]``, assigned_gt ``[B, A]``
    (int64), assigned_score ``[B, A]`` (the alignment normalised per gt:
    ``t / max_t * max_iou``, 0 off the positives) and the IoU with the
    assigned gt ``[B, A]``.  No value is read back.
    """
    B, A, C = scores.shape
    ious = _pairwise_iou(pred_boxes, gt_boxes)               # [B, A, G]
    lbl = gt_labels.long().clamp(0, C - 1)[:, None, :].expand(B, A, -1)
    cls_of_gt = torch.gather(scores, 2, lbl)                  # [B, A, G]
    px = points[None, :, None, 0]
    py = points[None, :, None, 1]
    inside = ((px >= gt_boxes[:, None, :, 0]) &
              (py >= gt_boxes[:, None, :, 1]) &
              (px <= gt_boxes[:, None, :, 2]) &
              (py <= gt_boxes[:, None, :, 3]))
    valid = inside & (gt_mask[:, None, :] > 0)
    metric = (cls_of_gt ** alpha) * (ious ** beta)
    metric = torch.where(valid, metric, torch.zeros_like(metric))
    k = min(topk, A)
    topv = torch.topk(metric.transpose(1, 2), k, dim=-1).values  # [B, G, k]
    thresh = topv[..., -1:].transpose(1, 2)                   # [B, 1, G]
    is_topk = (metric >= thresh.clamp_min(eps)) & valid
    assign_metric = torch.where(is_topk, ious, torch.full_like(ious, -1.0))
    assigned_gt = torch.argmax(assign_metric, dim=-1)         # [B, A]
    pos_mask = is_topk.any(-1)
    agt = assigned_gt[..., None]
    chosen = torch.gather(metric, -1, agt)[..., 0]
    chosen_iou = torch.gather(ious, -1, agt)[..., 0]
    max_m = torch.gather(metric.amax(1), -1, assigned_gt)
    max_i = torch.gather(
        torch.where(is_topk, ious, torch.zeros_like(ious)).amax(1), -1,
        assigned_gt)
    assigned_score = chosen / (max_m + eps) * max_i
    assigned_score = torch.where(pos_mask, assigned_score,
                                 torch.zeros_like(assigned_score))
    return pos_mask, assigned_gt, assigned_score, chosen_iou


class PPYOLOEHead(Layer):
    """Decoupled anchor-free head with DFL regression: per level an ESE
    stem and a 3x3 prediction conv for classes and for ``4 * (reg_max +
    1)`` distance bins; the class bias starts at -log(99) (prior 0.01)."""

    def __init__(self, in_channels: Sequence[int], num_classes=80,
                 strides=(8, 16, 32), reg_max=8, *, device=None,
                 generator=None):
        super().__init__()
        if len(set(in_channels)) != 1:
            raise ValueError(f"PPYOLOEHead takes levels of one width, got "
                             f"{list(in_channels)}")
        kw = layer_kw(device, generator)
        ch = in_channels[0]
        self.num_classes = num_classes
        self.strides = list(strides)
        self.reg_max = reg_max
        self.stem_cls = nn.LayerList([ESEAttn(ch, **kw) for _ in strides])
        self.stem_reg = nn.LayerList([ESEAttn(ch, **kw) for _ in strides])
        self.pred_cls = nn.LayerList(
            [nn.Conv2D(ch, num_classes, 3, padding=1, **kw)
             for _ in strides])
        self.pred_reg = nn.LayerList(
            [nn.Conv2D(ch, 4 * (reg_max + 1), 3, padding=1, **kw)
             for _ in strides])
        with torch.no_grad():
            for conv in self.pred_cls:
                conv.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def _raw(self, feats):
        """The per-level maps flattened: class logits ``[B, A, C]``,
        distance logits ``[B, A, 4 * (R + 1)]``, and each level's
        ``(H, W)``."""
        cls_list, reg_list, shapes = [], [], []
        for i, f in enumerate(feats):
            b, _, h, w = f.shape
            c = self.pred_cls[i](self.stem_cls[i](f))
            r = self.pred_reg[i](self.stem_reg[i](f))
            cls_list.append(c.reshape(b, self.num_classes, h * w)
                            .transpose(1, 2))
            reg_list.append(r.reshape(b, 4 * (self.reg_max + 1), h * w)
                            .transpose(1, 2))
            shapes.append((h, w))
        return torch.cat(cls_list, 1), torch.cat(reg_list, 1), shapes

    def _decode(self, reg, points, stride):
        """DFL expectation -> ltrb in strides -> x1y1x2y2 in pixels;
        also the ``[B, A, 4, R + 1]`` bin logits."""
        b, a, _ = reg.shape
        r = self.reg_max + 1
        logits = reg.reshape(b, a, 4, r)
        bins = torch.arange(r, dtype=torch.float32, device=reg.device)
        dist = (torch.softmax(logits, -1) * bins).sum(-1)
        return _dist2bbox(points[None], dist * stride[None, :, None]), logits

    def forward(self, feats):
        cls, reg, shapes = self._raw(feats)
        points, stride = _make_anchors(shapes, self.strides,
                                       device=cls.device)
        boxes, _ = self._decode(reg, points, stride)
        return torch.sigmoid(cls), boxes

    def loss(self, feats, gt_boxes, gt_labels, gt_mask, cls_weight=1.0,
             iou_weight=2.5, dfl_weight=0.5):
        """The training losses ``{loss, loss_cls, loss_iou, loss_dfl}``
        (0-d fp32).  The assignment sees detached scores and boxes; the
        negatives' weight ``0.75 * scores^2`` does not, so the gradient
        flows through it as in the JAX loss.  The normaliser is
        ``max(sum of assigned scores, 1)`` on the device."""
        cls, reg, shapes = self._raw(feats)
        points, stride = _make_anchors(shapes, self.strides,
                                       device=cls.device)
        pred_boxes, logits = self._decode(reg, points, stride)
        scores = torch.sigmoid(cls)
        gt_labels = gt_labels.long()
        pos, agt, ascore, _ = task_aligned_assign(
            scores.detach(), pred_boxes.detach(), points, gt_boxes,
            gt_labels, gt_mask)
        B, A, C = cls.shape
        tgt_label = torch.gather(gt_labels, -1, agt)             # [B, A]
        onehot = torch.nn.functional.one_hot(tgt_label, C).float()
        cls_target = onehot * ascore[..., None]
        w = torch.where(pos[..., None], cls_target, 0.75 * scores ** 2.0)
        logsig = torch.nn.functional.logsigmoid
        bce = -(cls_target * logsig(cls) + (1 - cls_target) * logsig(-cls))
        denom = ascore.sum().clamp_min(1.0)
        cls_loss = (w * bce).sum() / denom

        tgt_box = torch.gather(gt_boxes, 1, agt[..., None].expand(B, A, 4))
        wbox = ascore * pos
        giou_loss = ((1.0 - _giou(pred_boxes, tgt_box)) * wbox).sum() / denom

        # DFL: cross-entropy against the two bins bracketing the target
        # distance, in strides
        tdist = _bbox2dist(points[None], tgt_box, 1e9) / stride[None, :, None]
        tdist = tdist.clamp(0, self.reg_max - 0.01)
        tl = torch.floor(tdist)
        wr = tdist - tl
        wl = 1.0 - wr
        logp = torch.log_softmax(logits, -1)                     # [B,A,4,R]
        idx = tl.long()[..., None]
        pl = torch.gather(logp, -1, idx)[..., 0]
        pr = torch.gather(logp, -1, idx + 1)[..., 0]
        dfl = -(wl * pl + wr * pr).mean(-1)                      # [B, A]
        dfl_loss = (dfl * wbox).sum() / denom

        total = (cls_weight * cls_loss + iou_weight * giou_loss +
                 dfl_weight * dfl_loss)
        return {"loss": total, "loss_cls": cls_loss, "loss_iou": giou_loss,
                "loss_dfl": dfl_loss}


class PPYOLOE(Layer):
    """CSPResNet + CSPPAN + PPYOLOEHead.

    Train: ``model(images, gt_boxes=, gt_labels=, gt_mask=)`` -> the
    loss dict.  Eval: ``model(images)`` -> (sigmoid scores ``[B, A, C]``,
    boxes ``[B, A, 4]``); :meth:`postprocess` applies multiclass NMS."""

    def __init__(self, num_classes=80, width=(32, 64, 128, 256),
                 depth=(1, 1, 1), neck_ch=96, reg_max=8, *, device=None,
                 generator=None):
        super().__init__()
        kw = layer_kw(device, generator)
        self.backbone = CSPResNet(width, depth, **kw)
        self.neck = CSPPAN(self.backbone.out_channels, neck_ch, **kw)
        self.head = PPYOLOEHead(self.neck.out_channels, num_classes,
                                reg_max=reg_max, **kw)

    def forward(self, images, gt_boxes=None, gt_labels=None, gt_mask=None):
        feats = self.neck(self.backbone(images))
        if gt_boxes is not None:
            return self.head.loss(feats, gt_boxes, gt_labels, gt_mask)
        return self.head(feats)

    def postprocess(self, scores, boxes, score_threshold=0.05,
                    nms_threshold=0.6, keep_top_k=100):
        """Multiclass NMS per image: a list of ``[N, 6]`` rows (label,
        score, x1, y1, x2, y2)."""
        return [vops.multiclass_nms(boxes[b], scores[b].t(),
                                    score_threshold=score_threshold,
                                    nms_threshold=nms_threshold,
                                    keep_top_k=keep_top_k)
                for b in range(scores.shape[0])]


def ppyoloe_crn_s(num_classes=80, **kw):
    """The PP-YOLOE-s-class configuration (scaled CSPResNet widths)."""
    return PPYOLOE(num_classes, width=(32, 64, 128, 256), depth=(1, 2, 2),
                   neck_ch=96, **kw)


def ppyoloe_tiny(num_classes=20, **kw):
    """Test scale: the same topology, the least channels."""
    return PPYOLOE(num_classes, width=(16, 32, 48, 64), depth=(1, 1, 1),
                   neck_ch=32, reg_max=8, **kw)
