"""PP-YOLOE of the PyTorch port against the JAX package: the dense
task-aligned assignment, the eval outputs, the four loss terms and every
parameter's gradient, the anchors, and the NMS operators.

The detector is ``ppyoloe_tiny(num_classes=4)`` built in the JAX
package (``paddle.seed(0)``) and carried to the port through
``vision_state_dict_from_jax``; both see the same numpy batch: B=2
images of 64x64 (A = 64 + 16 + 4 = 84 anchors) with 4 padded boxes an
image, the last masked out, drawn as ``bench.py``'s ``bench_detector``
draws them.  The JAX loss and its gradient are one ``jax.jit`` of
``jax.value_and_grad`` under ``F.bind``, as ``bench_detector`` steps
(its cold compile is a few seconds; the eager tape compiles each op and
took ~50 s).  Each test builds its own reference: under xdist a module
fixture would be rebuilt on every worker that draws a test of the file.

Tolerances: the assignment's masks and indices exactly, its scores and
IoUs 1e-6; eval scores and boxes 1e-5 x max(|ref|, 1); the loss terms
1e-5 relative; gradients 1e-4 x max(|ref|, 1) (measured: 2e-6, fp32
sums in another order).  NMS results (indices, rows) exactly, on
distinct scores: the JAX ``multiclass_nms`` pre-selects with numpy's
unstable sort, so ties are not comparable (``ROADMAP.md`` queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.nn import functional_call as JF
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.vision import ops as JOPS
from paddle_tpu.vision.models import ppyoloe as JP

from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.vision import ops as TOPS
from paddle_tpu_torch.vision.models import ppyoloe as TP
from torch_parity_helpers import torch_one_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
B, G, SIZE, CLASSES = 2, 4, 64, 4


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def _pair():
    jpaddle.seed(0)
    jnet = JP.ppyoloe_tiny(num_classes=CLASSES)
    net = TM.ppyoloe_tiny(num_classes=CLASSES, device="cpu")
    net.load_state_dict(TM.vision_state_dict_from_jax(jnet, net))
    return jnet, net


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, 3, SIZE, SIZE), dtype=np.float32)
    bx = rng.random((B, G, 4), dtype=np.float32) * SIZE
    boxes = np.concatenate([np.minimum(bx[..., :2], bx[..., 2:]),
                            np.maximum(bx[..., :2], bx[..., 2:]) + 4], -1)
    labels = rng.integers(0, CLASSES, (B, G)).astype(np.int64)
    mask = np.ones((B, G), np.float32)
    mask[:, -1] = 0.0
    return imgs, boxes, labels, mask


def _boxes(rng, n, span=64.0, side=(4.0, 24.0)):
    xy = rng.random((n, 2), dtype=np.float32) * span
    wh = side[0] + rng.random((n, 2), dtype=np.float32) * (side[1] - side[0])
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_anchors_on_a_map_that_is_not_square():
    shapes, strides = [(3, 5), (2, 3)], [8, 16]
    jpts, jst = JP._make_anchors(shapes, strides)
    pts, st = TP._make_anchors(shapes, strides, device="cpu")
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    # row-major over each (H, W) map: x runs fastest
    assert pts[:5, 1].unique().numel() == 1 and pts[:5, 0].unique().numel() == 5


def test_task_aligned_assign_matches_jax():
    rng = np.random.default_rng(1)
    points, _ = TP._make_anchors([(8, 8), (4, 4), (2, 2)], [8, 16, 32],
                                 device="cpu")
    a = points.shape[0]
    scores = rng.random((B, a, CLASSES), dtype=np.float32)
    half = 4.0 + rng.random((B, a, 2), dtype=np.float32) * 12.0
    pred = np.concatenate([points.numpy()[None] - half,
                           points.numpy()[None] + half], -1)
    gt = np.stack([_boxes(rng, G, 40.0, (12.0, 30.0)) for _ in range(B)])
    labels = rng.integers(0, CLASSES, (B, G)).astype(np.int64)
    mask = np.ones((B, G), np.float32)
    mask[0, -1] = mask[1, -2:] = 0.0
    ref = jax.jit(JP.task_aligned_assign)(
        jnp.asarray(scores), jnp.asarray(pred), jnp.asarray(points.numpy()),
        jnp.asarray(gt), jnp.asarray(labels.astype(np.int32)),
        jnp.asarray(mask))
    got = TP.task_aligned_assign(
        torch.from_numpy(scores), torch.from_numpy(pred), points,
        torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(mask))
    pos, agt, ascore, aiou = (np.asarray(r) for r in ref)
    assert pos.sum() > 4, "too few positives for a meaningful comparison"
    np.testing.assert_array_equal(got[0].numpy(), pos)
    np.testing.assert_array_equal(got[1].numpy(), agt)
    np.testing.assert_allclose(got[2].numpy(), ascore, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), aiou, rtol=0, atol=1e-6)
    # a masked gt is never assigned
    for b in range(B):
        masked = np.flatnonzero(mask[b] == 0)
        assert not np.isin(got[1][b].numpy()[pos[b]], masked).any()


def test_eval_outputs_loss_terms_and_every_gradient_match_jax():
    jnet, net = _pair()
    imgs, boxes, labels, mask = _batch()
    jnet.eval()
    net.eval()
    params = JF.param_dict(jnet)
    frozen, buffers = JF.frozen_dict(jnet), JF.buffer_dict(jnet)

    @jax.jit
    def forward(x):
        with JF.bind(jnet, params, buffers, frozen):
            return tuple(t._value for t in jnet(JTensor(x)))

    jscores, jboxes = forward(imgs)
    with torch.no_grad():
        scores, pboxes = net(torch.from_numpy(imgs))
    assert tuple(scores.shape) == (B, 84, CLASSES)
    assert tuple(pboxes.shape) == (B, 84, 4)
    _close(scores.numpy(), np.asarray(jscores), FWD_TOL, "eval scores")
    _close(pboxes.numpy(), np.asarray(jboxes), FWD_TOL, "eval boxes")

    jnet.train()
    net.train()

    @jax.jit
    def loss_and_grad(p):
        def loss_fn(pp):
            with JF.bind(jnet, pp, buffers, frozen):
                out = jnet(JTensor(imgs), gt_boxes=JTensor(boxes),
                           gt_labels=JTensor(labels), gt_mask=JTensor(mask))
            return out["loss"]._value, {k: v._value for k, v in out.items()}
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (_, jterms), jgrads = loss_and_grad(params)
    out = net(torch.from_numpy(imgs), gt_boxes=torch.from_numpy(boxes),
              gt_labels=torch.from_numpy(labels),
              gt_mask=torch.from_numpy(mask))
    assert set(out) == {"loss", "loss_cls", "loss_iou", "loss_dfl"}
    for k, v in out.items():
        assert v.dim() == 0 and v.dtype == torch.float32
        np.testing.assert_allclose(float(v.detach()), float(jterms[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(out["loss_iou"].detach()) > 0 and \
        float(out["loss_dfl"].detach()) > 0
    out["loss"].backward()
    names = [n for n, _ in net.named_parameters()]
    assert set(names) == set(jgrads)
    for name, p in net.named_parameters():
        assert p.grad is not None, name
        _close(p.grad.numpy(), np.asarray(jgrads[name]), GRAD_TOL,
               f"grad {name}")


def test_negative_weight_keeps_its_gradient():
    """``w = where(pos, target, 0.75 * scores^2)`` is not detached: with
    no real box every anchor is a negative and the class loss is
    ``sum(0.75 p^2 * bce) / 1``, whose gradient includes ``w``'s."""
    torch.manual_seed(0)
    cls = torch.randn(1, 6, 3, requires_grad=True)
    net = TM.ppyoloe_tiny(num_classes=3, device="cpu")
    head = net.head
    points, stride = TP._make_anchors([(2, 3)], [8], device="cpu")
    reg = torch.zeros(1, 6, 4 * (head.reg_max + 1))
    head._raw = lambda feats: (cls, reg, [(2, 3)])
    head.strides = [8]
    out = head.loss(None, torch.zeros(1, 1, 4), torch.zeros(1, 1,
                    dtype=torch.int64), torch.zeros(1, 1))
    out["loss_cls"].backward()
    p = torch.sigmoid(cls.detach())
    bce = -torch.nn.functional.logsigmoid(-cls.detach())
    want = 0.75 * (2 * p * p * (1 - p) * bce + p * p * p)
    torch.testing.assert_close(cls.grad, want, rtol=1e-5, atol=1e-7)


def _distinct_scores(rng, shape):
    n = int(np.prod(shape))
    return (rng.permutation(n).astype(np.float32) / n + 0.5 / n).reshape(
        shape)


@pytest.mark.parametrize("case", ["plain", "no_scores", "categories"])
def test_nms_matches_jax(case):
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 60)
    scores = _distinct_scores(rng, (60,))
    kw, tkw = {}, {}
    if case != "no_scores":
        kw["scores"], tkw["scores"] = JTensor(scores), torch.from_numpy(
            scores)
    if case == "categories":
        cats = rng.integers(0, 3, (60,)).astype(np.int64)
        kw.update(category_idxs=JTensor(cats), top_k=7)
        tkw.update(category_idxs=torch.from_numpy(cats), top_k=7)
    ref = np.asarray(JOPS.nms(JTensor(boxes), 0.3, **kw).numpy())
    got = TOPS.nms(torch.from_numpy(boxes), 0.3, **tkw)
    assert got.dtype == torch.int64 and 0 < len(ref) < 60
    np.testing.assert_array_equal(got.numpy(), ref)


def test_nms_padded_and_box_iou_match_jax():
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, 40)
    scores = _distinct_scores(rng, (40,))
    for max_out in (5, 40):
        ridx, rcount = JOPS.nms_padded(JTensor(boxes), JTensor(scores), 0.4,
                                       max_out)
        idx, count = TOPS.nms_padded(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.4, max_out)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx.numpy()))
        assert int(count) == int(np.asarray(rcount.numpy()))
    _close(TOPS.box_iou(torch.from_numpy(boxes[:7]),
                        torch.from_numpy(boxes)).numpy(),
           np.asarray(JOPS.box_iou(JTensor(boxes[:7]),
                                   JTensor(boxes)).numpy()), 1e-6, "box_iou")


@pytest.mark.parametrize("nms_top_k,keep_top_k", [(400, 100), (12, 20),
                                                  (-1, 5)])
def test_multiclass_nms_and_postprocess_match_jax(nms_top_k, keep_top_k):
    rng = np.random.default_rng(4)
    n, c = 50, 3
    boxes = _boxes(rng, n)
    scores = _distinct_scores(rng, (c, n))
    ref = np.asarray(JOPS.multiclass_nms(
        JTensor(boxes), JTensor(scores), score_threshold=0.3,
        nms_threshold=0.45, keep_top_k=keep_top_k,
        nms_top_k=nms_top_k).numpy())
    got = TOPS.multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        score_threshold=0.3, nms_threshold=0.45, keep_top_k=keep_top_k,
        nms_top_k=nms_top_k)
    assert got.dtype == torch.float32 and len(ref) > 0
    np.testing.assert_array_equal(got.numpy(), ref)
    empty = TOPS.multiclass_nms(torch.from_numpy(boxes),
                                torch.from_numpy(scores), score_threshold=2.0)
    assert tuple(empty.shape) == (0, 6)
    # postprocess: per image, scores [B, A, C] transposed to [C, A]
    sc = np.stack([scores.T, _distinct_scores(rng, (n, c))])
    bx = np.stack([boxes, _boxes(rng, n)])
    refs = JP.ppyoloe_tiny(num_classes=c).postprocess(
        JTensor(sc), JTensor(bx), score_threshold=0.3)
    gots = TM.ppyoloe_tiny(num_classes=c, device="cpu").postprocess(
        torch.from_numpy(sc), torch.from_numpy(bx), score_threshold=0.3)
    assert len(gots) == 2
    for g, r in zip(gots, refs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r.numpy()))


@pytest.mark.parametrize("nms_top_k,keep_top_k", [(400, 100), (7, 100),
                                                  (400, 9)])
def test_multiclass_nms_breaks_ties_by_index(nms_top_k, keep_top_k):
    """Scores on a grid of eighths, so most of them tie: each class's
    candidates, its ``nms_top_k`` cut and the final rows are in
    descending score and then ascending index order, as a stable sort
    gives on any device (``torch.topk`` orders ties by its own rule,
    which differs between the CPU and the card).  Exact."""
    rng = np.random.default_rng(8)
    n, c, thr = 60, 4, 0.3
    boxes = _boxes(rng, n)
    scores = (np.floor(rng.random((c, n)) * 8) / 8).astype(np.float32)
    rows = []
    for k in range(c):
        idx = np.flatnonzero(scores[k] > thr)
        idx = idx[np.argsort(-scores[k][idx], kind="stable")]
        if nms_top_k > 0:
            idx = idx[:nms_top_k]
        kept = TOPS.nms(torch.from_numpy(boxes[idx]), 0.45,
                        torch.from_numpy(scores[k][idx])).numpy()
        rows += [[k, scores[k][idx[i]], *boxes[idx[i]]] for i in kept]
    ref = np.asarray(rows, np.float32)
    ref = ref[np.argsort(-ref[:, 1], kind="stable")][:keep_top_k]
    got = TOPS.multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        score_threshold=thr, nms_threshold=0.45, keep_top_k=keep_top_k,
        nms_top_k=nms_top_k)
    assert len(ref) > 0
    np.testing.assert_array_equal(got.numpy(), ref)


def test_constructors_and_refusals():
    net = TM.ppyoloe_crn_s(num_classes=10, device="cpu")
    assert len(list(net.parameters())) > 50
    assert float(net.head.pred_cls[0].bias[0].detach()) == pytest.approx(
        -np.log(99.0), rel=1e-6)
    with pytest.raises(ValueError, match="one width"):
        TP.PPYOLOEHead([32, 64], device="cpu")
