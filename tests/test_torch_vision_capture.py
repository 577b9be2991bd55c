"""What only the card can check of ViT and PP-YOLOE: the training step
captured once per image-size bucket and replayed bit for bit as the
eager step runs, and NMS and the resize on the card against the CPU.
All ``cuda``-marked (they skip without a card); this file imports no
JAX (the CPU parity with the JAX package is in
``tests/test_torch_vision_vit.py`` and ``test_torch_vision_ppyoloe.py``).
cuDNN runs its deterministic algorithms here (no atomic adds), so a
replay and the eager step compute the same sums in the same order."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework.dispatch import build_folded_step
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.vision import ops as vops
from torch_parity_helpers import torch_one_thread  # noqa: F401

VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
           num_classes=4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graph capture and the card's "
                    "kernels have no CPU mode")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield torch.device("cuda")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _vit_fit(fold, batches):
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = TM.VisionTransformer(**VIT, device="cuda", generator=gen)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters(),
                                 multi_precision=True)
    amp = {"level": "O2", "dtype": "bfloat16"}
    paddle.amp.decorate(net, opt, **amp)
    model = paddle.Model(net, device="cuda")
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), amp_configs=amp)
    losses = []

    class Keep(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"][0]))

    model.fit(batches, epochs=1, verbose=0, callbacks=[Keep()],
              steps_per_dispatch=fold)
    stats = model.compile_stats()
    model.release_graphs()
    return losses, stats


@pytest.mark.cuda
def test_vit_bucketed_fit_replays_are_bit_equal_to_eager(card):
    rng = np.random.default_rng(0)
    data = {s: (torch.from_numpy(rng.random((4, 3, s, s), dtype=np.float32)),
                torch.from_numpy(rng.integers(0, 4, (4,))))
            for s in (32, 24)}
    batches = [data[(32, 24)[i % 2]] for i in range(6)]
    replayed, stats = _vit_fit(1, batches)
    eager, estats = _vit_fit(0, batches)
    assert stats == {"graphs": 2, "captures": 2}
    assert estats == {"graphs": 0, "captures": 0}
    assert all(np.isfinite(replayed))
    assert replayed == eager


def _det_run(captured, seq):
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = TM.ppyoloe_tiny(num_classes=4, device="cuda", generator=gen)
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=net.parameters())
    net.train()

    def per_step(values):
        out = net(values[0], gt_boxes=values[1], gt_labels=values[2],
                  gt_mask=values[3])
        out["loss"].backward()
        opt._step()
        opt.clear_grad()
        return out["loss"].detach().float()

    pool = torch.cuda.graph_pool_handle()
    runners, out = {}, []
    opt.refresh_lr()
    for batch in seq:
        if not captured:
            out.append(per_step(list(batch)))
            continue
        key = tuple(b.shape for b in batch)
        if key not in runners:
            runners[key] = build_folded_step(
                per_step, torch.device("cuda", torch.cuda.current_device()),
                pool, ((opt._bookkeeping, opt._set_bookkeeping),))
        losses = torch.empty(1, device="cuda")
        runners[key].run([b[None] for b in batch], losses)
        out.append(losses[0])
    captures = sum(r.captures for r in runners.values())
    for r in runners.values():
        r.close()
    return torch.stack(out).cpu().numpy(), captures


@pytest.mark.cuda
def test_ppyoloe_captured_step_per_bucket_is_bit_equal_to_eager(card):
    rng = np.random.default_rng(1)
    data = {}
    for s in (64, 96):
        bx = rng.random((2, 4, 4), dtype=np.float32) * s
        boxes = np.concatenate([np.minimum(bx[..., :2], bx[..., 2:]),
                                np.maximum(bx[..., :2], bx[..., 2:]) + 4], -1)
        mask = np.ones((2, 4), np.float32)
        mask[:, -1] = 0
        data[s] = tuple(torch.from_numpy(v).cuda() for v in (
            rng.random((2, 3, s, s), dtype=np.float32), boxes,
            rng.integers(0, 4, (2, 4)), mask))
    seq = [data[(64, 96)[i % 2]] for i in range(6)]
    replayed, captures = _det_run(True, seq)
    eager, _ = _det_run(False, seq)
    assert captures == 2
    assert np.isfinite(replayed).all()
    np.testing.assert_array_equal(replayed, eager)


@pytest.mark.cuda
def test_nms_and_resize_on_the_card_match_the_cpu(card):
    rng = np.random.default_rng(2)
    xy = rng.random((300, 2), dtype=np.float32) * 200
    boxes = np.concatenate([xy, xy + 10 + rng.random((300, 2),
                                                     dtype=np.float32) * 40],
                           -1)
    scores = (rng.permutation(3 * 300).astype(np.float32) / 900).reshape(3,
                                                                         300)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    ref = vops.multiclass_nms(tb, ts, score_threshold=0.2)
    got = vops.multiclass_nms(tb.cuda(), ts.cuda(), score_threshold=0.2)
    assert len(ref) > 0
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)
    idx, n = vops.nms_padded(tb.cuda(), ts[0].cuda(), 0.5, 50)
    ridx, rn = vops.nms_padded(tb, ts[0], 0.5, 50)
    assert torch.equal(idx.cpu(), ridx) and int(n) == int(rn)
    x = torch.from_numpy(rng.standard_normal((2, 8, 14, 14),
                                             dtype=np.float32))
    for dt in (torch.float32, torch.bfloat16):
        xc = x.to(dt).cuda().requires_grad_()
        xr = x.to(dt).clone().requires_grad_()
        out = nn_ops.interpolate(xc, size=[12, 12], mode="bilinear")
        out.float().square().sum().backward()
        ref = nn_ops.interpolate(xr, size=[12, 12], mode="bilinear")
        ref.float().square().sum().backward()
        tol = 1e-5 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(out.float().cpu(), ref.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(xc.grad.float().cpu(), xr.grad.float(),
                                   rtol=tol, atol=tol)
