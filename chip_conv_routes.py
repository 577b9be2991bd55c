"""Where the convolutions of ``chip_smoke.py``'s CycleGAN and R(2+1)D-18
go on the card, and how far CycleGAN's are from float64.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_conv_routes.py [--size 256]

Two CycleGAN readings, fp32 with TF32 off, at ``--size`` (256, the
size ``chip_smoke.py``'s ``[train cyclegan]`` times):

1. Every convolution shape of the ResNet generator and the PatchGAN at
   B=1, alone, through the port's ``conv2d`` / ``conv2d_transpose``:
   the device time of one forward and backward by ``torch.profiler`` on
   cuDNN's default algorithm choice and on ATen's own convolutions
   (cuDNN off), the share of it in cuDNN's FFT kernels (``fft``, complex
   ``gemv``), and the output, input-gradient and weight-gradient errors
   against float64 (ATen), each over its largest value.  The upstream
   gradient has a zero mean per channel, as an InstanceNorm's backward
   gives it.
2. The generators' G step (PaddleGAN's loop, ``chip_smoke.slice20_models``)
   on each route, with every Conv2D, Conv2DTranspose and InstanceNorm2D
   call's input and upstream gradient kept: each layer's own weight
   gradient (summed over its calls) and input gradient against float64
   recomputed from those same tensors.  This separates the layers' own
   error from what the network does with it.
3. One G+D step's gradients on each route against float64 on ATen's
   convolutions, the float64 run's ReLUs and LeakyReLUs following the
   route's signs, its L1 losses free and then following too, with the
   count of L1 elements whose sign the two runs disagree on (the
   kink ``[train cyclegan parity]`` forces).

And one of R(2+1)D-18 under bf16 O2 (``[train r2plus1d]``'s B=32 clips
of 3x16x112x112): every distinct Conv3D call of one forward, with the
dtypes the port hands cuDNN, run alone: its forward's device time and
the cuDNN kernels it took (an ``f32f32`` kernel computes in fp32).

It imports nothing of JAX and needs no kernel build.
"""

import argparse
import copy
import os
import sys

import numpy as np


def conv_shapes(s):
    """``(name, transposed, input shape, weight shape, stride, padding)``
    of every convolution in CycleGAN at ``s`` x ``s`` (the reflection
    pads applied before the generator's 7x7 and 3x3 ones)."""
    return [("c7s1-64", False, (1, 3, s + 6, s + 6), (64, 3, 7, 7), 1, 0),
            ("d128", False, (1, 64, s, s), (128, 64, 3, 3), 2, 1),
            ("d256", False, (1, 128, s // 2, s // 2), (256, 128, 3, 3), 2, 1),
            ("R256", False, (1, 256, s // 4 + 2, s // 4 + 2),
             (256, 256, 3, 3), 1, 0),
            ("u128", True, (1, 256, s // 4, s // 4), (256, 128, 3, 3), 2, 1),
            ("u64", True, (1, 128, s // 2, s // 2), (128, 64, 3, 3), 2, 1),
            ("c7s1-3", False, (1, 64, s + 6, s + 6), (3, 64, 7, 7), 1, 0),
            ("D64", False, (1, 3, s, s), (64, 3, 4, 4), 2, 1),
            ("D128", False, (1, 64, s // 2, s // 2), (128, 64, 4, 4), 2, 1),
            ("D256", False, (1, 128, s // 4, s // 4), (256, 128, 4, 4), 2, 1),
            ("D512", False, (1, 256, s // 8, s // 8), (512, 256, 4, 4), 1, 1),
            ("D1", False, (1, 512, s // 8 - 1, s // 8 - 1), (1, 512, 4, 4),
             1, 1)]


def rel(torch, got, ref):
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-300))


def shapes_reading(torch, F, cs, size):
    from torch.autograd import DeviceType

    def run(transposed, x, w, b, stride, pad, g):
        x = x.detach().requires_grad_(True)
        w = w.detach().requires_grad_(True)
        out = (F.conv2d_transpose(x, w, b, stride=stride, padding=pad,
                                  output_padding=1) if transposed else
               F.conv2d(x, w, b, stride=stride, padding=pad))
        out.backward(g)
        return out.detach(), x.grad, w.grad

    for name, tr, xs, ws, stride, pad in conv_shapes(size):
        rng = np.random.default_rng(0)
        fan = ws[0] * 9 if tr else int(np.prod(ws[1:]))
        x = torch.from_numpy(np.maximum(rng.standard_normal(xs), 0)).float()
        w = torch.from_numpy(rng.standard_normal(ws) / np.sqrt(fan)).float()
        x, w = x.cuda(), w.cuda()
        b = torch.zeros(ws[1] if tr else ws[0], device="cuda")
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            out = (F.conv2d_transpose(x, w, b, stride=stride, padding=pad,
                                      output_padding=1) if tr else
                   F.conv2d(x, w, b, stride=stride, padding=pad))
            g = torch.from_numpy(rng.standard_normal(
                tuple(out.shape))).float().cuda()
            g = g - g.mean((2, 3), keepdim=True)
            ref = run(tr, x.double(), w.double(), b.double(), stride, pad,
                      g.double())
        parts = []
        for route, enabled in (("cuDNN", True), ("ATen", False)):
            with torch.backends.cudnn.flags(enabled=enabled, allow_tf32=False):
                got = run(tr, x, w, b, stride, pad, g)
                run(tr, x, w, b, stride, pad, g)
                prof = cs.profiled(torch, lambda: [
                    run(tr, x, w, b, stride, pad, g) for _ in range(3)],
                    cpu=True)
            us = fft = 0.0
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA or cs.SPIN_KEY in e.key:
                    continue
                t = cs.kernel_us(e) / 3
                us += t
                if "fft" in e.key.lower() or "gemv" in e.key.lower():
                    fft += t
            errs = [rel(torch, a, r) for a, r in zip(got, ref)]
            parts.append(f"{route} {us / 1e3:.3f} ms (FFT {fft / 1e3:.3f}), "
                         f"out {errs[0]:.2e} dx {errs[1]:.2e} "
                         f"dw {errs[2]:.2e}")
        print(f"[shapes {size}] {name} x{list(xs)} w{list(ws)}: "
              + "; ".join(parts), flush=True)


def local_reading(torch, paddle, cs, size, seed):
    nn = paddle.nn
    kinds = (nn.Conv2D, nn.Conv2DTranspose, nn.InstanceNorm2D)

    def instrument(gan):
        calls = []
        for net in ("netG_A", "netG_B"):
            for name, mod in getattr(gan, net).named_sublayers():
                if not isinstance(mod, kinds):
                    continue

                def pre(m, args, full=f"{net}.{name}"):
                    x = args[0]
                    xv = x.view_as(x)
                    rec = {"layer": full, "mod": m, "x": x.detach().clone()}
                    calls.append(rec)
                    if xv.requires_grad:
                        xv.register_hook(lambda gr, rec=rec: rec.__setitem__(
                            "dx", gr.detach().clone()))
                    m._probe_rec = rec
                    return (xv,) + tuple(args[1:])

                def post(m, args, out):
                    rec = m._probe_rec
                    if out.requires_grad:
                        out.register_hook(lambda gr, rec=rec: rec.__setitem__(
                            "g", gr.detach().clone()))

                mod.register_forward_pre_hook(pre)
                mod.register_forward_hook(post)
        return calls

    for route, enabled in (("cuDNN", True), ("ATen", False)):
        with torch.backends.cudnn.flags(enabled=enabled, allow_tf32=False):
            (a, b), = cs._gan_images(torch, seed + 1150, 1, size, "cuda")
            gan = cs._gan(torch, seed, "cuda")
            calls = instrument(gan)
            gan.set_requires_grad([gan.netD_A, gan.netD_B], False)
            total = gan.g_loss(a, b)[0]
            total.backward()
            torch.cuda.synchronize()
        wsum, dxe = {}, {}
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            for rec in calls:
                if "g" not in rec:
                    continue
                m64 = copy.deepcopy(rec["mod"]).to(torch.float64)
                m64._forward_pre_hooks.clear()
                m64._forward_hooks.clear()
                x64 = rec["x"].double().requires_grad_(True)
                params = list(m64.parameters())
                grads = torch.autograd.grad(m64(x64), [x64] + params,
                                            rec["g"].double())
                if "dx" in rec:
                    dxe[rec["layer"]] = max(dxe.get(rec["layer"], 0.0),
                                            rel(torch, rec["dx"], grads[0]))
                if params:
                    wsum[rec["layer"]] = wsum.get(rec["layer"], 0) + grads[1]
        named = dict(gan.named_parameters())
        we = {k: rel(torch, named[k + ".weight"].grad, v)
              for k, v in wsum.items()}
        for what, errs in (("weight gradients", we),
                           ("input gradients", dxe)):
            top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
            print(f"[layers {size} {route}] the generators' layers' own "
                  f"{what} against float64, largest of {len(errs)}: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)
        del gan, calls
        torch.cuda.empty_cache()


def network_reading(torch, paddle, cs, size, seed):
    data = cs._gan_images(torch, seed + 1150, 1, size, "cpu")
    probe = cs._gan(torch, seed, "cpu")
    noise = set()
    for name in ("netG_A", "netG_B", "netD_A", "netD_B"):
        noise |= {f"{name}.{k}" for k in cs.in_noise_leaves(
            getattr(probe, name), paddle.nn)}
    del probe

    def reference(seen, free_l1):
        """The float64 run; with ``free_l1`` its L1 losses take their own
        signs (the forced forward still runs, to keep the masks in
        step).  Returns its gradients and the count of L1 elements whose
        sign differs from the route's."""
        gan = cs._gan(torch, seed, "cuda").to(dtype=torch.float64)
        cs._relu_force(gan, seen)
        masks = iter([x > 0 for x in seen])
        flips = [0]
        for mod in gan.modules():
            if type(mod).__name__ != "L1Loss":
                continue
            forced = mod.forward

            def l1(x, y, forced=forced):
                out = forced(x, y)
                return (x - y).abs().mean() if free_l1 else out

            mod.forward = l1
        for mod in gan.modules():
            if type(mod).__name__ in ("ReLU", "LeakyReLU", "L1Loss"):
                def keep(m, args):
                    d = args[0] - args[1] if type(m).__name__ == "L1Loss" \
                        else None
                    mask = next(masks)
                    if d is not None:
                        flips[0] += int(((d > 0).cpu() != mask).sum())
                mod.register_forward_pre_hook(keep)
        a, b = data[0]
        gan.train_step(a.to("cuda", torch.float64),
                       b.to("cuda", torch.float64))
        grads = {k: q.grad.detach().double().cpu() for k, q in
                 gan.named_parameters()}
        del gan
        return grads, flips[0]

    for route, enabled in (("cuDNN", True), ("ATen", False)):
        with torch.backends.cudnn.flags(enabled=enabled, allow_tf32=False):
            card = cs._gan_run(torch, seed, "cuda", data, watch=True)
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            parts = []
            for free in (True, False):
                grads, flips = reference(card["seen"], free)
                errs = cs._gan_grad_errors(card["grads"], grads, noise)
                leaf = max(errs, key=errs.get)
                parts.append(f"L1 {'free' if free else 'forced'} "
                             f"{errs[leaf]:.3e} ({leaf})")
        print(f"[network {size} {route}] step 1's gradients per leaf "
              f"against float64 (ReLU signs forced): {'; '.join(parts)}; "
              f"L1 elements of the other sign in float64: {flips}",
              flush=True)
        torch.cuda.empty_cache()


def video_reading(torch, paddle, cs, seed):
    from torch.autograd import DeviceType
    from paddle_tpu_torch.ops import nn_ops
    calls, conv3d = {}, nn_ops._CONV_F[3]

    def keep(x, w, b, stride, pad, dilation, groups):
        key = (tuple(x.shape), x.dtype, tuple(w.shape), w.dtype, stride, pad)
        calls[key] = calls.get(key, 0) + 1
        return conv3d(x, w, b, stride, pad, dilation, groups)

    net, _ = cs._video_model(torch, seed)
    clips = cs._video_batch(torch, seed + 1200, cs.VIDEO_B, cs.VIDEO_T,
                            cs.VIDEO_SIZE)[0].cuda()
    nn_ops._CONV_F[3] = keep
    try:
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"), \
                torch.no_grad():
            net(clips)
    finally:
        nn_ops._CONV_F[3] = conv3d
    del net, clips
    for (xs, xd, ws, wd, stride, pad), n in calls.items():
        x = torch.randn(xs, device="cuda").to(xd)
        w = torch.randn(ws, device="cuda").to(wd)
        with torch.no_grad():
            conv3d(x, w, None, stride, pad, 1, 1)
            prof = cs.profiled(
                torch, lambda: conv3d(x, w, None, stride, pad, 1, 1),
                cpu=True)
        kernels = {e.key: cs.kernel_us(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and
                   cs.SPIN_KEY not in e.key}
        fp32 = sum(us for k, us in kernels.items() if "f32f32" in k)
        top = max(kernels, key=kernels.get)
        print(f"[video] Conv3D x{list(xs)} {str(xd)[6:]} w{list(ws)} "
              f"{str(wd)[6:]} stride {list(stride)} x{n} a forward: "
              f"{sum(kernels.values()) / 1e3:.3f} ms a call, fp32 kernels "
              f"{fp32 / 1e3:.3f}; busiest {top[:90]}", flush=True)
        del x, w
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_conv_routes: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    import paddle_tpu_torch as paddle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] card: {cs.card_line()}", flush=True)
    shapes_reading(torch, paddle.nn.functional, cs, args.size)
    local_reading(torch, paddle, cs, args.size, args.seed)
    network_reading(torch, paddle, cs, args.size, args.seed)
    video_reading(torch, paddle, cs, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
