#!/usr/bin/env python3
"""Variants of the training step, timed in turns on the card at the
reference's shapes (width 32, x3, crop 192) at batch 4 and 32.

    python3 scripts/train_variants.py          # from the repo root

1. Where a step's time goes: under torch.profiler, the kernels a step
   launches, the host's time per step, and the ops that take the most
   device time, for f32, ``--amp`` and the packed trunk.

2. The mixed-precision (``--amp``) convolution, two ways:

- ``f32 of bf16`` (shipped, `ops.conv.conv2d_same`): the bf16-rounded
  operands convolved in float32 with TF32 allowed, which holds them
  exactly: exact products and float32 sums, float32 out — the JAX
  package's bf16 convolution (``preferred_element_type=f32``);
- ``bf16 cuDNN + cast``: cuDNN's bf16 convolution, whose output is
  rounded to bf16, then cast to float32: one more rounding a conv.

   For each it prints ms/step (CUDA events, 20 steps, in turns A B B A
   after warm-up), and for the variant the loss and each gradient leaf
   against the shipped route on the same init and batch (worst leaf, as a
   share of its largest magnitude), and against the float32 tier's step.

3. The training loop's step on the card, `train.loop.GraphedStep` (the
   whole step — forward, backward and Adam with ``capturable=True`` —
   captured in one CUDA graph and replayed on a static batch buffer),
   against the eager `train_step`: the parameters after 20 steps on the
   same 20 batches (atol 1e-4, the f32 tolerance of chip_smoke's
   card-against-CPU check), and ms/step in turns, f32 and ``--amp``.

Prints the card's name and power limit.
"""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rusty_sr_tpu_torch.models import sr_net  # noqa: E402
from rusty_sr_tpu_torch.params import init_params  # noqa: E402
from rusty_sr_tpu_torch.train import loop as TL  # noqa: E402

SHIPPED = sr_net.conv2d_same


def cudnn_bf16_cast(x, w):
    """cuDNN's bf16 convolution on NHWC/HWIO bf16 operands, its bf16
    output cast to float32 (float32 operands take the shipped conv)."""
    if x.dtype != torch.bfloat16:
        return SHIPPED(x, w)
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=k // 2)
    return y.permute(0, 2, 3, 1).float()


VARIANTS = {"f32 of bf16 (shipped)": SHIPPED,
            "bf16 cuDNN + cast": cudnn_bf16_cast}


def step_state(tree, cfg, dev):
    p = {k: torch.tensor(v, device=dev, requires_grad=True)
         for k, v in tree.items()}
    return p, TL.make_optimizer(cfg, p)


def loss_and_grads(tree, x, cfg, dev):
    p, opt = step_state(tree, cfg, dev)
    loss, _ = TL.train_step(p, opt, x, cfg)
    return float(loss), {k: v.grad.double().cpu().numpy()
                         for k, v in p.items()}


def worst_leaf(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) / float(np.abs(b[k]).max())
               for k in b)


def cuda_ms(fn, iters=20):
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profile_steps(tree, cfg, x, dev, card):
    """Kernels launched, host ms and the top device ops of one eager step
    (10 steps under torch.profiler after 3 warm-up steps)."""
    from torch.autograd import DeviceType
    p, opt = step_state(tree, cfg, dev)
    for _ in range(3):
        TL.train_step(p, opt, x, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            TL.train_step(p, opt, x, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -getattr(e, "self_device_time_total",
                                        getattr(e, "self_cuda_time_total", 0)))
    top = "; ".join(
        f"{e.key} {getattr(e, 'self_device_time_total', 0) / 10:.0f} us "
        f"x{e.count // 10}" for e in ops[:8])
    trunk = "packed" if cfg.trunk == "packed" else (
        "amp" if cfg.amp else "f32")
    print(f"profile {trunk}, batch {x.shape[0]}: {len(kernels) / 10:.0f} "
          f"device events a step, {dev_us / 10 / 1e3:.3f} ms of them; top "
          f"ops by self device time a step: {top} ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("train_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        torch.cuda.get_device_name(0)
    print(card)
    dev = torch.device("cuda")
    tree = init_params(0, 3)
    rng = np.random.default_rng(0)
    for bsz in (4, 32):
        x = torch.from_numpy(rng.integers(0, 256, (bsz, 192, 192, 3),
                                          dtype=np.uint8)).to(dev)
        for kw in (dict(), dict(amp=True), dict(trunk="packed")):
            profile_steps(tree, TL.TrainConfig(batch_size=bsz, **kw), x, dev,
                          card)
    for bsz in (4, 32):
        cfg = TL.TrainConfig(batch_size=bsz, amp=True)
        x = torch.from_numpy(rng.integers(0, 256, (bsz, 192, 192, 3),
                                          dtype=np.uint8)).to(dev)
        ref = {}
        for name, conv in VARIANTS.items():
            sr_net.conv2d_same = conv
            try:
                ref[name] = loss_and_grads(tree, x, cfg, dev)
            finally:
                sr_net.conv2d_same = SHIPPED
        f32 = loss_and_grads(tree, x, TL.TrainConfig(batch_size=bsz), dev)
        states = {name: step_state(tree, cfg, dev) for name in VARIANTS}
        ms = {name: [] for name in VARIANTS}
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for name in list(VARIANTS) + order:      # warm-up, then timed
            sr_net.conv2d_same = VARIANTS[name]
            p, opt = states[name]
            try:
                t = cuda_ms(lambda: TL.train_step(p, opt, x, cfg))
            finally:
                sr_net.conv2d_same = SHIPPED
            ms[name].append(t)
        for name in VARIANTS:
            loss, grads = ref[name]
            base_loss, base = ref["f32 of bf16 (shipped)"]
            print(f"--amp, batch {bsz}, crop 192, {name}: "
                  f"{sum(ms[name][1:]) / 2:.3f} ms/step (CUDA events, 2 x 20 "
                  f"steps in turns); loss {loss:.8g} (shipped {base_loss:.8g}"
                  f", f32 tier {f32[0]:.8g}); worst gradient leaf vs shipped "
                  f"{worst_leaf(grads, base):.3g}, vs the f32 tier "
                  f"{worst_leaf(grads, f32[1]):.3g} of its max ({card})")
    for bsz in (4, 32):
        xs = [torch.from_numpy(rng.integers(0, 256, (bsz, 192, 192, 3),
                                            dtype=np.uint8)).to(dev)
              for _ in range(20)]
        for kw in (dict(), dict(amp=True)):
            cfg = TL.TrainConfig(batch_size=bsz, **kw)
            pg = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in tree.items()}
            graphed, _ = TL.make_train_step(cfg, pg)
            p, opt = step_state(tree, cfg, dev)
            for x in xs:
                TL.train_step(p, opt, x, cfg)
                graphed(x)
            err = max(float((pg[k] - p[k]).detach().abs().max()) for k in p)
            ms = {"eager": [], "graph": []}
            for name in ("eager", "graph", "graph", "eager"):
                if name == "eager":
                    t = cuda_ms(lambda: TL.train_step(p, opt, xs[0], cfg))
                else:
                    t = cuda_ms(lambda: graphed(xs[0]))
                ms[name].append(t)
            tier = "--amp" if cfg.amp else "f32"
            print(f"CUDA graph, {tier}, batch {bsz}: eager "
                  f"{sum(ms['eager']) / 2:.3f} ms/step, graph "
                  f"{sum(ms['graph']) / 2:.3f} ms/step (CUDA events, 2 x 20 "
                  f"steps in turns); parameters after 20 steps on the same "
                  f"batches max abs {err:.3g} apart (tol 1e-4) ({card})")
            del graphed
    return 0


if __name__ == "__main__":
    sys.exit(main())
