"""Whole frames through `api.upscale_batch` with HAT weights, back to back
in a closed loop: video frames or screenshots upscaled in batches, as
upscaler tools and video pipelines run a transformer model.

The contract and the traffic parameters are `frames_whole.py`'s (whose
reservoir this driver reuses), with HAT in SwinIR's place: the weights
are drawn from the seed in HAT's own state-dict layout
(`reference.hat.draw_weights`) and handed to the program as a user's
checkpoint; ``hr_mpix_s`` is the delivered frames' HR pixels over the
window's seconds; ``check_frames`` delivered frames, drawn from the
seed, are compared once the window has closed and the program's state
is dropped with the reference's float32 upscale of the same input, one
frame at a time on the card (``max_code_gap``, ``mean_code_gap``,
``clipped_share``).  The traced slice counts ``frames``, ``lr_px``, the
padded ``tokens`` (544 x 960 a 540p frame) and the attention kernels'
units of work, ``sa_window_heads`` (windows x heads x hybrid blocks) and
``oca_window_heads`` (windows x heads x OCABs).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import hat_flops, images
from portbench.harness import load_module
from portbench.reference import check
from portbench.reference import hat as ref
from portbench.tracing import Slice


def run(ctx) -> dict:
    from rusty_sr_tpu_torch.models import hat  # noqa: F401  (a program
    # without HAT fails here, before any set-up)
    import torch
    from rusty_sr_tpu_torch import api

    reservoir = load_module("mixes", "frames_whole")._reservoir
    tr, cfg = ctx.traffic, ctx.config
    f = cfg["upscale"]
    h, w = tr["lr_height"], tr["lr_width"]
    per_call, groups = tr["frames_per_call"], tr["frame_groups"]
    pool = images.pictures(ctx.seed, "frames", per_call * groups, h, w,
                           device=ctx.device).cpu().numpy()
    frames = [[pool[g * per_call + i] for i in range(per_call)]
              for g in range(groups)]
    tree = ref.draw_weights(ctx.seed, cfg)
    pick = images.rng(ctx.seed, "frames.check")
    kw = dict(weights=tree, factor=f, fast=tr["fast"], chunk=tr["chunk"],
              release_outputs=True, device=ctx.device)
    st = {"end": None, "in": 0, "late": 0, "seen": 0}
    kept = []

    def call(g: int, keep: int) -> None:
        def done(i, out):
            t = time.perf_counter()
            if st["end"] is None or t <= st["end"]:
                st["in"] += 1
                if i == keep and st["end"] is not None:
                    reservoir(kept, (g, i, out), st, tr["check_frames"],
                              pick)
            else:
                st["late"] += 1
        with ctx.spans("upscale_batch"):
            api.upscale_batch(frames[g], on_image_done=done, **kw)

    ctx.reset_peak()
    call(0, -1)                                    # warm-up: every shape
    if ctx.cuda():
        torch.cuda.synchronize()
    st["in"] = 0
    first, n_traced = tr["trace_first_call"], tr["trace_calls"]
    sl, reading, calls, traced = Slice(ctx.cuda()), None, 0, 0
    t0 = ctx.open_window()
    st["end"] = t0 + ctx.seconds
    while time.perf_counter() < st["end"]:
        if ctx.trace and calls == first:
            sl.start()
        call(calls % groups, int(pick.integers(per_call)))
        calls += 1
        if ctx.trace and first <= calls - 1 and reading is None:
            traced += 1
            if traced == n_traced:
                reading = sl.stop(_counts(traced, per_call, h, w, cfg))
    if ctx.trace and reading is None:
        if traced == 0:
            sl.start()
        reading = sl.stop(_counts(traced, per_call, h, w, cfg))
    ctx.close_window()
    delivered, late = st["in"], st["late"]
    attempted = calls * per_call
    metrics = {"hr_mpix_s": delivered * h * w * f * f / ctx.seconds / 1e6}

    del kw
    ctx.release()
    p = {k: v.to(ctx.device) for k, v in tree.items()}
    del tree
    gaps, refs = [], []
    for g, i, out in kept:
        r = ref.upscale_u8(p, frames[g][i], cfg, ctx.device)
        gaps.append(check.image_gaps(out, r))
        refs.append(ref.clipped_share(r))
    numbers = check.merge_image_gaps(gaps)
    numbers["clipped_share"] = float(np.mean(refs)) if refs else None
    return {"metrics": metrics, "attempted": attempted,
            "failed": attempted - delivered - late, "numbers": numbers,
            "reading": reading}


def _counts(calls, per_call, h, w, cfg) -> dict:
    n = calls * per_call
    tokens = hat_flops.padded_tokens(cfg, h, w)
    windows = n * tokens // cfg["window_size"] ** 2
    heads = cfg["num_heads"][0]
    return {"calls": calls, "frames": n, "lr_px": n * h * w,
            "tokens": n * tokens,
            "sa_window_heads": windows * heads * hat_flops.blocks(cfg),
            "oca_window_heads": windows * heads * hat_flops.groups(cfg)}
