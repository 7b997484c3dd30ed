"""Whole frames through `api.upscale_batch` with SwinIR weights, back to
back in a closed loop: video frames or screenshots upscaled in batches,
as upscaler tools and video pipelines run a transformer model.

Traffic parameters: ``lr_height`` x ``lr_width`` u8 frames,
``frames_per_call`` to a call, ``frame_groups`` distinct groups of them
made from the seed (call k takes group k mod ``frame_groups``), the fast
tier or not (``fast``), ``chunk`` (frames a chunk; null for the
program's default); ``check_frames`` delivered frames compared with the
reference; ``trace_first_call`` and ``trace_calls``: the traced slice is
that many whole calls of the window, from that one on (0-based).

The weights are drawn from the seed in SwinIR's own state-dict layout
(`reference.swinir.draw_weights`) and handed to the program as a user's
checkpoint.  The window runs calls until ``ctx.seconds`` have passed; a
frame counts as delivered when `upscale_batch` hands it to
``on_image_done`` before the window's end.  ``hr_mpix_s`` is the
delivered frames' HR pixels (H * W * s^2 each) over the window's
seconds.  Of each call one delivered frame, drawn from the seed, is a
candidate, and ``check_frames`` of the candidates (a reservoir drawn from
the seed) are compared, once the window has closed and the program's
state is dropped, with the reference's float32 upscale of the same
input, one frame at a time on the card: ``max_code_gap``,
``mean_code_gap`` (the worst over the frames) and ``clipped_share`` (the
share of the reference's u8 codes at 0 or 255 over the checked frames).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import images, swinir_flops
from portbench.reference import check
from portbench.reference import swinir as ref
from portbench.tracing import Slice


def run(ctx) -> dict:
    import torch
    from rusty_sr_tpu_torch import api
    from rusty_sr_tpu_torch.models import swinir  # noqa: F401  (a program
    # without SwinIR fails here, before any set-up)

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
                    _reservoir(kept, (g, i, out), st, tr["check_frames"],
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


def _reservoir(kept: list, item, st: dict, k: int, rng) -> None:
    """Keep a uniform draw of ``k`` of the candidates seen so far."""
    st["seen"] += 1
    if len(kept) < k:
        kept.append(item)
    else:
        j = int(rng.integers(st["seen"]))
        if j < k:
            kept[j] = item


def _counts(calls, per_call, h, w, cfg) -> dict:
    n = calls * per_call
    tokens = swinir_flops.padded_tokens(cfg, h, w)
    heads = sum(d * nh for d, nh in zip(cfg["depths"], cfg["num_heads"]))
    return {"calls": calls, "frames": n, "lr_px": n * h * w,
            "tokens": n * tokens,
            "window_heads": n * tokens // swinir_flops.WINDOW_TOKENS * heads}
