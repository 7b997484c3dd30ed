"""Frame batches through `api.upscale_batch`, back to back in a closed
loop: bulk upscaling of video frames or screenshots, as folder mode and
`upscale_batch` users run it.

Traffic parameters: ``lr_height`` x ``lr_width`` u8 frames,
``frames_per_call`` to a call, ``frame_groups`` distinct groups of them
made from the seed (call k takes group k mod ``frame_groups``), the
fast tier or not (``fast``), ``tile`` and ``chunk``; ``trace_first_call``
and ``trace_calls``: the traced slice is that many whole calls of the
window, from that one on (0-based).

The window runs calls until ``ctx.seconds`` have passed; a frame counts
as delivered when `upscale_batch` hands it to ``on_image_done`` before
the window's end.  ``hr_mpix_s`` is the delivered frames' useful HR
pixels (the frame's H * W * f^2, no halo or padding) over the window's
seconds.  Of each call one frame, drawn from the seed, is kept if it
is delivered in the window, and every kept frame is compared with the
reference's upscale of the same input once the window has closed.
"""

from __future__ import annotations

import time

from portbench import flops, images
from portbench.reference import check, net
from portbench.tracing import Slice


def run(ctx) -> dict:
    import torch
    from rusty_sr_tpu_torch import api
    from rusty_sr_tpu_torch import params as params_lib

    tr, cfg = ctx.traffic, ctx.config
    f = cfg["factor"]
    h, w = tr["lr_height"], tr["lr_width"]
    per_call, groups = tr["frames_per_call"], tr["frame_groups"]
    pool = images.pictures(ctx.seed, "frames", per_call * groups, h, w,
                           device=ctx.device).cpu().numpy()
    frames = [[pool[g * per_call + i] for i in range(per_call)]
              for g in range(groups)]
    tree = params_lib.load_rsr_file(ctx.weights_path(), f)
    pick = images.rng(ctx.seed, "frames.check")
    kw = dict(weights=tree, factor=f, fast=tr["fast"], tile=tr["tile"],
              chunk=tr["chunk"], release_outputs=True, device=ctx.device)
    st = {"end": None, "in": 0, "late": 0}
    kept = []

    def call(g: int, keep: int) -> None:
        def done(i, out):
            t = time.perf_counter()
            if st["end"] is None or t <= st["end"]:
                st["in"] += 1
                if i == keep and st["end"] is not None:
                    kept.append((g, i, out))
            else:
                st["late"] += 1
        with ctx.spans("upscale_batch"):
            api.upscale_batch(frames[g], on_image_done=done, **kw)

    ctx.reset_peak()
    call(0, -1)                                    # warm-up: every shape
    if ctx.cuda():
        torch.cuda.synchronize()
    st["in"] = 0
    tiles = per_call * flops.tiles_per_image(h, w, tr["tile"])
    n_chunks = flops.chunks(tiles, tr["chunk"])
    side = tr["tile"] + 2 * flops.HALO
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
                reading = sl.stop(_counts(traced, per_call, h, w, tiles,
                                          n_chunks, tr, side))
    if ctx.trace and reading is None:
        if traced == 0:
            sl.start()
        reading = sl.stop(_counts(traced, per_call, h, w, tiles, n_chunks,
                                  tr, side))
    ctx.close_window()
    delivered, late = st["in"], st["late"]
    attempted = calls * per_call
    metrics = {"hr_mpix_s": delivered * h * w * f * f / ctx.seconds / 1e6}

    del tree
    ctx.release()
    ref = {k: torch.as_tensor(v, device=ctx.device)
           for k, v in net.read_rsr(ctx.weights_path(), cfg).items()}
    gaps = [check.image_gaps(out, net.upscale_u8(ref, frames[g][i], f,
                                                 ctx.device))
            for g, i, out in kept]
    return {"metrics": metrics, "attempted": attempted,
            "failed": attempted - delivered - late,
            "numbers": check.merge_image_gaps(gaps), "reading": reading}


def _counts(calls, per_call, h, w, tiles, n_chunks, tr, side) -> dict:
    return {"calls": calls, "frames": calls * per_call,
            "lr_px": calls * per_call * h * w,
            "tiles": calls * n_chunks * tr["chunk"],
            "padded_px": calls * n_chunks * tr["chunk"] * side * side}
