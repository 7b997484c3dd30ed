"""Single-image requests from one client in a closed loop: PNG bytes in,
PNG bytes out, as the CLI and `api.upscale` users wait on each picture.

Traffic parameters: ``sizes`` (LR [height, width] pairs),
``images_per_size`` distinct pictures of each made from the seed and
written as RGB PNGs at zlib level ``png_level_in``; the order of sizes
is a new permutation of all of them for every block of ``len(sizes)``
requests, drawn from the seed, so every seed sends the same mix in
another order.  A request is the program's PNG decode (the native
decoder, or Pillow where it declines, as `utils.imageio.load_image_u8`
reads a file), `api.upscale` (``fast`` picks the tier; ``tile``,
``chunk``) and the native encoder at ``png_level_out`` (Pillow where it
declines, as `utils.imageio.save_image_u8` writes), minus the files.
``check_share`` of the requests, drawn from the seed, and the first of
the largest size, are kept and compared with the reference once the
window has closed.  The traced slice is ``trace_requests`` requests
from the ``trace_first_request``-th of the window on.

A request's latency runs from its send to its PNG bytes out;
``request_p50_ms`` and ``request_p95_ms`` are taken over every request
completed in the window.
"""

from __future__ import annotations

import io
import sys
import time
import traceback

import numpy as np

from portbench import images
from portbench.reference import check, net
from portbench.tracing import Slice


def run(ctx) -> dict:
    import torch
    from rusty_sr_tpu_torch import api
    from rusty_sr_tpu_torch import params as params_lib
    from rusty_sr_tpu_torch.utils import native

    tr, cfg = ctx.traffic, ctx.config
    f = cfg["factor"]
    sizes = [tuple(s) for s in tr["sizes"]]
    per = tr["images_per_size"]
    pics = {si: images.pictures(ctx.seed, f"requests.{si}", per, h, w,
                                device=ctx.device).cpu().numpy()
            for si, (h, w) in enumerate(sizes)}
    pngs = {(si, k): images.png_encode_rgb(pics[si][k], tr["png_level_in"])
            for si in pics for k in range(per)}
    order = images.rng(ctx.seed, "requests.order")
    coin = images.rng(ctx.seed, "requests.check")
    largest = max(range(len(sizes)), key=lambda si: sizes[si][0] * sizes[si][1])
    tree = params_lib.load_rsr_file(ctx.weights_path(), f)

    def decode(data: bytes) -> np.ndarray:
        img = native.png_decode(data)
        if img is None:
            from PIL import Image
            with Image.open(io.BytesIO(data)) as im:
                img = np.asarray(im.convert("RGB"))
        return img

    def encode(hr: np.ndarray) -> bytes:
        data = native.png_encode(hr, level=tr["png_level_out"])
        if data is None:
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(hr).convert("RGBA").save(
                buf, format="PNG", compress_level=tr["png_level_out"])
            data = buf.getvalue()
        return data

    def serve(data: bytes) -> bytes:
        with ctx.spans("decode"):
            img = decode(data)
        with ctx.spans("upscale"):
            hr = api.upscale(img, weights=tree, factor=f, fast=tr["fast"],
                             tile=tr["tile"], chunk=tr["chunk"],
                             device=ctx.device)
        with ctx.spans("encode"):
            return encode(hr)

    ctx.reset_peak()
    for si in range(len(sizes)):                   # warm-up: every size
        serve(pngs[(si, 0)])
    n = len(sizes)
    lat, kept, sent, failed, late = [], [], 0, 0, 0
    first, n_traced = tr["trace_first_request"], tr["trace_requests"]
    sl, reading, lr_px, traced = Slice(ctx.cuda()), None, 0, 0
    seen_largest, last = False, None
    t0 = ctx.open_window()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        if sent % n == 0:
            block = order.permutation(n)
        si, k = int(block[sent % n]), (sent // n) % per
        keep = coin.random() < tr["check_share"] or (
            si == largest and not seen_largest)
        if ctx.trace and sent == first:
            sl.start()
        t_send = time.perf_counter()
        sent += 1
        try:
            out = serve(pngs[(si, k)])
        except Exception:                          # a failed request
            traceback.print_exc(file=sys.stderr)
            failed += 1
            continue
        t_done = time.perf_counter()
        if t_done <= end:
            lat.append(t_done - t_send)
            last = (si, k, out)
            if keep:
                kept.append((si, k, out))
                seen_largest |= si == largest
        else:
            late += 1
        if ctx.trace and sent > first and reading is None:
            traced += 1
            lr_px += sizes[si][0] * sizes[si][1]
            if traced == n_traced:
                reading = sl.stop(_counts(traced, lr_px, f))
    if ctx.trace and reading is None:
        if traced == 0:
            sl.start()
        reading = sl.stop(_counts(traced, lr_px, f))
    ctx.close_window()
    if not kept and last is not None:   # a window too short for the draw
        kept.append(last)
    ms = np.asarray(lat) * 1e3
    metrics = {"request_p50_ms": float(np.percentile(ms, 50)) if lat else None,
               "request_p95_ms": float(np.percentile(ms, 95)) if lat else None}

    del tree
    ctx.release()
    ref = {k: torch.as_tensor(v, device=ctx.device)
           for k, v in net.read_rsr(ctx.weights_path(), cfg).items()}
    gaps = [check.image_gaps(images.png_decode_rgb(out),
                             net.upscale_u8(ref, pics[si][k], f, ctx.device))
            for si, k, out in kept]
    return {"metrics": metrics, "attempted": sent, "failed": failed,
            "numbers": check.merge_image_gaps(gaps), "reading": reading}


def _counts(requests, lr_px, f) -> dict:
    return {"requests": requests, "lr_px": lr_px, "hr_px": lr_px * f * f}
