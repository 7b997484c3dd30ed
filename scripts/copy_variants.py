#!/usr/bin/env python3
"""The chunk pipeline's host<->device copies, three ways, timed in turns on
the card through `tiled_sr_batch` at the serving configuration's shapes
(the anime weights, x3, tile 242, chunks of 24).

    python3 scripts/copy_variants.py          # from the repo root

The variants replace `tiling._run_chunks`, the one chunk loop:

- ``pinned, side streams``: the loop as shipped (pinned ring slots,
  uploads and downloads on two streams of their own, events per slot);
- ``pinned, compute stream``: the same slots with both copies on the
  compute stream, in order with the kernels;
- ``pageable``: the loop before the ring: fresh numpy arrays per chunk,
  ``torch.from_numpy(t).to(device)`` up and a blocking ``.cpu()`` down.
  Both of those copies wait for the stream, so the host's gather and
  scatter run while the card waits.

The images are a folder's worth (four 1024x768 and six small ones, made
from a seed) three times over: 276 tiles, 12 chunks, so the ring of
``_MAX_INFLIGHT + 1`` slots wraps.  For the exact and the fast (packed)
tier it checks that every variant's outputs are byte-identical to the
shipped loop's, times each ``tiled_sr_batch`` call on the host clock
(after a synchronize) in turns A B C C B A, twice, and runs each once
under torch.profiler for the device's busy share (the union of the CUDA
kernels' intervals over that run's wall).  Prints the card's name and
power limit.
"""

import os
import subprocess
import sys
import time
from collections import deque

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import busy_share, synthetic_image  # noqa: E402
from rusty_sr_tpu_torch import params  # noqa: E402
from rusty_sr_tpu_torch.parallel import tiling  # noqa: E402

SHIPPED = tiling._run_chunks
_COMPUTE_RINGS: dict = {}
SHAPES = [(768, 1024)] * 4 + [(300, 517), (97, 131), (241, 243), (16, 16),
                              (48, 64), (64, 48)]


def run_chunks_compute(devices, n_tiles, chunk, in_specs, out_spec, gather,
                       runs, scatter):
    """The shipped loop with both copies on the compute stream (its ring
    kept per shape, as the shipped loop keeps its own); one device."""
    (device,), (run,) = devices, runs
    pending: deque = deque()
    ring = _COMPUTE_RINGS.setdefault((tuple(in_specs), out_spec), [
        tiling._Slot(in_specs, out_spec)
        for _ in range(tiling._MAX_INFLIGHT + 1)])
    compute = torch.cuda.current_stream(device)

    def drain_one():
        g0, cnt, slot = pending.popleft()
        slot.fetched.synchronize()
        scatter(g0, slot.out[:cnt].numpy())

    for k, g0 in enumerate(range(0, n_tiles, chunk)):
        g1 = min(g0 + chunk, n_tiles)
        slot = ring[k % len(ring)]
        slot.uploaded.synchronize()
        slot.fetched.synchronize()
        bufs = [None if t is None else t.numpy() for t in slot.ins]
        gather(g0, g1, bufs)
        for b in bufs:
            if b is not None:
                b[g1 - g0:] = 0
        ins = [None if t is None else t.to(device, non_blocking=True)
               for t in slot.ins]
        slot.uploaded.record(compute)
        res = run(*ins)
        slot.out[:g1 - g0].copy_(res[:g1 - g0], non_blocking=True)
        slot.fetched.record(compute)
        pending.append((g0, g1 - g0, slot))
        if len(pending) >= tiling._MAX_INFLIGHT:
            drain_one()
    while pending:
        drain_one()


def run_chunks_pageable(devices, n_tiles, chunk, in_specs, out_spec, gather,
                        runs, scatter):
    """The loop before the ring: pageable arrays, blocking copies; one
    device."""
    (device,), (run,) = devices, runs
    pending: deque = deque()

    def drain_one():
        g0, cnt, res = pending.popleft()
        scatter(g0, res[:cnt].cpu().numpy())

    for g0 in range(0, n_tiles, chunk):
        g1 = min(g0 + chunk, n_tiles)
        bufs = [None if s is None else torch.zeros(s[0], dtype=s[1]).numpy()
                for s in in_specs]
        gather(g0, g1, bufs)
        res = run(*(None if b is None else torch.from_numpy(b).to(device)
                    for b in bufs))
        pending.append((g0, g1 - g0, res))
        if len(pending) >= tiling._MAX_INFLIGHT:
            drain_one()
    while pending:
        drain_one()


VARIANTS = {"pinned, side streams": SHIPPED,
            "pinned, compute stream": run_chunks_compute,
            "pageable": run_chunks_pageable}


def main() -> int:
    if not torch.cuda.is_available():
        print("copy_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    rng = np.random.default_rng(0)
    imgs = [synthetic_image(rng, h, w) for h, w in SHAPES] * 3
    hr = sum(im.shape[0] * im.shape[1] for im in imgs) * 9 / 1e6
    anime = params.load_builtin("anime")
    names = list(VARIANTS)
    try:
        for cd, tier in ((None, "exact"), (torch.bfloat16, "fast (packed)")):
            def batch(name):
                tiling._run_chunks = VARIANTS[name]
                outs = tiling.tiled_sr_batch(anime, imgs, 3, compute_dtype=cd)
                torch.cuda.synchronize()
                return outs

            want = batch(names[0])
            for name in names[1:]:
                same = all(a.tobytes() == b.tobytes()
                           for a, b in zip(batch(name), want))
                print(f"{tier}: {name} "
                      f"{'byte-identical to' if same else 'DIFFERS from'} "
                      f"{names[0]}")
                if not same:
                    return 1
            del want
            times = {n: [] for n in names}
            for name in (names + names[::-1]) * 2:
                t0 = time.perf_counter()
                batch(name)
                times[name].append(time.perf_counter() - t0)
            for name in names:
                t = times[name]
                mean = sum(t) / len(t)
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    batch(name)
                    wall = time.perf_counter() - t0
                share = busy_share(prof, wall)
                busy = ("busy not measured (no device event)" if share is None
                        else f"traced: kernels {share[0]:.1%} of {wall:.4f} s "
                        f"= {share[0] * wall:.4f} s, {share[0] * wall / mean:.1%}"
                        f" of the untraced mean; copies {share[1]:.1%}")
                print(f"{tier}, {len(imgs)} images, {hr:.2f} HR MPix, "
                      f"{name}: mean {mean:.4f} s ({hr / mean:.1f} HR MPix/s),"
                      f" min {min(t):.4f}, max {max(t):.4f} over {len(t)} in "
                      f"turns; {busy} (host clock; {card})")
    finally:
        tiling._run_chunks = SHIPPED
    return 0


if __name__ == "__main__":
    sys.exit(main())
