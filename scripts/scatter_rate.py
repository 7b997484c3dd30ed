#!/usr/bin/env python3
"""Time the chunk loop's output write on the host, apart from the card.

    python3 scripts/scatter_rate.py [--lr 540x960] [--factor 4] \
        [--frames 86] [--threads 1,2,4,8,16] [--rounds 3]

Writes the HR tiles of one `tiled_sr_batch` call (``--frames`` LR
frames of ``--lr`` at ``--factor``, tile 242, chunk 24; the defaults
are the ×4 frames cell's call: 1,032 tiles of 968×968×3 u8 into 86
frames of 2160×3840×3) into that call's outputs, allocated as the call
allocates them and drained chunk by chunk through
`tiling._drain_batch_chunk`, each frame dropped once its last tile is
written (``release_outputs=True``, as the benchmark runs it).  The
variants, in turns, ``--rounds`` times:

- ``zeros+numpy``: `np.zeros` outputs and the numpy copy a tile;
- ``empty+numpy``: `np.empty` outputs and the numpy copy a tile;
- ``empty+T``: `np.empty` outputs and the native scatter on T threads,
  for each T of ``--threads``;
- ``empty+rule``: the same on `native._scatter_threads`' count.

A first untimed round checks that every variant writes the same bytes.
Prints one JSON line a variant: its seconds a call in each round, the
best round's GB/s of HR bytes, and the host's ``os.cpu_count()`` and
the CPUs this process may run on.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rusty_sr_tpu_torch.parallel import tiling  # noqa: E402
from rusty_sr_tpu_torch.utils import native  # noqa: E402

TILE, CHUNK = 242, 24


def one_call(shapes, factor, chunks, alloc, on_done=None) -> float:
    """Seconds to allocate the outputs and drain every chunk into them."""
    metas = [(-(-h // TILE), -(-w // TILE)) for h, w in shapes]
    starts = np.cumsum([0] + [ny * nx for ny, nx in metas])
    t0 = time.perf_counter()
    outs = [alloc((h * factor, w * factor, 3), np.uint8) for h, w in shapes]
    remain, cursor = [ny * nx for ny, nx in metas], [0]
    n_tiles = int(starts[-1])
    for j, g0 in enumerate(range(0, n_tiles, CHUNK)):
        res = chunks[j % len(chunks)][:min(CHUNK, n_tiles - g0)]
        tiling._drain_batch_chunk(res, g0, starts, metas, outs, cursor,
                                  remain, on_done or (lambda i, o: None),
                                  release_outputs=True)
    return time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lr", default="540x960")
    p.add_argument("--factor", type=int, default=4)
    p.add_argument("--frames", type=int, default=86)
    p.add_argument("--threads", default="1,2,4,8,16")
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args()
    h, w = (int(v) for v in a.lr.split("x"))
    if not native.available():
        print("the native tile library did not build: "
              + native.build_error("tileio"), file=sys.stderr)
        return 1
    shapes = [(h, w)] * a.frames
    tf = TILE * a.factor
    rng = np.random.default_rng(0)
    # a ring of result buffers, written once, as the pinned slots are
    chunks = [rng.integers(0, 256, (CHUNK, tf, tf, 3), dtype=np.uint8)
              for _ in range(3)]
    hr_bytes = a.frames * h * w * a.factor ** 2 * 3
    real_load, real_threads = native._load, native._scatter_threads

    def fixed(t):
        return lambda nbytes: t

    variants = [("zeros+numpy", np.zeros, None, lambda name: None),
                ("empty+numpy", np.empty, None, lambda name: None)]
    variants += [(f"empty+{t}", np.empty, fixed(t), real_load)
                 for t in (int(v) for v in a.threads.split(","))]
    variants.append(("empty+rule", np.empty, real_threads, real_load))

    def run(variant, on_done=None):
        _, alloc, threads, load = variant
        native._load = load
        native._scatter_threads = threads or real_threads
        try:
            return one_call(shapes, a.factor, chunks, alloc, on_done)
        finally:
            native._load, native._scatter_threads = real_load, real_threads

    digests = {}
    for v in variants:
        d = hashlib.sha256()
        run(v, lambda i, o: d.update(o.tobytes()))
        digests[v[0]] = d.hexdigest()
    if len(set(digests.values())) != 1:
        print(json.dumps({"error": "variants differ", "digests": digests}))
        return 1
    times = {v[0]: [] for v in variants}
    for _ in range(a.rounds):
        for v in variants:
            times[v[0]].append(run(v))
    host = {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "rule_threads": real_threads(CHUNK * tf * tf * 3)}
    for name, ts in times.items():
        print(json.dumps({"variant": name, "s_a_call": ts,
                          "gb_s": hr_bytes / min(ts) / 1e9,
                          "hr_gb": hr_bytes / 1e9, "frames": a.frames,
                          "lr": a.lr, "factor": a.factor, **host}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
