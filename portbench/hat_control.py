"""The readings behind `hat_x4_frames_fast`'s limits, on the card, at
the cell's own sizes:

    python3 portbench/hat_control.py --seeds 11,12,13

For each seed it makes the cell's inputs and weights as its mix does
(`mixes/frames_whole_hat.py`), runs one `api.upscale_batch` call of the
cell's first frame group through the program, and compares
``check_frames`` of its frames, drawn from the seed, with the float32
reference (``sound``); then it puts in the program's place, on
``--control_frames`` of those frames, the reference one precision below
(``fp8``: every linear, convolution and attention operand in float8
e4m3, one scale a tensor) and the reference with each planted fault of
`reference.hat.FAULTS`.  One JSON line a seed: each reading's
``max_code_gap``, ``mean_code_gap`` and the reference's
``clipped_share``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness, images  # noqa: E402
from portbench.reference import check, net  # noqa: E402
from portbench.reference import hat as ref  # noqa: E402

CELL = "hat_x4_frames_fast"


def readings(seed: int, control_frames: int, device="cuda") -> dict:
    import torch
    from rusty_sr_tpu_torch import api

    _, cfg, tr, _ = harness.cell_files(harness.benchmark(), CELL)
    h, w, per_call = tr["lr_height"], tr["lr_width"], tr["frames_per_call"]
    frames = images.pictures(seed, "frames", per_call, h, w,
                             device=device).cpu().numpy()
    tree = ref.draw_weights(seed, cfg)
    outs = api.upscale_batch(list(frames), weights=tree,
                             factor=cfg["upscale"], fast=tr["fast"],
                             chunk=tr["chunk"], device=device)
    pick = images.rng(seed, "frames.check")
    idx = [int(i) for i in pick.choice(per_call, tr["check_frames"],
                                       replace=False)]
    p = {k: v.to(device) for k, v in tree.items()}
    del tree
    refs = {i: ref.upscale_u8(p, frames[i], cfg, device) for i in idx}
    row = {"sound": check.merge_image_gaps(
        [check.image_gaps(outs[i], refs[i]) for i in idx])}
    row["clipped_share"] = float(np.mean([ref.clipped_share(refs[i])
                                          for i in idx]))
    for name in ("fp8",) + ref.FAULTS:
        q = net.fp8_quant if name == "fp8" else None
        fault = None if name == "fp8" else name
        row[name] = check.merge_image_gaps([check.image_gaps(
            ref.upscale_u8(p, frames[i], cfg, device, q, fault), refs[i])
            for i in idx[:control_frames]])
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    import argparse
    a = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    a.add_argument("--seeds", required=True)
    a.add_argument("--control_frames", type=int, default=2)
    args = a.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": CELL, "seed": seed,
                          **readings(seed, args.control_frames)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
