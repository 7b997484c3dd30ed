"""The controls of `correct`: the reference put in the program's place in
the nearest precision below the one the configuration states, and the
planted faults of a training step, read on the card at the cells' own
sizes.

    python3 portbench/control.py --workload x4_frames_fast \
        --seeds 11,12,13 --seconds 20

prints one JSON line per seed with the numbers the cell compares, from a
full run of the cell (its window and its check) with the program's
serving call replaced by the reference in the control's precision: fp8
(e4m3, one scale per tensor) for the bf16 configurations, TF32 for the
exact float32 tier.  For the training cell it prints, per seed, the
numbers of the fp8 control and of a reference whose batches lose half
their rows, each put in the program's place on batches of the cell's
size, and of a state left unchanged; with ``--sound`` those of a sound
run of the program, and with ``--faults a,b`` those of runs with the
named faults (`FAULTS`) planted in the program, all three through the
cell's own set-up with a window of ``--seconds``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness, images  # noqa: E402
from portbench.reference import check, net  # noqa: E402

# The configuration's stated precision -> the control's.
CONTROL = {"bf16": "fp8", "f32": "tf32"}


def precision(traffic: dict) -> str:
    """The precision a cell states: bf16 for the fast tier and --amp, f32
    for the exact tier."""
    return "bf16" if traffic.get("fast") or traffic.get("amp") else "f32"


@contextlib.contextmanager
def reference_in_place(config: dict, quant: str, device):
    """`api.upscale` and `api.upscale_batch` replaced by the reference in
    the precision ``quant`` (a key of `net.QUANTS`)."""
    import torch
    from rusty_sr_tpu_torch import api

    q = net.QUANTS[quant]
    p = {k: torch.as_tensor(v, device=device) for k, v in net.read_rsr(
        os.path.join(harness.ROOT, config["weights"]), config).items()}

    def upscale(image, weights=None, factor=3, **_):
        return net.upscale_u8(p, np.asarray(image), factor, device, q)

    def upscale_batch(imgs, weights=None, factor=3, *, on_image_done=None,
                      release_outputs=False, **_):
        outs = []
        for i, im in enumerate(imgs):
            out = upscale(im, factor=factor)
            if on_image_done is not None:
                on_image_done(i, out)
            outs.append(None if release_outputs else out)
        return outs

    keep = api.upscale, api.upscale_batch
    api.upscale, api.upscale_batch = upscale, upscale_batch
    try:
        yield
    finally:
        api.upscale, api.upscale_batch = keep


def serving_control(cell: str, seed: int, seconds: float, device="cuda",
                    traffic_overrides=None, bench=None) -> dict:
    """A run of a serving cell with the reference, in the control's
    precision, in the program's place.  ``bench``: the cells to look
    ``cell`` up in (`BENCHMARK.json`'s by default)."""
    bench = bench or harness.benchmark()
    _, config, traffic, _ = harness.cell_files(bench, cell)
    traffic = {**traffic, **(traffic_overrides or {})}
    with reference_in_place(config, CONTROL[precision(traffic)], device):
        return harness.run_cell(cell, seed, seconds, False, device=device,
                                traffic_overrides=traffic_overrides,
                                bench=bench)


def crops(seed: int, traffic: dict, steps: int = 3) -> list:
    """``steps`` batches of the cell's size: random crops of the cell's
    synthetic pictures (the feed's sizes without its file round trip)."""
    r = images.rng(seed, "control.crops")
    pics = images.pictures(seed, "train", min(traffic["images"], 16),
                           traffic["image_height"],
                           traffic["image_width"]).numpy()
    c, out = traffic["crop"], []
    for _ in range(steps):
        idx = r.integers(len(pics), size=traffic["batch"])
        ys = r.integers(traffic["image_height"] - c + 1, size=traffic["batch"])
        xs = r.integers(traffic["image_width"] - c + 1, size=traffic["batch"])
        out.append(np.stack([pics[i, y:y + c, x:x + c]
                             for i, y, x in zip(idx, ys, xs)]))
    return out


def training_control(cell: str, seed: int, device="cuda",
                     traffic_overrides=None, bench=None) -> dict:
    """The training cell's numbers for the fp8 control and for faults of
    the reference put in the program's place, each against the float32
    reference over the three steps the cell compares, from the
    reference's initialisation drawn from ``seed``."""
    bench = bench or harness.benchmark()
    _, config, traffic, limits = harness.cell_files(bench, cell)
    traffic = {**traffic, **(traffic_overrides or {})}
    tree0 = net.init_params(seed, config)
    batches = crops(seed, traffic)
    rec = traffic["recipe"]

    def steps(**k):
        return net.train_steps(tree0, batches, config, rec, device, **k)

    ref = steps()
    fp8 = steps(quant=net.QUANTS[CONTROL[precision(traffic)]])
    half = steps(keep=lambda b: b[:len(b) // 2])
    still = dict(ref, delta={k: np.zeros_like(v)
                             for k, v in ref["delta"].items()})
    out = {}
    for name, obs in (("control_fp8", fp8), ("half_batch", half),
                      ("state_unchanged", still)):
        nums = check.train_gaps(obs, ref)
        ok, _ = check.judge(nums, limits)
        out[name] = {"numbers": nums, "correct": ok}
    return out


def _half(hrs):
    """Each batch of a group (groups, N, H, W, 3) with its second half
    replaced by its first: its mean is the mean over the first half, the
    rest left out."""
    h = hrs.shape[1] // 2
    hrs = hrs.clone()
    hrs[:, h:2 * h] = hrs[:, :h]
    return hrs


def _broken_steps(kind):
    """``train.loop.train_steps`` broken by the fault ``kind``: the steps
    of each grouped upload, the path of every step the training cell
    compares and times."""
    from rusty_sr_tpu_torch.train import loop
    real = loop.train_steps
    if kind == "state_unchanged":      # the group's steps never run
        def broken(step, hrs):
            import torch
            nan = torch.full((), float("nan"), device=hrs.device)
            return nan, nan
        return broken
    alter = {
        "half_batch": _half,
        "altered_batch": lambda hrs: 255 - hrs,
        "shifted_batch": lambda hrs: hrs.roll(1, 0),   # each step the one before's
        "repeated_batch": lambda hrs: hrs[:1].expand(hrs.shape),  # the first, n times
    }[kind]
    return lambda step, hrs: real(step, alter(hrs))


FAULTS = ("state_unchanged", "half_batch", "altered_batch", "shifted_batch",
          "repeated_batch")


@contextlib.contextmanager
def planted(fault):
    """``fault`` (one of `FAULTS`, or None) planted in the program."""
    if fault is None:
        yield
        return
    from rusty_sr_tpu_torch.train import loop
    keep = loop.train_steps
    loop.train_steps = _broken_steps(fault)
    try:
        yield
    finally:
        loop.train_steps = keep


def training_run(cell: str, seed: int, fault=None, seconds: float = 1.0,
                 device="cuda", traffic_overrides=None, bench=None) -> dict:
    """One run of the training cell with ``fault`` planted in the program
    (None: the program as it is): every reading, and `correct`."""
    nums = {}
    with planted(fault):
        r = harness.run_cell(cell, seed, seconds, False, device=device,
                             traffic_overrides=traffic_overrides,
                             numbers_out=nums, bench=bench)
    return {"numbers": nums, "correct": r["correct"]}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--sound", action="store_true",
                   help="training: also a sound run of the program")
    p.add_argument("--faults", default="",
                   help="training: faults to plant in the program, by name")
    a = p.parse_args(argv)
    _, _, traffic, _ = harness.cell_files(harness.benchmark(), a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        if traffic["driver"] == "train_job":
            row = training_control(a.workload, seed)
            runs = (["sound"] if a.sound else []) + \
                [f for f in a.faults.split(",") if f]
            for f in runs:
                row[f] = training_run(a.workload, seed,
                                      None if f == "sound" else f, a.seconds)
        else:
            r = serving_control(a.workload, seed, a.seconds)
            row = {"control": CONTROL[precision(traffic)],
                   "correct": r["correct"], "attempted": r["attempted"],
                   "numbers": {k: v["value"] for k, v in r["checks"].items()}}
        print(json.dumps({"workload": a.workload, "seed": seed, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
