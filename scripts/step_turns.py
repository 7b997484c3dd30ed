#!/usr/bin/env python3
"""Time the training step of two or more checkouts of the port on one card,
in turns.

    python3 scripts/step_turns.py ROOT_A ROOT_B [...]

Each ROOT is a directory holding a `rusty_sr_tpu_torch` package (for
example the parent commit unpacked with ``git archive`` into a git-ignored
directory, and ``.``).  The roots run in the order A, B, ..., then
reversed, each in a process of its own that imports the package from its
root: there, the loop's step (`train.loop.make_train_step`: one CUDA
graph a step) of the f32, ``--amp`` and ``--trunk packed`` tiers at batch
4 and 32 (crop 192, full width, x3, a random init from a seed and random
u8 batches made on the card) is timed with CUDA events over 20 steps
after 5 warm-up steps.  Prints one line per run and, last, the mean of
each root's two runs with the card's name and power limit.  Needs a CUDA
device; about half a minute a run on one H100.
"""

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from rusty_sr_tpu_torch.params import init_params
from rusty_sr_tpu_torch.train import loop as TL

dev = torch.device("cuda")
g = torch.Generator(device="cpu").manual_seed(0)
out = {}
for tier, kw in (("f32", {}), ("amp", {"amp": True}),
                 ("packed", {"trunk": "packed"})):
    for batch in (4, 32):
        p = {k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in init_params(0, 3).items()}
        cfg = TL.TrainConfig(batch_size=batch, crop=192, **kw)
        step, _ = TL.make_train_step(cfg, p)
        hrs = torch.randint(0, 256, (25, batch, 192, 192, 3), generator=g,
                            dtype=torch.uint8).to(dev)
        for i in range(5):
            step(hrs[i])
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(5, 25):
            step(hrs[i])
        b.record()
        torch.cuda.synchronize()
        out[f"{tier} b{batch}"] = a.elapsed_time(b) / 20
print(json.dumps(out))
"""


def main() -> int:
    roots = sys.argv[1:]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    runs = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        r = subprocess.run([sys.executable, "-c", CHILD,
                            os.path.abspath(root)], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr, file=sys.stderr)
            return 1
        ms = json.loads(r.stdout.strip().splitlines()[-1])
        runs[root].append(ms)
        print(f"{root}: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" ms/step ({card})")
    for root, got in runs.items():
        mean = {k: sum(m[k] for m in got) / len(got) for k in got[0]}
        print(f"mean of {len(got)} runs, {root}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
              + f" ms/step (CUDA events, 20 steps after 5; {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
