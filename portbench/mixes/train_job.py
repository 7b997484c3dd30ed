"""A training job on one card: `train.loop.train_loop` over
`train.data.CropPipeline`, the pair that `api.train_folder` and the
CLI's ``train`` wire, from the reference's initialisation.

Traffic parameters: ``images`` synthetic pictures of ``image_height`` x
``image_width`` made from the seed and written as RGB PNGs (zlib level
``png_level``, ``png_threads`` writers) into a folder under TMPDIR;
``crop``, ``batch``, ``amp`` and ``trunk`` for `TrainConfig`, whose
other fields keep the program's defaults, with ``checkpoint_every``
for the `.rsr` cadence (the CLI's) and no validation set; ``workers``:
the feed's crop threads (the CLI's ``--data_workers``); ``recipe``:
the reference's Adam and L2 settings, which the reference follows.
The first ``warmup_steps`` steps (graph capture and the first uploads)
fall before the window; the window opens when the loop asks for the
next batch and ends when `train_loop` returns, after its final host
copy of the parameters has synchronised the card.  The harness's
generator around `CropPipeline.next_batch` ends the stream once
``ctx.seconds`` have passed.  ``train_samples_s`` is the crops stepped
in the window over its seconds.  The traced slice is ``trace_steps``
steps from the ``trace_skip``-th step of the window on (both multiples
of the loop's upload group, so the slice holds whole groups).

``resume_step``: the loop starts from a checkpoint the harness writes
with the program's `train.checkpoint.save_native`: the reference's
initialisation drawn from the seed, no optimizer state (so Adam starts
fresh, as from scratch) and this step count.  From a step that is a
multiple of its upload group (ten, cadence-aligned) the loop uploads
every group of batches at once and steps through it
(`train.loop.train_steps`), the path of every step in the window; at
10 no step of the cell takes the one-batch-at-a-time path of a fresh
start's first steps.

The step the window drives is the one set-up drove through its first
three steps, the first three of the first group: a wrapper around
`train.loop.make_train_step` keeps the step, its parameters and its
optimizer, and after its first and third calls reads the first step's
gradient from Adam's first moment (m = (1 - beta1) g after one step)
and the parameters.  Once the window has closed the reference follows
the same three steps on the same batches from the same parameters.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import images
from portbench.reference import check, net
from portbench.tracing import Slice


class _Watch:
    """The program's step; ``after(k, out)`` runs after its k-th call
    (1-based) for its first ``calls`` calls."""

    def __init__(self, step, after, calls: int):
        self.step, self.after, self.calls, self.k = step, after, calls, 0

    @property
    def state(self):
        return self.step.state

    def __call__(self, hr):
        out = self.step(hr)
        if self.k < self.calls:
            self.k += 1
            self.after(self.k, out)
        return out


def _first_moment(opt, p) -> np.ndarray:
    """Adam's first moment of ``p``; zeros where Adam holds none (a step
    that never reached the optimizer)."""
    m = opt.state.get(p, {}).get("exp_avg")
    if m is None:
        return np.zeros(tuple(p.shape))
    return m.double().cpu().numpy()


def _write_pngs(folder: str, pics: np.ndarray, level: int,
                threads: int) -> None:
    def one(k):
        with open(os.path.join(folder, f"{k:04d}.png"), "wb") as f:
            f.write(images.png_encode_rgb(pics[k], level))
    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(one, range(len(pics))))


def run(ctx) -> dict:
    from rusty_sr_tpu_torch.train import checkpoint, loop
    from rusty_sr_tpu_torch.train.data import CropPipeline

    tr, cfg = ctx.traffic, ctx.config
    f, batch = cfg["factor"], tr["batch"]
    tmp = tempfile.mkdtemp(prefix="portbench_train_")
    try:
        folder = os.path.join(tmp, "images")
        os.makedirs(folder)
        pics = images.pictures(ctx.seed, "train", tr["images"],
                               tr["image_height"], tr["image_width"],
                               device=ctx.device).cpu().numpy()
        _write_pngs(folder, pics, tr["png_level"], tr["png_threads"])
        del pics
        tree0 = net.init_params(ctx.seed, cfg)
        tcfg = loop.TrainConfig(factor=f, batch_size=batch, crop=tr["crop"],
                                amp=tr["amp"], trunk=tr["trunk"],
                                checkpoint_every=tr["checkpoint_every"],
                                val_every=tr["checkpoint_every"])
        pipe = CropPipeline(folder, crop=(tr["crop"], tr["crop"]),
                            batch_size=batch, seed=ctx.seed,
                            workers=tr["workers"], out_dtype=np.uint8)
        start = net.hwio(tree0)
        resume = checkpoint.save_native(os.path.join(tmp, "start"),
                                        tr["resume_step"], start)
        try:
            out = _drive(ctx, loop, tcfg, pipe, start, resume,
                         os.path.join(tmp, "params.rsr"))
        finally:
            pipe.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ctx.release()
    ref = net.train_steps(tree0, out.pop("batches"), cfg, tr["recipe"],
                          ctx.device)
    prog = out.pop("prog")
    prog = dict(prog, **{k: net.oihw(prog.get(k, {}))
                         for k in ("grad1", "delta")})
    out["numbers"] = dict(check.train_gaps(prog, ref),
                          grouped_steps=prog["grouped_steps"])
    print("readings " + json.dumps(out["numbers"]), file=sys.stderr)
    return out


def _drive(ctx, loop, tcfg, pipe, start: dict, resume: str,
           param_file: str) -> dict:
    import torch
    tr = ctx.traffic
    beta1 = tr["recipe"]["beta1"]
    warm, batch = tr["warmup_steps"], tr["batch"]
    t_first, t_last = warm + tr["trace_skip"], \
        warm + tr["trace_skip"] + tr["trace_steps"]
    seen, losses, batches, prog = {}, [], [], {}
    st = {"n": 0, "end": None, "t0": None, "reading": None, "grouped": []}
    sl = Slice(ctx.cuda())
    real, real_group = loop.make_train_step, loop.train_steps

    def sync():
        if ctx.cuda():
            torch.cuda.synchronize()

    def after(call, out):
        losses.append(out[0])
        if call == 1:
            sync()
            opt = seen["opt"]
            prog["grad1"] = {k: _first_moment(opt, p) / (1 - beta1)
                             for k, p in seen["params"].items()}
        if call == 3:
            sync()
            prog["delta"] = {k: p.detach().double().cpu().numpy()
                             - start[k].astype(np.float64)
                             for k, p in seen["params"].items()}

    def spy(cfg, params, *a, **k):
        step, opt = real(cfg, params, *a, **k)
        seen.update(params=params, opt=opt)
        return _Watch(step, after, 3), opt

    def group_spy(step, hrs):
        # the asks (first, last] whose batches one grouped upload steps
        st["grouped"].append((st["n"] - len(hrs), st["n"]))
        return real_group(step, hrs)

    def counts(steps):
        return {"steps": steps, "samples": steps * batch,
                "lr_px": steps * batch * (tr["crop"] // tcfg.factor) ** 2}

    def feed():
        while True:
            n = st["n"]                    # batches handed out before this ask
            if n == warm:
                sync()
                st["t0"] = ctx.open_window()
                st["end"] = st["t0"] + ctx.seconds
            if st["end"] is not None and time.perf_counter() >= st["end"]:
                return
            if ctx.trace and n == t_first:
                sl.start()
            elif ctx.trace and n == t_last and st["reading"] is None:
                st["reading"] = sl.stop(counts(n - t_first))
            with ctx.spans("feed_wait"):
                b = pipe.next_batch()
            if n < 3:
                batches.append(b.copy())
            st["n"] += 1
            yield b

    ctx.reset_peak()
    loop.make_train_step, loop.train_steps = spy, group_spy
    try:
        loop.train_loop(tcfg, feed(), resume_from=resume,
                        param_file=param_file, validate=False,
                        device=ctx.device, log=lambda _m: None)
    finally:
        loop.make_train_step, loop.train_steps = real, real_group
    t_done = time.perf_counter()
    if ctx.trace and st["reading"] is None:
        if st["n"] <= t_first:
            sl.start()
        st["reading"] = sl.stop(counts(max(0, st["n"] - t_first)))
    ctx.close_window()
    steps = st["n"] - warm
    prog["losses"] = [float(x) for x in losses]
    # how many of the three compared steps took the grouped upload
    prog["grouped_steps"] = sum(max(0, min(b, 3) - a) for a, b in st["grouped"])
    seen.clear()
    return {"metrics": {"train_samples_s": steps * batch / (t_done - st["t0"])},
            "attempted": steps, "failed": 0, "prog": prog,
            "batches": batches, "reading": st["reading"]}
