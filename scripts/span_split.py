#!/usr/bin/env python3
"""Split a benchmark cell's traced slice by the program's stage spans.

    python3 scripts/span_split.py --workload x4_frames_fast --seed 7 \
        --seconds 20 [--spans on,off,...] [--tiny]

runs one cell of `BENCHMARK.json` through the benchmark's harness
(`portbench.harness.run_cell`, traced) once for each word of
``--spans`` (default ``on``), in one process and on one seed, and keeps
besides the harness's own ``portbench.*`` spans the program's
``rusty_sr.*`` ranges (`rusty_sr_tpu_torch.utils.profiling.span`) that
the same profiler recorded.  Prints one JSON line a run: the harness's
result (its per-layer metrics and breakdown as they are), then
``split``: each program span's count and summed seconds; the chunk
loop's shares of the slice (gather; scatter less the nested
``batch.on_image_done``; launch; the host blocked on the card,
``slot_wait`` + ``fetch_wait``; the outputs' allocation,
``tiled.outputs``); the scatter's GB/s (the useful HR bytes, u8, over
the seconds of ``chunk.scatter`` less the callback) and the count of
``scatter.fallback`` spans (scatters that missed the native path);
``tiled.prepare`` ms a request; SwinIR's stages (``swinir.embed``,
``swinir.rstb``, ``swinir.upsample``: the host's seconds in each, as
shares of the slice and ms a frame, the residual groups' count, and the
count of ``swinir.norm_plain`` spans: the exact tier's add-and-normalise
calls, which take the plain version, none in a fast-tier run);
the native
encoder's HR MPix/s (when every request's encode ran natively);
the slice's seconds a call or request; the idle gaps labelled by the
innermost span of either kind; and the count of the card's events that
carry a program span's name (annotations, none of which may be read as
a kernel).

A run ``off`` keeps the profiler on and the program's spans guarded off
(each call site's ``span`` made the null context), so that ``on,off,
off,on`` gives the spans' cost when a profiler records, in turns.
``--tiny`` runs the cell at the CPU sizes of the benchmark's tests
(`portbench/tests/conftest.py::TINY`) on the CPU, its slice the
window's first call or request, which every window holds however slow
the host.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, tracing  # noqa: E402

PRE = "rusty_sr."


class KeepSlice(tracing.Slice):
    """The harness's slice, whose `Reading` also carries ``program``: the
    program's CPU ranges, (full name, start, end) in seconds from the
    slice's start, and ``annotations``: the card's events of those
    names."""

    def stop(self, counts):
        prof = self.prof
        reading = super().stop(counts)
        events = prof.profiler.kineto_results.events()
        s0 = next(tracing._ns(e, "start") for e in events
                  if not tracing._is_device(e)
                  and e.name() == tracing.PREFIX + "slice")
        s1 = s0 + reading.slice_s * 1e9
        reading.program, reading.annotations = [], 0
        for e in events:
            if not e.name().startswith(PRE):
                continue
            if tracing._is_device(e):
                reading.annotations += 1
                continue
            a, b = tracing._ns(e, "start"), tracing._ns(e, "end")
            if b >= s0 and a <= s1:
                reading.program.append(
                    (e.name(), (max(a, s0) - s0) * 1e-9,
                     (min(b, s1) - s0) * 1e-9))
        return reading


def split(r, factor=None) -> dict:
    """The program's spans in reading ``r``; ``factor`` gives a frames
    cell's HR bytes from its LR pixels (a request cell counts HR pixels
    itself)."""
    def tot(name):
        return sum(e - s for n, s, e in r.program if n == PRE + name)

    names = sorted({n for n, _, _ in r.program})
    out = {"spans": {n: [sum(1 for m, _, _ in r.program if m == n),
                         tot(n[len(PRE):])] for n in names},
           "slice_s": r.slice_s, "kernels_named_rusty_sr":
               sum(1 for n, _, _ in r.kernels + r.copies
                   if n.startswith(PRE)),
           "device_annotations": r.annotations}
    scatter_s = tot("chunk.scatter") - tot("batch.on_image_done")
    hr_px = (r.counts.get("hr_px")
             or r.counts.get("lr_px", 0) * (factor or 0) ** 2)
    out.update(scatter_fallbacks=sum(1 for n, _, _ in r.program
                                     if n == PRE + "scatter.fallback"),
               scatter_gb_s=(3 * hr_px / scatter_s / 1e9
                             if hr_px and scatter_s > 0 else None))
    pct = (lambda s: 100.0 * s / r.slice_s) if r.slice_s > 0 else None
    if pct and r.counts.get("calls"):
        out.update(
            gather_pct=pct(tot("chunk.gather")),
            scatter_pct=pct(scatter_s),
            launch_pct=pct(tot("chunk.launch")),
            outputs_pct=pct(tot("tiled.outputs")),
            card_wait_pct=pct(tot("chunk.slot_wait")
                              + tot("chunk.fetch_wait")),
            slice_s_per_call=r.slice_s / r.counts["calls"])
    stages = {k: tot("swinir." + k) for k in ("embed", "rstb", "upsample")}
    if pct and any(stages.values()):
        frames = r.counts.get("frames", 0)
        out.update(
            swinir_pct={k: pct(v) for k, v in stages.items()},
            swinir_ms_per_frame={k: 1e3 * v / frames
                                 for k, v in stages.items()}
            if frames else None,
            swinir_groups=sum(1 for m, _, _ in r.program
                              if m == PRE + "swinir.rstb"),
            swinir_norm_plain=sum(1 for m, _, _ in r.program
                                  if m == PRE + "swinir.norm_plain"))
    n = r.counts.get("requests", 0)
    if n:
        enc = [1 for m, _, _ in r.program if m == PRE + "codec.encode"]
        out.update(prepare_ms=1e3 * tot("tiled.prepare") / n,
                   slice_ms_per_request=1e3 * r.slice_s / n,
                   encode_mpix_s=(r.counts["hr_px"] / tot("codec.encode")
                                  / 1e6 if len(enc) == n else None))
    both = [(n, s, e) for n, s, e in r.spans] + r.program
    gaps: dict = {}
    busy = tracing.union([(s, e) for _, s, e in r.kernels])
    edges = [0.0] + [x for iv in busy for x in iv] + [r.slice_s]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, label, width = (a + b) / 2, "no span", float("inf")
        for n, s, e in both:
            if s <= mid <= e and e - s < width:
                label, width = n, e - s
        t, c = gaps.get(label, (0.0, 0))
        gaps[label] = (t + (b - a), c + 1)
    out["idle_gaps"] = sorted(([k, t, c] for k, (t, c) in gaps.items()),
                              key=lambda g: -g[1])
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", default="on",
                   help="on or off for each run, comma-separated")
    p.add_argument("--tiny", action="store_true")
    a = p.parse_args()
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, ".portbench_cache",
                                                sub))
    turns = a.spans.split(",")
    if set(turns) - {"on", "off"}:
        p.error("--spans takes on and off, comma-separated")
    tracing.Slice = KeepSlice
    from rusty_sr_tpu_torch.models import swinir
    from rusty_sr_tpu_torch.parallel import tiling
    from rusty_sr_tpu_torch.utils import imageio, native, profiling
    sites = (tiling, native, imageio, swinir)
    kw = {}
    if a.tiny:
        sys.path.insert(0, os.path.join(ROOT, "portbench", "tests"))
        from conftest import TINY
        first = {"trace_first_call": 0, "trace_calls": 1,
                 "trace_first_request": 0, "trace_requests": 1}
        kw = dict(device="cpu",
                  traffic_overrides={**TINY[a.workload], **first})
    got = {}
    real = harness.load_module

    def load_module(kind, name):        # keeps the mix's output
        mod = real(kind, name)
        if kind == "mixes":
            run = mod.run

            def run_and_keep(ctx):
                got.update(run(ctx))
                return got
            mod.run = run_and_keep
        return mod

    harness.load_module = load_module
    import torch
    factor = harness.cell_files(harness.benchmark(),
                                a.workload)[1]["factor"]
    for turn in turns:
        for mod in sites:
            mod.span = profiling.span if turn == "on" else (
                lambda name: profiling._NULL)
        result = harness.run_cell(a.workload, a.seed, a.seconds, True, **kw)
        result.update(spans=turn, seed=a.seed, torch=torch.__version__,
                      split=split(got["reading"], factor))
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
