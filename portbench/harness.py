"""One run of one cell: find its files by name, drive it, judge it, and
print the result line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix.  The
harness reads `configs/<config>.json` (the network's sizes and its
weight file), `traffic/<traffic>.json` (the mix's parameters, and under
"driver" the general generator that reads them, `mixes/<driver>.py`)
and `limits/<cell>.json` (the limit of each number that decides
`correct`).  Each per-layer metric is `metrics/<name>.py`, whose
``read(reading)`` returns a number or None.  A new cell, configuration,
mix or metric is new files and new entries in `BENCHMARK.json`; no file
here changes for it.

A driver's ``run(ctx)`` makes its inputs from ``ctx.seed``, warms up,
calls ``ctx.open_window()``, measures for ``ctx.seconds``, calls
``ctx.close_window()`` (which reads the device's peak memory) and then
frees the program's state and compares what the window produced with
the reference.  It returns a dict: "metrics" (every end-to-end value it
measured), "attempted", "failed", "numbers" (the compared values) and,
in a traced run, "reading" (a `tracing.Reading` of its slice).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "rusty_sr_tpu")


class NoDevice(RuntimeError):
    pass


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by path (metric
    names hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, name: str) -> tuple:
    """(cell, config, traffic, limits) of the cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = load_json(os.path.join(BENCH, "configs", cell["config"] + ".json"))
    traffic = load_json(os.path.join(BENCH, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH, "limits", name + ".json"))
    return cell, config, traffic, limits


def applies(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    names compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in watts, from nvidia-smi, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Ctx:
    """What a driver gets: the run's arguments, the cell's files, spans,
    and the window's bookkeeping."""

    def __init__(self, name, seed, seconds, trace, device, config, traffic,
                 t_proc):
        from portbench.tracing import Spans
        self.cell, self.seed, self.seconds = name, seed, seconds
        self.trace, self.device = trace, device
        self.config, self.traffic = config, traffic
        self.spans = Spans(trace)
        self.t_proc = t_proc
        self.t_window = self.memory_peak = None

    def weights_path(self) -> str:
        return os.path.join(ROOT, self.config["weights"])

    def cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def reset_peak(self) -> None:
        """Forget the inputs' allocations: the peak is the program's."""
        if self.cuda():
            import torch
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def open_window(self) -> float:
        self.t_window = time.perf_counter()
        return self.t_window

    def close_window(self) -> None:
        if self.cuda():
            import torch
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def release(self) -> None:
        """After the program's state is dropped: the reference's room."""
        import gc
        gc.collect()
        if self.cuda():
            import torch
            torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_proc=None, traffic_overrides=None,
             bench=None, numbers_out=None) -> dict:
    """Run cell ``name`` once; returns the result line's object.  A dict
    ``numbers_out`` receives every reading of the comparison, compared
    or not."""
    from portbench.reference.check import judge

    t_proc = time.perf_counter() if t_proc is None else t_proc
    bench = bench or benchmark()
    cell, config, traffic, limits = cell_files(bench, name)
    traffic = {**traffic, **(traffic_overrides or {})}
    kind = count = None
    if str(device).startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {cell['chips']}")
        kind, count = torch.cuda.get_device_name(0), cell["chips"]
    ctx = Ctx(name, seed, seconds, trace, device, config, traffic, t_proc)
    mix = load_module("mixes", traffic["driver"])
    out = mix.run(ctx)

    if numbers_out is not None:
        numbers_out.update(out["numbers"])
    ok, checks = judge(out["numbers"], limits)
    correct = bool(ok and out["failed"] == 0)
    metrics = {}
    if not trace:
        e2e = [m for m in bench["end_to_end"] if applies(m, name)]
        vals = dict(out["metrics"], setup_s=ctx.t_window - t_proc)
        for m in e2e:
            if vals.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": vals[m["name"]],
                                      "unit": m["unit"]}
    device_info = {"platform": "gpu" if kind else str(device),
                   "kind": kind or str(device), "count": count or 1,
                   "memory_peak_bytes": ctx.memory_peak or 0}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if trace:
        reading = out["reading"]
        reading.config, reading.traffic = config, traffic
        reading.power_limit_w = power_limit_w() if kind else None
        e2e_names = {m["name"] for m in bench["end_to_end"]
                     if applies(m, name)}
        for m in bench["per_layer"]:
            if not applies(m, name, e2e_names):
                continue
            v = load_module("metrics", m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = reading.busy_s
        device_info["window_s"] = reading.slice_s
        result["breakdown"] = reading.breakdown()
        result["power_limit_w"] = reading.power_limit_w
    result["checks"] = checks
    return result


def main(argv=None, t_proc=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                "once on the card and print its result.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seed < 0:
        p.error("--seed must be a whole number >= 0")
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                          t_proc=t_proc)
    except NoDevice as e:
        print(f"portbench: no card for this cell: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return 3
    for k, row in result["checks"].items():
        print(f"check {k}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
