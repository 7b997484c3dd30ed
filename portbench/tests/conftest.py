"""The benchmark's own tests, on the CPU at tiny sizes:

    python -m pytest portbench/tests -q

Nothing here imports JAX.  Tests marked ``cuda`` need a card and skip
without one (each decides inside the test)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Each cell's traffic cut to what the CPU runs in a second or two; the
# widths, weights and code paths are the cells' own.
TINY = {
    "x3_frames_fast": {"lr_height": 40, "lr_width": 50, "frames_per_call": 3,
                       "tile": 16, "chunk": 4},
    "x4_frames_fast": {"lr_height": 30, "lr_width": 40, "frames_per_call": 3,
                       "tile": 16, "chunk": 4},
    "x3_requests_exact": {"sizes": [[20, 30], [30, 40]], "images_per_size": 2,
                          "tile": 16, "chunk": 4, "check_share": 0.5,
                          "trace_first_request": 1, "trace_requests": 3},
    "x3_train_amp_b32": {"images": 4, "image_height": 64, "image_width": 80,
                         "crop": 24, "batch": 4, "warmup_steps": 10,
                         "trace_skip": 0, "trace_steps": 10},
}


# Cells kept out of BENCHMARK.json until their runs are steady enough to
# bound (PERF.md section 7), with the entries that bring each back: their
# files stay under the benchmark and stay tested.  ``reports``: metrics
# already in BENCHMARK.json that such a cell reports too.
LATER = {
    "workloads": [
        {"name": "x3_frames_fast", "config": "rusty_sr_x3",
         "traffic": "frames_720p_fast", "chips": 1,
         "why": "1280x720 to 4K frames, 48 a upscale_batch call back to "
                "back: fast-tier chunk loop, packed conv stages and "
                "epilogue; 18 tiles a frame, 87% useful"},
        {"name": "x3_train_amp_b32", "config": "rusty_sr_x3",
         "traffic": "train_amp_crop192_b32", "chips": 1,
         "why": "train --amp from init (resumed at step 10: grouped "
                "uploads), crop 192, batch 32, .rsr every 100 steps: graphed "
                "cuDNN bf16 step, 2-worker crop feed over 64 PNGs"},
    ],
    "end_to_end": [
        {"name": "train_samples_s", "unit": "samples/s", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["x3_train_amp_b32"]},
    ],
    "per_layer": [
        {"name": "idle_pct.train", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "train_samples_s", "workloads": ["x3_train_amp_b32"]},
        {"name": "mfu_pct.train", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "model step",
         "moves": "train_samples_s", "workloads": ["x3_train_amp_b32"]},
        {"name": "feed_wait_pct.train", "unit": "%", "better": "lower",
         "source": "program_span", "layer": "crop feed",
         "moves": "train_samples_s", "workloads": ["x3_train_amp_b32"]},
    ],
    "reports": {
        "x3_frames_fast": ["hr_mpix_s", "idle_pct.frames", "mfu_pct.frames",
                           "conv_stage_roofline_pct.frames",
                           "epilogue_roofline_pct.frames"],
    },
}


def with_later() -> dict:
    """`BENCHMARK.json` with the cells of `LATER` added."""
    from portbench import harness
    bench = harness.benchmark()
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + LATER[key]
    for cell, names in LATER["reports"].items():
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in names:
                m["workloads"] = m["workloads"] + [cell]
    return bench


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def tiny():
    return {k: dict(v) for k, v in TINY.items()}


@pytest.fixture
def bench():
    return with_later()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here")
