"""The SwinIR cell, `swinir_x4_frames_fast`, on the CPU at the model's
published widths on small frames; its reference and its work counts."""

import json
import os
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from portbench import harness, swinir_flops
from portbench.reference import swinir as ref

CELL = "swinir_x4_frames_fast"
# Small frames (a 16x24 grid of 2x3 windows, so the shift mask is live),
# two a call in one group, both checked.
TINY = {"lr_height": 16, "lr_width": 24, "frames_per_call": 2,
        "frame_groups": 1, "check_frames": 2, "trace_first_call": 0}


def _config():
    return harness.cell_files(harness.benchmark(), CELL)[1]


@pytest.fixture
def two_threads():
    """The model at its full widths on two CPU threads: several test
    workers each on every core slow a call by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_cpu_is_correct(trace, two_threads):
    """A window of several calls (about 0.5-1.5 s each), so that some
    frames are delivered inside it to be checked."""
    r = harness.run_cell(CELL, 2 ** 31 + 3, 10.0, trace, device="cpu",
                         traffic_overrides=TINY)
    assert r["correct"], (r["checks"], r["attempted"], r["failed"])
    assert r["checks"]["clipped_share"]["value"] <= 0.02
    if trace:
        assert "mfu_pct.swinir" in r["metrics"]
    else:
        assert set(r["metrics"]) == {"hr_mpix_s", "setup_s"}


def test_counts_of_a_traced_slice():
    from portbench.mixes import frames_whole
    c = frames_whole._counts(2, 16, 540, 960, _config())
    assert c == {"calls": 2, "frames": 32, "lr_px": 32 * 540 * 960,
                 "tokens": 32 * 544 * 960,
                 "window_heads": 32 * 8160 * 6 * 36}


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, %r); "
            "import portbench.reference.swinir, portbench.swinir_flops; "
            "print(json.dumps(sorted(sys.modules)))" % harness.ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    names = json.loads(p.stdout)
    assert not any(n.split(".")[0] in ("rusty_sr_tpu_torch", "rusty_sr_tpu",
                                       "jax", "jaxlib") for n in names)


def test_run_loads_no_jax():
    code = f"""
import json, sys
sys.path.insert(0, {harness.ROOT!r})
from portbench import harness
harness.run_cell({CELL!r}, 5, 1.0, False, device="cpu",
                 traffic_overrides={TINY!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "rusty_sr_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "rusty_sr_tpu"}


def _counted_flop_per_px(cfg, h=16, w=24):
    """FLOP of the reference's own layers at their shapes, counted by
    wrapping F.linear, F.conv2d and the attention products as the
    reference calls them, over the LR pixels of an h x w frame (a
    multiple of the window: no padding)."""
    total = [0]
    lin, conv, mm = F.linear, F.conv2d, torch.Tensor.__matmul__

    def count_linear(x, wt, b=None):
        total[0] += 2 * x.numel() // x.shape[-1] * wt.shape[0] * wt.shape[1]
        return lin(x, wt, b)

    def count_conv(x, wt, b=None, **k):
        y = conv(x, wt, b, **k)
        total[0] += 2 * y.numel() * wt[0].numel()
        return y

    def count_mm(a, b):
        y = mm(a, b)
        total[0] += 2 * y.numel() * a.shape[-1]
        return y

    p = ref.draw_weights(0, cfg)
    x = torch.rand(1, 3, h, w)
    try:
        F.linear, F.conv2d = count_linear, count_conv
        torch.Tensor.__matmul__ = count_mm
        with torch.no_grad():
            ref.forward(p, x, cfg)
    finally:
        F.linear, F.conv2d = lin, conv
        torch.Tensor.__matmul__ = mm
    return total[0] / (h * w)


def test_flop_counts_equal_the_references_layers(two_threads):
    cfg = _config()
    per_px = swinir_flops.forward_flop_per_lr_px(cfg)
    assert per_px == cfg["forward_flop_per_lr_px"] == 26_150_616
    assert _counted_flop_per_px(cfg) == per_px
    attn = swinir_flops.attn_flop_per_token(cfg)
    assert attn == 46_080 and swinir_flops.attn_bytes_per_token(cfg) == 1_440
    assert swinir_flops.blocks(cfg) * attn / per_px == pytest.approx(
        0.0634, abs=1e-4)


def test_published_widths_and_parameters():
    cfg = _config()
    assert (cfg["embed_dim"], cfg["depths"], cfg["num_heads"],
            cfg["window_size"], cfg["mlp_ratio"], cfg["num_feat"],
            cfg["upscale"]) == (180, [6] * 6, [6] * 6, 8, 2, 64, 4)
    assert ref.num_parameters(ref.draw_weights(0, cfg)) == \
        cfg["parameters"] == 11_900_199
    assert cfg["reduced"] == []


def test_metrics_read_nothing_without_their_kernel():
    from portbench.tracing import Reading
    r = Reading(1.0, [("other_kernel", 0.0, 0.5)], [], [],
                {"tokens": 522240, "lr_px": 518400})
    r.config = _config()
    mod = harness.load_module("metrics", "window_attn_roofline_pct.swinir")
    assert mod.read(r) is None
    r = Reading(1.0, r.kernels + [
        ("(anonymous namespace)::window_attn_kernel(WaArgs)", 0.5, 0.5081)],
        [], [], r.counts)
    r.config = _config()
    assert mod.read(r) == pytest.approx(100 * 0.008081469 / 0.0081,
                                        rel=1e-6)
    assert harness.load_module("metrics", "idle_pct.swinir").read(r) == \
        pytest.approx(100 * (1 - 0.5081))
