"""The HAT cell, `hat_x4_frames_fast`, on the CPU at the model's published
widths on small frames; its reference, its work counts and its
metrics."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import harness, hat_flops
from portbench.reference import hat as ref

CELL = "hat_x4_frames_fast"
# One 16x16 window a frame: the shift mask is live inside it and every
# overlapping key window reaches outside the frame; two frames a call in
# one group, both checked.
TINY = {"lr_height": 16, "lr_width": 16, "frames_per_call": 2,
        "frame_groups": 1, "check_frames": 2, "trace_first_call": 0}


KERNEL_METRICS = ("sa16_roofline_pct.hat", "oca_roofline_pct.hat",
                  "add3_ln_roofline_pct.hat", "mlp_roofline_pct.hat",
                  "add_ln_roofline_pct.hat")


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
    """A window of several calls, so that some frames are delivered inside
    it to be checked."""
    r = harness.run_cell(CELL, 2 ** 31 + 5, 12.0, trace, device="cpu",
                         traffic_overrides=TINY)
    assert r["correct"], (r["checks"], r["attempted"], r["failed"])
    assert r["checks"]["clipped_share"]["value"] <= 0.02
    if trace:
        assert "mfu_pct.hat" in r["metrics"]
        # no kernel runs on the CPU: the kernels' shares read nothing
        for name in KERNEL_METRICS:
            assert name not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"hr_mpix_s", "setup_s"}


def test_counts_of_a_traced_slice():
    from portbench.mixes import frames_whole_hat
    c = frames_whole_hat._counts(1, 8, 540, 960, _config())
    assert c == {"calls": 1, "frames": 8, "lr_px": 8 * 540 * 960,
                 "tokens": 8 * 544 * 960,
                 "sa_window_heads": 8 * 2040 * 6 * 36,
                 "oca_window_heads": 8 * 2040 * 6 * 6}


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


def _counted_flop_per_px(cfg, h=16, w=32):
    """FLOP of the reference's own layers at their shapes, counted by
    wrapping F.linear, F.conv2d and the attention products as the
    reference calls them, over the LR pixels of an h x w frame (whole
    windows: no padding).  The channel attention's 1x1 convolutions on
    the pooled 1x1 map are a frame's, not a pixel's, and left out, as
    `hat_flops` leaves them."""
    total = [0]
    lin, conv, mm = F.linear, F.conv2d, torch.Tensor.__matmul__

    def count_linear(x, wt, b=None):
        total[0] += 2 * x.numel() // x.shape[-1] * wt.shape[0] * wt.shape[1]
        return lin(x, wt, b)

    def count_conv(x, wt, b=None, **k):
        y = conv(x, wt, b, **k)
        if y.shape[-2:] != (1, 1):
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
    per_px = hat_flops.forward_flop_per_lr_px(cfg)
    assert per_px == cfg["forward_flop_per_lr_px"] == 50_722_776
    assert _counted_flop_per_px(cfg) == per_px
    assert hat_flops.sa_flop_per_token(cfg) == 184_320
    assert hat_flops.oca_flop_per_token(cfg) == 414_720
    assert hat_flops.attn_bytes_per_token(cfg) == 1_440
    assert hat_flops.blocks(cfg) * hat_flops.cab_flop_per_px(cfg) \
        / per_px == pytest.approx(0.276, abs=1e-3)
    assert hat_flops.blocks(cfg) * hat_flops.sa_flop_per_token(cfg) \
        / per_px == pytest.approx(0.131, abs=1e-3)
    assert hat_flops.add3_bytes_per_token(cfg) == 2_520
    assert hat_flops.add2_bytes_per_token(cfg) == 118_800
    assert hat_flops.mlp_flop_per_token(cfg) == 10_886_400


def test_add_and_mlp_counts_equal_the_programs_calls(monkeypatch):
    """The add-and-normalise and MLP calls of one fast-tier forward, by
    form, against the counts behind `add_ln_roofline_pct.hat`,
    `add3_ln_roofline_pct.hat` and `mlp_roofline_pct.hat`, on a small
    tree of 3 groups of 2 blocks."""
    from rusty_sr_tpu_torch.models import hat, swinir
    from rusty_sr_tpu_torch.ops.cuda import swin_mlp
    cfg = dict(_config(), embed_dim=24, depths=[2] * 3, num_heads=[2] * 3,
               window_size=4, squeeze_factor=6, num_feat=16)
    al, forms, mlps = swinir.add_layernorm, [], [0]
    add, mlp = al.add_layernorm, swin_mlp.swin_mlp

    def spy_add(x, y=None, norm=None, out_dtype=torch.float32, x_out=None,
                eps=1e-5, z=None, *a):
        forms.append(("three" if z is not None else
                      "two" if y is not None else "none"))
        return add(x, y, norm, out_dtype, x_out, eps, z, *a)

    def spy_mlp(*a):
        mlps[0] += 1
        return mlp(*a)

    monkeypatch.setattr(al, "add_layernorm", spy_add)
    monkeypatch.setattr(swin_mlp, "swin_mlp", spy_mlp)
    net = hat.prepare(ref.draw_weights(3, cfg), "cpu", fast=True)
    hat.forward(net, torch.zeros(1, 8, 8, 3, dtype=torch.uint8))
    blocks, groups = hat_flops.blocks(cfg), hat_flops.groups(cfg)
    assert forms.count("three") == blocks
    assert forms.count("none") == 2
    assert mlps[0] == blocks + groups
    c = cfg["embed_dim"]
    assert hat_flops.add2_bytes_per_token(cfg) == \
        12 * c * forms.count("two") + 6 * c * forms.count("none")
    assert hat_flops.mlp_flop_per_token(cfg) == \
        mlps[0] * 4 * c * c * cfg["mlp_ratio"]


def test_published_widths_and_parameters():
    cfg = _config()
    assert (cfg["embed_dim"], cfg["depths"], cfg["num_heads"],
            cfg["window_size"], cfg["overlap_ratio"], cfg["compress_ratio"],
            cfg["squeeze_factor"], cfg["conv_scale"], cfg["mlp_ratio"],
            cfg["num_feat"], cfg["upscale"]) == (
        180, [6] * 6, [6] * 6, 16, 0.5, 3, 30, 0.01, 2, 64, 4)
    assert ref.num_parameters(ref.draw_weights(0, cfg)) == \
        cfg["parameters"] == 20_772_507
    assert cfg["reduced"] == []


def test_metrics_read_nothing_without_their_kernels():
    from portbench.tracing import Reading
    cfg = _config()
    tokens = 8 * 544 * 960
    counts = {"tokens": tokens, "lr_px": 8 * 518400}
    names = KERNEL_METRICS
    r = Reading(1.0, [("other_kernel", 0.0, 0.5)], [], [], counts)
    r.config = cfg
    for name in names:
        assert harness.load_module("metrics", name).read(r) is None
    # the two-term add + norm alone: only its own share reads
    r = Reading(1.0, [("other_kernel", 0.0, 0.5),
                      ("void (anonymous namespace)::add_layernorm_kernel"
                       "<2, false>((anonymous namespace)::AlArgs)", 0.5,
                       0.6)], [], [], counts)
    r.config = cfg
    for name in names:
        got = harness.load_module("metrics", name).read(r)
        if name == "add_ln_roofline_pct.hat":
            assert got == pytest.approx(100 * tokens * 118_800 / 3.35e12
                                        / 0.1)
        else:
            assert got is None, name
    kernels = r.kernels + [
        ("void (anonymous namespace)::hat_sa16_kernel("
         "(anonymous namespace)::HaArgs)", 0.6, 0.7),
        ("void (anonymous namespace)::hat_oca_kernel("
         "(anonymous namespace)::HaArgs)", 0.7, 0.75),
        ("void (anonymous namespace)::add_layernorm_kernel<2, true>("
         "(anonymous namespace)::AlArgs)", 0.75, 0.8),
        ("void (anonymous namespace)::swin_mlp_kernel("
         "(anonymous namespace)::MlpArgs)", 0.8, 1.0)]
    r = Reading(1.0, kernels, [], [], counts)
    r.config = cfg
    read = {n: harness.load_module("metrics", n).read(r) for n in names}
    assert read["sa16_roofline_pct.hat"] == pytest.approx(
        100 * hat_flops.sa_bound_s(cfg, tokens) / 0.1)
    assert read["oca_roofline_pct.hat"] == pytest.approx(
        100 * hat_flops.oca_bound_s(cfg, tokens) / 0.05)
    assert read["add3_ln_roofline_pct.hat"] == pytest.approx(
        100 * tokens * 36 * 2520 / 3.35e12 / 0.05)
    assert read["mlp_roofline_pct.hat"] == pytest.approx(
        100 * tokens * 10_886_400 / 989e12 / 0.2)
    assert read["add_ln_roofline_pct.hat"] == pytest.approx(
        100 * tokens * 118_800 / 3.35e12 / 0.1)
    assert harness.load_module("metrics", "mfu_pct.hat").read(r) == \
        pytest.approx(100 * 50_722_776 * 8 * 518400 / 989e12)


def _in_programs_place(fn, quant, fault):
    """``api.upscale_batch`` with the reference in the program's place:
    each frame upscaled by `reference.hat` at ``quant`` or with ``fault``,
    on the weights the call was given.  A frame's answer is kept from the
    first call (the cell's warm-up), so that the calls inside the window
    deliver frames to check however slow the reference runs here."""
    done = {}

    def answer(weights, f, device):
        key = np.asarray(f).tobytes()
        if key not in done:
            done[key] = ref.upscale_u8(weights, f, _config(), device, quant,
                                       fault)
        return done[key]

    def run(frames, *, weights, on_image_done=None, device="cpu", **_):
        outs = [answer(weights, f, device) for f in frames]
        for i, out in enumerate(outs):
            if on_image_done is not None:
                on_image_done(i, out)
        return None if on_image_done is not None else outs
    return run


@pytest.mark.parametrize("control", ["fp8", "no_cab", "no_ca"])
def test_control_and_branch_faults_are_not_correct(control, two_threads,
                                                   monkeypatch):
    """The fp8 reference, and the reference without the convolution
    branch or without its gate, in the program's place: the cell's limits
    refuse each at the tiny override (the branch's faults are those that
    only the limits set from the seeded draw see)."""
    from portbench.reference import net
    from rusty_sr_tpu_torch import api
    quant = net.fp8_quant if control == "fp8" else None
    fault = None if control == "fp8" else control
    monkeypatch.setattr(api, "upscale_batch", _in_programs_place(
        api.upscale_batch, quant, fault))
    r = harness.run_cell(CELL, 2 ** 31 + 7, 6.0, False, device="cpu",
                         traffic_overrides=TINY)
    assert not r["correct"], r["checks"]
    assert all(c["value"] is not None for c in r["checks"].values())
