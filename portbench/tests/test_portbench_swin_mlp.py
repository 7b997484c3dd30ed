"""`mlp_roofline_pct.swinir`: the fused MLP kernel's share of its bound in
the SwinIR cell, against a hand count."""

import pytest

from portbench import harness
from portbench.tracing import Reading

CELL = "swinir_x4_frames_fast"


def _config():
    return harness.cell_files(harness.benchmark(), CELL)[1]


def _metric():
    return harness.load_module("metrics", "mlp_roofline_pct.swinir")


def test_mlp_bound_is_the_hand_count():
    """SwinIR-M, per padded token and block: fc1 180 -> 360 and fc2 360 ->
    180, 2 FLOP a multiply-add: 2 * (180 * 360 + 360 * 180) = 259,200;
    h read and y written in bf16: 2 * 180 * 2 = 720 bytes; 36 blocks."""
    mod, cfg = _metric(), _config()
    assert mod.flop_per_token(cfg) == 36 * 259_200
    assert mod.bytes_per_token(cfg) == 36 * 720


@pytest.mark.parametrize("kernel_s", [0.0, None])
def test_mlp_reads_none_without_the_kernel(kernel_s):
    """The parent's slice: no such kernel, or a slice with no tokens."""
    mod, cfg = _metric(), _config()
    kernels = [("other_kernel", 0.0, 0.5)]
    counts = {"tokens": 522240}
    if kernel_s is None:
        kernels.append(("void (anonymous namespace)::swin_mlp_kernel<192>("
                        "const __nv_bfloat16 *)", 0.5, 0.51))
        counts = {}
    r = Reading(1.0, kernels, [], [], counts)
    r.config = cfg
    assert mod.read(r) is None


def test_mlp_reads_the_hand_counted_share():
    """One 544 x 960 frame in 36 launches of 0.4 ms: 4.871 TFLOP at 989
    TFLOP/s, 4.925 ms, over 14.4 ms; the bytes (13.5 GB, 4.04 ms) bound
    less."""
    mod, cfg = _metric(), _config()
    kernels = [("other_kernel", 0.0, 0.5)] + [
        ("void (anonymous namespace)::swin_mlp_kernel<192>(const "
         "__nv_bfloat16 *, long long, int, int)", 0.5 + i * 0.001,
         0.5 + i * 0.001 + 0.0004) for i in range(36)]
    r = Reading(1.0, kernels, [], [], {"tokens": 522240, "lr_px": 518400})
    r.config = cfg
    flop = 522240 * 36 * 259_200
    assert flop / 989e12 > 522240 * 36 * 720 / 3.35e12
    assert mod.read(r) == pytest.approx(100 * flop / 989e12 / 0.0144,
                                        rel=1e-6)
