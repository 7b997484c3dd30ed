"""`add_ln_roofline_pct.swinir`: the add-and-normalise kernel's share of
its byte bound in the SwinIR cell, against a hand count."""

import pytest

from portbench import harness
from portbench.tracing import Reading

CELL = "swinir_x4_frames_fast"


def _config():
    return harness.cell_files(harness.benchmark(), CELL)[1]


def test_add_ln_bound_is_the_hand_count():
    """SwinIR-M, per padded token and frame: 78 launches that add, 12 x
    180 bytes each (x f32 and y bf16 read, the sum f32 and its norm bf16
    written), and 2 that do not, 6 x 180 each (bf16 in, f32 out; f32 in,
    bf16 out)."""
    mod = harness.load_module("metrics", "add_ln_roofline_pct.swinir")
    cfg = _config()
    assert mod.bytes_per_token(cfg) == 78 * 2160 + 2 * 1080 == 170_640
    r = Reading(1.0, [("other_kernel", 0.0, 0.5)], [], [],
                {"tokens": 522240, "lr_px": 518400})
    r.config = cfg
    assert mod.read(r) is None          # the parent: no such kernel
    r = Reading(1.0, r.kernels + [
        ("void (anonymous namespace)::add_layernorm_kernel<2, 1>("
         "(anonymous namespace)::AlArgs)", 0.5, 0.54)], [], [], r.counts)
    r.config = cfg
    assert mod.read(r) == pytest.approx(
        100 * 522240 * 170_640 / 3.35e12 / 0.04, rel=1e-6)
