"""The work counts against hand counts."""

import json
import os

import pytest

from portbench import flops
from portbench.harness import BENCH


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name, per_px, params", [
    ("rusty_sr_x3", 260_352, 130_459), ("rusty_sr_x4", 296_640, 148_624)])
def test_forward_flop_per_lr_px(name, per_px, params):
    cfg = config(name)
    assert flops.forward_flop_per_lr_px(cfg) == per_px == \
        cfg["forward_flop_per_lr_px"]
    # weights, 8 bias and slope vectors of 32, and the expansion bias
    assert flops.conv_weights(cfg) + 8 * 32 + flops.expansion(cfg) == params


def test_step_flops_batch4_crop192():
    assert round(flops.step_flops(4, 192, False) / 1e9, 2) == 12.80
    # three passes of the forward's useful work
    cfg = config("rusty_sr_x3")
    assert flops.step_flops(4, 192, False) == \
        3 * flops.forward_flop_per_lr_px(cfg) * 4 * 64 * 64


def test_merged_stages_count_the_same_work():
    for name in ("rusty_sr_x3", "rusty_sr_x4"):
        cfg = config(name)
        assert sum(k * k * ci * co for _, k, ci, co, _, _ in
                   flops.merged_stages(cfg)) == flops.conv_weights(cfg)


def test_bounds_by_hand():
    cfg = config("rusty_sr_x3")
    # convA over one 256^2 padded tile: compute-bound at the bf16 peak
    px = 256 * 256
    flop = 2 * px * 25 * 32 * 96
    assert flops.stage_bound_s(px, 5, 32, 96, 2, 2) == flop / 989e12
    # the epilogue of one tile: its 242^2 * 27 f32 window in (not the
    # halo), 726^2 * 3 u8 out
    assert flops.epilogue_bound_s(cfg, 1, 242) == \
        (242 * 242 * 27 * 4 + 726 * 726 * 3) / 3.35e12
    assert flops.tiles_per_image(720, 1280, 242) == 18
    assert flops.tiles_per_image(540, 960, 242) == 12
    assert flops.chunks(48 * 18, 24) == 36
