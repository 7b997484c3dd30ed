"""The yardstick's work counts and the card's peaks.

Every count here is the work the network needs, whatever implements it:
the reference's convolutions at their published widths, each input and
weight read once and each output written once.  A kernel that computes
more (zero taps of a space-to-depth packing, padded channels) does not
get credit for it, so a roofline share or an MFU from these counts never
passes 100% unless the time leaves out part of the work.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
# data sheet, dense rates).
PEAKS = {
    "bf16_flop_s": 989e12,
    "tf32_flop_s": 495e12,
    "f32_flop_s": 67e12,
    "hbm_bytes_s": 3.35e12,
}

HALO = 7     # the trunk's receptive-field radius in LR pixels


def expansion(cfg: dict) -> int:
    """e = channels * factor^2, the expansion convolutions' width."""
    return cfg["channels"] * cfg["factor"] ** 2


def convolutions(cfg: dict) -> list:
    """(name, k, c_in, c_out) of the ten convolutions of the reference's
    network (SURVEY.md section 2.3)."""
    n, c, e = cfg["width"], cfg["channels"], expansion(cfg)
    k0, k1, k3 = cfg["conv0_kernel"], cfg["conv1_3_kernel"], \
        cfg["conv5_10_kernel"]
    return [("conv0", k0, c, n),
            ("conv1", k1, n, n), ("conv2", k1, n, n), ("conv3", k1, n, n),
            ("conv5", k3, n, n), ("conv6", k3, n, n), ("conv8", k3, n, n),
            ("conv7", k3, n, e), ("conv9", k3, n, e), ("conv10", k3, n, e)]


def conv_weights(cfg: dict) -> int:
    """Multiply-adds per LR pixel: 130,176 at x3, 148,320 at x4."""
    return sum(k * k * ci * co for _, k, ci, co in convolutions(cfg))


def forward_flop_per_lr_px(cfg: dict) -> int:
    """Useful FLOP of one forward pass per LR pixel (2 per multiply-add):
    260,352 at x3, 296,640 at x4."""
    return 2 * conv_weights(cfg)


def step_flops(batch: int, crop: int, packed: bool, n: int = 32,
               e: int = 27, factor: int = 3) -> float:
    """Operations of one training step's convolutions: the forward's
    2 * pixels * sum(k^2 * Cin * Cout) at the LR side crop/factor, and
    twice that again for the backward (input and weight gradients;
    conv0's input gradient, which is not needed, included).  The packed
    trunk runs every conv as 3x3 taps over the 2x2 space-to-depth grid,
    which counts the zero taps too: 144/100 of a 5x5 conv's products and
    144/36 of a 3x3's.  (A copy of `chip_smoke.py::step_flops`, with the
    factor as an argument.)"""
    taps = ((25, 3, n), (25, n, 3 * n), (9, n, 2 * n + e), (9, n, n + e),
            (9, n, e))
    px = batch * (crop // factor) ** 2
    if packed:
        macs = sum(144 / 4 * ci * co for _, ci, co in taps)
    else:
        macs = sum(k * ci * co for k, ci, co in taps)
    return 3 * 2.0 * px * macs


def merged_stages(cfg: dict) -> list:
    """The trunk as the merged convolutions every fast tier runs (conv0,
    convA = conv1|2|3, convB = conv5|6|7, convC = conv8|9, conv10): (name,
    k, c_in, c_out, in_bytes, out_bytes) with the fast tier's stated types
    (u8 tiles into conv0, bf16 activations, the f32 sum out of conv10)."""
    n, c, e = cfg["width"], cfg["channels"], expansion(cfg)
    k0, k1, k3 = cfg["conv0_kernel"], cfg["conv1_3_kernel"], \
        cfg["conv5_10_kernel"]
    return [("conv0", k0, c, n, 1, 2), ("convA", k1, n, 3 * n, 2, 2),
            ("convB", k3, n, 2 * n + e, 2, 2), ("convC", k3, n, n + e, 2, 2),
            ("conv10", k3, n, e, 2, 4)]


def stage_bound_s(px: int, k: int, c_in: int, c_out: int, in_b: int,
                  out_b: int, flop_s: float = PEAKS["bf16_flop_s"]) -> float:
    """Least seconds for one stage over ``px`` pixels: the larger of its
    FLOP at ``flop_s`` and its bytes (input and bf16 weights read once,
    output written once) at the HBM rate."""
    flop = 2.0 * px * k * k * c_in * c_out
    byt = px * c_in * in_b + k * k * c_in * c_out * 2 + px * c_out * out_b
    return max(flop / flop_s, byt / PEAKS["hbm_bytes_s"])


def trunk_bound_s(cfg: dict, padded_px: int) -> float:
    """The sum of the trunk stages' bounds over ``padded_px`` pixels of
    padded tiles."""
    return sum(stage_bound_s(padded_px, k, ci, co, ib, ob)
               for _, k, ci, co, ib, ob in merged_stages(cfg))


def epilogue_bound_s(cfg: dict, n_tiles: int, tile: int) -> float:
    """Least seconds for the output epilogue over ``n_tiles`` tiles: the
    f32 expansion sum of each tile's own ``tile`` x ``tile`` window in
    (the halo around it is not read), its HR u8 tile out (a pure byte
    mover).  The packed form, which the fast tier runs, takes the base
    inside that sum; a form that also reads edge tiles for the base does
    more than this counts, and reads lower."""
    f = cfg["factor"]
    byt = n_tiles * (tile * tile * expansion(cfg) * 4
                     + (tile * f) ** 2 * cfg["channels"])
    return byt / PEAKS["hbm_bytes_s"]


def tiles_per_image(h: int, w: int, tile: int) -> int:
    """Tiles of one LR image: the grid `tiled_sr` cuts."""
    return max(1, -(-h // tile)) * max(1, -(-w // tile))


def chunks(n_tiles: int, chunk: int) -> int:
    """Chunks of ``chunk`` tiles for ``n_tiles`` (the last one padded)."""
    return -(-n_tiles // chunk)
