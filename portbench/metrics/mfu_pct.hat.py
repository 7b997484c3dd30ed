"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s),
in %: HAT's useful FLOP per LR pixel (`hat_flops.py`: 50,722,776 for HAT
x4, no reflect padding) times the LR pixels of the frames delivered in
the traced slice (whole `upscale_batch` calls), over the slice's seconds.
None where the slice counted no frame.  The result line carries the
card's power limit beside it."""

from portbench import flops, hat_flops


def read(r):
    px = r.counts.get("lr_px", 0)
    if r.slice_s <= 0 or px <= 0:
        return None
    work = hat_flops.forward_flop_per_lr_px(r.config) * px
    return 100.0 * work / r.slice_s / flops.PEAKS["bf16_flop_s"]
