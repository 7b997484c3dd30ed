"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s),
in %: the configuration's useful FLOP per LR pixel (`flops.py`: the
reference's ten convolutions, no halo, no padding, no zero taps) times
the LR pixels of the frames delivered in the traced slice (whole
`upscale_batch` calls), over the slice's seconds.  The result line
carries the card's power limit beside it."""

from portbench import flops


def read(r):
    px = r.counts.get("lr_px", 0)
    if r.slice_s <= 0 or px <= 0:
        return None
    work = flops.forward_flop_per_lr_px(r.config) * px
    return 100.0 * work / r.slice_s / flops.PEAKS["bf16_flop_s"]
