"""The whole step's share of the card's float32 peak (67 TFLOP/s; the
exact tier runs with TF32 off), in %: the configuration's useful FLOP
per LR pixel times the LR pixels of the requests in the traced slice
(whole requests), over the slice's seconds."""

from portbench import flops


def read(r):
    px = r.counts.get("lr_px", 0)
    if r.slice_s <= 0 or px <= 0:
        return None
    work = flops.forward_flop_per_lr_px(r.config) * px
    return 100.0 * work / r.slice_s / flops.PEAKS["f32_flop_s"]
