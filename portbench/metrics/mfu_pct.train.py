"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s;
``--amp`` runs the convolutions on bf16 operands), in %: three times the
forward's useful FLOP (forward, input and weight gradients) per LR pixel
times the LR pixels of the crops stepped in the traced slice (whole
upload groups), over the slice's seconds."""

from portbench import flops


def read(r):
    px = r.counts.get("lr_px", 0)
    if r.slice_s <= 0 or px <= 0:
        return None
    work = 3 * flops.forward_flop_per_lr_px(r.config) * px
    return 100.0 * work / r.slice_s / flops.PEAKS["bf16_flop_s"]
