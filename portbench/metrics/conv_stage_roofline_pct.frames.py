"""The trunk's conv-stage kernels' share of their roofline, in %: the
sum over the traced slice's chunks (whole `upscale_batch` calls) of each
merged trunk stage's bound (`flops.trunk_bound_s`: the larger of the
stage's useful FLOP over the chunk's padded tiles at 989 TFLOP/s and
its bytes at 3.35 TB/s), over the summed device time of the kernels
whose name matches ``PATTERN`` (`csrc/conv_stage.cu`).  None where no
kernel matches: a renamed or removed kernel reads null until a
benchmark change repoints the pattern."""

import re

from portbench import flops

PATTERN = re.compile(r"\bconv_stage_kernel\b")


def read(r):
    t = r.kernel_s(PATTERN)
    px = r.counts.get("padded_px", 0)
    if t <= 0 or px <= 0:
        return None
    return 100.0 * flops.trunk_bound_s(r.config, px) / t
