"""The fused MLP kernel's share of its roofline in the HAT cell, in %:
its bound over the traced slice's padded tokens (`hat_flops.mlp_bound_s`:
4 * C * hidden FLOP a token in each hybrid block and each OCAB, 42 at the
published widths, at 989 TFLOP/s), over the summed device time of the
kernels whose name matches ``PATTERN`` (`csrc/swin_mlp.cu`).  None where
no kernel matches."""

import re

from portbench import hat_flops

PATTERN = re.compile(r"\bswin_mlp_kernel\b")


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    return 100.0 * hat_flops.mlp_bound_s(r.config, n) / t
