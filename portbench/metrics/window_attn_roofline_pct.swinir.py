"""The window-attention kernel's share of its roofline, in %: its bound
over the traced slice's padded tokens in every block
(`swinir_flops.window_attn_bound_s`: the larger of 46,080 FLOP a token
and block at 989 TFLOP/s and 1,440 bytes at 3.35 TB/s, for SwinIR-M),
over the summed device time of the kernels whose name matches
``PATTERN`` (`csrc/window_attn.cu`).  None where no kernel matches."""

import re

from portbench import swinir_flops

PATTERN = re.compile(r"\bwindow_attn_kernel\b")


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    return 100.0 * swinir_flops.window_attn_bound_s(r.config, n) / t
