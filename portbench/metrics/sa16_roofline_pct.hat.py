"""The window-16 attention kernel's share of its roofline, in %: its
bound over the traced slice's padded tokens in every hybrid block
(`hat_flops.sa_bound_s`: the larger of 184,320 FLOP a token and block at
989 TFLOP/s and 1,530 bytes, q, k, v, the output and the table, at 3.35
TB/s), over the summed device time of the kernels whose name matches
``PATTERN`` (`csrc/hat_attn.cu`).  None where no kernel matches."""

import re

from portbench import hat_flops

PATTERN = re.compile(r"\bhat_sa16_kernel\b")


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    return 100.0 * hat_flops.sa_bound_s(r.config, n) / t
