"""The two-term add-and-normalise's share of its roofline in the HAT
cell, in %: its bound over the traced slice's padded tokens
(`hat_flops.add2_bound_s`: 118,800 bytes a token and frame at 3.35 TB/s,
12 C for each of the blocks + 3 * groups launches that add and 6 C for
each of the two that do not), over the summed device time of the kernels
whose name matches ``PATTERN``: the add-and-normalise kernel's two-term
instantiation (`csrc/add_layernorm.cu`, ``add_layernorm_kernel<V,
false>``).  The three-term launches are `add3_ln_roofline_pct.hat`'s.
None where no kernel matches."""

import re

from portbench import hat_flops

PATTERN = re.compile(r"\badd_layernorm_kernel<\d+, false>")


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    return 100.0 * hat_flops.add2_bound_s(r.config, n) / t
