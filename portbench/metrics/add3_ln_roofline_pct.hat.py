"""The three-term add-and-normalise's share of its roofline, in %: its
bound over the traced slice's padded tokens in every hybrid block
(`hat_flops.add3_bound_s`: 14 C bytes a token and block, 2,520 at C =
180, at 3.35 TB/s), over the summed device time of the kernels whose
name matches ``PATTERN``: the add-and-normalise kernel's three-term
instantiation (`csrc/add_layernorm.cu`, ``add_layernorm_kernel<V,
true>``).  None where no kernel matches, as where the kernel has no
third term."""

import re

from portbench import hat_flops

PATTERN = re.compile(r"\badd_layernorm_kernel<\d+, true>")


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    return 100.0 * hat_flops.add3_bound_s(r.config, n) / t
