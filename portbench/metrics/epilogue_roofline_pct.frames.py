"""The output epilogue kernel's share of its roofline, in %: the traced
slice's tiles (whole `upscale_batch` calls, every tile of every chunk)
at the epilogue's bytes bound (`flops.epilogue_bound_s`: the f32
expansion sum of each tile's window in, its HR u8 tile out, at 3.35 TB/s),
over the summed device time of the kernels whose name matches
``PATTERN`` (`csrc/shuffle.cu`).  None where no kernel matches."""

import re

from portbench import flops

PATTERN = re.compile(r"\bepilogue_kernel\b")


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tiles", 0)
    if t <= 0 or n <= 0:
        return None
    return 100.0 * flops.epilogue_bound_s(r.config, n,
                                          r.traffic["tile"]) / t
