"""The add-and-normalise kernel's share of its roofline, in %: its bound
over the traced slice's padded tokens, over the summed device time of the
kernels whose name matches ``PATTERN`` (`csrc/add_layernorm.cu`).  None
where no kernel matches.

The bound is bytes at the HBM rate (about 10 FLOP an element against 12
bytes).  Per padded token and frame SwinIR runs 2 * blocks + groups
launches that add: each reads x (f32) and y (bf16) and writes the sum
(f32) and its norm or cast (bf16), 12 C bytes; and two that do not: the
patch embedding's norm (bf16 in, f32 out) and block 0's norm1 (f32 in,
bf16 out), 6 C bytes each.  170,640 bytes a token for SwinIR-M."""

import re

from portbench.flops import PEAKS

PATTERN = re.compile(r"\badd_layernorm_kernel\b")


def bytes_per_token(cfg: dict) -> int:
    c = cfg["embed_dim"]
    adds = 2 * sum(cfg["depths"]) + len(cfg["depths"])
    return 12 * c * adds + 2 * 6 * c


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    return 100.0 * n * bytes_per_token(r.config) / PEAKS["hbm_bytes_s"] / t
