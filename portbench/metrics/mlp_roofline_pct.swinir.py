"""The fused MLP kernel's share of its roofline, in %: its bound over the
traced slice's padded tokens, over the summed device time of the kernels
whose name matches ``PATTERN`` (`csrc/swin_mlp.cu`).  None where no
kernel matches.

Per padded token and block the MLP does fc1 (C -> hidden) and fc2
(hidden -> C): 4 * C * hidden FLOP, and, fused, reads h and writes y, 4 * C
bytes in bf16; hidden = C * mlp_ratio.  The bound is the larger of the
FLOP at the bf16 tensor-core rate and the bytes at the HBM rate: 259,200
FLOP against 720 bytes a token and block for SwinIR-M, so the FLOP."""

import re

from portbench.flops import PEAKS

PATTERN = re.compile(r"\bswin_mlp_kernel\b")


def flop_per_token(cfg: dict) -> int:
    """FLOP a padded token over all the blocks."""
    c = cfg["embed_dim"]
    return 4 * c * c * cfg["mlp_ratio"] * sum(cfg["depths"])


def bytes_per_token(cfg: dict) -> int:
    """Bytes a padded token over all the blocks: h read, y written."""
    return 4 * cfg["embed_dim"] * sum(cfg["depths"])


def read(r):
    t = r.kernel_s(PATTERN)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    bound = max(n * flop_per_token(r.config) / PEAKS["bf16_flop_s"],
                n * bytes_per_token(r.config) / PEAKS["hbm_bytes_s"])
    return 100.0 * bound / t
