"""The qkv and proj GEMMs' share of their roofline, in %: their bound over
the traced slice's padded tokens in every block, over the summed device
time of cuBLAS's GEMM kernels: names that match ``PATTERN`` (``gemm`` or
``nvjet``) and not ``CONV`` (cuDNN's convolutions, ``fprop``, ``dgrad``,
``wgrad`` or ``implicit``).  None where no kernel matches.

Per padded token and block qkv reads the normed row (C bf16) and writes
q, k and v (3C), and proj reads the attention's output (C) and writes C:
12 * C bytes, 2,160 at C = 180, against 8 * C^2 FLOP (259,200), so the
bytes at the HBM rate bound them.  Both are counted at the published C,
not at the wider rows that the program may run."""

import re

from portbench.flops import PEAKS

PATTERN = re.compile(r"gemm|nvjet", re.IGNORECASE)
CONV = re.compile(r"fprop|dgrad|wgrad|implicit", re.IGNORECASE)


def flop_per_token(cfg: dict) -> int:
    """FLOP a padded token over all the blocks: qkv (C -> 3C) and proj
    (C -> C) at 2 FLOP a multiply-add."""
    c = cfg["embed_dim"]
    return 8 * c * c * sum(cfg["depths"])


def bytes_per_token(cfg: dict) -> int:
    """Bytes a padded token over all the blocks, in bf16: qkv's input and
    output, proj's input and output."""
    c = cfg["embed_dim"]
    return 2 * (c + 3 * c + c + c) * sum(cfg["depths"])


def gemm_s(r) -> float:
    """Summed device seconds of the GEMM kernels in the slice."""
    return sum(e - s for n, s, e in r.kernels
               if PATTERN.search(n) and not CONV.search(n))


def read(r):
    t = gemm_s(r)
    n = r.counts.get("tokens", 0)
    if t <= 0 or n <= 0:
        return None
    bound = max(n * flop_per_token(r.config) / PEAKS["bf16_flop_s"],
                n * bytes_per_token(r.config) / PEAKS["hbm_bytes_s"])
    return 100.0 * bound / t
