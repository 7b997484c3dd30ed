"""Same-padded 2-D convolution (cross-correlation), NHWC / HWIO.

Precision: a float32 convolution on the card goes through cuDNN, which
by default may run it in TF32 (about three decimal digits) — the Hopper
form of the TPU's DEFAULT-precision trap described in
`rusty_sr_tpu/ops/conv.py`.  Every convolution here runs inside
`exact_f32`, which turns TF32 off for cuDNN and for cuBLAS matmuls.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32():
    """Full float32 convolutions and matmuls: TF32 off in cuDNN
    (``torch.backends.cudnn.flags(allow_tf32=False)``) and
    ``torch.backends.cuda.matmul.allow_tf32 = False``; both restored on
    exit."""
    cudnn = torch.backends.cudnn
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def bf16_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo) bfloat16 with v ~= hi + lo: hi is v rounded to
    nearest-even bf16, done in integer bits (+0x7FFF plus the tie bit,
    then the low 16 bits cleared), and lo is the rounded residual, so
    |lo| <= 2^-9 |v|.  Bit for bit the JAX package's `ops.conv.bf16_split`
    (which uses bits because XLA may fold a convert pair away).  Finite
    inputs only: the carry would corrupt Inf and NaN payloads.

    The int32 view stands in for uint32: bit 16 survives the arithmetic
    shift, and no finite value carries past bit 31."""
    v = v.to(torch.float32).contiguous()
    bits = v.view(torch.int32)
    rnd = bits + 0x7FFF + ((bits >> 16) & 1)
    hi_f = (rnd & -0x10000).view(torch.float32)
    return hi_f.to(torch.bfloat16), (v - hi_f).to(torch.bfloat16)


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (N,H,W,Cin); w: (kh,kw,Cin,Cout) HWIO. Stride 1, zero-pad Same."""
    kh, kw = w.shape[0], w.shape[1]
    with exact_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)
