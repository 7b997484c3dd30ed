"""Same-padded 2-D convolution (cross-correlation), NHWC / HWIO.

Precision: a float32 convolution on the card goes through cuDNN, which
by default may run it in TF32 (about three decimal digits) — the Hopper
form of the TPU's DEFAULT-precision trap described in
`rusty_sr_tpu/ops/conv.py`.  A float32 convolution here runs inside
`exact_f32`, which turns TF32 off for cuDNN and for cuBLAS matmuls.
Autograd runs the backward convolutions later, outside any context the
forward entered, so a training step enters `exact_f32` around its
backward pass too (`train.loop`).

bfloat16 operands mean what they mean in the JAX package: one rounding
of each operand, exact products, float32 accumulation and a float32
result (``preferred_element_type=f32``).  The convolution then runs on
the operands' float32 values, whose products TF32 represents exactly.
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


@contextlib.contextmanager
def tf32_on_bf16():
    """cuDNN may use TF32: the convolutions inside take bfloat16-valued
    float32 operands, which TF32 holds exactly (8 of its 11 significant
    bits), so the forward products stay exact and the sums float32."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=True):
        yield


def conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (N,H,W,Cin); w: (kh,kw,Cin,Cout) HWIO. Stride 1, zero-pad Same.

    float32 (or float64) operands: an exact convolution in their type
    (TF32 off).  bfloat16 operands: float32 out, the JAX package's bf16
    convolution — the convolution of their float32 values, under
    `tf32_on_bf16`; the gradients with respect to the bfloat16 operands
    come back rounded to bfloat16, as JAX's do."""
    kh, kw = w.shape[0], w.shape[1]
    x, w = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if x.dtype != w.dtype:
        raise ValueError(f"conv2d_same takes operands of one type, not "
                         f"{x.dtype} and {w.dtype}")
    if x.dtype == torch.bfloat16:
        with tf32_on_bf16():
            y = F.conv2d(x.float(), w.float(), padding=(kh // 2, kw // 2))
    else:
        with exact_f32():
            y = F.conv2d(x, w, padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def im2col_patches(xp: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(N, H+kh-1, W+kw-1, Cin) padded tensor -> (N, H, W, kh*kw*Cin)
    patches in (row offset, column offset, channel) order, the order of
    HWIO ``w.reshape(kh*kw*cin, cout)``: `rusty_sr_tpu/ops/conv.py::
    im2col_patches`, any dtype (the int8 trunk quantises between the pad
    and the patches)."""
    n, hp, wp, cin = xp.shape
    h, wd = hp - (kh - 1), wp - (kw - 1)
    return torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                      for dy in range(kh) for dx in range(kw)], dim=-1)


class _Bf16Conv(torch.autograd.Function):
    """`conv2d_bf16` on NCHW / OIHW operands of any float type: the
    convolution of float32 tensors holding their bfloat16 values, and its
    backward pass as autograd would run it on them (one
    ``convolution_backward`` on the saved tensors), the gradients given
    back in the operands' types, unrounded."""

    @staticmethod
    def forward(ctx, x, w):
        xf = x.to(torch.bfloat16).float()
        wf = w.to(torch.bfloat16).float()
        ctx.save_for_backward(xf, wf)
        ctx.types = (x.dtype, w.dtype)
        with tf32_on_bf16():
            return F.conv2d(xf, wf, padding=(w.shape[2] // 2, w.shape[3] // 2))

    @staticmethod
    def backward(ctx, g):
        xf, wf = ctx.saved_tensors
        with tf32_on_bf16():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, xf, wf, None, [1, 1], [wf.shape[2] // 2, wf.shape[3] // 2],
                [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return (None if dx is None else dx.to(ctx.types[0]),
                None if dw is None else dw.to(ctx.types[1]))


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-conv of ``x`` (N,H,W,Cin) and HWIO ``w``, both rounded to
    bfloat16, float32 out: `conv2d_same` on the two casts, the JAX
    package's bf16 convolution.  Its gradients come back unrounded, in the
    operands' types (the casts' own gradients would round each to
    bfloat16): the input gradient, so that a spatial shard's halo rows,
    whose gradient another rank completes through the weights', carry no
    rounding that one process would not make; the weight gradient, so
    that a training step rounds the sum of a weight's gradients once,
    after a mesh's all-reduce (`train.loop.bf16_grad_leaves`)."""
    y = _Bf16Conv.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


class _SplitPrecise(torch.autograd.Function):
    """The three-term split convolution; its gradient is that of the
    plain bfloat16-cast convolution (the JAX op's custom VJP)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        hi, lo = bf16_split(h)
        w_hi, w_lo = bf16_split(w)
        return conv2d_same(torch.cat([hi, hi, lo], dim=-1),
                           torch.cat([w_hi, w_lo, w_hi], dim=2))

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        with torch.enable_grad():
            h_ = h.detach().requires_grad_(True)
            w_ = w.detach().requires_grad_(True)
            y = conv2d_same(h_.to(torch.bfloat16), w_.to(torch.bfloat16))
            return torch.autograd.grad(y, (h_, w_), g)


def conv_split_precise(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-conv of float32 ``h`` and HWIO ``w`` through the three-term
    bf16 split of both (hi*w_hi + hi*w_lo + lo*w_hi as one widened
    convolution), float32 out: `rusty_sr_tpu/ops/conv.py::
    conv_split_precise`.  Differentiable: the backward pass is the
    gradient of ``conv2d_same(h.bf16, w.bf16)``, as the JAX op's custom
    VJP is (the split refines the forward value only)."""
    return _SplitPrecise.apply(h, w)


def _bf16_3(a: torch.Tensor, b: torch.Tensor, dim_a: int, dim_b: int):
    """The three-term split of a product's operands, widened along the
    axis that the product sums over: (a_hi, a_hi, a_lo) along ``dim_a``
    and (b_hi, b_lo, b_hi) along ``dim_b``, as float32 tensors holding
    bfloat16 values."""
    a_hi, a_lo = bf16_split(a)
    b_hi, b_lo = bf16_split(b)
    return (torch.cat([a_hi, a_hi, a_lo], dim=dim_a).float(),
            torch.cat([b_hi, b_lo, b_hi], dim=dim_b).float())


class _Bf16x3(torch.autograd.Function):
    """`conv2d_bf16x3` on NCHW / OIHW operands.  Each product, the forward
    one and both of the backward pass, is hi*hi + hi*lo + lo*hi of its
    two operands' bf16 splits, run as one convolution widened threefold
    along the axis it sums over, under `tf32_on_bf16`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with tf32_on_bf16():
            xs, ws = _bf16_3(x, w, 1, 1)
            return F.conv2d(xs, ws, padding=(w.shape[2] // 2,
                                             w.shape[3] // 2))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pad = (w.shape[2] // 2, w.shape[3] // 2)
        dx = dw = None
        with tf32_on_bf16():
            if ctx.needs_input_grad[0]:
                gs, ws = _bf16_3(g, w, 1, 0)       # sum over the outputs
                dx = torch.nn.grad.conv2d_input(x.shape, ws, gs,
                                                padding=pad)
            if ctx.needs_input_grad[1]:
                xs, gs = _bf16_3(x, g, 0, 0)       # sum over the batch
                dw = torch.nn.grad.conv2d_weight(xs, w.shape, gs,
                                                 padding=pad)
        return dx, dw


def conv2d_bf16x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-conv of float32 ``x`` (N,H,W,Cin) and HWIO ``w``, float32 out,
    at the JAX package's ``Precision.HIGH`` (`train --precision high`):
    both operands split into bf16 (hi, lo) (`bf16_split`) and the product
    taken as hi*w_hi + hi*w_lo + lo*w_hi, summed in float32, so the
    dropped lo*w_lo and the rounding of lo leave about 2^-16 of
    sum |x||w|.  The backward pass splits its products the same way, as
    JAX's transpose of a HIGH dot is HIGH: the input gradient from
    (g_hi, g_lo) x (w_hi, w_lo), the weight gradient from (x_hi, x_lo) x
    (g_hi, g_lo).  Only these convolutions enter `tf32_on_bf16` (TF32
    holds bf16 values exactly); the caller's precision stays what it
    was.  Bit operations and convolutions only: a CUDA graph can hold
    it."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"conv2d_bf16x3 takes float32 operands, not "
                         f"{x.dtype} and {w.dtype}")
    y = _Bf16x3.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)
