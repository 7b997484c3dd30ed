"""SwinIR's residual stream in one pass: an optional add, then LayerNorm
or a plain cast, on rows of C channels.

Replaces no TPU kernel (the JAX package runs no transformer).
`add_layernorm` runs the hand-written CUDA kernel `csrc/add_layernorm.cu`
on CUDA tensors, and raises for a row width the kernel refuses
(`kernel_takes`), and `add_layernorm_reference`, its plain version, on
CPU tensors.

Both take ``x`` (..., C), the f32 residual stream (or, with no ``y``, a
bf16 or f32 row), an optional ``y`` of the same shape in bf16, an
optional LayerNorm ``norm`` = (w, b) f32 (C,), the type of ``h`` (bf16 or
f32) and an optional ``x_out``, and return (s, h):

    s = x + y, written to ``x_out`` (which may be ``x`` itself: in place;
        a fresh buffer when None); s is ``x`` when no ``y`` is given
    h = LN(s) * w + b rounded once to its type, or s rounded when no
        ``norm`` is given; always a fresh tensor

The plain version is PyTorch's composition (the add, ``F.layer_norm`` on
f32, the cast); the kernel gives the same ``s`` bit for bit and ``h``
from f32 statistics summed in another order.  `LAUNCHES` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
MAX_C = 512             # 4 float4 groups a lane


def kernel_takes(x: torch.Tensor) -> bool:
    """True where the kernel takes ``x``'s rows: a CUDA tensor whose row
    width C is a multiple of 4 up to `MAX_C`."""
    c = x.shape[-1] if x.dim() else 0
    return x.device.type == "cuda" and c % 4 == 0 and 4 <= c <= MAX_C


def add_layernorm_reference(x: torch.Tensor, y=None, norm=None,
                            out_dtype=torch.bfloat16, x_out=None,
                            eps: float = 1e-5) -> tuple:
    """The plain version (see the module): PyTorch's add, ``F.layer_norm``
    on f32 and the cast, on any device and any width."""
    if y is None:
        s = x
    elif x_out is None:
        s = x + y
    else:
        s = torch.add(x, y, out=x_out)
    if norm is None:
        return s, s.to(out_dtype, copy=True)
    return s, F.layer_norm(s.float(), (s.shape[-1],), norm[0], norm[1],
                           eps).to(out_dtype)


def _check(x, y, norm, out_dtype, x_out) -> None:
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must be (..., C) with C >= 1, got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"h is bf16 or f32, not {out_dtype}")
    if y is None:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"x is f32 or bf16, not {x.dtype}")
        if x_out is not None:
            raise ValueError("x_out is written only with y")
    else:
        if x.dtype != torch.float32 or y.dtype != torch.bfloat16:
            raise TypeError(f"the add takes f32 x and bf16 y, not {x.dtype} "
                            f"and {y.dtype}")
        if y.shape != x.shape:
            raise ValueError(f"y {tuple(y.shape)} is not x's shape "
                             f"{tuple(x.shape)}")
    if x_out is not None:
        if x_out.dtype != torch.float32 or x_out.shape != x.shape:
            raise ValueError(f"x_out must be f32 {tuple(x.shape)}, got "
                             f"{x_out.dtype} {tuple(x_out.shape)}")
    ts = [x, y, x_out]
    if norm is not None:
        w, b = norm
        for t in (w, b):
            if t.dtype != torch.float32 or tuple(t.shape) != (c,):
                raise ValueError(f"the norm's weight and bias must be f32 "
                                 f"({c},), got {t.dtype} {tuple(t.shape)}")
        ts += [w, b]
    ts = [t for t in ts if t is not None]
    if any(t.device != x.device for t in ts):
        raise ValueError(f"every tensor must be on x's device {x.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, y, x_out and the norm must be contiguous")


def add_layernorm(x: torch.Tensor, y=None, norm=None,
                  out_dtype=torch.bfloat16, x_out=None,
                  eps: float = 1e-5) -> tuple:
    """(s, h) of the module's contract.  CPU tensors take
    `add_layernorm_reference`; CUDA tensors launch
    ``add_layernorm_kernel`` on the current stream (no synchronisation)
    and raise for a width that `kernel_takes` refuses."""
    global LAUNCHES
    _check(x, y, norm, out_dtype, x_out)
    if x.device.type == "cpu":
        return add_layernorm_reference(x, y, norm, out_dtype, x_out, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layernorm runs on cpu or cuda, not "
                         f"{x.device}")
    if not kernel_takes(x):
        raise ValueError(f"the kernel takes a row width that is a multiple "
                         f"of 4 up to {MAX_C}, not {x.shape[-1]}")
    if y is not None and x_out is None:
        x_out = torch.empty_like(x)
    h = torch.empty(x.shape, device=x.device, dtype=out_dtype)
    w, b = norm if norm is not None else (None, None)
    for t in (x, y, x_out, w, b, h):
        if t is not None and t.data_ptr() % (4 * t.element_size()):
            raise ValueError("every tensor must start on a 4-element "
                             "boundary")
    s = x if y is None else x_out
    if h.numel() == 0:
        return s, h
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        rc = lib.srt_add_layernorm(
            ptr(x), ptr(y), ptr(w), ptr(b), ptr(x_out), ptr(h),
            h.numel() // x.shape[-1], x.shape[-1],
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            eps, stream)
    if rc != 0:
        raise RuntimeError(f"add_layernorm kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return s, h
