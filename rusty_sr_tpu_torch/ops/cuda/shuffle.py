"""Depth-to-space in the reference's (fy, fx, c) order, with an optional
f32 addend: ``depth_to_space(x + addend, factor)`` in one pass.

Counterpart of `rusty_sr_tpu/ops/pallas/shuffle.py::depth_to_space_pallas`.
`depth_to_space_cuda` runs the hand-written CUDA kernel `csrc/shuffle.cu`
on CUDA tensors and the plain PyTorch version on CPU tensors; on any
other device, or on a build or launch failure, it raises.  The kernel
is byte-identical to the plain version: both do one f32 add per element.
`LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0


def depth_to_space_reference(x: torch.Tensor, factor: int,
                             addend: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The plain version: (N,H,W,f*f*C) -> (N,f*H,f*W,C)."""
    return depth_to_space(x if addend is None else x + addend, factor)


def depth_to_space_cuda(x: torch.Tensor, factor: int,
                        addend: torch.Tensor | None = None) -> torch.Tensor:
    """``depth_to_space(x + addend, factor)`` for (N,H,W,f*f*C) x of
    float32 or uint8; ``addend`` (float32, x's shape) needs a float32 x.

    CPU tensors take `depth_to_space_reference`; CUDA tensors launch the
    kernel on the current stream (no synchronisation)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return depth_to_space_reference(x, factor, addend)
    if x.device.type != "cuda":
        raise ValueError(f"depth_to_space_cuda runs on cpu or cuda, not "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, f*f*C), got {tuple(x.shape)}")
    n, h, w, cff = x.shape
    f = int(factor)
    if f < 1 or cff == 0 or cff % (f * f):
        raise ValueError(f"{cff} channels do not split into factor {f}^2 "
                         "phases")
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or uint8")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    if addend is not None:
        if x.dtype != torch.float32 or addend.dtype != torch.float32:
            raise TypeError("an addend needs float32 x and addend, got "
                            f"{x.dtype} and {addend.dtype}")
        if addend.device != x.device:
            raise ValueError(f"addend is on {addend.device}, x on {x.device}")
        if addend.shape != x.shape:
            raise ValueError(f"addend has shape {tuple(addend.shape)}, x "
                             f"{tuple(x.shape)}")
        if not addend.is_contiguous():
            raise ValueError("addend is not contiguous")
    c = cff // (f * f)
    out = torch.empty((n, f * h, f * w, c), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        if x.dtype == torch.float32:
            rc = lib.srt_depth_to_space_f32(
                x.data_ptr(), None if addend is None else addend.data_ptr(),
                out.data_ptr(), n, h, w, c, f, stream)
        else:
            rc = lib.srt_depth_to_space_u8(x.data_ptr(), out.data_ptr(),
                                           n, h, w, c, f, stream)
    if rc != 0:
        raise RuntimeError("depth-to-space kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out
