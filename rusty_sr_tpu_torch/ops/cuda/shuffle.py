"""Depth-to-space in the reference's (fy, fx, c) order, and the tile
paths' output epilogue around it.

Counterpart of `rusty_sr_tpu/ops/pallas/shuffle.py::depth_to_space_pallas`.
Two wrappers run the hand-written CUDA kernel `csrc/shuffle.cu`:

- `depth_to_space_cuda`: ``depth_to_space(x + addend, factor)`` in one
  pass (the fused engine's epilogue, and the bilinear mode's u8
  rearrangement);
- `epilogue_cuda`: the xla engine's epilogue — the halo crop of
  ``expand`` read in place, the bilinear base added in f32, the u8
  quantisation ``floor(clip(v, 0, 1) * 255 + 0.5)``, then depth-to-space;
  or, for the packed fast tier, the quantisation, 2x2 unpack, crop and
  depth-to-space of the f32 packed sum.

Each takes its plain PyTorch version on CPU tensors and launches the
kernel on CUDA tensors; on any other device, or on a build or launch
failure, it raises.  The kernel is byte-identical to the plain versions:
both do one f32 add per element and the same quantisation arithmetic.
`LAUNCHES` and `EPILOGUE_LAUNCHES` count the launches of each wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space

# Launches of the CUDA kernel since the counts were last set to 0, by
# `depth_to_space_cuda` and by `epilogue_cuda`.
LAUNCHES = 0
EPILOGUE_LAUNCHES = 0


def quantise_u8(x: torch.Tensor) -> torch.Tensor:
    """floor(clip(x, 0, 1) * 255 + 0.5) as uint8, the JAX package's rule."""
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def unpack_s2d(x: torch.Tensor) -> torch.Tensor:
    """(N, H/2, W/2, 4*C) block-major 2x2 space-to-depth -> (N, H, W, C):
    channel ((y % 2)*2 + x % 2)*C + c of packed pixel (y/2, x/2)."""
    n, ph, pw, c4 = x.shape
    c = c4 // 4
    return x.reshape(n, ph, pw, 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, 2 * ph, 2 * pw, c)


def depth_to_space_reference(x: torch.Tensor, factor: int,
                             addend: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The plain version: (N,H,W,f*f*C) -> (N,f*H,f*W,C)."""
    return depth_to_space(x if addend is None else x + addend, factor)


def epilogue_reference(x: torch.Tensor, factor: int, tile: int,
                       offset: int, addend: torch.Tensor | None = None,
                       to_u8: bool = False,
                       packed: bool = False) -> torch.Tensor:
    """The plain version of `epilogue_cuda`, step by step as the JAX tile
    kernels take them: ``addend + x[:, o:o+tile, o:o+tile]`` (x unpacked
    first if ``packed``), quantised if ``to_u8``, then depth-to-space."""
    if packed:
        x = unpack_s2d(x)
    t = x[:, offset:offset + tile, offset:offset + tile, :]
    if addend is not None:
        t = addend + t
    if to_u8:
        t = quantise_u8(t)
    return depth_to_space(t, factor)


def _launch_setup(x: torch.Tensor):
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    return lib, stream


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")


def _check_addend(x: torch.Tensor, addend: torch.Tensor, shape) -> None:
    if addend.dtype != torch.float32:
        raise TypeError(f"addend has dtype {addend.dtype}, expected float32")
    if addend.device != x.device:
        raise ValueError(f"addend is on {addend.device}, x on {x.device}")
    if tuple(addend.shape) != tuple(shape):
        raise ValueError(f"addend has shape {tuple(addend.shape)}, expected "
                         f"{tuple(shape)}")
    if not addend.is_contiguous():
        raise ValueError("addend is not contiguous")


def depth_to_space_cuda(x: torch.Tensor, factor: int,
                        addend: torch.Tensor | None = None) -> torch.Tensor:
    """``depth_to_space(x + addend, factor)`` for (N,H,W,f*f*C) x of
    float32 or uint8; ``addend`` (float32, x's shape) needs a float32 x.

    CPU tensors take `depth_to_space_reference`; CUDA tensors launch the
    kernel on the current stream (no synchronisation)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return depth_to_space_reference(x, factor, addend)
    _check_device(x, "depth_to_space_cuda")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, f*f*C), got {tuple(x.shape)}")
    n, h, w, cff = x.shape
    f = int(factor)
    if f < 1 or cff == 0 or cff % (f * f):
        raise ValueError(f"{cff} channels do not split into factor {f}^2 "
                         "phases")
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or uint8")
    if addend is not None:
        if x.dtype != torch.float32:
            raise TypeError(f"an addend needs a float32 x, not {x.dtype}")
        _check_addend(x, addend, x.shape)
    c = cff // (f * f)
    out = torch.empty((n, f * h, f * w, c), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        lib, stream = _launch_setup(x)
        if x.dtype == torch.float32:
            rc = lib.srt_depth_to_space_f32(
                x.data_ptr(), None if addend is None else addend.data_ptr(),
                out.data_ptr(), n, h, w, c, f, stream)
        else:
            rc = lib.srt_depth_to_space_u8(x.data_ptr(), out.data_ptr(),
                                           n, h, w, c, f, stream)
    _raise_on(lib, rc, "depth-to-space")
    LAUNCHES += 1
    return out


def epilogue_cuda(x: torch.Tensor, factor: int, tile: int, offset: int,
                  addend: torch.Tensor | None = None, to_u8: bool = False,
                  packed: bool = False) -> torch.Tensor:
    """The tile epilogue: float32 ``x`` (N, S, S, f*f*C) and ``addend``
    (N, tile, tile, f*f*C) -> (N, f*tile, f*tile, C), uint8 if ``to_u8``
    else float32; or, with ``packed``, float32 ``x`` (N, S/2, S/2,
    4*f*f*C), no addend, uint8 out.  See `epilogue_reference`.

    CPU tensors take `epilogue_reference`; CUDA tensors launch the kernel
    on the current stream (no synchronisation)."""
    global EPILOGUE_LAUNCHES
    if x.device.type == "cpu":
        return epilogue_reference(x, factor, tile, offset, addend, to_u8,
                                  packed)
    _check_device(x, "epilogue_cuda")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected float32")
    if x.dim() != 4:
        raise ValueError(f"x must be 4-d, got {tuple(x.shape)}")
    n, xh, xw, ch = x.shape
    f = int(factor)
    if packed:
        if addend is not None or not to_u8:
            raise ValueError("the packed epilogue takes no addend and "
                             "writes uint8")
        xh, xw, ch = 2 * xh, 2 * xw, ch // 4
        if x.shape[-1] % 4:
            raise ValueError(f"{x.shape[-1]} packed channels are not 4 "
                             "sub-pixel blocks")
    elif addend is None:
        raise ValueError("the flat epilogue needs the addend")
    if f < 1 or ch == 0 or ch % (f * f):
        raise ValueError(f"{ch} channels do not split into factor {f}^2 "
                         "phases")
    if tile < 1 or offset < 0 or offset + tile > min(xh, xw):
        raise ValueError(f"a {tile}-pixel window at {offset} does not fit "
                         f"in {xh}x{xw} pixels")
    if addend is not None:
        _check_addend(x, addend, (n, tile, tile, ch))
    c = ch // (f * f)
    out = torch.empty((n, f * tile, f * tile, c), device=x.device,
                      dtype=torch.uint8 if to_u8 else torch.float32)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        lib, stream = _launch_setup(x)
        if packed:
            rc = lib.srt_epilogue_packed(x.data_ptr(), out.data_ptr(), n, xh,
                                         xw, offset, tile, c, f, stream)
        else:
            rc = lib.srt_epilogue(x.data_ptr(), addend.data_ptr(),
                                  out.data_ptr(), n, xh, xw, offset, tile, c,
                                  f, int(to_u8), stream)
    _raise_on(lib, rc, "epilogue")
    EPILOGUE_LAUNCHES += 1
    return out
