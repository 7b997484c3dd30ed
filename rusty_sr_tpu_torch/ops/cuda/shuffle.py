"""The tile paths' output epilogue, and depth-to-space in the reference's
(fy, fx, c) order.

Counterpart of `rusty_sr_tpu/ops/pallas/shuffle.py::depth_to_space_pallas`.
Two wrappers run the hand-written CUDA kernel `csrc/shuffle.cu`:

- `epilogue_cuda`: the halo crop of ``expand`` read in place, plus the
  LR-space bilinear base computed inside the kernel from the edge tiles
  (u8 or f32), the u8 quantisation ``floor(clip(v, 0, 1) * 255 + 0.5)``,
  then depth-to-space (the xla engine's exact and flat fast tiers, and
  the fused engine at crop offset 0); or, for the packed fast tier, the
  quantisation, 2x2 unpack, crop and depth-to-space of the f32 packed sum;
- `depth_to_space_cuda`: the plain rearrangement, f32 or u8 (the bilinear
  mode).

Each takes its plain PyTorch version on CPU tensors and launches the
kernel on CUDA tensors; on any other device, or on a build or launch
failure, it raises.  The kernel is byte-identical to the plain versions:
both compute the base with the same f32 products and sums in the same
order, add it with one f32 add and quantise with the same arithmetic.
`LAUNCHES` and `EPILOGUE_LAUNCHES` count the launches of each wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from rusty_sr_tpu_torch.ops.cuda.trunk import HALO
from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
from rusty_sr_tpu_torch.ops.resize import bilinear_phases_cropped

# The largest factor of the kernel's forms with a base (its phase table).
MAX_BASE_FACTOR = 8

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


def depth_to_space_reference(x: torch.Tensor, factor: int) -> torch.Tensor:
    """The plain version: (N,H,W,f*f*C) -> (N,f*H,f*W,C)."""
    return depth_to_space(x, factor)


def edge_to_f32(edge: torch.Tensor) -> torch.Tensor:
    """Edge tiles as the base reads them: u8 values times f32(1/255)."""
    return edge.float() * (1.0 / 255.0) if edge.dtype == torch.uint8 \
        else edge


def epilogue_reference(x: torch.Tensor, factor: int, tile: int,
                       offset: int, edge: torch.Tensor | None = None,
                       edge_offset: int = HALO, to_u8: bool = False,
                       packed: bool = False) -> torch.Tensor:
    """The plain version of `epilogue_cuda`, step by step as the JAX tile
    kernels take them: the base ``bilinear_phases_cropped(edge, factor,
    edge_offset, edge_offset, tile)`` (u8 edge tiles times f32(1/255)
    first) plus ``x[:, o:o+tile, o:o+tile]`` (x unpacked first if
    ``packed``), quantised if ``to_u8``, then depth-to-space."""
    if packed:
        x = unpack_s2d(x)
    t = x[:, offset:offset + tile, offset:offset + tile, :]
    if edge is not None:
        t = bilinear_phases_cropped(edge_to_f32(edge), factor, edge_offset,
                                    edge_offset, tile) + t
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


def _phases(ch: int, f: int) -> int:
    """C of f*f*C channels, or raise."""
    if f < 1 or ch == 0 or ch % (f * f):
        raise ValueError(f"{ch} channels do not split into factor {f}^2 "
                         "phases")
    return ch // (f * f)


def depth_to_space_cuda(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``depth_to_space(x, factor)`` for (N,H,W,f*f*C) x of float32 or
    uint8.

    CPU tensors take `depth_to_space_reference`; CUDA tensors launch the
    kernel on the current stream (no synchronisation)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return depth_to_space_reference(x, factor)
    _check_device(x, "depth_to_space_cuda")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, f*f*C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or uint8")
    n, h, w, cff = x.shape
    f = int(factor)
    c = _phases(cff, f)
    out = torch.empty((n, f * h, f * w, c), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        lib, stream = _launch_setup(x)
        rc = lib.srt_depth_to_space(x.data_ptr(), out.data_ptr(),
                                    int(x.dtype == torch.uint8), n, h, w, c,
                                    f, stream)
    _raise_on(lib, rc, "depth-to-space")
    LAUNCHES += 1
    return out


def _check_edge(x: torch.Tensor, edge: torch.Tensor, n: int, c: int, f: int,
                tile: int, edge_offset: int) -> None:
    if edge.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"edge has dtype {edge.dtype}, expected uint8 or "
                        "float32")
    if edge.device != x.device:
        raise ValueError(f"edge is on {edge.device}, x on {x.device}")
    if edge.dim() != 4 or edge.shape[0] != n or edge.shape[3] != c:
        raise ValueError(f"edge has shape {tuple(edge.shape)}, expected "
                         f"({n}, H, W, {c})")
    if edge_offset < 1 or edge_offset + tile + 1 > min(edge.shape[1:3]):
        raise ValueError(
            f"the base's {tile}-pixel window at {edge_offset} needs one "
            f"pixel of margin in {edge.shape[1]}x{edge.shape[2]} edge tiles")
    if f > MAX_BASE_FACTOR:
        raise ValueError(f"the base takes factors up to {MAX_BASE_FACTOR}, "
                         f"not {f}")
    if not edge.is_contiguous():
        raise ValueError("edge is not contiguous")


def epilogue_cuda(x: torch.Tensor, factor: int, tile: int, offset: int,
                  edge: torch.Tensor | None = None, edge_offset: int = HALO,
                  to_u8: bool = False, packed: bool = False) -> torch.Tensor:
    """The tile epilogue: float32 ``x`` (N, S, S, f*f*C) and the edge
    tiles ``edge`` (N, E, E, C), uint8 or float32, or None (no base) ->
    (N, f*tile, f*tile, C), uint8 if ``to_u8`` else float32; or, with
    ``packed``, float32 ``x`` (N, S/2, S/2, 4*f*f*C), no edge tiles,
    uint8 out.  The base's window needs one pixel of margin in the edge
    tiles (``edge_offset >= 1``, ``edge_offset + tile + 1 <= E``); the
    tiles' halo gives it.  See `epilogue_reference`.

    CPU tensors take `epilogue_reference`; CUDA tensors launch the kernel
    on the current stream (no synchronisation)."""
    global EPILOGUE_LAUNCHES
    if x.dim() != 4:
        raise ValueError(f"x must be 4-d, got {tuple(x.shape)}")
    n, xh, xw, ch = x.shape
    f = int(factor)
    if packed:
        if edge is not None or not to_u8:
            raise ValueError("the packed epilogue takes no edge tiles and "
                             "writes uint8")
        if ch % 4:
            raise ValueError(f"{ch} packed channels are not 4 sub-pixel "
                             "blocks")
        xh, xw, ch = 2 * xh, 2 * xw, ch // 4
    c = _phases(ch, f)
    if tile < 1 or offset < 0 or offset + tile > min(xh, xw):
        raise ValueError(f"a {tile}-pixel window at {offset} does not fit "
                         f"in {xh}x{xw} pixels")
    if edge is not None:
        _check_edge(x, edge, n, c, f, tile, edge_offset)
    if x.device.type == "cpu":
        return epilogue_reference(x, factor, tile, offset, edge, edge_offset,
                                  to_u8, packed)
    _check_device(x, "epilogue_cuda")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected float32")
    out = torch.empty((n, f * tile, f * tile, c), device=x.device,
                      dtype=torch.uint8 if to_u8 else torch.float32)
    if out.numel() == 0:
        return out
    kind = 0 if edge is None else 1 if edge.dtype == torch.uint8 else 2
    eh, ew = (0, 0) if edge is None else edge.shape[1:3]
    with torch.cuda.device(x.device):
        lib, stream = _launch_setup(x)
        rc = lib.srt_epilogue(x.data_ptr(),
                              None if edge is None else edge.data_ptr(),
                              kind, out.data_ptr(), int(to_u8), int(packed),
                              n, xh, xw, offset, tile, eh, ew, edge_offset,
                              c, f, stream)
    _raise_on(lib, rc, "epilogue")
    EPILOGUE_LAUNCHES += 1
    return out
