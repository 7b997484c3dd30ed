"""Overlap-tile inference: any image size through fixed-shape tile chunks.

The contract of `rusty_sr_tpu/parallel/tiling.py::tiled_sr` with
``engine="fused"``, in the exact (f32) and fast (bf16) tiers, and of its
`tiled_simple`, the bilinear and downsample modes:

- The image is cut into ``tile``-sided tiles, each with a HALO-px ring
  (the trunk's receptive-field radius, 7 LR px), gathered on the host
  three ways: zero-padded (the trunk's input), edge-padded (the bilinear
  base's input, reproducing its clamp at the true border) and a {0,1}
  border mask.  The trunk multiplies every activation by the mask, so a
  tile's result equals the whole-image computation.
- Tiles run in chunks of a fixed size (the last chunk padded), and at
  most ``_MAX_INFLIGHT`` chunks are queued on the device before the
  oldest is fetched and scattered.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from rusty_sr_tpu_torch.ops.color import linear_to_srgb, srgb_to_linear
from rusty_sr_tpu_torch.ops.cuda.shuffle import depth_to_space_cuda
from rusty_sr_tpu_torch.ops.cuda.trunk import fused_trunk, pack_trunk_weights
from rusty_sr_tpu_torch.ops.resize import avg_pool, bilinear_phases_cropped
from rusty_sr_tpu_torch.utils import native

HALO = 7

_DEFAULT_CHUNK = 24     # tiles per dispatch

# Dispatched-but-unfetched chunks per call: each parked chunk holds its
# input and HR output on the device, so the window bounds device memory
# however large the image is.
_MAX_INFLIGHT = 8


def trunk_params(params) -> dict:
    """The merged-conv tree (`models.sr_net.merge_params`) restricted to
    the keys the trunk consumes; raw or merged trees are both accepted."""
    if "convA" not in params:
        from rusty_sr_tpu_torch.models.sr_net import merge_params
        params = merge_params(params)
    keys = ("conv0", "convA", "convB", "convC", "conv10",
            "f_bias", "f_belu", "l1_bias", "l1_belu", "l2_bias", "l2_belu",
            "l3_bias", "l3_belu", "expand_bias")
    return {k: params[k] for k in keys}


def _tile_kernel_fused(packed, zero_tiles, edge_tiles, mask_tiles,
                       factor: int, tile: int,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """(B, T+2h, T+2h, ·) tiles -> (B, f*T, f*T, 3) SR of the tile centres:
    the trunk in one kernel, then the LR-space bilinear base, added to it
    in f32 inside the depth-to-space kernel."""
    h = HALO
    expand = fused_trunk(packed, zero_tiles, mask_tiles, factor,
                         compute_dtype)
    base_ph = bilinear_phases_cropped(edge_tiles, factor, h, h, tile)
    return depth_to_space_cuda(expand, factor, addend=base_ph)


def tiled_sr(params, image: np.ndarray, factor: int = 3, *, tile: int = 242,
             chunk: Optional[int] = None, engine: str = "fused",
             compute_dtype: Optional[torch.dtype] = None,
             device="cuda") -> np.ndarray:
    """Upscale an (H,W,3) f32 image in [0,1] by ``factor``, any size.

    ``tile`` is the LR tile side (tile + 2*HALO is the padded side; 242
    gives 256).  ``chunk`` is the number of tiles per dispatch.  ``engine``
    is "fused", the trunk kernel, the one engine ported so far.
    ``compute_dtype`` None (or float32) is the exact tier; bfloat16 the
    fast tier, the trunk in bf16 with f32 accumulation (the bilinear base
    and the sum stay f32).  ``device`` runs the tiles there: "cuda"
    launches the kernels, "cpu" runs their plain PyTorch versions."""
    if engine != "fused":
        raise ValueError(f"engine {engine!r} is not ported yet; use 'fused'")
    cd = compute_dtype or torch.float32
    img = np.asarray(image)
    if img.dtype == np.uint8:
        raise ValueError("the fused engine takes f32 images in [0,1]; "
                         "divide uint8 pixels by 255")
    img = np.asarray(img, np.float32)
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    device = torch.device(device)
    chunk = _DEFAULT_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    packed = {k: v.to(device) for k, v in
              pack_trunk_weights(trunk_params(params), factor, cd).items()}
    hgt, wid, _ = img.shape
    h = HALO
    ny = max(1, -(-hgt // tile))
    nx = max(1, -(-wid // tile))
    n_tiles = ny * nx
    out = np.zeros((hgt * factor, wid * factor, 3), np.float32)
    pending: deque = deque()

    def drain_one():
        start, cnt, res = pending.popleft()
        native.scatter_tiles(res[:cnt].cpu().numpy(), start, nx, out)

    for start in range(0, n_tiles, chunk):
        stop = min(start + chunk, n_tiles)
        cnt = stop - start
        zb, eb, mb = native.gather_tiles_range(img, tile, h, nx, start, stop)
        if cnt < chunk:  # pad the last chunk: one shape for every chunk
            pad = ((0, chunk - cnt), (0, 0), (0, 0), (0, 0))
            zb, eb, mb = (np.pad(t, pad) for t in (zb, eb, mb))
        res = _tile_kernel_fused(
            packed, *(torch.from_numpy(t).to(device) for t in (zb, eb, mb)),
            factor, tile, cd)
        pending.append((start, cnt, res))
        if len(pending) >= _MAX_INFLIGHT:
            drain_one()
    while pending:
        drain_one()
    return out


def _quantise_u8(x: torch.Tensor) -> torch.Tensor:
    """floor(clip(x, 0, 1) * 255 + 0.5) as uint8, the JAX package's."""
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _tile_kernel_simple(edge_tiles: torch.Tensor, factor: int, tile: int,
                        mode: str, u8_io: bool) -> torch.Tensor:
    """Tile kernel for the non-neural modes, on edge-padded tiles.

    ``bilinear``: sRGB->linear -> half-pixel clamped bilinear xf ->
    linear->sRGB, the phases rearranged by the depth-to-space kernel (u8
    I/O quantises the phases first: quantisation is elementwise, so the
    order is JAX's result, and the kernel moves a quarter of the bytes).
    ``downsample``: sRGB->linear -> fxf mean pool -> linear->sRGB, on the
    tile's core (tile % factor == 0)."""
    h = HALO
    x = edge_tiles.float() * (1.0 / 255.0) if u8_io else edge_tiles
    if mode == "bilinear":
        ph = linear_to_srgb(bilinear_phases_cropped(srgb_to_linear(x),
                                                    factor, h, h, tile))
        return depth_to_space_cuda(_quantise_u8(ph) if u8_io else ph, factor)
    core = x[:, h:h + tile, h:h + tile, :]
    out = linear_to_srgb(avg_pool(srgb_to_linear(core), factor))
    return _quantise_u8(out) if u8_io else out


def _gather_edge(img: np.ndarray, tile: int, h: int, ny: int, nx: int):
    """Edge-padded tiles over the whole grid, any dtype (the bilinear and
    downsample kernels use neither zero-padded tiles nor masks)."""
    hgt, wid, ch = img.shape
    pad = ((h, h + ny * tile - hgt), (h, h + nx * tile - wid), (0, 0))
    edge_img = np.pad(img, pad, mode="edge")
    side = tile + 2 * h
    et = np.empty((ny * nx, side, side, ch), img.dtype)
    for k in range(ny * nx):
        y0, x0 = (k // nx) * tile, (k % nx) * tile
        et[k] = edge_img[y0:y0 + side, x0:x0 + side]
    return et


def _scatter_u8(res: np.ndarray, start: int, nx: int, tf: int,
                out: np.ndarray) -> None:
    """Scatter uint8 HR tiles (grid indices start..) into `out`, cropping
    at its far edges."""
    for j in range(res.shape[0]):
        iy, ix = divmod(start + j, nx)
        rows = min(out.shape[0] - iy * tf, tf)
        cols = min(out.shape[1] - ix * tf, tf)
        if rows > 0 and cols > 0:
            out[iy * tf:iy * tf + rows, ix * tf:ix * tf + cols] = \
                res[j, :rows, :cols]


def tiled_simple(image: np.ndarray, factor: int = 3, *, mode: str,
                 tile: int = 240, chunk: Optional[int] = None,
                 device="cuda") -> np.ndarray:
    """Overlap-tile loop for the bilinear and downsample modes: any image
    size through one tile shape.  uint8 in gives uint8 out; float in
    gives float out.  For ``downsample`` the image must already be
    cropped to a multiple of ``factor`` (the CLI does so)."""
    if mode not in ("bilinear", "downsample"):
        raise ValueError(f"mode must be 'bilinear' or 'downsample', not "
                         f"{mode!r}")
    if mode == "downsample":
        tile -= tile % factor
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    u8_io = np.asarray(image).dtype == np.uint8
    img = np.asarray(image) if u8_io else np.asarray(image, np.float32)
    device = torch.device(device)
    chunk = _DEFAULT_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    hgt, wid, _ = img.shape
    h = HALO
    ny = max(1, -(-hgt // tile))
    nx = max(1, -(-wid // tile))
    et = _gather_edge(img, tile, h, ny, nx)
    side = tile + 2 * h
    n_tiles = ny * nx
    up = mode == "bilinear"
    tf = tile * factor if up else tile // factor
    oh, ow = (hgt * factor, wid * factor) if up else (hgt // factor,
                                                     wid // factor)
    out = np.zeros((oh, ow, 3), np.uint8 if u8_io else np.float32)
    pending: deque = deque()

    def drain_one():
        start, cnt, res = pending.popleft()
        res = res[:cnt].cpu().numpy()
        if u8_io:
            _scatter_u8(res, start, nx, tf, out)
        else:
            native.scatter_tiles(res, start, nx, out)

    for start in range(0, n_tiles, chunk):
        stop = min(start + chunk, n_tiles)
        eb = et[start:stop]
        if stop - start < chunk:
            eb = np.concatenate(
                [eb, np.zeros((chunk - (stop - start), side, side, 3),
                              et.dtype)])
        res = _tile_kernel_simple(torch.from_numpy(eb).to(device), factor,
                                  tile, mode, u8_io)
        pending.append((start, stop - start, res))
        if len(pending) >= _MAX_INFLIGHT:
            drain_one()
    while pending:
        drain_one()
    return out
