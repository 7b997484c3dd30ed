"""Host tile gather/scatter for overlap-tile inference, in numpy.

The contract of `rusty_sr_tpu/utils/native.py::gather_tiles_range` and
`scatter_tiles`: tiles in row-major order over the grid, each
``(tile + 2*halo)`` on a side, as three arrays — zero-padded tiles,
edge-padded tiles and a {0,1} mask that is 1 inside the true image.
"""

from __future__ import annotations

import numpy as np


def gather_tiles_range(img: np.ndarray, tile: int, halo: int, nx: int,
                       t0: int, t1: int, need_zero: bool = True):
    """Tiles [t0, t1) of the row-major grid of an (H,W,C) image, gathered
    straight from the unpadded image (host memory O(t1-t0)).

    Returns (zero_tiles, edge_tiles, mask_tiles), shapes (n, side, side,
    C), (n, side, side, C), (n, side, side, 1): uint8 for a uint8 image,
    float32 otherwise.  ``need_zero=False`` returns None for the
    zero-padded tiles."""
    dtype = np.uint8 if img.dtype == np.uint8 else np.float32
    img = np.ascontiguousarray(img, dtype=dtype)
    h, w, c = img.shape
    side = tile + 2 * halo
    n = t1 - t0
    zt = np.zeros((n, side, side, c), dtype) if need_zero else None
    et = np.empty((n, side, side, c), dtype)
    mt = np.zeros((n, side, side, 1), dtype)
    for k in range(n):
        iy, ix = divmod(t0 + k, nx)
        y0, x0 = iy * tile - halo, ix * tile - halo
        ylo, yhi = max(y0, 0), min(y0 + side, h)
        xlo, xhi = max(x0, 0), min(x0 + side, w)
        sub = img[ylo:yhi, xlo:xhi]
        ry, rx = ylo - y0, xlo - x0
        et[k] = np.pad(sub, ((ry, side - ry - sub.shape[0]),
                             (rx, side - rx - sub.shape[1]), (0, 0)),
                       mode="edge")
        if need_zero:
            zt[k, ry:ry + sub.shape[0], rx:rx + sub.shape[1]] = sub
        mt[k, ry:ry + sub.shape[0], rx:rx + sub.shape[1]] = 1
    return zt, et, mt


def scatter_tiles(results: np.ndarray, start: int, nx: int,
                  canvas: np.ndarray) -> None:
    """Write (count, tf, tf, C) HR tiles, grid indices start.., into
    ``canvas`` (crop_h, crop_w, C), cropping at its far edges."""
    count, tf = results.shape[0], results.shape[1]
    crop_h, crop_w = canvas.shape[:2]
    for j in range(count):
        iy, ix = divmod(start + j, nx)
        y0, x0 = iy * tf, ix * tf
        rows = max(0, min(crop_h - y0, tf))
        cols = max(0, min(crop_w - x0, tf))
        if rows and cols:
            canvas[y0:y0 + rows, x0:x0 + cols] = results[j, :rows, :cols]
