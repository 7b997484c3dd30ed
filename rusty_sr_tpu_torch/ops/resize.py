"""Bilinear xf upsample (alumina `LinearInterp`) and the fxf mean pool,
NHWC.

Half-pixel phase — output index ``f*y + fy`` samples input coordinate
``y + alpha``, ``alpha = (fy + 0.5)/f - 0.5`` — and edge clamping.  Each
phase is a 2-tap filter over rows {y+d, y+d+1}, d = floor(alpha), so the
op is static slices and FMAs; the arithmetic is that of
`rusty_sr_tpu/ops/resize.py`, step for step.
"""

from __future__ import annotations

import numpy as np
import torch


def _phase_taps_padded(xe: torch.Tensor, f: int, axis: int, n: int):
    """Per-phase (lo, hi, w) length-n views of an axis that carries one
    extra sample on each side (xe.shape[axis] == n + 2)."""
    out = []
    for fy in range(f):
        alpha = (fy + 0.5) / f - 0.5
        d = int(np.floor(alpha))
        w = float(np.float32(alpha - d))
        out.append((xe.narrow(axis, 1 + d, n), xe.narrow(axis, 2 + d, n), w))
    return out


def _phase_taps(x: torch.Tensor, f: int, axis: int):
    """Per-phase (lo, hi, w) views along `axis`, edge-padded."""
    n = x.shape[axis]
    xe = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                   dim=axis)
    return _phase_taps_padded(xe, f, axis, n)


def _lerp(lo, hi, w):
    return lo * (1.0 - w) + hi * w if w != 0.0 else lo


def _upsample_axis(x: torch.Tensor, f: int, axis: int) -> torch.Tensor:
    y = torch.stack([_lerp(*t) for t in _phase_taps(x, f, axis)],
                    dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= f
    return y.reshape(shape)


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """x: (N,H,W,C) -> (N,f*H,f*W,C), half-pixel phase, edge-clamped."""
    return _upsample_axis(_upsample_axis(x, factor, 1), factor, 2)


def bilinear_phases(x: torch.Tensor, factor: int) -> torch.Tensor:
    """LR-space phases of `upsample_bilinear`:
    ``depth_to_space(bilinear_phases(x, f), f) == upsample_bilinear(x, f)``.
    Returns (N,H,W,f*f*C) in the Expand channel order ``(fy*f + fx)*C + c``.
    """
    blocks = []
    for lo_r, hi_r, wr in _phase_taps(x, factor, 1):
        xr = _lerp(lo_r, hi_r, wr)
        for lo_c, hi_c, wc in _phase_taps(xr, factor, 2):
            blocks.append(_lerp(lo_c, hi_c, wc))
    return torch.cat(blocks, dim=-1)


def bilinear_phases_cropped(x: torch.Tensor, factor: int,
                            y0: int, x0: int, size: int) -> torch.Tensor:
    """``bilinear_phases(x, f)[:, y0:y0+size, x0:x0+size, :]``, computed
    only over the ``size + 2`` window the 2-tap filters read.

    With one sample of margin on every side the taps never reach the
    edge clamp, so cropping first gives the same values; without that
    margin this falls back to the uncropped form."""
    f = factor
    n, hgt, wid, c = x.shape
    if not (y0 >= 1 and x0 >= 1 and y0 + size + 1 <= hgt
            and x0 + size + 1 <= wid):
        return bilinear_phases(x, f)[:, y0:y0 + size, x0:x0 + size, :]
    xt = x[:, y0 - 1:y0 + size + 1, x0 - 1:x0 + size + 1, :]
    blocks = []
    for lo_r, hi_r, wr in _phase_taps_padded(xt, f, 1, size):
        xr = _lerp(lo_r, hi_r, wr)
        for lo_c, hi_c, wc in _phase_taps_padded(xr, f, 2, size):
            blocks.append(_lerp(lo_c, hi_c, wc))
    return torch.cat(blocks, dim=-1)


def avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """x: (N,H,W,C) -> (N,H//f,W//f,C) mean pool, stride f, valid padding:
    the f*f window summed in row-major order from 0, then divided by
    float(f*f), as the JAX op's `reduce_window` computes it."""
    f = factor
    n, hgt, wid, c = x.shape
    ho, wo = hgt // f, wid // f
    acc = torch.zeros((n, ho, wo, c), dtype=x.dtype, device=x.device)
    for dy in range(f):
        for dx in range(f):
            acc = acc + x[:, dy:dy + f * ho:f, dx:dx + f * wo:f, :]
    return acc / float(f * f)
