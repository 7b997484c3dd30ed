"""Synthetic pictures from a seed, and PNG bytes for the inputs.

The pictures stand for anime frames and screenshots: a two-colour
gradient background under flat-coloured ellipses and rectangles, each
shaded by a gentle gradient and drawn with a dark outline.  Every seed
draws the same number of shapes of the same size range, so the work a
picture makes (tiles, PNG bytes) does not drift from seed to seed.
The shapes' parameters come from NumPy's generator, seeded by
(seed, stream), and the drawing runs on ``device`` in float32.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of the seed."""
    return np.random.default_rng([seed, zlib.crc32(stream.encode())])


def pictures(seed: int, stream: str, n: int, h: int, w: int, device="cpu",
             shapes: int = 24, group: int = 8) -> torch.Tensor:
    """``n`` (h, w, 3) u8 pictures as one (n, h, w, 3) tensor on ``device``."""
    r = rng(seed, stream)
    bg = r.uniform(0.0, 1.0, (n, 2, 3))
    ang = r.uniform(0.0, 2 * np.pi, n)
    kind = r.integers(0, 2, (n, shapes))
    cy = r.uniform(0.0, 1.0, (n, shapes)) * h
    cx = r.uniform(0.0, 1.0, (n, shapes)) * w
    s = min(h, w)
    ry = r.uniform(0.04, 0.3, (n, shapes)) * s
    rx = r.uniform(0.04, 0.3, (n, shapes)) * s
    col = r.uniform(0.0, 1.0, (n, shapes, 3))
    shade = r.uniform(-0.15, 0.15, (n, shapes))
    line = r.uniform(0.0, 0.12, (n, shapes, 3))
    width = r.uniform(1.0, 3.0, (n, shapes))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    yy = torch.arange(h, dtype=torch.float32, device=device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, w)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for g0 in range(0, n, group):
        sl = slice(g0, min(n, g0 + group))
        m = sl.stop - sl.start
        ca, sa = t(np.cos(ang[sl])).view(m, 1, 1), t(np.sin(ang[sl])).view(
            m, 1, 1)
        u = (xx * ca + yy * sa) / max(h, w) * 0.5 + 0.5
        b = t(bg[sl])
        img = b[:, 0].view(m, 1, 1, 3) + (b[:, 1] - b[:, 0]).view(
            m, 1, 1, 3) * u.unsqueeze(-1)
        for k in range(shapes):
            dy = (yy - t(cy[sl, k]).view(m, 1, 1)) / t(ry[sl, k]).view(m, 1, 1)
            dx = (xx - t(cx[sl, k]).view(m, 1, 1)) / t(rx[sl, k]).view(m, 1, 1)
            ell = torch.sqrt(dy * dy + dx * dx)
            box = torch.maximum(dy.abs(), dx.abs())
            d = torch.where(t(kind[sl, k]).view(m, 1, 1) > 0, ell, box)
            rim = 1.0 - t(width[sl, k]).view(m, 1, 1) / torch.minimum(
                t(ry[sl, k]), t(rx[sl, k])).view(m, 1, 1)
            fill = t(col[sl, k]).view(m, 1, 1, 3) \
                + (t(shade[sl, k]).view(m, 1, 1) * dy).unsqueeze(-1)
            inside = (d <= 1.0).unsqueeze(-1)
            edge = (inside.squeeze(-1) & (d > rim)).unsqueeze(-1)
            img = torch.where(inside, fill, img)
            img = torch.where(edge, t(line[sl, k]).view(m, 1, 1, 3), img)
        out[sl] = torch.floor(img.clamp(0.0, 1.0) * 255.0 + 0.5).to(
            torch.uint8)
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_encode_rgb(rgb: np.ndarray, level: int) -> bytes:
    """(H, W, 3) u8 -> an 8-bit RGB PNG, Sub filter on every row."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 1
    sub = rgb.copy()
    sub[:, 1:] = rgb[:, 1:] - rgb[:, :-1]
    rows[:, 1:] = sub.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def png_decode_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) u8, alpha dropped, through Pillow."""
    import io
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))
