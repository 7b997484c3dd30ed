"""Host-side image I/O: PNG u8 <-> f32 [0,1] sRGB code values.

The same pixel contract as `rusty_sr_tpu/utils/imageio.py`: load drops
alpha (no compositing) and divides by 255 with no gamma change; save
clamps to [0,1], scales by 255, rounds half up (``floor(x*255 + 0.5)``)
and writes an RGBA PNG.

PNGs go through the native codec (`utils/native.py`: a fixed Sub filter
and a parallel deflate out, libpng in) where it builds.  What it declines
(16-bit samples, a remapped gamma, a file that is not really a PNG) and
every other format go to Pillow, imported lazily and used when it is
installed.  Without Pillow, a small codec on the standard library's
`zlib` reads 8-bit non-interlaced RGB/RGBA PNGs (every filter type) and
writes 8-bit RGBA PNGs.  Where no codec works, `check_codec` raises
before any pixel reaches the device.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from rusty_sr_tpu_torch.utils import native
from rusty_sr_tpu_torch.utils.profiling import span

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

# zlib level of the PNGs written: 1, as the JAX package's native encoder
# uses; an HR output is tens of MB raw, and level 6 takes seconds.
_PNG_LEVEL = 1

# What a decode raises for a bad or hostile file, as opposed to a bug.
DECODE_ERRORS = (OSError, ValueError)


def _pil():
    """The Pillow `Image` module, or None when Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _zlib():
    try:
        import zlib
    except ImportError:
        return None
    return zlib


def _fallback():
    """The codec behind the native one: "PIL", "zlib" (the stdlib codec)
    or None."""
    if _pil() is not None:
        return "PIL"
    if _zlib() is not None:
        return "zlib"
    return None


def codec() -> str:
    """The PNG encoder and decoder in use: "native" (with the fallback
    that takes what it declines), "native encoder, <fallback> decoder"
    (libpng missing), "PIL" or "zlib"."""
    fallback = _fallback()
    if native.png_decoder_available():
        return f"native ({fallback or 'no'} fallback)"
    if native.png_available() and fallback is not None:
        return f"native encoder ({fallback} fallback), {fallback} decoder"
    if fallback is None:
        raise RuntimeError("no PNG codec: install Pillow, or use a Python "
                           "built with the zlib module")
    return fallback


def check_codec(path: str) -> str:
    """Raise now, not after an upscale, when ``path`` cannot be written or
    read here; returns the codec's name."""
    name = codec()
    if _pil() is None and not path.lower().endswith(".png"):
        raise ValueError(f"{path!r}: without Pillow only .png files can be "
                         "read or written")
    return name


# ---------------------------------------------------------------------------
# The stdlib PNG codec.

def _chunk(kind: bytes, data: bytes) -> bytes:
    zlib = _zlib()
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_encode(rgb: np.ndarray, level: int = _PNG_LEVEL) -> bytes:
    """(H,W,3) u8 -> RGBA PNG bytes (alpha 255), Sub filter on every row."""
    zlib = _zlib()
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rgba = np.empty((h, w, 4), np.uint8)
    rgba[..., :3] = rgb
    rgba[..., 3] = 255
    sub = rgba.copy()
    sub[:, 1:] = rgba[:, 1:] - rgba[:, :-1]      # uint8 arithmetic wraps
    rows = np.empty((h, 1 + 4 * w), np.uint8)
    rows[:, 0] = 1                               # filter type Sub
    rows[:, 1:] = sub.reshape(h, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter_slow(ft: int, cur: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) filters, which run left to right."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ft == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 255
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255


def png_decode(data: bytes) -> np.ndarray:
    """8-bit non-interlaced RGB/RGBA PNG bytes -> (H,W,3) u8, alpha dropped."""
    zlib = _zlib()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or not idat:
        raise ValueError("PNG has no IHDR or no IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in (2, 6) or interlace != 0:
        raise ValueError(f"PNG with bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} needs Pillow; the built-in "
                         "codec reads 8-bit non-interlaced RGB/RGBA")
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + stride):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(h, 1 + stride)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        ft, line = int(raw[r, 0]), raw[r, 1:]
        if ft == 0:
            out[r] = line
        elif ft == 1:
            out[r] = np.cumsum(line.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ft == 2:
            out[r] = line + prior
        elif ft in (3, 4):
            cur = bytearray(line.tobytes())
            _unfilter_slow(ft, cur, prior.tobytes(), bpp)
            out[r] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {ft} is not defined")
        prior = out[r]
    return np.ascontiguousarray(out.reshape(h, w, bpp)[..., :3])


# ---------------------------------------------------------------------------
# Public entry points.

def _read_native(path: str):
    """(H,W,3) u8 through the native decoder, or None: for a name without
    the .png extension, a file without the PNG signature (a mis-named
    file, which Pillow sniffs) or one the decoder declines."""
    if not path.lower().endswith(".png") or \
            not native.png_decoder_available():
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None       # the fallback reports the error
    if data[:8] != _PNG_SIG:
        return None
    return native.png_decode(data)


def load_image_u8(path: str) -> np.ndarray:
    """PNG (any image Pillow reads, with Pillow) -> (H,W,3) u8, alpha dropped."""
    with span("codec.decode"):
        return _load_image_u8(path)


def _load_image_u8(path: str) -> np.ndarray:
    u8 = _read_native(path)
    if u8 is not None:
        return u8
    Image = _pil()
    if Image is not None:
        try:
            with Image.open(path) as img:
                return np.asarray(img.convert("RGB"))
        except Image.DecompressionBombError as e:
            raise ValueError(str(e)) from e
    check_codec(path)
    with open(path, "rb") as f:
        return png_decode(f.read())


def load_image(path: str) -> np.ndarray:
    """PNG (any image Pillow reads, with Pillow) -> (H,W,3) float32 sRGB in
    [0, 1], alpha dropped: the u8 pixels over 255."""
    return load_image_u8(path).astype(np.float32) / 255.0


def _write_replacing(path: str, data: bytes) -> None:
    """Write to a temporary name and rename, so that a failed or
    interrupted write leaves no truncated file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_image_u8(path: str, u8: np.ndarray, png_threads: int = 0) -> None:
    """(H,W,3) u8 -> RGBA PNG (plain RGB for formats without alpha).
    ``png_threads``: the native encoder's deflate threads (0: its rule,
    one per started MB); writers that already run one image a thread
    pass 1.  The native and stdlib codecs write to a temporary name and
    rename."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    if path.lower().endswith(".png"):
        data = native.png_encode(u8, level=_PNG_LEVEL, threads=png_threads)
        if data is not None:
            _write_replacing(path, data)
            return
    Image = _pil()
    if Image is None:
        check_codec(path)
        _write_replacing(path, png_encode(u8))
        return
    img = Image.fromarray(u8)
    if path.lower().endswith((".png", ".tif", ".tiff", ".webp")):
        img = img.convert("RGBA")
    img.save(path, compress_level=_PNG_LEVEL)


def to_u8(data: np.ndarray) -> np.ndarray:
    """clamp [0,1] -> x255 -> round half up, as the reference saves."""
    data = np.clip(np.asarray(data, dtype=np.float32), 0.0, 1.0)
    return np.floor(data * 255.0 + 0.5).astype(np.uint8)


def save_image(path: str, data: np.ndarray) -> None:
    """(H,W,3) f32 -> clamp [0,1] -> round -> u8 RGBA PNG."""
    save_image_u8(path, to_u8(data))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """-10*log10(mean squared error / peak^2)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(-10.0 * np.log10(mse / (peak * peak)))
