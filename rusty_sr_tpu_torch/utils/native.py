"""The host layer in C++: tile gather/scatter and the PNG codec.

Two libraries, each built at first use from the port's own sources
(`csrc/host/tileio.cc`, `csrc/host/pngio.cc`) with g++ into
``rusty_sr_tpu_torch/_build/host/`` and loaded with ctypes (a plain C
interface).  Each library's file name carries a hash of its source, the
compiler's flags and the target that ``-march=native`` resolves to on
this host, so a binary built on another machine is rebuilt here, not
loaded.  Concurrent processes build it once: a cross-process ``flock``,
a build to a per-PID temporary name, then ``rename``.

Every entry point keeps its numpy or Pillow path: where g++ is missing,
quietly; where a compile fails, after printing the compiler's error to
stderr (`build_error` keeps it).  Where libpng's headers are missing, the
codec is built again without its decoder (the encoder needs only zlib),
and decoding goes to Pillow.

The contracts of `rusty_sr_tpu/utils/native.py`: tiles in row-major
order over the grid, each ``(tile + 2*halo)`` on a side, as three arrays —
zero-padded tiles, edge-padded tiles and a {0,1} mask that is 1 inside
the true image; RGBA PNGs written with a fixed Sub filter and a parallel
deflate; PNG decode with alpha dropped, as Pillow's ``convert("RGB")``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

from rusty_sr_tpu_torch.utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build", "host")

CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
# name -> (source, extra flags) of each build to try, in order
_LIBS = {"tileio": [("tileio.cc", ("-pthread",))],
         "png": [("pngio.cc", ("-lpng", "-lz", "-lpthread")),
                 ("pngio.cc", ("-DSR_PNG_ENCODE_ONLY", "-lz", "-lpthread"))]}

_lock = threading.Lock()
_loaded: dict = {}        # name -> (CDLL, build index), or None (tried)
_errors: dict = {}        # name -> the compiler's errors
_target = None            # what -march=native resolves to here

_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _cxx():
    return shutil.which("g++") or shutil.which("c++")


def _native_target(cxx: str) -> bytes:
    """The compiler's target options under ``-march=native`` on this
    host (one run of the compiler per process)."""
    global _target
    if _target is None:
        r = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                           capture_output=True, timeout=60)
        _target = r.stdout
    return _target


def library_path(name: str, cxx: str, build: int = 0) -> str:
    """Path of library ``name`` (its ``build``-th form in `_LIBS`) for the
    current source, flags and host."""
    src, extra = _LIBS[name][build]
    h = hashlib.sha256(" ".join((cxx,) + CXXFLAGS + extra).encode())
    h.update(_native_target(cxx))
    with open(os.path.join(CSRC, src), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsr{name}_{h.hexdigest()[:16]}.so")


def _build(name: str, cxx: str, build: int) -> str:
    """Compile library ``name`` in its ``build``-th form unless it exists;
    returns its path.  Raises `subprocess.CalledProcessError` (with the
    compiler's stderr) when the compile fails."""
    so = library_path(name, cxx, build)
    if os.path.exists(so):
        return so
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so):
                src, extra = _LIBS[name][build]
                tmp = f"{so}.tmp.{os.getpid()}"
                try:
                    subprocess.run([cxx, *CXXFLAGS, "-o", tmp,
                                    os.path.join(CSRC, src), *extra],
                                   check=True, capture_output=True,
                                   timeout=600)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name == "tileio":
        lib.sr_gather_tiles_range.argtypes = [
            _f32p, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
            _f32p, _f32p, _f32p]
        lib.sr_gather_tiles_range.restype = None
        lib.sr_scatter_runs.argtypes = [
            ctypes.c_void_p, _i64, _i64, _i64p, _i64, _i64]
        lib.sr_scatter_runs.restype = None
    else:
        lib.sr_png_bound.argtypes = [_i64, _i64]
        lib.sr_png_bound.restype = _i64
        lib.sr_png_encode2.argtypes = [
            _u8p, _i64, _i64, _i64, _i64, _i64, _u8p, _i64]
        lib.sr_png_encode2.restype = _i64
        lib.sr_png_info.argtypes = [_u8p, _i64, _i64p]
        lib.sr_png_info.restype = _i64
        lib.sr_png_decode.argtypes = [_u8p, _i64, _u8p, _i64, _i64]
        lib.sr_png_decode.restype = _i64


def _load_build(name: str):
    """(library, build index) of library ``name``, built if needed in the
    first of its forms that compiles, or None where none can be."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        _loaded[name] = None
        cxx = _cxx()
        if cxx is None:       # no toolchain: the numpy/Pillow paths
            return None
        errors = []
        for build in range(len(_LIBS[name])):
            try:
                lib = ctypes.CDLL(_build(name, cxx, build))
                _declare(name, lib)
                _loaded[name] = (lib, build)
                break
            except subprocess.CalledProcessError as e:
                errors.append((e.stderr or b"").decode(errors="replace"))
            except (OSError, subprocess.TimeoutExpired) as e:
                errors.append(str(e))
        if errors:
            # A compile that fails must be seen: the fallbacks are several
            # times slower and would otherwise look like a regression.
            _errors[name] = "\n".join(errors)
            what = ("built without its decoder" if _loaded[name]
                    else "using the fallback")
            print(f"warning: building the native {name} library failed; "
                  f"{what}:\n{_errors[name]}", file=sys.stderr)
        return _loaded[name]


def _load(name: str):
    """Library ``name`` (built if needed), or None where it cannot be."""
    got = _load_build(name)
    return None if got is None else got[0]


def build_error(name: str) -> str:
    """The compiler's errors for library ``name`` ("tileio" or "png"), or
    "" when its first form built or it was not tried."""
    return _errors.get(name, "")


def available() -> bool:
    """Whether the native tile gather/scatter is in use."""
    return _load("tileio") is not None


def png_available() -> bool:
    """Whether the native PNG encoder is in use."""
    return _load("png") is not None


def png_decoder_available() -> bool:
    """Whether the native PNG decoder is in use (it needs libpng)."""
    got = _load_build("png")
    return got is not None and got[1] == 0


def gather_tiles_range(img: np.ndarray, tile: int, halo: int, nx: int,
                       t0: int, t1: int, need_zero: bool = True, out=None):
    """Tiles [t0, t1) of the row-major grid of an (H,W,C) image, gathered
    straight from the unpadded image (host memory O(t1-t0)).

    Returns (zero_tiles, edge_tiles, mask_tiles), shapes (n, side, side,
    C), (n, side, side, C), (n, side, side, 1): uint8 for a uint8 image,
    float32 otherwise.  ``need_zero=False`` returns None for the
    zero-padded tiles.  ``out``: three arrays of at least n tiles (the
    first None when ``need_zero`` is False) to gather into; the results
    are their first n tiles.  The f32 gather of all three runs in the
    native library; uint8 and ``need_zero=False`` take numpy, as the JAX
    package does."""
    dtype = np.uint8 if img.dtype == np.uint8 else np.float32
    img = np.ascontiguousarray(img, dtype=dtype)
    h, w, c = img.shape
    side = tile + 2 * halo
    n = t1 - t0
    if out is None:
        zt = np.empty((n, side, side, c), dtype) if need_zero else None
        et = np.empty((n, side, side, c), dtype)
        mt = np.empty((n, side, side, 1), dtype)
    else:
        zt, et, mt = (None if a is None else a[:n] for a in out)
    lib = _load("tileio") if dtype == np.float32 and need_zero else None
    if lib is not None:
        lib.sr_gather_tiles_range(img, h, w, tile, halo, nx, t0, t1, zt, et,
                                  mt.reshape(n, side, side))
        return zt, et, mt
    if need_zero:
        zt[:] = 0
    mt[:] = 0
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
    ``canvas`` (crop_h, crop_w, C), cropping at its far edges: one run of
    `scatter_runs`."""
    scatter_runs(results, [(0, results.shape[0], start, nx, canvas)])


def _scatter_threads(nbytes: int) -> int:
    """The native scatter's threads for a call that writes ``nbytes``:
    one a whole 4 MiB, at most half the host's cores, so a call under 8
    MiB runs on the caller's thread alone.  (On an 8-core host, writing
    fresh output pages stopped scaling past 4 threads, for a ×4 frames
    call and a 4K request alike: `scripts/scatter_rate.py` times it.)"""
    return max(1, min((os.cpu_count() or 1) // 2, nbytes >> 22))


def scatter_runs(results: np.ndarray, runs) -> None:
    """Write HR tiles into output canvases.  ``runs`` lists (j0, count,
    start, nx, canvas): tiles [j0, j0 + count) of ``results`` (n, tf, tf,
    C) are tiles start.. of ``canvas``'s row-major grid of ``nx`` tiles a
    row, cropped at the canvas's (crop_h, crop_w, C) far edges.

    Every run goes into one native call, which copies the tiles' rows on
    `_scatter_threads` threads (the caller's among them; ctypes lets go
    of the interpreter lock meanwhile), for any dtype, where each canvas
    is C-contiguous with the results' dtype and channels.  Otherwise, or
    where the library cannot be built, a numpy copy per tile, inside the
    span ``scatter.fallback``."""
    if not runs:
        return
    c = results.shape[3]
    lib = _load("tileio") if all(
        cv.dtype == results.dtype and cv.ndim == 3 and cv.shape[2] == c
        and cv.flags.c_contiguous and cv.flags.writeable
        for *_, cv in runs) else None
    tf = results.shape[1]
    if lib is not None:
        res = np.ascontiguousarray(results)
        recs = np.array([(j0, cnt, start, nx, cv.shape[0], cv.shape[1],
                          cv.ctypes.data)
                         for j0, cnt, start, nx, cv in runs], np.int64)
        tile_bytes = tf * tf * c * res.itemsize
        threads = _scatter_threads(int(recs[:, 1].sum()) * tile_bytes)
        lib.sr_scatter_runs(res.ctypes.data, tf, c * res.itemsize, recs,
                            len(recs), threads)
        return
    with span("scatter.fallback"):
        for j0, cnt, start, nx, canvas in runs:
            crop_h, crop_w = canvas.shape[:2]
            for j in range(cnt):
                iy, ix = divmod(start + j, nx)
                y0, x0 = iy * tf, ix * tf
                rows = max(0, min(crop_h - y0, tf))
                cols = max(0, min(crop_w - x0, tf))
                if rows and cols:
                    canvas[y0:y0 + rows, x0:x0 + cols] = \
                        results[j0 + j, :rows, :cols]


# Pillow's default decompression-bomb limit, used when Pillow is absent.
_MAX_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def png_encode(rgb: np.ndarray, level: int = 1, threads: int = 0,
               codec: str = "fh"):
    """(H,W,3) u8 -> RGBA PNG bytes; None where the native codec is
    unavailable or declines the input.

    ``codec``: "fh" (the default: one dynamic-Huffman block per slab,
    literals and distance-1 runs) or "zlib" (zlib deflate at ``level``,
    0..9).  ``threads`` <= 0: one deflate thread per started MB of
    filtered data, at most the host's cores; the bytes depend on the
    thread count, which this rule fixes for a given image size and
    host."""
    if codec not in ("zlib", "fh"):
        raise ValueError(f"codec must be 'zlib' or 'fh', got {codec!r}")
    lib = _load("png")
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape[:2]:
        return None
    h, w = rgb.shape[:2]
    if threads <= 0:
        raw_mb = (h * (1 + 4 * w)) >> 20
        threads = max(1, min(os.cpu_count() or 1, raw_mb))
    with span("codec.encode"):      # only the encodes that run natively
        out = np.empty(int(lib.sr_png_bound(h, w)), np.uint8)
        n = lib.sr_png_encode2(rgb, h, w, int(level), int(threads),
                               1 if codec == "fh" else 0, out, out.size)
    if n < 0:
        return None
    return out[:n].tobytes()


def png_decode(data: bytes):
    """PNG bytes -> (H,W,3) u8, alpha dropped (Pillow's ``convert("RGB")``);
    None for what the native decoder does not take (16-bit samples, a
    gamma it would remap, a malformed file, no decoder) and for images
    past the decompression-bomb limit, so that the caller's fallback
    applies its own policy."""
    got = _load_build("png")
    if got is None or got[1] != 0:
        return None
    lib = got[0]
    buf = np.frombuffer(data, dtype=np.uint8)
    hw = np.zeros(2, np.int64)
    if lib.sr_png_info(buf, len(data), hw) != 0:
        return None
    h, w = int(hw[0]), int(hw[1])
    # A tiny file can claim gigapixel dimensions; never allocate from them
    # past Pillow's limit (its MAX_IMAGE_PIXELS, which users may change).
    try:
        from PIL import Image
        max_px = Image.MAX_IMAGE_PIXELS
    except ImportError:
        max_px = _MAX_PIXELS
    if max_px is not None and h * w > max_px:
        return None
    out = np.empty((h, w, 3), np.uint8)
    if lib.sr_png_decode(buf, len(data), out.reshape(-1), h, w) != 0:
        return None
    return out
