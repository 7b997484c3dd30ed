"""The port's native host layer (`rusty_sr_tpu_torch/utils/native.py`,
built from `rusty_sr_tpu_torch/csrc/host/`) against the JAX package's and
against its own numpy and Pillow paths.

- The PNG encoder is a copy of the JAX package's source: at the same
  ``threads`` and ``codec`` it writes the same bytes.
- The decoder equals Pillow's ``convert("RGB")`` on 8-bit RGB, RGBA,
  palette and grey images, and declines 16-bit samples, garbage,
  truncated files and decompression bombs (the caller's fallback then
  applies Pillow's own policy).
- The native f32 gather and the native scatter (any dtype, inline or on
  several threads) equal the numpy path byte for byte.
- Concurrent first builds give every process a loadable library, and a
  failed compile prints the compiler's error.
"""

import importlib.util
import io
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from rusty_sr_tpu.parallel import tiling as jt
from rusty_sr_tpu.utils import native as j_native
from rusty_sr_tpu_torch.utils import imageio, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rng(seed):
    return np.random.default_rng(seed)


def photo(h, w, seed=0):
    """Gradients plus noise, as u8."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 9.0 + yy / 5.0)],
                    axis=-1) + rng(seed).normal(0.0, 0.05, (h, w, 3))
    return (np.clip(base, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


@pytest.fixture(scope="module")
def png_ok():
    if not native.png_available():
        pytest.skip("the native PNG codec did not build here (no g++ or "
                    "no libpng headers): " + native.build_error("png"))


@pytest.fixture(scope="module")
def decoder_ok():
    if not native.png_decoder_available():
        pytest.skip("the native PNG decoder did not build here (the codec "
                    "needs libpng's headers for it): "
                    + native.build_error("png"))


@pytest.fixture(scope="module")
def tileio_ok():
    if not native.available():
        pytest.skip("the native tile library did not build here: "
                    + native.build_error("tileio"))


@pytest.mark.parametrize("codec,threads", [("fh", 1), ("fh", 3), ("fh", 0),
                                           ("zlib", 1), ("zlib", 2)])
def test_png_encode_bytes_equal_jax(png_ok, codec, threads):
    if not j_native.png_available():
        pytest.skip("the JAX package's native codec is unavailable")
    for img in (photo(37, 53, 1), rng(2).integers(0, 256, (300, 257, 3),
                                                  dtype=np.uint8),
                np.zeros((1, 1, 3), np.uint8)):
        got = native.png_encode(img, threads=threads, codec=codec)
        want = j_native.png_encode(img, threads=threads, codec=codec)
        assert got is not None and got == want
        with Image.open(io.BytesIO(got)) as back:
            assert back.mode == "RGBA"
            np.testing.assert_array_equal(np.asarray(back)[..., :3], img)


def _pil_png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "LA"])
def test_png_decode_matches_pil(decoder_ok, mode):
    rgb = photo(21, 17, 3)
    alpha = rng(4).integers(0, 256, (21, 17, 1), dtype=np.uint8)
    img = {"RGB": lambda: Image.fromarray(rgb, "RGB"),
           "RGBA": lambda: Image.fromarray(np.concatenate([rgb, alpha], -1),
                                           "RGBA"),
           "P": lambda: Image.fromarray(rgb, "RGB").convert(
               "P", palette=Image.Palette.ADAPTIVE),
           "L": lambda: Image.fromarray(rgb[..., 0], "L"),
           "LA": lambda: Image.fromarray(
               np.concatenate([rgb[..., :1], alpha], -1), "LA")}[mode]()
    data = _pil_png(img)
    with Image.open(io.BytesIO(data)) as back:
        want = np.asarray(back.convert("RGB"))
    got = native.png_decode(data)
    assert got is not None
    np.testing.assert_array_equal(got, want)


def test_png_decode_declines_what_it_cannot_read(decoder_ok):
    data16 = _pil_png(Image.fromarray(
        rng(5).integers(0, 65536, (9, 9)).astype(np.uint16)))
    assert native.png_decode(data16) is None          # 16-bit samples
    assert native.png_decode(b"not a png at all") is None
    ok = native.png_encode(photo(32, 32))
    assert native.png_decode(ok[: len(ok) // 2]) is None   # truncated


def _bomb() -> bytes:
    """A 66-byte PNG whose header claims 65536 x 65536 pixels."""
    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(
            ">I", zlib.crc32(t + d))
    ihdr = struct.pack(">II5B", 1 << 16, 1 << 16, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"\x00")) + chunk(b"IEND", b""))


def test_png_decode_bomb_guard(decoder_ok, tmp_path, monkeypatch):
    assert native.png_decode(_bomb()) is None
    path = tmp_path / "bomb.png"
    path.write_bytes(_bomb())
    with pytest.raises(imageio.DECODE_ERRORS, match="pixels"):
        imageio.load_image_u8(str(path))          # Pillow's own refusal
    img = photo(32, 32, 6)
    data = native.png_encode(img)
    np.testing.assert_array_equal(native.png_decode(data), img)
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", 100)   # the user's limit
    assert native.png_decode(data) is None
    monkeypatch.setattr(Image, "MAX_IMAGE_PIXELS", None)  # no limit
    np.testing.assert_array_equal(native.png_decode(data), img)


def test_imageio_routes_png_through_native(png_ok, tmp_path):
    img = photo(40, 56, 7)
    path = str(tmp_path / "a.png")
    imageio.save_image_u8(path, img)
    with open(path, "rb") as f:
        assert f.read() == native.png_encode(img, level=1, threads=0)
    np.testing.assert_array_equal(imageio.load_image_u8(path), img)
    imageio.save_image_u8(path, img, png_threads=1)
    with open(path, "rb") as f:
        assert f.read() == native.png_encode(img, level=1, threads=1)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    assert imageio.codec().startswith("native")
    # A JPEG named .png has no PNG signature: Pillow sniffs and reads it.
    fake = str(tmp_path / "fake.png")
    Image.fromarray(np.full((16, 16, 3), 128, np.uint8)).save(fake, "JPEG")
    assert imageio.load_image_u8(fake).shape == (16, 16, 3)


# The first three keep their ids from before the scatter took any dtype;
# the "threads" canvases are large enough for `_scatter_threads` to split.
@pytest.mark.parametrize("shape,tile,dtype", [
    pytest.param((23, 31, 3), 8, np.float32, id="shape0-8"),
    pytest.param((5, 40, 3), 16, np.float32, id="shape1-16"),
    pytest.param((1, 1, 3), 4, np.float32, id="shape2-4"),
    pytest.param((23, 31, 3), 8, np.uint8, id="u8-inline"),
    pytest.param((601, 633, 3), 128, np.uint8, id="u8-threads"),
    pytest.param((301, 317, 3), 64, np.float32, id="f32-threads")])
def test_native_gather_scatter_equal_numpy(tileio_ok, monkeypatch, shape,
                                           tile, dtype):
    ny, nx = -(-shape[0] // tile), -(-shape[1] // tile)
    if dtype == np.uint8:
        img = rng(11).integers(0, 256, shape, dtype=np.uint8)
        res = rng(12).integers(0, 256, (ny * nx, tile * 3, tile * 3, 3),
                               dtype=np.uint8)
    else:
        img = rng(11).random(shape, dtype=np.float32)
        res = rng(12).random((ny * nx, tile * 3, tile * 3, 3),
                             dtype=np.float32)
    side = tile + 14
    # ragged on both sides, prefilled with a sentinel; tile 1 is never
    # written, so its sentinel must stay
    canvas = np.full((shape[0] * 3, shape[1] * 3, 3), 7, dtype)
    threads = native._scatter_threads(res[2:].nbytes)
    assert (threads > 1) == (shape[0] > 300 and (os.cpu_count() or 1) > 3)
    runs = {}
    for path in ("native", "numpy"):
        if path == "numpy":
            monkeypatch.setattr(native, "_load_build", lambda name: None)
        out = tuple(np.full((ny * nx + 2, side, side, ch), 7, dtype)
                    for ch in (3, 3, 1))
        fresh = native.gather_tiles_range(img, tile, 7, nx, 1, ny * nx)
        into = native.gather_tiles_range(img, tile, 7, nx, 1, ny * nx,
                                         out=out)
        c = canvas.copy()
        native.scatter_tiles(res[:1], 0, nx, c)
        native.scatter_tiles(res[2:], 2, nx, c)
        runs[path] = (fresh, into, c)
    (fa, ia, ca), (fb, ib, cb) = runs["native"], runs["numpy"]
    for a, b, c_, d in zip(fa, fb, ia, ib):
        assert a.tobytes() == b.tobytes() == c_.tobytes() == d.tobytes()
    assert ca.tobytes() == cb.tobytes()
    if nx > 1:
        tf = tile * 3
        assert (ca[:tf, tf:2 * tf] == 7).all()
        assert not (ca[:tf, :tf] == 7).all()
    want = j_native.gather_tiles_range(img, tile, 7, nx, 1, ny * nx)
    for a, b in zip(runs["native"][0], want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_scatter_runs_over_canvases_equal_numpy(tileio_ok, monkeypatch,
                                                dtype):
    """One call writes runs into several canvases, from any offset of the
    results, as `tiled_sr_batch` drains a chunk that spans images, on any
    number of threads; a canvas of another dtype, or one not
    C-contiguous, takes the numpy loop in the same call's place."""
    tf, nx = 12, 3
    res = rng(14).integers(0, 256, (9, tf, tf, 3)).astype(dtype)
    shapes = [(20, 30), (12, 12), (25, 36)]          # crop_h x crop_w

    def scatter():
        cs = [np.full(s + (3,), 7, dtype) for s in shapes]
        native.scatter_runs(res, [(0, 2, 4, nx, cs[0]), (2, 1, 0, 1, cs[1]),
                                  (3, 6, 0, nx, cs[2])])
        return b"".join(c.tobytes() for c in cs)

    got = scatter()
    for t in (2, 3, 7, 1000):       # every split of the rows, even past them
        monkeypatch.setattr(native, "_scatter_threads", lambda nbytes: t)
        assert scatter() == got
    odd = np.full((20, 30, 3), 7, np.float64)
    strided = np.full((20, 60, 3), 7, dtype)[:, ::2]
    for cv in (odd, strided):
        native.scatter_runs(res, [(0, 2, 4, nx, cv)])    # tiles (1,1), (1,2)
        np.testing.assert_array_equal(cv[12:, 12:24], res[0, :8])
        np.testing.assert_array_equal(cv[12:, 24:], res[1, :8, :6])
        assert (cv[:12] == 7).all() and (cv[:, :12] == 7).all()
    monkeypatch.setattr(native, "_load_build", lambda name: None)
    assert scatter() == got


def test_u8_gather_equals_jax():
    img = rng(13).integers(0, 256, (37, 50, 3), dtype=np.uint8)
    nx = -(-50 // 16)
    for need_zero in (True, False):
        got = native.gather_tiles_range(img, 16, 7, nx, 2, 9,
                                        need_zero=need_zero)
        want = jt._gather_u8_range(img, 16, 7, nx, 2, 9, need_zero)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == np.uint8 and a.tobytes() == b.tobytes()


def _package_copy(root) -> str:
    """The loader and the host sources in a package tree of their own, so
    that a build there touches nothing of the repository's."""
    pkg = os.path.join(root, "pkg")
    os.makedirs(os.path.join(pkg, "utils"))
    shutil.copy(native.__file__, os.path.join(pkg, "utils", "native.py"))
    shutil.copytree(native.CSRC, os.path.join(pkg, "csrc", "host"))
    return os.path.join(pkg, "utils", "native.py")


def _needs_cxx():
    if native._cxx() is None:
        pytest.skip("no C++ compiler")


def test_concurrent_native_build_race(tmp_path):
    """Four processes build both libraries from nothing at once: the
    flock and the per-PID temporary name with its rename give every one
    a loadable library, and one file per library."""
    _needs_cxx()
    loader = _package_copy(str(tmp_path))
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('n', {loader!r})\n"
            "n = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(n)\n"
            "ok = n.available() and (n.png_available() or "
            "n.build_error('png') != '')\n"
            "sys.exit(0 if ok else 1)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stderr=subprocess.PIPE) for _ in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    built = os.listdir(os.path.join(str(tmp_path), "pkg", "_build", "host"))
    assert len([f for f in built if f.startswith("libsrtileio_")]) == 1
    assert not [f for f in built if ".tmp." in f]


def test_failed_compile_prints_the_error(tmp_path, capfd):
    _needs_cxx()
    loader = _package_copy(str(tmp_path))
    src = os.path.join(str(tmp_path), "pkg", "csrc", "host", "tileio.cc")
    with open(src, "a") as f:
        f.write("\nthis is not C++;\n")
    spec = importlib.util.spec_from_file_location("native_broken", loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert not mod.available()
    assert "error" in mod.build_error("tileio")
    assert "building the native tileio library failed" in capfd.readouterr().err
    # The numpy path still gathers.
    img = rng(14).random((9, 11, 3), dtype=np.float32)
    got = mod.gather_tiles_range(img, 4, 7, 3, 0, 9)
    want = native.gather_tiles_range(img, 4, 7, 3, 0, 9)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_library_name_carries_source_flags_and_target(monkeypatch):
    _needs_cxx()
    cxx = native._cxx()
    name = native.library_path("tileio", cxx)
    assert os.path.dirname(name) == native.BUILD_DIR
    assert name != native.library_path("png", cxx)
    monkeypatch.setattr(native, "_target", b"-march= another-host")
    assert native.library_path("tileio", cxx) != name
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-g",))
    monkeypatch.setattr(native, "_target", None)
    assert native.library_path("tileio", cxx) != name


def test_codec_without_libpng_keeps_the_native_encoder(png_ok, tmp_path,
                                                       capfd):
    """Where libpng's headers are missing, the codec builds again without
    its decoder: the same encoder bytes, decoding left to Pillow."""
    loader = _package_copy(str(tmp_path))
    src = os.path.join(str(tmp_path), "pkg", "csrc", "host", "pngio.cc")
    with open(src) as f:
        text = f.read()
    with open(src, "w") as f:
        f.write(text.replace("#include <png.h>", "#include <no_such_png.h>"))
    spec = importlib.util.spec_from_file_location("native_no_png", loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.png_available() and not mod.png_decoder_available()
    assert "no_such_png.h" in mod.build_error("png")
    assert "built without its decoder" in capfd.readouterr().err
    img = photo(45, 61, 8)
    for threads in (1, 0):
        data = mod.png_encode(img, threads=threads)
        assert data == native.png_encode(img, threads=threads)
    assert mod.png_decode(data) is None


def test_scatter_rate_script_variants_write_the_same_bytes(tileio_ok):
    """`scripts/scatter_rate.py` (the output write timed on the host)
    checks that its variants write the same bytes before it times them."""
    import json
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "scatter_rate.py"),
         "--lr", "300x500", "--factor", "3", "--frames", "2", "--threads",
         "1,3", "--rounds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()]
    assert [ln["variant"] for ln in lines] == [
        "zeros+numpy", "empty+numpy", "empty+1", "empty+3", "empty+rule"]
    assert all(ln["gb_s"] > 0 and len(ln["s_a_call"]) == 1 for ln in lines)
