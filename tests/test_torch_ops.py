"""The port's ops against the JAX package's, on the same numpy inputs.

Tolerance 1e-6 absolute for the float ops: both sides run the same f32
arithmetic, except the convolution, whose sums run in another order
(values here are O(1), so f32 rounding of the order is ~1e-7), and the
sRGB curves, whose pow may differ by an ulp between XLA and torch.  Pixel
codecs and the tile gather must agree exactly.
"""

import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from rusty_sr_tpu.ops.activations import belu as j_belu
from rusty_sr_tpu.ops.color import (linear_to_srgb as j_lin2srgb,
                                    srgb_to_linear as j_srgb2lin)
from rusty_sr_tpu.ops.conv import conv2d_same as j_conv
from rusty_sr_tpu.ops.pixel_shuffle import (depth_to_space as j_d2s,
                                            space_to_depth as j_s2d)
from rusty_sr_tpu.ops.resize import (avg_pool as j_avg_pool,
                                     bilinear_phases as j_phases,
                                     bilinear_phases_cropped as j_cropped,
                                     upsample_bilinear as j_up)
from rusty_sr_tpu.utils import imageio as j_io
from rusty_sr_tpu.utils import native as j_native
from rusty_sr_tpu_torch.ops.activations import belu
from rusty_sr_tpu_torch.ops.color import linear_to_srgb, srgb_to_linear
from rusty_sr_tpu_torch.ops.conv import conv2d_same
from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space, space_to_depth
from rusty_sr_tpu_torch.ops.resize import (avg_pool, bilinear_phases,
                                           bilinear_phases_cropped,
                                           upsample_bilinear)
from rusty_sr_tpu_torch.utils import imageio, native

ATOL = 1e-6


def rng(seed=0):
    return np.random.default_rng(seed)


def both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    return got, want


def test_belu_matches_jax():
    r = rng(1)
    x = r.normal(0, 3, (2, 5, 7, 32)).astype(np.float32)
    p = r.normal(0, 1, (32,)).astype(np.float32)
    got, want = both(belu, j_belu, x, p)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("fn,j_fn", [(srgb_to_linear, j_srgb2lin),
                                     (linear_to_srgb, j_lin2srgb)],
                         ids=["srgb_to_linear", "linear_to_srgb"])
def test_srgb_curves_match_jax(fn, j_fn):
    """Both branches, the knee and the clamp below 0 (the clamped base
    keeps the unselected pow branch finite)."""
    x = np.concatenate([rng(13).random(4995, dtype=np.float32),
                        np.array([0.0, 0.0031308, 0.04045, 1.0, -0.01],
                                 np.float32)]).reshape(1, 5, 1000, 1)
    got, want = both(fn, j_fn, x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("factor,shape", [(3, (2, 9, 12, 3)),
                                          (2, (1, 7, 5, 3)),
                                          (4, (1, 8, 17, 3))],
                         ids=["f3", "f2-ragged", "f4-ragged"])
def test_avg_pool_matches_jax(factor, shape):
    x = rng(14).random(shape, dtype=np.float32)
    got, want = both(avg_pool, j_avg_pool, x, factor=factor)
    assert got.shape == (shape[0], shape[1] // factor, shape[2] // factor,
                         shape[3])
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_depth_to_space_matches_jax(factor):
    x = rng(2).random((2, 5, 6, 3 * factor * factor), dtype=np.float32)
    got, want = both(depth_to_space, j_d2s, x, factor=factor)
    np.testing.assert_array_equal(got, want)
    back, want_back = both(space_to_depth, j_s2d, got, factor=factor)
    np.testing.assert_array_equal(back, want_back)
    np.testing.assert_array_equal(back, x)


def test_pixel_shuffle_order_differs():
    """torch.pixel_shuffle orders channels (c, fy, fx); the reference's
    Expand is (fy, fx, c)."""
    x = torch.from_numpy(rng(3).random((1, 4, 4, 27), dtype=np.float32))
    ours = depth_to_space(x, 3)
    theirs = torch.pixel_shuffle(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)
    assert ours.shape == theirs.shape
    assert not torch.equal(ours, theirs)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_upsample_and_phases_match_jax(factor):
    x = rng(4).random((2, 9, 11, 3), dtype=np.float32)
    got, want = both(upsample_bilinear, j_up, x, factor=factor)
    np.testing.assert_allclose(got, want, atol=ATOL)
    ph, want_ph = both(bilinear_phases, j_phases, x, factor=factor)
    np.testing.assert_allclose(ph, want_ph, atol=ATOL)
    np.testing.assert_allclose(depth_to_space(torch.from_numpy(ph),
                                              factor).numpy(), got, atol=ATOL)


@pytest.mark.parametrize("y0,x0,size", [(7, 7, 16), (1, 2, 5), (0, 3, 4),
                                        (3, 0, 6)])
def test_bilinear_phases_cropped_matches_jax(y0, x0, size):
    """Interior crops take the cropped path; crops at the edge fall back."""
    x = rng(5).random((2, 30, 30, 3), dtype=np.float32)
    got = bilinear_phases_cropped(torch.from_numpy(x), 3, y0, x0, size).numpy()
    want = np.asarray(j_cropped(jnp.asarray(x), 3, y0, x0, size))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k,cin,cout,gain", [(5, 3, 32, 1.0),
                                             (3, 32, 27, 0.1)])
def test_conv2d_same_matches_jax(k, cin, cout, gain):
    """Weights at the net's own init scale (conv0 gain 1, the rest 0.1), so
    the f32 rounding of the sum order stays below the 1e-6 bound."""
    r = rng(6)
    x = r.random((2, 12, 10, cin), dtype=np.float32)
    std = gain * np.sqrt(2.0 / (k * k * cin))
    w = r.normal(0, std, (k, k, cin, cout)).astype(np.float32)
    got, want = both(conv2d_same, j_conv, x, w)
    np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# Image I/O: the stdlib PNG codec against Pillow.

def _filtered_png(rgb, alpha):
    """A PNG whose rows cycle through filter types 0-4, written with a
    straightforward per-byte filter, to exercise every unfilter path."""
    h, w, _ = rgb.shape
    img = np.concatenate([rgb, alpha[..., None]], -1) if alpha is not None \
        else rgb
    bpp = img.shape[-1]
    raw, prior = bytearray(), bytes(w * bpp)
    for r in range(h):
        line = img[r].reshape(-1).tobytes()
        ft = r % 5
        out = bytearray()
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out.append((x - pred) & 255)
        raw += bytes([ft]) + out
        prior = line

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if alpha is not None else 2,
                       0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("with_alpha", [False, True])
def test_png_decode_matches_pil_every_filter(tmp_path, with_alpha):
    r = rng(7)
    rgb = r.integers(0, 256, (11, 13, 3), dtype=np.uint8)
    alpha = r.integers(0, 256, (11, 13), dtype=np.uint8) if with_alpha \
        else None
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(rgb, alpha))
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = imageio.png_decode(path.read_bytes())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rgb)


def test_png_encode_read_by_pil(tmp_path):
    rgb = rng(8).integers(0, 256, (17, 9, 3), dtype=np.uint8)
    path = tmp_path / "e.png"
    path.write_bytes(imageio.png_encode(rgb))
    with Image.open(path) as im:
        assert im.mode == "RGBA"
        px = np.asarray(im)
    np.testing.assert_array_equal(px[..., :3], rgb)
    assert (px[..., 3] == 255).all()
    # and Pillow's own PNGs decode to the same pixels
    Image.fromarray(rgb).save(tmp_path / "p.png")
    np.testing.assert_array_equal(
        imageio.png_decode((tmp_path / "p.png").read_bytes()), rgb)


def test_png_decode_rejects_what_it_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="not a PNG"):
        imageio.png_decode(b"GIF89a....")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "g.png")
    with pytest.raises(ValueError, match="Pillow"):
        imageio.png_decode((tmp_path / "g.png").read_bytes())
    good = bytearray(imageio.png_encode(np.zeros((2, 2, 3), np.uint8)))
    good[-20] ^= 0xFF                                   # corrupt IDAT
    with pytest.raises(ValueError):
        imageio.png_decode(bytes(good))


def test_without_pillow_the_stdlib_codec_round_trips(tmp_path, monkeypatch):
    monkeypatch.setattr(imageio, "_pil", lambda: None)
    monkeypatch.setattr(imageio.native, "_load_build", lambda name: None)
    assert imageio.codec() == "zlib"
    img = rng(9).random((7, 10, 3), dtype=np.float32)
    imageio.save_image(str(tmp_path / "o.png"), img)
    np.testing.assert_array_equal(imageio.load_image_u8(str(tmp_path / "o.png")),
                                  j_io.to_u8(img))
    with pytest.raises(ValueError, match="only .png"):
        imageio.check_codec(str(tmp_path / "o.jpg"))
    monkeypatch.setattr(imageio, "_zlib", lambda: None)
    with pytest.raises(RuntimeError, match="no PNG codec"):
        imageio.codec()


def test_save_image_quantises_like_jax(tmp_path):
    data = rng(10).uniform(-0.2, 1.2, (9, 8, 3)).astype(np.float32)
    data[0, 0] = [0.5 / 255.0, 254.5 / 255.0, 1.0]
    np.testing.assert_array_equal(imageio.to_u8(data), j_io.to_u8(data))
    imageio.save_image(str(tmp_path / "a.png"), data)
    j_io.save_image(str(tmp_path / "b.png"), data)
    np.testing.assert_array_equal(imageio.load_image_u8(str(tmp_path / "a.png")),
                                  j_io.load_image_u8(str(tmp_path / "b.png")))
    assert imageio.psnr(data, data) == float("inf")
    assert abs(imageio.psnr(data, data + 0.1) - j_io.psnr(data, data + 0.1)) \
        < 1e-9


# ---------------------------------------------------------------------------
# Tile gather/scatter against the JAX package's.

@pytest.mark.parametrize("shape,tile", [((23, 31, 3), 8), ((5, 40, 3), 16),
                                        ((1, 1, 3), 4)])
def test_gather_scatter_match_jax(shape, tile):
    img = rng(11).random(shape, dtype=np.float32)
    ny, nx = -(-shape[0] // tile), -(-shape[1] // tile)
    for t0, t1 in ((0, ny * nx), (ny * nx // 2, ny * nx)):
        got = native.gather_tiles_range(img, tile, 7, nx, t0, t1)
        want = j_native.gather_tiles_range(img, tile, 7, nx, t0, t1)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
    res = rng(12).random((ny * nx, tile * 3, tile * 3, 3), dtype=np.float32)
    a = np.zeros((shape[0] * 3, shape[1] * 3, 3), np.float32)
    b = np.zeros_like(a)
    native.scatter_tiles(res, 0, nx, a)
    j_native.scatter_tiles(res, 0, nx, b)
    np.testing.assert_array_equal(a, b)
