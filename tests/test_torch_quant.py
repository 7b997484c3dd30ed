"""The port's int8 engine (`models/quant.py`, `tiled_sr(engine="int8")`,
`api.upscale(engine="int8")`) against the JAX package's, on the CPU,
where the int8 products run their plain version (`int8_mm_reference`).

Bounds:
- `ops.conv.im2col_patches`, `quantize_trunk` given JAX's calibrated
  ranges, and the int32 products of `_conv_q8` given the same int8
  operands: bit for bit (integer and IEEE arithmetic in one order);
- `calibrate_act_scales`: each range end within 1e-5 of the channel's
  range width hi - lo, which sets its scale (the exact f32 convolutions
  sum in another order; an end of a one-sided channel is a small
  difference of large terms, so its own relative error is larger);
- `tiled_sr(engine="int8")` against JAX's: at least 65 dB (measured 72.9
  dB u8, 85.9 dB f32 on this image: a sum in another order moves an
  activation across an int8 rounding point now and then), and against
  the exact tier at least 50 dB, the JAX suite's bound
  (tests/test_quant.py::test_int8_tiled_engine_matches_whole).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu.models import quant as JQ
from rusty_sr_tpu.models.sr_net import merge_params as j_merge
from rusty_sr_tpu.ops import conv as jconv
from rusty_sr_tpu.parallel import tiling as jt
from rusty_sr_tpu.params import load_builtin
from rusty_sr_tpu_torch import api
from rusty_sr_tpu_torch.models import quant as Q
from rusty_sr_tpu_torch.models.sr_net import merge_params
from rusty_sr_tpu_torch.ops.conv import im2col_patches
from rusty_sr_tpu_torch.parallel import tiling
from rusty_sr_tpu_torch.utils.imageio import psnr
from test_torch_xla import jtree, u8_image

IMG = u8_image((40, 56, 3), 31)
IMG_F32 = IMG.astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def anime():
    return load_builtin("anime")


@pytest.fixture(scope="module")
def merged(anime):
    """(port's merged tree, JAX's)."""
    m = merge_params({k: torch.as_tensor(v) for k, v in anime.items()})
    return ({k: v.detach().clone() for k, v in m.items()},
            j_merge(jtree(anime)))


@pytest.fixture(scope="module")
def sample():
    return np.random.default_rng(32).random((5, 22, 22, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def ranges(merged, sample):
    """(port's calibrated ranges, JAX's), on the same sample."""
    m, jm = merged
    return (Q.calibrate_act_scales(m, torch.from_numpy(sample)),
            JQ.calibrate_act_scales(jm, jnp.asarray(sample)))


@pytest.fixture(scope="module")
def trunks(merged, ranges):
    """(port's int8 tree, JAX's), both from JAX's ranges."""
    m, jm = merged
    jr = ranges[1]
    return (Q.quantize_trunk(m, {k: tuple(torch.from_numpy(np.array(t))
                                          for t in v)
                                 for k, v in jr.items()}),
            JQ.quantize_trunk(jm, jr))


@pytest.mark.parametrize("k", [(5, 5), (3, 3), (1, 3)])
def test_im2col_patches_match_jax(k):
    x = np.random.default_rng(33).integers(-127, 128, (2, 9, 11, 5),
                                           dtype=np.int8)
    got = im2col_patches(torch.from_numpy(x), *k)
    want = np.asarray(jconv.im2col_patches(jnp.asarray(x), *k))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_calibration_matches_jax(ranges):
    got, want = ranges
    assert set(got) == set(want) == {"f", "l1", "l2"}
    for k in want:
        lo, hi = (np.asarray(t) for t in want[k])
        width = hi - lo
        for g, w in zip(got[k], (lo, hi)):
            assert np.all(np.abs(g.numpy() - w) <= 1e-5 * width), k
        assert (lo <= 0).all() and (hi >= 0).all()


def test_calibration_pads_a_small_sample(merged, sample):
    """One tile pads to the microbatch by repetition: the ranges of one
    tile and of four copies of it agree."""
    m = merged[0]
    one = torch.from_numpy(sample[:1])
    a = Q.calibrate_act_scales(m, one)
    b = Q.calibrate_act_scales(m, torch.cat([one] * 4))
    for k in a:
        for x, y in zip(a[k], b[k]):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


def test_quantize_trunk_matches_jax_bit_for_bit(trunks):
    q, jq = trunks
    for k, v in jq.items():
        want = np.asarray(v)
        got = q[k]
        if got.dtype == torch.bfloat16:
            got, want = got.float(), want.astype(np.float32)
        assert got.numpy().dtype == want.dtype, k
        assert got.numpy().tobytes() == want.tobytes(), k


def test_product_operands_are_the_padded_weights(trunks):
    """``<conv>_m1/_m2``: the HWIO int8 weights as a (K, N) matrix, N
    padded with zeros to a multiple of 8 (96, 96, 64 at width 32), stored
    column-major for ``torch._int_mm``."""
    q = trunks[0]
    for conv, n in (("convA", 96), ("convB", 96), ("convC", 64)):
        for i in ("1", "2"):
            w = q[conv + "_q" + i]
            m = q[conv + "_m" + i]
            kh, kw, cin, cout = w.shape
            assert m.shape == (kh * kw * cin, n) and m.stride() == (1, m.shape[0])
            assert torch.equal(m[:, :cout], w.reshape(-1, cout))
            assert not m[:, cout:].any()


@pytest.mark.parametrize("act,conv", [("f", "convA"), ("l1", "convB"),
                                      ("l2", "convC")])
def test_conv_q8_products_match_jax(trunks, act, conv):
    """The int32 products of the same int8 patches and weights, bit for
    bit, and `_conv_q8`'s dequantised output."""
    q, jq = trunks
    cin = q[conv + "_q1"].shape[2]
    rng = np.random.default_rng(34)
    x = rng.normal(0.0, 0.5, (2, 9, 10, cin)).astype(np.float32)
    kh = q[conv + "_q1"].shape[0]
    xp = np.pad(x, ((0, 0), (kh // 2,) * 2, (kh // 2,) * 2, (0, 0)))
    xq = np.clip(np.round(xp * np.asarray(jq[act + "_invs"]))
                 + np.asarray(jq[act + "_z"]), -127, 127).astype(np.int8)
    pat = im2col_patches(torch.from_numpy(xq), kh, kh).reshape(
        -1, kh * kh * cin)
    for i in ("1", "2"):
        got = Q.int8_mm(pat, q[conv + "_m" + i])[:, :q[conv + "_q1"]
                                                   .shape[3]]
        want = jnp.dot(jnp.asarray(pat.numpy()), jq[conv + "_q" + i].reshape(
            kh * kh * cin, -1), preferred_element_type=jnp.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = Q._conv_q8(torch.from_numpy(x), q, act, conv)
    jy = np.asarray(JQ._conv_q8(jnp.asarray(x), jq, act, conv))
    np.testing.assert_allclose(y.numpy(), jy, rtol=0,
                               atol=1e-6 * np.abs(jy).max())


def test_int8_mm_reference_equals_torch_int_mm():
    """The plain integer product is ``torch._int_mm``'s result on the CPU
    too (the card's chip_smoke holds cuBLASLt's to it)."""
    rng = np.random.default_rng(35)
    a = torch.from_numpy(rng.integers(-127, 128, (40, 800), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (800, 96), dtype=np.int8))
    want = Q.int8_mm_reference(a, b)
    assert want.dtype == torch.int32
    assert torch.equal(torch._int_mm(a, b), want)
    assert torch.equal(Q.int8_mm(a, b.t().contiguous().t()), want)
    with pytest.raises(ValueError, match="cpu or cuda"):
        Q.int8_mm(a.to("meta"), b.to("meta"))


def test_sr_apply_q8_matches_jax(trunks):
    q, jq = trunks
    x = np.random.default_rng(36).random((1, 14, 17, 3), dtype=np.float32)
    got = Q.sr_apply_q8(q, torch.from_numpy(x), 3).numpy()
    want = np.asarray(JQ.sr_apply_q8(jq, jnp.asarray(x), 3))
    assert got.shape == want.shape == (1, 42, 51, 3)
    assert psnr(np.clip(got, 0, 1), np.clip(want, 0, 1)) >= 65.0


@pytest.fixture(scope="module")
def tiled(anime):
    """tiled_sr(engine="int8") of the port and of JAX, and the port's
    exact tier, on the u8 and f32 images."""
    out = {}
    for name, img in (("u8", IMG), ("f32", IMG_F32)):
        kw = dict(tile=16, chunk=4)
        out[name] = (
            tiling.tiled_sr(anime, img, 3, engine="int8", device="cpu", **kw),
            jt.tiled_sr(jtree(anime), img, 3, engine="int8", **kw),
            tiling.tiled_sr(anime, img, 3, device="cpu", **kw))
    return out


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_tiled_int8_matches_jax_and_exact(tiled, kind):
    got, want, exact = tiled[kind]
    assert got.dtype == want.dtype == exact.dtype
    assert got.shape == want.shape == (120, 168, 3)
    s = 255.0 if kind == "u8" else 1.0
    assert psnr(got / s, want / s) >= 65.0
    assert psnr(np.clip(got / s, 0, 1), np.clip(exact / s, 0, 1)) >= 50.0


def test_api_upscale_int8_keeps_u8(anime, tiled):
    got = api.upscale(IMG, anime, 3, engine="int8", tile=16, chunk=4,
                      device="cpu")
    assert got.dtype == np.uint8
    assert got.tobytes() == tiled["u8"][0].tobytes()


def test_int8_trunk_cache_calibrates_once(anime):
    sample = IMG_F32[None, :30, :30]
    cache = {}
    q = tiling._int8_trunk(tiling.trunk_params(anime), sample, False, "cpu",
                           cache)
    assert tiling._int8_trunk(None, None, False, "cpu", cache) is q


def test_int8_retired_from_serving_drivers():
    """As in the JAX package: the batch driver takes no engine."""
    sig = inspect.signature(tiling.tiled_sr_batch)
    assert "engine" not in sig.parameters
    assert "int8_cache" not in sig.parameters
