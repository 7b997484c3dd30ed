"""The port's xla engine (the default) against the JAX package's, on the
CPU, where the conv-stage and epilogue wrappers run their plain versions.

Bounds, all from the JAX suite:
- exact tier: f32 atol 3e-6 (tests/test_tiling.py's exact-tier bound)
  and at most 1 u8 code (outputs within 3e-6 can still round to
  neighbouring codes);
- fast tiers (packed and flat): at most 4 u8 codes against JAX's same
  tier — its bound for the same bf16 products summed in another order
  (tests/test_tiling.py:142) — and at least 45 dB and at most 8 codes
  against the exact tier (its bf16 class);
- the gather, the weights and the packed kernel's two input forms: bit
  for bit.

Synthetic images and in-repo weights only; small tiles (16: padded side
30, even, the packed tier; 15: odd, the flat fast tier) and chunks of 4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu import api as j_api
from rusty_sr_tpu import cli as j_cli
from rusty_sr_tpu.params import load_builtin, load_rsr_file
from rusty_sr_tpu.parallel import tiling as jt
from rusty_sr_tpu_torch import api, cli
from rusty_sr_tpu_torch.ops.cuda import conv_stage, shuffle
from rusty_sr_tpu_torch.parallel import tiling
from rusty_sr_tpu_torch.utils.imageio import load_image_u8, psnr, save_image_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = tiling.HALO
ATOL = 3e-6
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def anime():
    return load_builtin("anime")


def jtree(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def u8_image(shape, seed=0):
    """Smooth gradients plus noise, as u8: nearer to real images than
    uniform noise, and still every code in use."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    base = np.stack([xx / max(shape[1], 1), yy / max(shape[0], 1),
                     0.5 + 0.5 * np.sin(xx / 5.0 + yy / 7.0)], axis=-1)
    base = base + r.normal(0.0, 0.08, base.shape)
    return (np.clip(base, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def codes(a, b):
    """Max u8 difference between two uint8 arrays."""
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def assert_bf16_class(fast, exact):
    assert psnr(fast / 255.0, exact / 255.0) >= 45.0
    assert codes(fast, exact) <= 8


@pytest.mark.parametrize("need_zero", [True, False])
@pytest.mark.parametrize("tile,t0,t1", [(16, 0, 12), (15, 3, 9), (7, 5, 6)])
def test_gather_u8_range_matches_jax(tile, t0, t1, need_zero):
    img = u8_image((40, 56, 3), 1)
    nx = -(-56 // tile)
    got = tiling.native.gather_tiles_range(img, tile, H, nx, t0, t1,
                                           need_zero)
    want = jt._gather_u8_range(img, tile, H, nx, t0, t1, need_zero)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype == np.uint8
            assert g.tobytes() == w.tobytes()


def test_gather_u8_whole_grid_matches_jax():
    img = u8_image((23, 31, 3), 2)
    got = tiling.native.gather_tiles_range(img, 10, H, 4, 0, 12)
    want = jt._gather_u8(img, 10, H, 3, 4)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.tobytes() == w.tobytes()
    # A float image takes the f32 gather: the same tiles, as float32.
    got_f = tiling.native.gather_tiles_range(img.astype(np.float32), 10, H,
                                             4, 0, 12)
    for g, w in zip(got_f, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w.astype(np.float32))


def tiles_u8(img, tile, count, need_zero=True):
    nx = -(-img.shape[1] // tile)
    return tiling.native.gather_tiles_range(img, tile, H, nx, 0, count,
                                            need_zero)


def run_port_flat(params, z, e, m, tile, fast, u8_io):
    fp = tiling.flat_trunk_params(params, fast)
    return tiling._tile_kernel(fp, *(torch.from_numpy(t) for t in (z, e, m)),
                               3, tile, fast, u8_io).numpy()


def run_jax_flat(params, z, e, m, tile, fast, u8_io):
    return np.asarray(jt._tile_kernel(
        jt.trunk_params(jtree(params)), jnp.asarray(z), jnp.asarray(e),
        jnp.asarray(m), 3, tile, jnp.bfloat16 if fast else None, u8_io,
        fast))


@pytest.mark.parametrize("tile", [16, 15])
def test_exact_tile_kernel_u8_matches_jax(anime, tile):
    z, e, m = tiles_u8(u8_image((40, 45, 3), 3), tile, 4)
    got = run_port_flat(anime, z, e, m, tile, False, True)
    want = run_jax_flat(anime, z, e, m, tile, False, True)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (4, 3 * tile, 3 * tile, 3)
    assert codes(got, want) <= 1


def test_exact_tile_kernel_f32_matches_jax(anime):
    img = u8_image((40, 45, 3), 4).astype(np.float32) / 255.0
    z, e, m = tiling.native.gather_tiles_range(img, 16, H, 3, 0, 4)
    got = run_port_flat(anime, z, e, m, 16, False, False)
    want = run_jax_flat(anime, z, e, m, 16, False, False)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("case", ["u8-odd", "f32"])
def test_flat_fast_tier_matches_jax(anime, case):
    """The flat fast tier: u8 tiles of an odd side (the split u8-exact
    conv0, K = 2*3) and f32 tiles (the three-term split conv0, K = 3*3)."""
    img = u8_image((40, 45, 3), 5)
    if case == "u8-odd":
        z, e, m = tiles_u8(img, 15, 4)
        u8_io, tile = True, 15
    else:
        z, e, m = tiling.native.gather_tiles_range(
            img.astype(np.float32) / 255.0, 16, H, 3, 0, 4)
        u8_io, tile = False, 16
    got = run_port_flat(anime, z, e, m, tile, True, u8_io)
    want = run_jax_flat(anime, z, e, m, tile, True, u8_io)
    exact = run_port_flat(anime, z, e, m, tile, False, u8_io)
    if not u8_io:
        got, want, exact = (shuffle.quantise_u8(torch.tensor(t)).numpy()
                            for t in (got, want, exact))
    assert codes(got, want) <= 4
    assert_bf16_class(got, exact)


def run_port_packed(params, z, e, m, tile):
    pp = tiling.packed_trunk_params(params, 3)
    return tiling._tile_kernel_packed(
        pp, None if z is None else torch.from_numpy(z), torch.from_numpy(e),
        torch.from_numpy(m), 3, tile).numpy()


def test_packed_tile_kernel_matches_jax(anime):
    img = u8_image((40, 45, 3), 6)
    z, e, m = tiles_u8(img, 16, 4)
    got = run_port_packed(anime, None, e, m, 16)
    want = np.asarray(jt._tile_kernel_packed(
        jt.packed_trunk_params(jt.trunk_params(jtree(anime)), jnp.bfloat16,
                               3), None, jnp.asarray(e), jnp.asarray(m), 3,
        16))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (4, 48, 48, 3)
    assert codes(got, want) <= 4
    assert_bf16_class(got, run_port_flat(anime, z, e, m, 16, False, True))


def test_packed_two_and_three_input_forms_bit_identical(anime):
    """Zero-padded tiles derived on the device (edge * mask) are the
    gathered zero-padded tiles, byte for byte."""
    z, e, m = tiles_u8(u8_image((37, 21, 3), 7), 16, 6)
    two = run_port_packed(anime, None, e, m, 16)
    three = run_port_packed(anime, z, e, m, 16)
    assert two.tobytes() == three.tobytes()


def test_packed_tier_rounds_stage_outputs_like_jax(anime, monkeypatch):
    """JAX on the CPU rounds the packed stages' bf16 outputs (a, b, c)
    even where only an f32 read follows: leaving them in f32 moves the
    port several codes away from it."""
    z, e, m = tiles_u8(u8_image((40, 45, 3), 6), 16, 4)
    want = np.asarray(jt._tile_kernel_packed(
        jt.packed_trunk_params(jt.trunk_params(jtree(anime)), jnp.bfloat16,
                               3), None, jnp.asarray(e), jnp.asarray(m), 3,
        16))
    rounded = run_port_packed(anime, None, e, m, 16)
    monkeypatch.setattr(tiling, "conv_stage", lambda x, w, out_dtype=None:
                        conv_stage.conv_stage_reference(x, w))
    unrounded = run_port_packed(anime, None, e, m, 16)
    diff = np.abs(want.astype(int) - rounded.astype(int))
    diff_f32 = np.abs(want.astype(int) - unrounded.astype(int))
    assert (diff > 0).mean() < (diff_f32 > 0).mean() / 10


SHAPES = [(40, 56, 3), (37, 21, 3), (1, 1, 3), (1, 7, 3), (5, 1, 3)]
SHAPE_IDS = ["40x56", "ragged-37x21", "1x1", "1x7", "5x1"]


@pytest.mark.parametrize("tier", ["exact", "packed", "flat"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_tiled_sr_xla_matches_jax(anime, shape, tier):
    img = u8_image(shape, 8)
    tile = 15 if tier == "flat" else 16
    cd = None if tier == "exact" else BF16
    got = tiling.tiled_sr(anime, img, 3, tile=tile, chunk=4, device="cpu",
                          compute_dtype=cd)
    want = jt.tiled_sr(jtree(anime), img, 3, tile=tile, chunk=4,
                       compute_dtype=None if cd is None else jnp.bfloat16)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (shape[0] * 3, shape[1] * 3, 3)
    assert codes(got, want) <= (1 if tier == "exact" else 4)
    if tier != "exact":
        exact = tiling.tiled_sr(anime, img, 3, tile=tile, chunk=4,
                                device="cpu")
        if img.size > 3:
            assert_bf16_class(got, exact)
        else:
            assert codes(got, exact) <= 8


@pytest.mark.parametrize("name,factor", [("imagenet", 3),
                                         ("imagenetlinear", 3),
                                         ("factor2", 2), ("factor4", 4)])
def test_tiled_sr_xla_other_weights_match_jax(name, factor):
    params = load_builtin(name) if factor == 3 else load_rsr_file(
        os.path.join(ROOT, "tests", "fixtures", f"{name}.rsr"), factor)
    img = u8_image((21, 30, 3), 9)
    for cd, bound in ((None, 1), (BF16, 4)):
        got = tiling.tiled_sr(params, img, factor, tile=16, chunk=4,
                              device="cpu", compute_dtype=cd)
        want = jt.tiled_sr(jtree(params), img, factor, tile=16, chunk=4,
                           compute_dtype=None if cd is None
                           else jnp.bfloat16)
        assert got.shape == want.shape == (21 * factor, 30 * factor, 3)
        assert codes(got, want) <= bound


def test_tiled_sr_xla_f32_matches_jax(anime):
    img = u8_image((37, 21, 3), 10).astype(np.float32) / 255.0
    got = tiling.tiled_sr(anime, img, 3, tile=16, chunk=4, device="cpu")
    want = jt.tiled_sr(jtree(anime), img, 3, tile=16, chunk=4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_api_upscale_dtype_contract(anime):
    u8 = u8_image((9, 14, 3), 11)
    kw = dict(tile=16, chunk=4, device="cpu")
    got = api.upscale(u8, anime, 3, **kw)
    assert got.dtype == np.uint8 and got.shape == (27, 42, 3)
    assert got.tobytes() == tiling.tiled_sr(anime, u8, 3, **kw).tobytes()
    assert codes(got, j_api.upscale(u8, jtree(anime), 3, tile=16,
                                    chunk=4)) <= 1
    fast = api.upscale(u8, anime, 3, fast=True, **kw)
    assert fast.dtype == np.uint8
    f32 = api.upscale(u8.astype(np.float32) / 255.0, anime, 3, **kw)
    assert f32.dtype == np.float32 and f32.shape == (27, 42, 3)
    assert api.upscale(u8, anime, 3, engine="fused", **kw).dtype == \
        np.float32
    with pytest.raises(ValueError, match="finite sRGB"):
        api.upscale(np.full((4, 4, 3), 1.5, np.float32), anime, **kw)


@pytest.fixture(scope="module")
def lr_png(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("png") / "lr.png")
    save_image_u8(path, u8_image((26, 35, 3), 12))
    return path


@pytest.mark.parametrize("flags,bound", [([], 1), (["--fast"], 4),
                                         (["--fast", "--tile", "15"], 4)],
                         ids=["exact", "fast-packed", "fast-flat"])
def test_cli_default_engine_matches_jax_cli(lr_png, tmp_path, capsys, flags,
                                            bound):
    """No --engine: the xla engine on both sides, the same flags; the
    fast tiers also in the bf16 class against the exact tier."""
    base = ["--platform", "cpu", "--chunk", "4", "-p", "anime"]
    if "--tile" not in flags:
        base += ["--tile", "16"]
    assert cli.main(base + flags + [lr_png, str(tmp_path / "t.png")]) == 0
    err = capsys.readouterr().err
    assert ("tip:" in err) == (not flags)
    assert j_cli.main(base + flags + [lr_png, str(tmp_path / "j.png")]) == 0
    t = load_image_u8(str(tmp_path / "t.png"))
    j = load_image_u8(str(tmp_path / "j.png"))
    assert t.shape == j.shape == (78, 105, 3)
    assert codes(t, j) <= bound
    if flags:
        tile = flags[-1] if "--tile" in flags else "16"
        assert cli.main(["--platform", "cpu", "--chunk", "4", "-p", "anime",
                         "--tile", tile, lr_png,
                         str(tmp_path / "e.png")]) == 0
        assert_bf16_class(t, load_image_u8(str(tmp_path / "e.png")))
