"""The epilogue's plain version with the base from the edge tiles, on the
CPU.

- `epilogue_reference(..., edge=)` is byte-identical to the composition
  the tile kernels ran before the base moved into the kernel: the plain
  `bilinear_phases_cropped` of the cast edge tiles, then the addend form
  (``base + crop(x)``, or ``x + base`` for the fused engine), quantised,
  then depth-to-space;
- it is within 1 u8 code and f32 atol 3e-6 (the JAX suite's exact-tier
  bounds) of the JAX package's tail on the same inputs:
  `rusty_sr_tpu.ops.resize.bilinear_phases_cropped`, the crop, the
  quantisation and `rusty_sr_tpu.ops.pixel_shuffle.depth_to_space`;
- the tile kernels hand the edge tiles to the epilogue and compute no
  base themselves;
- the wrapper refuses a base window without its one pixel of margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu.ops.pixel_shuffle import depth_to_space as j_d2s
from rusty_sr_tpu.ops.resize import bilinear_phases_cropped as j_cropped
from rusty_sr_tpu_torch.ops.cuda import shuffle
from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
from rusty_sr_tpu_torch.ops.resize import bilinear_phases_cropped
from rusty_sr_tpu_torch.parallel import tiling

H = tiling.HALO
ATOL = 3e-6


def inputs(seed, factor, tile, edge_u8, offset=H):
    """x (3, S, S, f*f*3) near [0, 1] with S = tile + 2*offset, and edge
    tiles (3, tile + 2*H, tile + 2*H, 3), u8 or f32 in [0, 1]."""
    r = np.random.default_rng(seed)
    side = tile + 2 * offset
    x = r.normal(0.5, 0.4, (3, side, side, 3 * factor * factor)).astype(
        np.float32)
    es = tile + 2 * H
    edge = (r.integers(0, 256, (3, es, es, 3), dtype=np.uint8) if edge_u8
            else r.random((3, es, es, 3), dtype=np.float32))
    return x, edge


def old_composition(x, edge, factor, tile, offset, to_u8):
    """The tile kernels' epilogue before this form: the plain base, then
    the kernel's addend form."""
    e = edge.float() * (1.0 / 255.0) if edge.dtype == torch.uint8 else edge
    base = bilinear_phases_cropped(e, factor, H, H, tile)
    if offset == 0:                      # the fused engine: x + addend
        return depth_to_space(x + base, factor)
    t = base + x[:, offset:offset + tile, offset:offset + tile, :]
    return depth_to_space(shuffle.quantise_u8(t) if to_u8 else t, factor)


CASES = [(3, 9, True, True), (3, 9, False, False), (2, 8, True, True),
         (4, 5, False, True), (2, 7, False, False)]


@pytest.mark.parametrize(
    "factor,tile,edge_u8,to_u8,offset",
    [c + (H,) for c in CASES]                          # the xla engine
    + [(f, t, u8, False, 0) for f, t, u8, _ in CASES[:3]])   # fused, f32
def test_reference_is_the_old_composition(factor, tile, edge_u8, to_u8,
                                          offset):
    x, edge = inputs(factor * 7 + tile, factor, tile, edge_u8, offset)
    xt, et = torch.from_numpy(x), torch.from_numpy(edge)
    got = shuffle.epilogue_reference(xt, factor, tile, offset, et,
                                     to_u8=to_u8)
    want = old_composition(xt, et, factor, tile, offset, to_u8)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.numpy().tobytes()


def j_tail(x, edge, factor, tile, offset, to_u8):
    """The JAX package's ops on the same values: the cropped phases, the
    crop, the sum, its u8 rule and depth-to-space."""
    e = jnp.asarray(edge, jnp.float32)
    if edge.dtype == np.uint8:
        e = e * (1.0 / 255.0)
    t = j_cropped(e, factor, H, H, tile) + jnp.asarray(
        x[:, offset:offset + tile, offset:offset + tile])
    if to_u8:
        t = jnp.floor(jnp.clip(t, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    return np.asarray(j_d2s(t, factor))


@pytest.mark.parametrize("factor,tile,edge_u8,to_u8", CASES)
def test_reference_matches_the_jax_tail(factor, tile, edge_u8, to_u8):
    x, edge = inputs(factor * 11 + tile, factor, tile, edge_u8)
    got = shuffle.epilogue_reference(
        torch.from_numpy(x), factor, tile, H, torch.from_numpy(edge),
        to_u8=to_u8).numpy()
    want = j_tail(x, edge, factor, tile, H, to_u8)
    assert got.dtype == want.dtype and got.shape == want.shape
    if to_u8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _no_plain_base(*args, **kwargs):
    raise AssertionError("a tile kernel computed the plain bilinear base")


@pytest.mark.parametrize("form", ["exact-u8", "exact-f32", "fast-flat-u8",
                                  "fused"])
def test_tile_kernels_leave_the_base_to_the_epilogue(monkeypatch, form):
    """The device path of `_tile_kernel` and `_tile_kernel_fused` runs no
    plain `bilinear_phases_cropped` and materialises no f32 base: it hands
    the trunk's expand and the edge tiles, as gathered, to `epilogue_cuda`,
    whose kernel computes the base (on the CPU its plain version does, as
    the card's kernel would).  The trunk is a stand-in that returns a
    fixed expand, so the result is exactly the epilogue of the two."""
    tile, u8 = 9, form != "exact-f32" and form != "fused"
    img = np.random.default_rng(5).integers(0, 256, (14, 17, 3),
                                            dtype=np.uint8)
    if not u8:
        img = img.astype(np.float32) / 255.0
    z, e, m = tiling.native.gather_tiles_range(img, tile, H, 2, 0, 4)
    z, e, m = (torch.from_numpy(t) for t in (z, e, m))
    side = tile if form == "fused" else tile + 2 * H
    expand = torch.from_numpy(np.random.default_rng(6).normal(
        0.5, 0.4, (4, side, side, 27)).astype(np.float32))
    seen = []

    def epilogue(x, factor, tile_, offset, edge=None, **kw):
        seen.append((edge, kw))
        return shuffle.epilogue_cuda(x, factor, tile_, offset, edge, **kw)

    monkeypatch.setattr(tiling, "bilinear_phases_cropped", _no_plain_base)
    monkeypatch.setattr(tiling, "epilogue_cuda", epilogue)
    if form == "fused":
        monkeypatch.setattr(tiling, "fused_trunk", lambda *a: expand)
        got = tiling._tile_kernel_fused(None, z, e, m, 3, tile,
                                        torch.float32)
    else:
        fast = form.startswith("fast")
        monkeypatch.setattr(tiling, "_flat_fast_trunk" if fast
                            else "_flat_exact_trunk", lambda *a: expand)
        got = tiling._tile_kernel(None, z, e, m, 3, tile, fast, u8)
    want = shuffle.epilogue_reference(expand, 3, tile,
                                      0 if form == "fused" else H, e,
                                      edge_offset=H, to_u8=u8)
    assert len(seen) == 1 and seen[0][0] is e
    assert "addend" not in seen[0][1]
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_epilogue_refuses_a_base_without_margin():
    x, edge = inputs(1, 3, 6, True)
    xt, et = torch.from_numpy(x), torch.from_numpy(edge)
    with pytest.raises(ValueError, match="margin"):
        shuffle.epilogue_cuda(xt, 3, 6, H, et, edge_offset=0)
    with pytest.raises(ValueError, match="margin"):
        shuffle.epilogue_cuda(xt, 3, 6, H, et[:, :13, :13].contiguous())
    with pytest.raises(ValueError, match="shape"):
        shuffle.epilogue_cuda(xt, 3, 6, H, et[:2])
    with pytest.raises(TypeError, match="dtype"):
        shuffle.epilogue_cuda(xt, 3, 6, H, et.double())
    with pytest.raises(ValueError, match="no edge tiles"):
        shuffle.epilogue_cuda(tiling._pack_s2d(xt), 3, 6, H, et, to_u8=True,
                              packed=True)
    wide = np.zeros((1, 12, 12, 3 * 81), np.float32)
    with pytest.raises(ValueError, match="factors up to"):
        shuffle.epilogue_cuda(torch.from_numpy(wide), 9, 6, 3,
                              torch.zeros((1, 12, 12, 3)), edge_offset=3)
