"""`tiled_sr`'s variant knobs in the port against the JAX package's, on the
CPU, where the conv-stage and epilogue wrappers run their plain versions:
``trunk="flat"``, ``conv0_s2d``, ``conv0_ws``, ``out16`` (also on
`tiled_sr_batch` and `tiled_sr_sharded`), the fused engine's ``packed=``
and ``rh``.

Bounds, from the JAX suite as in tests/test_torch_xla.py:
- fast tier: at most 4 u8 codes against JAX's `tiled_sr` with the same
  knobs (the same bf16 products summed in another order), and the bf16
  class against the port's exact tier (at least 45 dB, at most 8 codes);
- exact tier: the knobs change nothing in JAX, so the port's output is
  byte-identical to its default's;
- ``packed=``: byte-identical to the same call without it.

One JAX compile per knob (a module-scoped cache); tile 16 (padded side
30: even, where "auto" takes the packed tier) and 15 (odd), chunk 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu.parallel import mesh as jmesh
from rusty_sr_tpu.parallel import tiling as jt
from rusty_sr_tpu.params import load_builtin
from rusty_sr_tpu_torch.ops.cuda.shuffle import quantise_u8
from rusty_sr_tpu_torch.ops.cuda.trunk import pack_trunk_weights
from rusty_sr_tpu_torch.parallel import tiling
from rusty_sr_tpu_torch.parallel.mesh import make_mesh, tiled_sr_sharded
from test_torch_xla import assert_bf16_class, codes, jtree, u8_image

BF16 = torch.bfloat16
IMG = u8_image((40, 56, 3), 21)          # tile 16: 12 tiles, 3 chunks of 4
IMG_F32 = IMG.astype(np.float32) / 255.0

# name -> (f32 image?, knobs); every fast case but "packed-out16" runs the
# flat tile kernel.
FAST = {
    "flat": (False, dict(trunk="flat")),
    "flat-direct": (False, dict(trunk="flat", conv0_s2d=False)),
    "flat-ws1": (False, dict(trunk="flat", conv0_ws=False)),
    "flat-direct-ws1": (False, dict(trunk="flat", conv0_s2d=False,
                                    conv0_ws=False)),
    "flat-out32": (False, dict(trunk="flat", out16=False)),
    "flat-bcd": (False, dict(trunk="flat", out16="bcd")),
    "flat-bcd-ws1": (False, dict(trunk="flat", out16="bcd", conv0_ws=False)),
    "odd-ws1": (False, dict(tile=15, conv0_ws=False)),
    "odd-out32": (False, dict(tile=15, out16=False)),
    "odd-bcd": (False, dict(tile=15, out16="bcd")),
    "f32-ws1": (True, dict(conv0_ws=False)),
    "f32-out32": (True, dict(out16=False)),
    "f32-bcd": (True, dict(out16="bcd", conv0_ws=False)),
    "packed-out16": (False, dict(out16=False)),
}


@pytest.fixture(scope="module")
def anime():
    return load_builtin("anime")


@pytest.fixture(scope="module")
def runs(anime):
    """Lazily computed outputs, each once: (engine side, f32?, knobs)."""
    cache = {}

    def get(side, f32, fast, **kw):
        kw = {"tile": 16, "chunk": 4, **kw}
        key = (side, f32, fast, tuple(sorted(kw.items())))
        if key not in cache:
            img = IMG_F32 if f32 else IMG
            if side == "jax":
                cache[key] = jt.tiled_sr(
                    jtree(anime), img, 3,
                    compute_dtype=jnp.bfloat16 if fast else None, **kw)
            else:
                cache[key] = tiling.tiled_sr(
                    anime, img, 3, compute_dtype=BF16 if fast else None,
                    device="cpu", **kw)
        return cache[key]
    return get


def as_u8(x):
    return x if x.dtype == np.uint8 else quantise_u8(torch.from_numpy(x)) \
        .numpy()


@pytest.mark.parametrize("name", list(FAST))
def test_fast_knobs_match_jax(runs, name):
    f32, kw = FAST[name]
    got = runs("port", f32, True, **kw)
    want = runs("jax", f32, True, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == (120, 168,
                                                                   3)
    assert codes(as_u8(got), as_u8(want)) <= 4
    tile = kw.get("tile", 16)
    assert_bf16_class(as_u8(got), as_u8(runs("port", f32, False, tile=tile)))
    if name == "packed-out16":      # the packed tier has no stage outputs
        assert got.tobytes() == runs("port", f32, True).tobytes()


def test_knobs_change_the_flat_tier(runs):
    """Each knob reaches the kernel: the outputs differ from one another
    (the JAX package's differ too)."""
    outs = {name: runs("port", False, True, **FAST[name][1]).tobytes()
            for name in ("flat", "flat-direct", "flat-ws1", "flat-out32",
                         "flat-bcd")}
    assert len(set(outs.values())) == len(outs)


@pytest.mark.parametrize("f32", [False, True], ids=["u8", "f32"])
@pytest.mark.parametrize("kw", [
    dict(trunk="flat"), dict(conv0_s2d=False), dict(conv0_ws=False),
    dict(out16=True), dict(out16="bcd", conv0_ws=False, trunk="flat")],
    ids=["flat", "direct", "ws1", "out16", "all"])
def test_exact_tier_ignores_knobs(runs, f32, kw):
    got = runs("port", f32, False, **kw)
    assert got.tobytes() == runs("port", f32, False).tobytes()


def test_fused_packed_weights_are_taken(anime, monkeypatch):
    img = IMG_F32[:20, :30]
    for cd in (None, BF16):
        pk = pack_trunk_weights(tiling.trunk_params(anime), 3,
                                cd or torch.float32)
        want = tiling.tiled_sr(anime, img, 3, tile=16, chunk=4,
                               engine="fused", compute_dtype=cd,
                               device="cpu")
        monkeypatch.setattr(tiling, "pack_trunk_weights", None)  # not packed
        got = tiling.tiled_sr(None, img, 3, tile=16, chunk=4, engine="fused",
                              compute_dtype=cd, packed=pk, rh=5,
                              device="cpu")
        monkeypatch.undo()
        assert got.tobytes() == want.tobytes()


def test_knob_values_are_checked(anime):
    kw = dict(tile=16, chunk=4, device="cpu")
    with pytest.raises(ValueError, match="out16"):
        tiling.tiled_sr(anime, IMG, compute_dtype=BF16, out16="bc", **kw)
    with pytest.raises(ValueError, match="trunk"):
        tiling.tiled_sr(anime, IMG, compute_dtype=BF16, trunk="packed", **kw)
    with pytest.raises(ValueError, match="rh"):
        tiling.tiled_sr(anime, IMG_F32, engine="fused", rh=0, **kw)
    with pytest.raises(ValueError, match="engine"):
        tiling.tiled_sr(anime, IMG, engine="int4", **kw)


@pytest.mark.parametrize("out16", [False, "bcd"])
def test_batch_out16_matches_jax(anime, out16):
    """`tiled_sr_batch(out16=)` on tile 15 (the flat tier) over two
    images, against JAX's; the first image also against `tiled_sr`."""
    imgs = [IMG, u8_image((23, 31, 3), 22)]
    kw = dict(tile=15, chunk=4)
    got = tiling.tiled_sr_batch(anime, imgs, 3, compute_dtype=BF16,
                                out16=out16, device="cpu", **kw)
    want = jt.tiled_sr_batch(jtree(anime), imgs, 3,
                             compute_dtype=jnp.bfloat16, out16=out16, **kw)
    exact = tiling.tiled_sr_batch(anime, imgs, 3, device="cpu", **kw)
    for g, w, x in zip(got, want, exact):
        assert g.shape == w.shape and codes(g, w) <= 4
        assert_bf16_class(g, x)
    one = tiling.tiled_sr(anime, IMG, 3, compute_dtype=BF16, out16=out16,
                          device="cpu", **kw)
    assert codes(got[0], one) <= 1


def test_sharded_out16_matches_jax(anime):
    kw = dict(tile=15, chunk=2, compute_dtype=BF16, out16=False)
    got = tiled_sr_sharded(anime, IMG, make_mesh(2, devices=["cpu"] * 2), 3,
                           **kw)
    want = jmesh.tiled_sr_sharded(jtree(anime), IMG, jmesh.make_mesh(2), 3,
                                  **{**kw, "compute_dtype": jnp.bfloat16})
    assert codes(got, want) <= 4
    one = tiling.tiled_sr_batch(anime, [IMG], 3, device="cpu", **kw)[0]
    assert codes(got, one) <= 1
