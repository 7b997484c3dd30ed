"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances (chip_smoke.py holds the main path's shapes to the same):
- trunk, f32: atol 1e-5 — the kernel and cuDNN sum up to 800 products in
  other orders;
- trunk, bf16: max abs 1e-2 and mean abs 1e-4 — a sum in another order
  can put a value on the other side of a bf16 rounding boundary, and the
  later stages carry that ulp (tests/test_torch_trunk.py);
- depth-to-space and the epilogue: byte-identical (one f32 add per
  element and the same quantisation arithmetic on both sides);
- conv stage with a fused epilogue: byte-identical to the same kernel
  without it followed by the plain glue (the same accumulators, the same
  f32 operations in the same order);
- conv stage: f32 out within 1e-5 of the largest output (exact bf16
  products, f32 sums in another order and in the tensor cores'
  accumulator); bf16 out within that bound plus one bf16 ulp (the
  rounding of f32 sums that differ can cross a midpoint; measured on an
  H100, kernel and cuDNN alike reach tens of ulps on values that cancel
  to near zero), with at most 1e-3 of the values differing;
- the fast tiers end to end: 4 u8 codes, the JAX suite's bound for the
  same bf16 products summed in another order; the exact tier 1 code;
- a float32 training step: each gradient leaf within 1e-4 of its largest
  magnitude of a float64 step on the CPU (TF32 would be ~1e-3).
"""

import os

import numpy as np
import pytest
import torch

from rusty_sr_tpu_torch.api import upscale
from rusty_sr_tpu_torch.ops.cuda import conv_stage, shuffle, trunk
from rusty_sr_tpu_torch.ops.cuda.conv_stage import Epilogue, FusedStage
from rusty_sr_tpu_torch.parallel import tiling
from rusty_sr_tpu_torch.params import init_params, load_builtin
from rusty_sr_tpu_torch.utils.imageio import to_u8

TOL = 1e-5
BF16_MAX, BF16_MEAN = 1e-2, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def params_for(factor):
    """anime at x3, random init at x2, the factor-4 fixture (e = 48)."""
    if factor == 4:
        import os
        from rusty_sr_tpu_torch.params import load_rsr_file
        return load_rsr_file(os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "fixtures", "factor4.rsr"), 4)
    return load_builtin("anime") if factor == 3 else init_params(7, 2)


# (factor, S, seed): sides 13, 11 and 23 that are multiples of neither
# kernel's block (f32 12x12; bf16 8 rows of up to 22 columns, 21 at
# factor 3), 24 that fills whole f32 blocks and whole bf16 block rows, 45
# that spans several blocks of both, factor 4.
TRUNK_CASES = [(3, 13, 3), (3, 24, 4), (2, 11, 5), (4, 23, 6), (3, 45, 7)]


def tiles(seed, bsz, s):
    """Zero-padded tiles; the odd ones hold an image corner that ends
    inside the tile, so their mask zeroes a ring on two sides."""
    r = np.random.default_rng(seed)
    side = s + 2 * trunk.HALO
    x = np.zeros((bsz, side, side, 3), np.float32)
    m = np.zeros((bsz, side, side, 1), np.float32)
    for b in range(bsz):
        hh, ww = (r.integers(1, s + 1), r.integers(1, s + 1)) if b % 2 \
            else (side, side)
        y0 = trunk.HALO if b % 2 else 0
        x[b, y0:y0 + hh, y0:y0 + ww] = r.random((hh, ww, 3), np.float32)
        m[b, y0:y0 + hh, y0:y0 + ww] = 1.0
    return x, m


@pytest.mark.cuda
@pytest.mark.parametrize("factor,s,seed", TRUNK_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, factor, s, seed):
    params = params_for(factor)
    x, m = tiles(seed, 3, s)
    packed = {k: v.to(cuda_device)
              for k, v in trunk.pack_trunk_weights(params, factor).items()}
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(m).to(cuda_device)
    before = trunk.LAUNCHES[torch.float32]
    got = trunk.fused_trunk(packed, xt, mt, factor)
    torch.cuda.synchronize()
    assert trunk.LAUNCHES[torch.float32] == before + 1
    want = trunk.fused_trunk_reference(packed, xt, mt, factor)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("factor,s,seed", TRUNK_CASES)
def test_cuda_bf16_kernel_matches_plain_version(cuda_device, factor, s, seed):
    params = params_for(factor)
    x, m = tiles(seed, 3, s)
    x = np.round(x * 255.0) / np.float32(255.0)     # the CLI's u8 values
    packed = {k: v.to(cuda_device) for k, v in trunk.pack_trunk_weights(
        params, factor, torch.bfloat16).items()}
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(m).to(cuda_device)
    before = dict(trunk.LAUNCHES)
    got = trunk.fused_trunk(packed, xt, mt, factor, torch.bfloat16)
    torch.cuda.synchronize()
    assert trunk.LAUNCHES[torch.bfloat16] == before[torch.bfloat16] + 1
    assert trunk.LAUNCHES[torch.float32] == before[torch.float32]
    want = trunk.fused_trunk_reference(packed, xt, mt, factor)
    assert torch.isfinite(got).all()
    d = (got - want).abs()
    assert d.max() <= BF16_MAX and d.mean() <= BF16_MEAN, \
        (float(d.max()), float(d.mean()))


def same_bytes(got, want) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.contiguous().view(torch.uint8),
                            want.contiguous().view(torch.uint8)))


@pytest.mark.cuda
@pytest.mark.parametrize("factor,shape,dtype", [
    (3, (4, 21, 19, 27), torch.float32), (2, (3, 11, 13, 12), torch.float32),
    (3, (2, 17, 9, 27), torch.uint8), (2, (70000, 1, 1, 12), torch.float32),
    (4, (3, 5, 700, 48), torch.uint8)],
    ids=["f3-f32", "f2-f32", "f3-u8", "f2-many-rows", "f4-u8-wide"])
def test_cuda_shuffle_is_byte_identical(cuda_device, factor, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(factor)
    if dtype == torch.uint8:
        x = torch.randint(0, 256, shape, generator=g, dtype=dtype)
    else:
        x = torch.randn(shape, generator=g)
    x = x.to(cuda_device)
    before = shuffle.LAUNCHES
    got = shuffle.depth_to_space_cuda(x, factor)
    torch.cuda.synchronize()
    assert shuffle.LAUNCHES == before + 1
    assert same_bytes(got, shuffle.depth_to_space_reference(x, factor))


@pytest.mark.cuda
def test_cuda_tiled_path_matches_cpu(cuda_device):
    img = np.random.default_rng(6).random((37, 50, 3), dtype=np.float32)
    anime = load_builtin("anime")
    before = trunk.LAUNCHES[torch.float32]
    before_epi = shuffle.EPILOGUE_LAUNCHES
    got = upscale(img, anime, 3, engine="fused", tile=21, chunk=4,
                  device=cuda_device)
    # 2x3 tiles in two chunks
    assert trunk.LAUNCHES[torch.float32] == before + 2
    assert shuffle.EPILOGUE_LAUNCHES == before_epi + 2
    want = upscale(img, anime, 3, engine="fused", tile=21, chunk=4,
                   device="cpu")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_cuda_fast_tier_matches_cpu(cuda_device):
    u8 = np.random.default_rng(7).integers(0, 256, (37, 50, 3),
                                           dtype=np.uint8)
    anime = load_builtin("anime")
    before = trunk.LAUNCHES[torch.bfloat16]
    got = upscale(u8, anime, 3, fast=True, engine="fused", tile=21, chunk=4,
                  device=cuda_device)
    assert trunk.LAUNCHES[torch.bfloat16] == before + 2
    want = upscale(u8, anime, 3, fast=True, engine="fused", tile=21,
                   chunk=4, device="cpu")
    d = np.abs(to_u8(got).astype(int) - to_u8(want).astype(int))
    assert d.max() <= 4


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    packed = {k: v.to(cuda_device) for k, v in
              trunk.pack_trunk_weights(load_builtin("anime"), 3).items()}
    x = torch.zeros((1, 20, 20, 3), device=cuda_device)
    m = torch.zeros((1, 20, 20, 1), device=cuda_device)
    with pytest.raises(TypeError):
        trunk.fused_trunk(packed, x.double(), m, 3)
    with pytest.raises(ValueError):
        trunk.fused_trunk(packed, x, m[:, :19], 3)
    with pytest.raises(ValueError):
        trunk.fused_trunk(packed, x.transpose(1, 2), m, 3)
    with pytest.raises(ValueError):
        trunk.fused_trunk(packed, x, m, 2)
    with pytest.raises(ValueError):
        trunk.fused_trunk({k: v.cpu() for k, v in packed.items()}, x, m, 3)
    with pytest.raises(ValueError, match="packed as"):
        trunk.fused_trunk(packed, x, m, 3, torch.bfloat16)
    bf16 = {k: v.to(cuda_device) for k, v in trunk.pack_trunk_weights(
        load_builtin("anime"), 3, torch.bfloat16).items()}
    with pytest.raises(TypeError):
        trunk.fused_trunk(bf16, x.half(), m, 3)
    with pytest.raises(ValueError):
        trunk.fused_trunk(bf16, x.transpose(1, 2), m, 3)
    # the kernels' weight forms: the f32 padded rows, the bf16 B image
    with pytest.raises(ValueError):
        trunk.fused_trunk(dict(packed, wB_padded=packed["wB_padded"][:, :88]
                               .contiguous()), x, m, 3)
    img = bf16["w_mma"]
    shifted = torch.empty(img.numel() + 8, device=cuda_device,
                          dtype=img.dtype)[1:1 + img.numel()]
    shifted.copy_(img)
    bad = [(TypeError, dict(bf16, w_mma=img.float())),             # dtype
           (ValueError, dict(bf16, w_mma=img[:-8].contiguous())),  # layout
           (ValueError, dict(bf16, w_mma=img.reshape(-1, 8))),     # layout
           (ValueError, dict(bf16, w_mma=shifted)),                # aligned
           (ValueError, {k: v for k, v in bf16.items() if k != "w_mma"}),
           (ValueError, dict(bf16, w_mma=img.cpu()))]
    for err, pk in bad:
        with pytest.raises(err):
            trunk.fused_trunk(pk, x, m, 3)
    shifted32 = torch.empty(packed["wA_padded"].numel() + 4,
                            device=cuda_device)[1:].view(-1)[
        :packed["wA_padded"].numel()].view(packed["wA_padded"].shape)
    shifted32.copy_(packed["wA_padded"])
    with pytest.raises(ValueError, match="16-byte"):
        trunk.fused_trunk(dict(packed, wA_padded=shifted32), x, m, 3)


@pytest.mark.cuda
def test_cuda_shuffle_rejects_bad_inputs(cuda_device):
    x = torch.zeros((2, 4, 5, 27), device=cuda_device)
    with pytest.raises(TypeError):
        shuffle.depth_to_space_cuda(x.double(), 3)
    with pytest.raises(ValueError):
        shuffle.depth_to_space_cuda(x[..., :26], 3)
    with pytest.raises(ValueError):
        shuffle.depth_to_space_cuda(x.transpose(1, 2), 3)
    with pytest.raises(ValueError):
        shuffle.depth_to_space_cuda(x[0], 3)
    # the fused engine's form: edge tiles on another device, of another
    # batch or channel count, of another type, without a margin
    e = torch.zeros((2, 20, 19, 3), device=cuda_device)
    with pytest.raises(ValueError):
        shuffle.epilogue_cuda(x[:, :4, :4], 3, 4, 0, edge=e.cpu())
    with pytest.raises(ValueError):
        shuffle.epilogue_cuda(x[:, :4, :4], 3, 4, 0, edge=e[:1])
    with pytest.raises(ValueError):
        shuffle.epilogue_cuda(x[:, :4, :4].contiguous(), 3, 4, 0,
                              edge=e[..., :2])
    with pytest.raises(TypeError):
        shuffle.epilogue_cuda(x[:, :4, :4].contiguous(), 3, 4, 0,
                              edge=e.double())
    with pytest.raises(ValueError, match="margin"):
        shuffle.epilogue_cuda(x[:, :4, :4].contiguous(), 3, 4, 0, edge=e,
                              edge_offset=15)


def bf16_excess_ulps(got, want, f32_bound):
    """|got - want| beyond ``f32_bound``, in bf16 ulps at the larger
    magnitude."""
    got, want = got.float(), want.float()
    m = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    excess = ((got - want).abs() - f32_bound).clamp_min(0.0)
    return excess / torch.exp2(torch.floor(torch.log2(m)) - 7)


# (batch, h, w, cin, cout, k): the packed stages (W0, WA, WD), the flat
# tier's conv0s and convA/conv10, one probe shape, ragged sizes.
CONV_CASES = [(2, 64, 64, 24, 128, 3), (2, 64, 64, 128, 384, 3),
              (2, 64, 64, 152, 108, 3), (3, 37, 45, 6, 32, 5),
              (3, 37, 45, 9, 32, 5), (2, 30, 30, 32, 96, 5),
              (2, 30, 30, 32, 27, 3), (1, 24, 136, 32, 96, 1),
              (1, 13, 21, 13, 130, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"{c[3]}to{c[4]}-k{c[5]}-{c[1]}x{c[2]}"
                              for c in CONV_CASES])
def test_cuda_conv_stage_matches_plain_version(cuda_device, case,
                                               out_dtype):
    bsz, h, w, cin, cout, k = case
    out_dtype = getattr(torch, out_dtype)
    g = torch.Generator(device="cpu").manual_seed(cin * 131 + cout)
    x = torch.randn((bsz, h, w, cin), generator=g).bfloat16().to(cuda_device)
    wt = (torch.randn((k, k, cin, cout), generator=g)
          / (k * k * cin) ** 0.5).bfloat16().to(cuda_device)
    before = conv_stage.LAUNCHES
    got = conv_stage.conv_stage(x, wt, out_dtype)
    torch.cuda.synchronize()
    assert conv_stage.LAUNCHES == before + 1
    want = conv_stage.conv_stage_reference(x, wt, out_dtype)
    assert got.dtype == want.dtype == out_dtype
    assert got.shape == want.shape == (bsz, h, w, cout)
    assert torch.isfinite(got.float()).all()
    bound = 1e-5 * float(want.float().abs().max())
    if out_dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= bound, err
    else:
        u = bf16_excess_ulps(got, want, bound)
        share = float((got != want).float().mean())
        assert u.max() <= 1 and share <= 1e-3, (float(u.max()), share)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["u8", "f32", "packed", "fused",
                                  "u8-f32edge", "crop-u8"])
@pytest.mark.parametrize("factor,tile,off", [(3, 242, 7), (2, 13, 7),
                                             (4, 5, 2), (3, 1100, 7)])
def test_cuda_epilogue_is_byte_identical(cuda_device, mode, factor, tile,
                                         off):
    """Every form of the epilogue: the xla tiers' (u8 or f32 edge tiles,
    u8 or f32 out), the packed tier's, the fused engine's (crop offset 0,
    f32 edge tiles) and the crop alone; a 1100-pixel tile takes blocks of
    one row and a segment of its columns."""
    g = torch.Generator(device="cpu").manual_seed(tile)
    side = tile + 2 * off + (1 if mode == "packed" and tile % 2 else 0)
    e = 3 * factor * factor
    n = 1 if tile > 1000 else 3
    xs = tile if mode == "fused" else side
    x = (torch.randn((n, xs, xs, e), generator=g) * 0.4 + 0.5)
    if mode == "packed":
        x = x.reshape(n, side // 2, 2, side // 2, 2, e).permute(
            0, 1, 3, 2, 4, 5).reshape(n, side // 2, side // 2, 4 * e)
    edge = None
    if mode == "u8":
        edge = torch.randint(0, 256, (n, side, side, 3), generator=g,
                             dtype=torch.uint8).to(cuda_device)
    elif mode in ("f32", "fused", "u8-f32edge"):
        edge = torch.rand((n, side, side, 3), generator=g).to(cuda_device)
    x = x.contiguous().to(cuda_device)
    kw = dict(edge=edge, edge_offset=off, to_u8=mode not in ("f32", "fused"),
              packed=mode == "packed")
    offset = 0 if mode == "fused" else off
    before = shuffle.EPILOGUE_LAUNCHES
    got = shuffle.epilogue_cuda(x, factor, tile, offset, **kw)
    torch.cuda.synchronize()
    assert shuffle.EPILOGUE_LAUNCHES == before + 1
    assert same_bytes(got, shuffle.epilogue_reference(x, factor, tile, offset,
                                                      **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("fast,tile", [(False, 21), (True, 20), (True, 21)],
                         ids=["exact", "fast-packed", "fast-flat"])
def test_cuda_xla_path_matches_cpu(cuda_device, fast, tile):
    """The default engine on u8 input: uint8 out, the kernels launched
    (2x3 tiles in two chunks), within the bounds of the plain run."""
    u8 = np.random.default_rng(8).integers(0, 256, (37, 50, 3),
                                           dtype=np.uint8)
    anime = load_builtin("anime")
    n_conv, n_epi = conv_stage.LAUNCHES, shuffle.EPILOGUE_LAUNCHES
    got = upscale(u8, anime, 3, fast=fast, tile=tile, chunk=4,
                  device=cuda_device)
    assert shuffle.EPILOGUE_LAUNCHES == n_epi + 2
    assert conv_stage.LAUNCHES == n_conv + (10 if fast else 0)
    want = upscale(u8, anime, 3, fast=fast, tile=tile, chunk=4,
                   device="cpu")
    assert got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= (4 if fast else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,bound", [
    (dict(compute_dtype=torch.bfloat16, trunk="flat"), 4),
    (dict(compute_dtype=torch.bfloat16, trunk="flat", conv0_ws=False), 4),
    (dict(compute_dtype=torch.bfloat16, trunk="flat", out16=False), 4),
    (dict(compute_dtype=torch.bfloat16, trunk="flat", out16="bcd"), 4),
    (dict(compute_dtype=torch.bfloat16, tile=21, conv0_ws=False), 4),
    (dict(engine="int8"), 1),
    (dict(compute_dtype=torch.bfloat16, conv0_ws=False, f32=True), 4)],
    ids=["flat", "flat-ws1", "flat-out32", "flat-bcd", "odd-ws1", "int8",
         "f32-ws1"])
def test_cuda_tiled_sr_knobs_match_cpu(cuda_device, kw, bound):
    """`tiled_sr`'s variant knobs and the int8 engine on u8 input (f32
    where named): the kernels launched, within the tier's bound of the
    plain run."""
    from rusty_sr_tpu_torch.models import quant
    img = np.random.default_rng(9).integers(0, 256, (37, 50, 3),
                                            dtype=np.uint8)
    if kw.get("f32"):
        img = img.astype(np.float32) / 255.0
    kw = {k: v for k, v in kw.items() if k != "f32"}
    anime = load_builtin("anime")
    kw = {"tile": 20, "chunk": 4, **kw}
    n_conv, n_int8 = conv_stage.LAUNCHES, quant.LAUNCHES
    got = tiling.tiled_sr(anime, img, 3, device=cuda_device, **kw)
    assert conv_stage.LAUNCHES > n_conv
    if kw.get("engine") == "int8":
        assert quant.LAUNCHES == n_int8 + 2 * 6     # two chunks
    want = tiling.tiled_sr(anime, img, 3, device="cpu", **kw)
    assert got.dtype == want.dtype == img.dtype
    if got.dtype != np.uint8:
        got, want = (np.floor(np.clip(t, 0, 1) * 255 + 0.5) for t in
                     (got, want))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 800, 96), (1000, 288, 64)])
def test_cuda_int8_mm_matches_integer_product(cuda_device, m, k, n):
    from rusty_sr_tpu_torch.models import quant
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).t()
    before = quant.LAUNCHES
    got = quant.int8_mm(a.to(cuda_device), b.to(cuda_device))
    assert quant.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), quant.int8_mm_reference(a, b))
    assert torch.equal(quant.int8_mm_reference(a.to(cuda_device),
                                               b.to(cuda_device)).cpu(),
                       quant.int8_mm_reference(a, b))


@pytest.mark.cuda
def test_cuda_conv_stage_and_epilogue_reject_bad_inputs(cuda_device):
    x = torch.zeros((1, 8, 8, 16), device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16, 8), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv_stage.conv_stage(x.float(), w)
    with pytest.raises(ValueError):
        conv_stage.conv_stage(x, w[:2])
    with pytest.raises(ValueError):
        conv_stage.conv_stage(x, w[:, :, :15])
    with pytest.raises(ValueError):
        conv_stage.conv_stage(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv_stage.conv_stage(x, w.cpu())
    e = torch.zeros((2, 20, 20, 27), device=cuda_device)
    edge = torch.zeros((2, 20, 20, 3), device=cuda_device,
                       dtype=torch.uint8)
    with pytest.raises(ValueError):
        shuffle.epilogue_cuda(e, 3, 6, 15, edge)     # window past the edge
    with pytest.raises(ValueError):
        shuffle.epilogue_cuda(e, 3, 6, 7, edge[:1])
    with pytest.raises(TypeError):
        shuffle.epilogue_cuda(e.double(), 3, 6, 7, edge)
    with pytest.raises(ValueError):
        shuffle.epilogue_cuda(e, 3, 6, 7, edge, packed=True)
    with pytest.raises(ValueError):
        shuffle.epilogue_cuda(e, 3, 6, 7, edge, edge_offset=0)  # no margin


FUSED = ["packed-W0", "packed-WA", "packed-WB", "packed-WC", "packed-WD",
         "flat-conv0", "flat-convC", "flat-expand"]


def fused_case(name, dev, bsz=2, s=21):
    """(x, weights, FusedStage, out dtype) of one stage form, with the
    anime weights and random bf16 activations, addends and masks."""
    g = torch.Generator(device="cpu").manual_seed(len(name) * 7 + bsz)
    bf, f32 = torch.bfloat16, torch.float32

    def r(c):
        return torch.randn((bsz, s, s, c), generator=g).to(bf).to(dev)

    def mask(groups):
        return (torch.rand((bsz, s, s, groups), generator=g) > 0.2).to(
            bf).to(dev)

    anime = load_builtin("anime")
    tier, key = name.split("-")
    if tier == "packed":
        p = {k: v.to(dev) for k, v in
             tiling.packed_trunk_params(anime, 3).items()}
        N, E, m = 128, 108, mask(4)
        forms = {
            "W0": (r(24), "W0", Epilogue(N, p["f_bias"], p["f_belu"], (),
                                         m), f32),
            "WA": (r(N), "WA", Epilogue(N, p["l1_bias"], p["l1_belu"], (),
                                        m), bf),
            "WB": (r(N), "WB", Epilogue(N, p["l2_bias"], p["l2_belu"],
                                        (r(384)[..., N:],), m), bf),
            "WC": (r(N), "WC", Epilogue(N, p["l3_bias"], p["l3_belu"],
                                        (r(384)[..., 2 * N:],
                                         r(368)[..., N:]), m, gap=24), bf),
            "WD": (r(152), "WD", Epilogue(E, p["expand_bias"],
                                          addends=(r(368)[..., 2 * N:],
                                                   r(264)[..., 152:]),
                                          act_dtype=f32), f32)}
    else:
        p = {k: v.to(dev) for k, v in
             tiling.flat_trunk_params(anime, True).items()}
        n, e, m = 32, 27, mask(1)
        forms = {
            "conv0": (r(8), "conv0_u8", Epilogue(n, p["f_bias"],
                                                 p["f_belu"], (), m), f32),
            "convC": (r(n), "convC_bf16", Epilogue(
                n, p["l3_bias"], p["l3_belu"],
                (r(96)[..., 2 * n:], r(96)[..., n:]), m), bf),
            "expand": (r(n), "conv10_bf16", Epilogue(
                e, p["expand_bias"], addends=(r(96)[..., 2 * n:],
                                              r(64)[..., n:]),
                act_dtype=f32), bf)}
    x, wkey, epi, odt = forms[key]
    return x, p[wkey], FusedStage(p[wkey], epi), odt


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUSED)
def test_cuda_fused_stage_is_byte_identical(cuda_device, name):
    """The kernel with its epilogue against the same kernel without it
    followed by the plain glue on the card, on every written channel; and
    the gap left as it was."""
    x, w, fused, odt = fused_case(name, cuda_device)
    epi = fused.epilogue
    before = conv_stage.LAUNCHES
    got = conv_stage.conv_stage(x, fused, odt)
    plain = conv_stage.conv_stage(x, w, odt)
    torch.cuda.synchronize()
    assert conv_stage.LAUNCHES == before + 2
    cout = w.shape[3]
    want = conv_stage.stage_epilogue_reference(
        plain, epi, torch.empty_like(got))
    assert got.dtype == want.dtype and got.shape == want.shape
    n, gap = epi.n_act, epi.gap
    for sl in (slice(0, n), slice(n + gap, cout + gap)):
        a, b = got[..., sl], want[..., sl]
        assert torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8)), sl


@pytest.mark.cuda
def test_cuda_conv_stage_rejects_bad_epilogues(cuda_device):
    x, w, fused, odt = fused_case("packed-WC", cuda_device, bsz=1, s=8)
    epi = fused.epilogue
    add0, add1 = epi.addends
    bad = [
        dict(addends=(add0.float(), add1)),                  # dtype
        dict(addends=(add0.transpose(1, 2), add1)),          # strides
        dict(addends=(add0[:, :4], add1)),                   # shape
        dict(addends=(add0[..., :64], add1)),                # too few channels
        dict(mask=epi.mask[..., :3].contiguous()),           # 3 groups of 128
        dict(mask=epi.mask.float()),
        dict(bias=epi.bias.double()),
        dict(bias=epi.bias[:64]),
        dict(act_dtype=torch.float32),    # f32 activations beside bf16 convs
        dict(gap=-8),
        dict(n_act=w.shape[3] + 1)]
    import dataclasses
    for change in bad:
        stage = FusedStage(w, dataclasses.replace(epi, **change))
        with pytest.raises((TypeError, ValueError)):
            conv_stage.conv_stage(x, stage, odt)


# The serving path: tiled_sr_batch over ragged images with pinned slots.
# Every chunk goes through one ring slot; a slot reused before its copy
# lands would give wrong tiles with no error, so the outputs must be
# byte-identical at any in-flight depth.
SERVING_SHAPES = [(130, 97), (61, 200), (16, 16), (243, 241), (75, 30)]


def serving_images():
    r = np.random.default_rng(31)
    return [r.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in SERVING_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("tier,tile,bound", [
    ("exact", 62, 1), ("packed", 62, 4), ("flat", 61, 4)])
def test_cuda_batch_pinned_slots(cuda_device, monkeypatch, tier, tile,
                                 bound):
    anime = load_builtin("anime")
    imgs = serving_images()
    cd = None if tier == "exact" else torch.bfloat16
    runs = {}
    for depth in (8, 1, 2):
        monkeypatch.setattr(tiling, "_MAX_INFLIGHT", depth)
        before = shuffle.EPILOGUE_LAUNCHES
        runs[depth] = tiling.tiled_sr_batch(
            anime, imgs, 3, tile=tile, chunk=4, compute_dtype=cd,
            device=cuda_device)
        assert shuffle.EPILOGUE_LAUNCHES > before
    first = runs[8]
    for key, outs in runs.items():
        for a, b in zip(outs, first):
            assert a.tobytes() == b.tobytes(), key
    # One ring per lane (a device and its place in the mesh), of the last
    # call's shape and at most the deepest window's slots; another shape
    # replaces it.
    specs, ring = tiling._RINGS[(torch.device(cuda_device), 0)]
    assert specs[1][0] == (4, tile * 3, tile * 3, 3) and len(ring) <= 9
    tiling.tiled_sr(anime, imgs[2], 3, tile=tile + 2, chunk=4,
                    compute_dtype=cd, device=cuda_device)
    specs, ring = tiling._RINGS[(torch.device(cuda_device), 0)]
    assert specs[1][0] == (4, (tile + 2) * 3, (tile + 2) * 3, 3)
    assert len(ring) == 1
    for img, out in zip(imgs, first):
        one = tiling.tiled_sr(anime, img, 3, tile=tile, chunk=4,
                              compute_dtype=cd, device=cuda_device)
        assert out.shape == one.shape == (img.shape[0] * 3,
                                          img.shape[1] * 3, 3)
        assert np.abs(out.astype(int) - one.astype(int)).max() <= bound


@pytest.mark.cuda
def test_cuda_batch_callbacks_and_simple_modes(cuda_device):
    anime = load_builtin("anime")
    imgs = serving_images()
    done = []
    outs = tiling.tiled_sr_batch(
        anime, imgs, 3, tile=62, chunk=4, compute_dtype=torch.bfloat16,
        device=cuda_device, release_outputs=True,
        on_image_done=lambda i, out: done.append((i, out.copy())))
    assert outs == [None] * len(imgs)
    assert [i for i, _ in done] == list(range(len(imgs)))
    for img in imgs[:2]:
        for mode in ("bilinear", "downsample"):
            got = tiling.tiled_simple(img[:129, :96], 3, mode=mode, tile=30,
                                      chunk=4, device=cuda_device)
            want = tiling.tiled_simple(img[:129, :96], 3, mode=mode, tile=30,
                                       chunk=4, device="cpu")
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def step_grads(tree, u8, device, dtype, cfg):
    """The loss and each gradient leaf (float64 numpy) of one step of the
    training loop's `make_train_step` (on the card, the CUDA graph) on
    ``device`` in ``dtype``; a float64 step takes the batch as float64 of
    its float32 scaling."""
    from rusty_sr_tpu_torch.train import loop as TL
    p = {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
         for k, v in tree.items()}
    x = torch.from_numpy(u8).to(device)
    if dtype == torch.float64:
        x = (x.float() * (1.0 / 255.0)).double()
    step, _ = TL.make_train_step(cfg, p)
    loss, _ = step(x)
    return float(loss), {k: v.grad.double().cpu().numpy()
                         for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(amp=True),
                                dict(trunk="packed", remat=True)],
                         ids=["f32", "amp", "packed-remat"])
def test_cuda_graphed_step_matches_eager(cuda_device, kw):
    """The CUDA graph of the step against the eager `train_step` over 12
    steps on the same batches, parameters within 1e-4 (chip_smoke's
    card-against-CPU bound) and losses within rtol 1e-3 (the bf16 tiers
    flip a few roundings once the parameters differ by an ulp), with a
    change of batch shape half-way (the graph is captured again and the
    run goes on from where it was)."""
    from rusty_sr_tpu_torch.train import loop as TL
    tree = init_params(4, 3)
    r = np.random.default_rng(5)
    xs = [torch.from_numpy(r.integers(0, 256, (2 if i < 6 else 3, 48, 48,
                                               3), dtype=np.uint8))
          .to(cuda_device) for i in range(12)]
    cfg = TL.TrainConfig(crop=48, **kw)
    runs = []
    for graphed in (False, True):
        p = {k: torch.tensor(v, device=cuda_device, requires_grad=True)
             for k, v in tree.items()}
        if graphed:
            step, opt = TL.make_train_step(cfg, p)
            assert isinstance(step, TL.GraphedStep)
        else:
            opt = TL.make_optimizer(cfg, p)

            def step(hr, p=p, opt=opt):
                return TL.train_step(p, opt, hr, cfg)
        losses = [float(step(x)[0]) for x in xs]
        runs.append((losses, {k: v.detach().cpu().numpy()
                              for k, v in p.items()}))
    (l_e, p_e), (l_g, p_g) = runs
    np.testing.assert_allclose(l_g, l_e, rtol=1e-3)
    for k in tree:
        np.testing.assert_allclose(p_g[k], p_e[k], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("tier,tile", [("exact", 62), ("packed", 62),
                                       ("flat", 61)])
def test_cuda_mesh_replicas_byte_identical(cuda_device, tier, tile):
    """`tiled_sr_batch` over a mesh of two replicas on the card (one
    device listed twice: two rings, two pairs of copy streams, two
    copies of the weights) gives the single-device outputs, byte for
    byte."""
    from rusty_sr_tpu_torch.parallel.mesh import make_mesh
    anime = load_builtin("anime")
    imgs = serving_images()
    cd = None if tier == "exact" else torch.bfloat16
    single = tiling.tiled_sr_batch(anime, imgs, 3, tile=tile, chunk=2,
                                   compute_dtype=cd, device=cuda_device)
    mesh = make_mesh(devices=[cuda_device, cuda_device])
    before = shuffle.EPILOGUE_LAUNCHES
    sharded = tiling.tiled_sr_batch(anime, imgs, 3, tile=tile, chunk=2,
                                    compute_dtype=cd, mesh=mesh)
    assert shuffle.EPILOGUE_LAUNCHES > before
    for a, b in zip(single, sharded):
        assert a.tobytes() == b.tobytes()
    assert (torch.device(cuda_device), 1) in tiling._RINGS


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_cuda_graphed_dp_step_matches_eager(cuda_device, backend):
    """The data-parallel step over a group of one: its two CUDA graphs
    with the all-reduce between them against the eager data-parallel
    `train_step`, over 8 steps with a change of batch shape, to the
    bounds of `test_cuda_graphed_step_matches_eager`; and the graphed
    step of the group against the graphed step without one."""
    import socket
    import torch.distributed as dist
    from rusty_sr_tpu_torch.train import loop as TL
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        tree = init_params(4, 3)
        r = np.random.default_rng(6)
        xs = [torch.from_numpy(r.integers(
            0, 256, (2 if i < 4 else 3, 48, 48, 3), dtype=np.uint8))
            .to(cuda_device) for i in range(8)]
        cfg = TL.TrainConfig(crop=48)
        runs = []
        for mode in ("eager", "graphed", "graphed, no group"):
            group = None if mode.endswith("no group") else dist.group.WORLD
            p = {k: torch.tensor(v, device=cuda_device, requires_grad=True)
                 for k, v in tree.items()}
            if mode == "eager":
                opt = TL.make_optimizer(cfg, p)

                def step(hr, p=p, opt=opt):
                    return TL.train_step(p, opt, hr, cfg, dist.group.WORLD)
            else:
                step, _ = TL.make_train_step(cfg, p, group)
                assert isinstance(step, TL.GraphedStep)
            losses = [float(step(x)[0]) for x in xs]
            runs.append((losses, {k: v.detach().cpu().numpy()
                                  for k, v in p.items()}))
    finally:
        dist.destroy_process_group()
    for losses, params in runs[1:]:
        np.testing.assert_allclose(losses, runs[0][0], rtol=1e-3)
        for k in tree:
            np.testing.assert_allclose(params[k], runs[0][1][k], rtol=0,
                                       atol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_cuda_f32_step_within_f32_noise_of_float64(cuda_device):
    """The TF32 witness: autograd runs the backward convolutions outside
    the forward's `exact_f32`, so the step enters it around both.  Every
    gradient leaf of the card's float32 step is within 1e-4 of its
    largest magnitude of a float64 step on the CPU (TF32 would put it
    near 1e-3), and its loss within rtol 1e-5."""
    from rusty_sr_tpu_torch.train import loop as TL
    tree = init_params(3, 3)
    u8 = np.random.default_rng(0).integers(0, 256, (4, 96, 96, 3),
                                           dtype=np.uint8)
    cfg = TL.TrainConfig(crop=96)
    loss, got = step_grads(tree, u8, cuda_device, torch.float32, cfg)
    ref_loss, ref = step_grads(tree, u8, "cpu", torch.float64, cfg)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for k, g in got.items():
        scale = float(np.abs(ref[k]).max())
        assert float(np.abs(g - ref[k]).max()) <= 1e-4 * scale, k


@pytest.mark.cuda
def test_cuda_train_folder_runs_and_validates_on_the_card(cuda_device,
                                                          tmp_path):
    from rusty_sr_tpu_torch.api import train_folder
    from rusty_sr_tpu_torch.utils.imageio import save_image_u8
    r = np.random.default_rng(2)
    for i in range(3):
        save_image_u8(str(tmp_path / f"i{i}.png"),
                      r.integers(0, 256, (60, 75, 3), dtype=np.uint8))
    before = shuffle.EPILOGUE_LAUNCHES
    mf = str(tmp_path / "m.jsonl")
    for kw in (dict(), dict(amp=True), dict(trunk="packed", remat=True)):
        tree = train_folder(str(tmp_path), steps=4, crop=48, batch_size=2,
                            val_folder=str(tmp_path), val_max=1,
                            checkpoint_every=2, val_every=2,
                            metrics_file=mf,
                            param_file=str(tmp_path / "o.rsr"),
                            device=cuda_device, **kw)
        assert all(np.isfinite(v).all() for v in tree.values())
        assert os.path.getsize(tmp_path / "o.rsr") == 1_043_676
    assert shuffle.EPILOGUE_LAUNCHES > before   # validation on the card
    import json
    recs = [json.loads(ln) for ln in open(mf)]
    assert [r_["step"] for r_ in recs] == [1, 2, 4] * 3
    assert all(np.isfinite(r_["val_psnr"]) for r_ in recs)


@pytest.mark.cuda
@pytest.mark.parametrize("k,ci,co", [(5, 3, 32), (3, 32, 96), (3, 32, 27)])
def test_cuda_split_conv_within_2e16_of_float64(cuda_device, k, ci, co):
    """`ops.conv.conv2d_bf16x3` (``--precision high``) on the card: the
    output and both gradients within 2^-16 of sum |a||b| of float64 on
    the CPU (cuDNN under TF32 holds the bf16 halves exactly; a Winograd
    or FFT algorithm that transformed them would not)."""
    from rusty_sr_tpu_torch.ops.conv import conv2d_bf16x3, conv2d_same
    r = np.random.default_rng(k * ci)
    x = torch.tensor(r.standard_normal((4, 48, 48, ci)), dtype=torch.float32)
    w = torch.tensor(r.standard_normal((k, k, ci, co)) * 0.1,
                     dtype=torch.float32)
    g = torch.tensor(r.standard_normal((4, 48, 48, co)), dtype=torch.float32)
    xs = x.to(cuda_device).requires_grad_()
    ws = w.to(cuda_device).requires_grad_()
    y = conv2d_bf16x3(xs, ws)
    got = (y, *torch.autograd.grad(y, (xs, ws), g.to(cuda_device)))

    def float64(a, b, gy):
        a, b = (t.double().requires_grad_() for t in (a, b))
        y64 = conv2d_same(a, b)
        return (y64, *torch.autograd.grad(y64, (a, b), gy.double()))
    refs = (float64(x, w, g), float64(x.abs(), w.abs(), g.abs()))
    for name, t, want, scale in zip(("y", "dx", "dw"), got, *refs):
        err = (t.detach().double().cpu() - want).abs()
        assert bool((err <= 2.0 ** -16 * scale).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["merged", "flat"])
def test_cuda_graphed_high_step_matches_eager(cuda_device, trunk):
    """``--precision high``'s CUDA graph against its eager step over 8
    steps, to the bounds of `test_cuda_graphed_step_matches_eager`; and
    its first gradient within 1e-4 of each leaf's largest magnitude of a
    float64 step on the CPU."""
    from rusty_sr_tpu_torch.train import loop as TL
    tree = init_params(4, 3)
    r = np.random.default_rng(7)
    xs = [torch.from_numpy(r.integers(0, 256, (2, 48, 48, 3),
                                      dtype=np.uint8)).to(cuda_device)
          for _ in range(8)]
    cfg = TL.TrainConfig(crop=48, trunk=trunk, precision="high")
    runs = []
    for graphed in (False, True):
        p = {k: torch.tensor(v, device=cuda_device, requires_grad=True)
             for k, v in tree.items()}
        if graphed:
            step, _ = TL.make_train_step(cfg, p)
            assert isinstance(step, TL.GraphedStep)
        else:
            opt = TL.make_optimizer(cfg, p)

            def step(hr, p=p, opt=opt):
                return TL.train_step(p, opt, hr, cfg)
        losses = []
        for x in xs:
            losses.append(float(step(x)[0]))
            if len(losses) == 1:
                grad = {k: v.grad.double().cpu().numpy()
                        for k, v in p.items()}
        runs.append((losses, grad, {k: v.detach().cpu().numpy()
                                    for k, v in p.items()}))
    (l_e, g_e, p_e), (l_g, g_g, p_g) = runs
    np.testing.assert_allclose(l_g, l_e, rtol=1e-3)
    for k in tree:
        np.testing.assert_allclose(p_g[k], p_e[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    p64 = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for k, v in tree.items()}
    x64 = (xs[0].cpu().float() * (1.0 / 255.0)).double()
    from rusty_sr_tpu_torch.models import sr_net
    from rusty_sr_tpu_torch.ops.conv import conv2d_same
    saved = sr_net.conv2d_bf16x3
    sr_net.conv2d_bf16x3 = conv2d_same
    try:
        loss64, _ = TL.loss_fn(p64, x64, cfg)
    finally:
        sr_net.conv2d_bf16x3 = saved
    g64 = torch.autograd.grad(loss64, list(p64.values()))
    for (k, want) in zip(p64, g64):
        scale = float(want.abs().max())
        assert float(np.abs(g_g[k] - want.numpy()).max()) <= 1e-4 * scale, k
