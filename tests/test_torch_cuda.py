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
- depth-to-space: byte-identical (one f32 add per element on both sides);
- the fast tier end to end: 4 u8 codes, the JAX suite's bound for the
  same bf16 products summed in another order.
"""

import numpy as np
import pytest
import torch

from rusty_sr_tpu_torch.api import upscale
from rusty_sr_tpu_torch.ops.cuda import shuffle, trunk
from rusty_sr_tpu_torch.params import init_params, load_builtin
from rusty_sr_tpu_torch.utils.imageio import to_u8

TOL = 1e-5
BF16_MAX, BF16_MEAN = 1e-2, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


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
@pytest.mark.parametrize("factor,s,seed", [(3, 13, 3), (3, 24, 4), (2, 11, 5)])
def test_cuda_kernel_matches_plain_version(cuda_device, factor, s, seed):
    params = load_builtin("anime") if factor == 3 else init_params(7, 2)
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
@pytest.mark.parametrize("factor,s,seed", [(3, 13, 3), (3, 24, 4), (2, 11, 5)])
def test_cuda_bf16_kernel_matches_plain_version(cuda_device, factor, s, seed):
    params = load_builtin("anime") if factor == 3 else init_params(7, 2)
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


@pytest.mark.cuda
@pytest.mark.parametrize("factor,shape,dtype", [
    (3, (4, 21, 19, 27), torch.float32), (2, (3, 11, 13, 12), torch.float32),
    (3, (2, 17, 9, 27), torch.uint8), (2, (70000, 1, 1, 12), torch.float32)],
    ids=["f3-f32", "f2-f32", "f3-u8", "f2-many-rows"])
def test_cuda_shuffle_is_byte_identical(cuda_device, factor, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(factor)
    if dtype == torch.uint8:
        x = torch.randint(0, 256, shape, generator=g, dtype=dtype)
        add = None
    else:
        x = torch.randn(shape, generator=g)
        add = torch.randn(shape, generator=g).to(cuda_device)
    x = x.to(cuda_device)
    before = shuffle.LAUNCHES
    got = shuffle.depth_to_space_cuda(x, factor, addend=add)
    torch.cuda.synchronize()
    assert shuffle.LAUNCHES == before + 1
    want = shuffle.depth_to_space_reference(x, factor, add)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8) if dtype == torch.uint8
                       else got.view(torch.int32),
                       want.view(torch.uint8) if dtype == torch.uint8
                       else want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_tiled_path_matches_cpu(cuda_device):
    img = np.random.default_rng(6).random((37, 50, 3), dtype=np.float32)
    anime = load_builtin("anime")
    before = trunk.LAUNCHES[torch.float32]
    before_d2s = shuffle.LAUNCHES
    got = upscale(img, anime, 3, tile=21, chunk=4, device=cuda_device)
    # 2x3 tiles in two chunks
    assert trunk.LAUNCHES[torch.float32] == before + 2
    assert shuffle.LAUNCHES == before_d2s + 2
    want = upscale(img, anime, 3, tile=21, chunk=4, device="cpu")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_cuda_fast_tier_matches_cpu(cuda_device):
    u8 = np.random.default_rng(7).integers(0, 256, (37, 50, 3),
                                           dtype=np.uint8)
    anime = load_builtin("anime")
    before = trunk.LAUNCHES[torch.bfloat16]
    got = upscale(u8, anime, 3, fast=True, tile=21, chunk=4,
                  device=cuda_device)
    assert trunk.LAUNCHES[torch.bfloat16] == before + 2
    want = upscale(u8, anime, 3, fast=True, tile=21, chunk=4, device="cpu")
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
    with pytest.raises(TypeError):
        trunk.fused_trunk(dict(bf16, wB_padded=bf16["wB_padded"].float()),
                          x, m, 3)


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
        shuffle.depth_to_space_cuda(x, 3, addend=x.cpu())
    with pytest.raises(ValueError):
        shuffle.depth_to_space_cuda(x, 3, addend=x[:1])
    with pytest.raises(TypeError):
        shuffle.depth_to_space_cuda(x.to(torch.uint8), 3,
                                    addend=x)
