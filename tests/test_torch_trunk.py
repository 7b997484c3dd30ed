"""The port's trunk against the JAX package's fused Pallas trunk.

On the CPU the JAX kernel runs in Pallas interpret mode (as
tests/test_pallas_trunk.py runs it) and the port's wrapper runs its
plain PyTorch version.  Tolerances:

- f32: atol 3e-6, the JAX suite's own bound for the fused trunk
  (tests/test_pallas_trunk.py), since the two sum up to 800 products in
  other orders;
- bf16: max abs 1e-2 and mean abs 1e-4.  Both sides round the same
  values to bf16, but a value that an f32 sum in another order puts on
  the other side of a rounding boundary moves by a bf16 ulp and carries
  that through the later stages: measured 2.3e-3 max and 1.5e-5 mean on
  anime weights, against 1.7e-2 max and 1.2e-3 mean for the whole
  bf16-against-f32 difference, so the mean gate tells a faithful
  emulation from a mode that rounds elsewhere.

The CUDA kernels are held to their plain versions on the card in
tests/test_torch_cuda.py, and their device code, compiled here as plain
C++, in the host-kernel tests below.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rusty_sr_tpu.ops.pallas.trunk import (fused_trunk as j_fused_trunk,
                                           pack_trunk_weights as j_pack)
from rusty_sr_tpu.params import init_params, load_builtin
from rusty_sr_tpu_torch.ops.cuda import shuffle, trunk
from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
from rusty_sr_tpu_torch.params import to_torch

H = trunk.HALO
ATOL = 3e-6
BF16_MAX, BF16_MEAN = 1e-2, 1e-4
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "rusty_sr_tpu_torch", "csrc")


def tiles(seed, bsz, s, border):
    """Zero-padded tiles and masks from a numpy seed.  With ``border`` the
    odd tiles hold an image corner that ends inside the tile, so the mask
    zeroes a ring on two sides."""
    r = np.random.default_rng(seed)
    side = s + 2 * H
    x = np.zeros((bsz, side, side, 3), np.float32)
    m = np.zeros((bsz, side, side, 1), np.float32)
    for b in range(bsz):
        if border and b % 2:
            hh, ww = r.integers(1, s + 1), r.integers(1, s + 1)
            y0 = x0 = H
        else:
            hh = ww = side
            y0 = x0 = 0
        x[b, y0:y0 + hh, x0:x0 + ww] = r.random((hh, ww, 3), np.float32)
        m[b, y0:y0 + hh, x0:x0 + ww] = 1.0
    return x, m


def u8_valued(x):
    """x with every value k/255, as the CLI's inputs are."""
    return (np.round(x * 255.0) / 255.0).astype(np.float32)


def jax_expand(params, x, m, factor, dtype=jnp.float32):
    packed = j_pack({k: jnp.asarray(v) for k, v in params.items()}, factor,
                    dtype=dtype)
    return np.asarray(j_fused_trunk(packed, jnp.asarray(x), jnp.asarray(m),
                                    factor, rh=8, compute_dtype=dtype,
                                    interpret=True))


def assert_bf16_close(got, want):
    d = np.abs(np.asarray(got, np.float64) - want)
    assert d.max() <= BF16_MAX and d.mean() <= BF16_MEAN, \
        (d.max(), d.mean())


CASES = {
    "anime-f3": (lambda: load_builtin("anime"), 3, 2, 16, False),
    "init-f2": (lambda: init_params(7, 2), 2, 2, 8, False),
    "anime-f3-border": (lambda: load_builtin("anime"), 3, 2, 16, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_trunk_matches_jax_fused_trunk(case):
    load, factor, bsz, s, border = CASES[case]
    params = load()
    x, m = tiles(1, bsz, s, border)
    packed = trunk.pack_trunk_weights(params, factor)
    got = trunk.fused_trunk_reference(packed, torch.from_numpy(x),
                                      torch.from_numpy(m), factor).numpy()
    want = jax_expand(params, x, m, factor)
    assert got.shape == want.shape == (bsz, s, s, 3 * factor * factor)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_reference_trunk_matches_jax_fused_trunk(case):
    load, factor, bsz, s, border = CASES[case]
    params = load()
    x, m = tiles(1, bsz, s, border)
    x = u8_valued(x)
    packed = trunk.pack_trunk_weights(params, factor, torch.bfloat16)
    got = trunk.fused_trunk_reference(packed, torch.from_numpy(x),
                                      torch.from_numpy(m), factor).numpy()
    want = jax_expand(params, x, m, factor, jnp.bfloat16)
    assert got.shape == want.shape == (bsz, s, s, 3 * factor * factor)
    assert_bf16_close(got, want)
    # compute_dtype names the mode: f32-packed weights rounded in the
    # reference give the same values.
    f32 = trunk.pack_trunk_weights(params, factor)
    again = trunk.fused_trunk_reference(f32, torch.from_numpy(x),
                                        torch.from_numpy(m), factor,
                                        compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(again.numpy(), got)


def bits(t):
    """The raw bits of a bf16 tensor or array (uint16), or f32 values."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    t = np.asarray(t)
    return t.view(np.uint16) if t.dtype.itemsize == 2 else t


@pytest.mark.parametrize("factor,dtype", [(2, "float32"), (3, "float32"),
                                          (2, "bfloat16"), (3, "bfloat16")])
def test_packed_weights_match_jax(factor, dtype):
    """The JAX packer's dict, bit for bit, plus the kernel's weight forms
    made once at packing time: each matrix padded (f32), or the B operand
    image (bf16)."""
    params = load_builtin("anime") if factor == 3 else init_params(7, 2)
    got = trunk.pack_trunk_weights(params, factor, getattr(torch, dtype))
    want = j_pack({k: jnp.asarray(v) for k, v in params.items()}, factor,
                  dtype=getattr(jnp, dtype))
    extra = (["w_mma"] if dtype == "bfloat16" else
             [k + "_padded" for k in trunk._MATS])
    assert sorted(got) == sorted(list(want) + extra)
    for k in want:
        assert got[k].dtype == (getattr(torch, dtype) if k in trunk._MATS
                                else torch.float32)
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
    if dtype == "float32":
        for k in trunk._MATS:
            assert torch.equal(got[k + "_padded"], trunk._padded(got[k]))
    else:
        e = 3 * factor * factor
        assert torch.equal(got["w_mma"], trunk.mma_image(got, 3, 32, e))


def test_packing_takes_merged_trees_and_tensors():
    from rusty_sr_tpu_torch.models.sr_net import merge_params
    params = to_torch(load_builtin("anime"), "cpu")
    a = trunk.pack_trunk_weights(params, 3)
    b = trunk.pack_trunk_weights(merge_params(params), 3)
    for k in a:
        assert torch.equal(a[k], b[k])
    with pytest.raises(ValueError, match="wrong weights for this factor"):
        trunk.pack_trunk_weights(params, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trunk.pack_trunk_weights(params, 3, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    params = load_builtin("anime")
    x, m = tiles(2, 1, 5, True)
    packed = trunk.pack_trunk_weights(params, 3, dtype)
    before = dict(trunk.LAUNCHES)
    got = trunk.fused_trunk(packed, torch.from_numpy(x), torch.from_numpy(m), 3)
    want = trunk.fused_trunk_reference(packed, torch.from_numpy(x),
                                       torch.from_numpy(m), 3, dtype)
    assert torch.equal(got, want)
    assert trunk.LAUNCHES == before


def test_shuffle_cpu_tensors_take_the_plain_version():
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.random((2, 4, 5, 27), dtype=np.float32))
    u8 = torch.from_numpy(r.integers(0, 256, (2, 4, 5, 27), dtype=np.uint8))
    before = shuffle.LAUNCHES
    assert torch.equal(shuffle.depth_to_space_cuda(u8, 3),
                       depth_to_space(u8, 3))
    assert torch.equal(shuffle.depth_to_space_cuda(x, 3),
                       depth_to_space(x, 3))
    assert shuffle.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        shuffle.depth_to_space_cuda(x.to("meta"), 3)


def test_other_devices_raise():
    packed = trunk.pack_trunk_weights(load_builtin("anime"), 3)
    x = torch.zeros((1, 20, 20, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        trunk.fused_trunk(packed, x, torch.zeros((1, 20, 20, 1),
                                                 device="meta"), 3)


def test_kernel_weight_layout():
    """The kernel reads weight rows as float4s: columns padded with zeros
    to a multiple of 8, rows starting on 16-byte boundaries."""
    w = torch.arange(6 * 27, dtype=torch.float32).reshape(6, 27)
    p = trunk._padded(w)
    assert p.shape == (6, 32) and torch.equal(p[:, :27], w)
    assert not p[:, 27:].any() and p.data_ptr() % 16 == 0
    base = torch.zeros(6 * 32 + 1)
    view = base[1:].reshape(6, 32)            # 4 bytes off alignment
    assert trunk._padded(view).data_ptr() % 16 == 0
    aligned = torch.zeros(6, 32)
    assert trunk._padded(aligned) is aligned


# The kernels' device code, compiled as plain C++ and run one thread per
# block, blocks in turn: every index and barrier-separated pass of
# csrc/*.cu, checked here without a card.  __nv_bfloat16 is 16 bits with
# round-to-nearest-even conversion, as on the card.
_HOST_DEFS = r"""
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1},
    gridDim{1, 1, 1};
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
static inline void __syncthreads() {}
struct float4 { float x, y, z, w; };
static inline float4 __ldg(const float4* p) { return *p; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
struct __nv_bfloat16 { uint16_t bits; };
static inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
static inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
"""

# The trunk kernels' device code runs on the host with the conv stage's
# Hopper stand-ins (tests/test_torch_conv_stage.py: one OS thread per CUDA
# thread, mbarriers, the bulk copy, wgmma through its descriptors, the
# warpgroup-collective wgmma wait), cp.async and the accumulator copy as
# memcpy, rsqrtf as 1 / sqrt, and shared memory
# poisoned with NaN bits before every block.
_TRUNK_SHIM_TAIL = r"""
template <int NI> static void copy_acc(float* dst, const float* d) {
  std::memcpy(dst, d, NI / 2 * sizeof(float));
}
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
static void cp_async16(void* d, const void* s) { std::memcpy(d, s, 16); }
static void cp_async_commit() {}
static void cp_async_wait_all() {}
#include "trunk.cu"
namespace {
alignas(128) unsigned char tk_smem[1 << 18];
alignas(16) float smem[1 << 16];
}
static unsigned char* smem_base() { return tk_smem; }
template <class K>
static void run_grid(int threads, int consumers, unsigned gx, unsigned gy,
                     unsigned gz, K kernel) {
  Barrier bar(threads), cbar(consumers);
  Barrier wgb[2] = {Barrier(128), Barrier(128)};
  block_bar = &bar;
  cons_bar = &cbar;
  wg_bars = wgb;
  blockDim = {(unsigned)threads, 1, 1};
  for (unsigned z = 0; z < gz; ++z)
    for (unsigned y = 0; y < gy; ++y)
      for (unsigned x = 0; x < gx; ++x) {
        std::memset(tk_smem, 0xff, sizeof(tk_smem));
        std::memset(smem, 0xff, sizeof(smem));
        blockIdx = {x, y, z};
        std::vector<std::thread> th;
        for (int i = 0; i < threads; ++i)
          th.emplace_back([=] {
            threadIdx = {(unsigned)i, 0, 0};
            kernel();
          });
        for (auto& t : th) t.join();
      }
}
// p: x, mask, then the five padded f32 matrices (f32) or the B operand
// image (bf16), then the nine vectors.
extern "C" int host_trunk(int bf16, const void* const* p, float* out,
                          int batch, int S, int cimg, int n, int e) {
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  // The launchers' choices of weight rows (f32) and block columns (bf16).
  if (!bf16) {
    const int wch = f32_rows(cimg, n, e);
    if (wch < 1 || FGeom::smem_bytes(cimg, n, e, wch) > sizeof(smem))
      return 1;
    const unsigned g = (unsigned)ceil_div(S, F_R);
    run_grid(F_THREADS, F_THREADS, g, g, (unsigned)batch, [&] {
      trunk_f32_kernel(f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8),
                       f(9), f(10), f(11), f(12), f(13), f(14), f(15), out, S,
                       cimg, n, e, wch);
    });
    return 0;
  }
  const int C = bf16_cols(n, e, cimg);
  if (C < 1 || tb_plan(n, e, cimg, TB_R, C).smem > sizeof(tk_smem))
    return 1;
  auto img = static_cast<const __nv_bfloat16*>(p[2]);
  const TPlan pl = tb_plan(n, e, cimg, TB_R, C);
  run_grid(TB_THREADS, HOPPER_CONSUMERS, (unsigned)ceil_div(S, C),
           (unsigned)ceil_div(S, TB_R), (unsigned)batch, [&] {
             trunk_bf16_kernel(f(0), f(1), img, f(3), f(4), f(5), f(6), f(7),
                               f(8), f(9), f(10), f(11), out, S, cimg, n, e,
                               pl);
           });
  return 0;
}
"""


def _compile_shim(tmp_path_factory, name, code, extra=()):
    """Compile ``code`` (a shim that includes a kernel source) with g++
    into a shared library; no FMA contraction, as nvcc's __fmul_rn and
    __fadd_rn promise."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' device code")
    d = tmp_path_factory.mktemp(name)
    (d / "shim.cc").write_text(code)
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-fno-strict-aliasing", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", *extra, "-I", CSRC, "-o",
                    str(d / "shim.so"), str(d / "shim.cc")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(d / "shim.so"))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    from test_torch_conv_stage import _HOPPER_STANDINS
    lib = _compile_shim(tmp_path_factory, "host_kernel",
                        _HOPPER_STANDINS + _TRUNK_SHIM_TAIL, ["-pthread"])
    lib.host_trunk.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p] + [ctypes.c_int] * 5
    return lib


def _raw(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous numpy array with the tensor's bytes."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy())


def params_for(factor, width=32):
    if width != 32:
        return init_params(9, factor, width=width)
    if factor == 4:
        from rusty_sr_tpu_torch.params import load_rsr_file
        return load_rsr_file(os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "fixtures", "factor4.rsr"), 4)
    return load_builtin("anime") if factor == 3 else init_params(7, 2)


def host_trunk(lib, packed, x, m, factor):
    """The kernel of the packed weights' mode, its device code run on the
    host over the whole grid, as the wrapper launches it on the card."""
    bf16 = packed["w0"].dtype == torch.bfloat16
    mats = ([_raw(packed["w_mma"])] if bf16 else
            [_raw(packed[k + "_padded"]) for k in trunk._MATS])
    arrays = [x, m] + mats + [packed[k].numpy() for k in trunk._VECS]
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    e = 3 * factor * factor
    out = np.full((x.shape[0], x.shape[1] - 2 * H, x.shape[2] - 2 * H, e),
                  np.nan, np.float32)
    assert lib.host_trunk(int(bf16), ptrs, out.ctypes.data, x.shape[0],
                          out.shape[1], x.shape[3],
                          packed["f_bias"].shape[-1], e) == 0
    return out


# (factor, S, seed, mode, trunk width): factors 2, 3 and 4 (every N chunk
# width of the bf16 kernel), sides that are multiples of neither kernel's
# block, and a width of 40 (a K padding plane in bf16).
HOST_CASES = [(3, 13, 6, "float32", 32), (2, 11, 7, "float32", 32),
              (4, 9, 8, "float32", 32), (2, 10, 9, "float32", 40),
              (3, 13, 6, "bfloat16", 32), (2, 11, 7, "bfloat16", 32),
              (4, 9, 8, "bfloat16", 32), (2, 10, 9, "bfloat16", 40)]


@pytest.mark.parametrize("factor,s,seed,dtype,width", HOST_CASES)
def test_kernel_device_code_on_the_host(host_kernel, factor, s, seed, dtype,
                                        width):
    """The kernel's own code against its plain version: f32 at 1e-5 (the
    bound used on the card; the sums run in the kernel's order), bf16 at
    the bf16 gates above (a sum in another order can flip a rounding)."""
    bf16 = dtype == "bfloat16"
    x, m = tiles(seed, 3, s, True)
    if bf16:
        x = u8_valued(x)
    packed = trunk.pack_trunk_weights(params_for(factor, width), factor,
                                      getattr(torch, dtype))
    want = trunk.fused_trunk_reference(packed, torch.from_numpy(x),
                                       torch.from_numpy(m), factor).numpy()
    out = host_trunk(host_kernel, packed, x, m, factor)
    if bf16:
        assert_bf16_close(out, want)
    else:
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_with_exact_sums(dtype):
    """exact_sums changes only the convolutions' sums (float64, rounded
    once to f32): f32 out, within the f32 bound or the bf16 gates of the
    plain version, and not equal to it."""
    x, m = tiles(4, 2, 13, True)
    if dtype == "bfloat16":
        x = u8_valued(x)
    packed = trunk.pack_trunk_weights(load_builtin("anime"), 3,
                                      getattr(torch, dtype))
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    plain = trunk.fused_trunk_reference(packed, xt, mt, 3)
    exact = trunk.fused_trunk_reference(packed, xt, mt, 3, exact_sums=True)
    assert exact.dtype == torch.float32 and exact.shape == plain.shape
    assert not torch.equal(exact, plain)
    if dtype == "bfloat16":
        assert_bf16_close(plain.numpy(), exact.numpy())
    else:
        np.testing.assert_allclose(plain.numpy(), exact.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_device_code_against_exact_sums(host_kernel, dtype):
    """The kernel's own code holds the same bounds against the plain
    version with exact sums as against the plain version.  In bf16 it is
    the closer of the two to exact sums, since the host's wgmma stand-in
    rounds each instruction's sum once: its rounding points are the plain
    version's."""
    x, m = tiles(5, 3, 13, True)
    if dtype == "bfloat16":
        x = u8_valued(x)
    packed = trunk.pack_trunk_weights(load_builtin("anime"), 3,
                                      getattr(torch, dtype))
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    exact = trunk.fused_trunk_reference(packed, xt, mt, 3,
                                        exact_sums=True).numpy()
    out = host_trunk(host_kernel, packed, x, m, 3)
    if dtype == "bfloat16":
        assert_bf16_close(out, exact)
        plain = trunk.fused_trunk_reference(packed, xt, mt, 3).numpy()
        assert np.abs(out - exact).mean() <= np.abs(plain - exact).mean()
    else:
        np.testing.assert_allclose(out, exact, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def host_shuffle(tmp_path_factory):
    from test_torch_conv_stage import compile_host_epilogue
    return compile_host_epilogue(tmp_path_factory)


SHUFFLE_CASES = [
    (3, (2, 5, 7, 27), "f32+edge", 0), (2, (3, 4, 9, 12), "f32+edge", 1),
    (3, (2, 6, 5, 27), "u8", 0), (2, (1, 7, 3, 12), "u8", 0),
    (4, (2, 3, 5, 48), "f32", 1), (3, (1, 5, 6, 27), "f32", 0),
    (4, (1, 5, 4, 48), "u8", 5), (4, (2, 4, 3, 48), "f32+u8 edge", 2)]


@pytest.mark.parametrize(
    "factor,shape,dtype,shift", SHUFFLE_CASES,
    ids=[f"{f}-shape{i}-{d}" + (f"-shift{s}" if s else "")
         for i, (f, _, d, s) in enumerate(SHUFFLE_CASES)])
def test_shuffle_device_code_on_the_host(host_shuffle, factor, shape, dtype,
                                         shift):
    """The shuffle kernel's own code, byte-identical to its plain version:
    the plain rearrangement of u8 or f32 values, and the fused engine's
    form, ``depth_to_space(x + base)`` with the base from the edge tiles
    around the h x w window (f32 or u8), on windows that are not square
    and inputs and outputs that start off 16-byte alignment."""
    from test_torch_conv_stage import host_epilogue_run
    from rusty_sr_tpu_torch.ops.resize import bilinear_phases
    r = np.random.default_rng(factor)
    n, h, w, cff = shape
    c = cff // (factor * factor)
    edge = None
    if dtype == "u8":
        x = r.integers(0, 256, shape, dtype=np.uint8)
        want = depth_to_space(torch.from_numpy(x), factor).numpy()
    else:
        x = r.normal(0, 1, shape).astype(np.float32)
        want = shuffle.depth_to_space_reference(torch.from_numpy(x), factor)
        if dtype != "f32":
            edge = (r.integers(0, 256, (n, h + 4, w + 4, c), dtype=np.uint8)
                    if "u8" in dtype else
                    r.random((n, h + 4, w + 4, c), dtype=np.float32))
            e = shuffle.edge_to_f32(torch.from_numpy(edge))
            base = bilinear_phases(e, factor)[:, 2:2 + h, 2:2 + w]
            want = depth_to_space(torch.from_numpy(x) + base, factor)
        want = want.numpy()
    got = host_epilogue_run(host_shuffle, x, factor, h, w, 0, edge, 2,
                            shift=shift)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("factor,width", [(3, 32), (4, 32), (2, 40)])
def test_mma_image_layout(factor, width):
    """Each element of the bf16 kernel's B operand image is the weight the
    kernel's k16 step reads there: per stage, per N chunk of at most 96
    columns, per (tap, 16 channels) step, [k8 half][column][8]; conv0's
    taps are its 5 rows, each 5 * cimg channels; zeros pad K and N."""
    params = init_params(3, factor, width=width)
    pk = trunk.pack_trunk_weights(params, factor, torch.bfloat16)
    n, e, cimg = width, 3 * factor * factor, 3
    img = pk["w_mma"].float().numpy()
    assert img.size == trunk.mma_image_len(cimg, n, e)
    off = 0
    for name, taps, cin, ncol in trunk._stage_geometry(cimg, n, e):
        w = pk[name].float().numpy().reshape(taps, cin, ncol)
        kpad = -(-cin // 16) * 16
        for c0, width_ in trunk._chunks(ncol):
            assert width_ % 32 == 0 and width_ <= 96
            steps = taps * kpad // 16
            blk = img[off:off + steps * 16 * width_].reshape(
                taps, kpad // 16, 2, width_, 8)
            off += steps * 16 * width_
            ref = np.zeros((taps, kpad, width_), np.float32)
            cols = min(width_, ncol - c0)
            ref[:, :cin, :cols] = w[:, :, c0:c0 + cols]
            got = blk.transpose(0, 1, 2, 4, 3).reshape(taps, kpad, width_)
            np.testing.assert_array_equal(got, ref)
    assert off == img.size


def test_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    from rusty_sr_tpu_torch.ops.cuda import _build
    # the shared Hopper header is part of the key
    assert os.path.join(_build.CSRC, "hopper.cuh") in _build._sources()
    assert _build.library_path().startswith(_build.BUILD_DIR)
    assert _build.library_path() == _build.library_path()
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text("// one")
    first = _build.library_path()
    (tmp_path / "k.cu").write_text("// two")
    assert _build.library_path() != first


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    from rusty_sr_tpu_torch.ops.cuda import _build
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
