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
    """The JAX packer's dict, bit for bit, plus each matrix padded for
    the kernel once at packing time."""
    params = load_builtin("anime") if factor == 3 else init_params(7, 2)
    got = trunk.pack_trunk_weights(params, factor, getattr(torch, dtype))
    want = j_pack({k: jnp.asarray(v) for k, v in params.items()}, factor,
                  dtype=getattr(jnp, dtype))
    assert sorted(got) == sorted(list(want)
                                 + [k + "_padded" for k in trunk._MATS])
    for k in want:
        assert got[k].dtype == (getattr(torch, dtype) if k in trunk._MATS
                                else torch.float32)
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
    for k in trunk._MATS:
        assert torch.equal(got[k + "_padded"],
                           trunk._padded(got[k]))


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
    a = torch.from_numpy(r.random((2, 4, 5, 27), dtype=np.float32))
    before = shuffle.LAUNCHES
    got = shuffle.depth_to_space_cuda(x, 3, addend=a)
    assert torch.equal(got, depth_to_space(x + a, 3))
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

_TRUNK_SHIM = _HOST_DEFS + r"""
#include "trunk.cu"
namespace { float smem[1 << 20]; }
template <class T>
static void run(const void* const* p, float* out, int batch, int S,
                int cimg, int n, int e) {
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto w = [&](int i) { return static_cast<const T*>(p[i]); };
  const int nb = (S + Mode<T>::R - 1) / Mode<T>::R;
  for (int z = 0; z < batch; ++z)
    for (int y = 0; y < nb; ++y)
      for (int x = 0; x < nb; ++x) {
        blockIdx = {(unsigned)x, (unsigned)y, (unsigned)z};
        trunk_kernel<T>(f(0), f(1), w(2), w(3), w(4), w(5), w(6), f(7),
                        f(8), f(9), f(10), f(11), f(12), f(13), f(14), f(15),
                        out, S, cimg, n, e);
      }
}
extern "C" void host_trunk(int bf16, const void* const* p, float* out,
                           int batch, int S, int cimg, int n, int e) {
  if (bf16)
    run<__nv_bfloat16>(p, out, batch, S, cimg, n, e);
  else
    run<float>(p, out, batch, S, cimg, n, e);
}
"""

_SHUFFLE_SHIM = _HOST_DEFS + r"""
#include "shuffle.cu"
extern "C" void host_d2s_f32(const float* x, const float* a, float* out,
                             int n, int h, int w, int c, int f) {
  if (a)
    d2s_kernel<float, float, true, false>(x, a, out, n * f * h, h, w, h, w, 0,
                                          c, f);
  else
    d2s_kernel<float, float, false, false>(x, nullptr, out, n * f * h, h, w,
                                           h, w, 0, c, f);
}
extern "C" void host_d2s_u8(const unsigned char* x, unsigned char* out,
                            int n, int h, int w, int c, int f) {
  d2s_kernel<unsigned char, unsigned char, false, false>(
      x, nullptr, out, n * f * h, h, w, h, w, 0, c, f);
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
    lib = _compile_shim(tmp_path_factory, "host_kernel", _TRUNK_SHIM)
    lib.host_trunk.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p] + [ctypes.c_int] * 5
    return lib


def _raw(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous numpy array with the tensor's bytes."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy())


@pytest.mark.parametrize("factor,s,seed,dtype", [
    (3, 13, 6, "float32"), (2, 11, 7, "float32"),
    (3, 13, 6, "bfloat16"), (2, 11, 7, "bfloat16")])
def test_kernel_device_code_on_the_host(host_kernel, factor, s, seed, dtype):
    """The kernel's own code against its plain version: f32 at 1e-5 (the
    bound used on the card; the sums run in the kernel's order), bf16 at
    the bf16 gates above (a sum in another order can flip a rounding)."""
    bf16 = dtype == "bfloat16"
    params = load_builtin("anime") if factor == 3 else init_params(7, 2)
    x, m = tiles(seed, 3, s, True)
    if bf16:
        x = u8_valued(x)
    packed = trunk.pack_trunk_weights(params, factor, getattr(torch, dtype))
    want = trunk.fused_trunk_reference(packed, torch.from_numpy(x),
                                       torch.from_numpy(m), factor).numpy()
    arrays = [x, m] + [_raw(packed[k + "_padded"]) for k in trunk._MATS] + \
        [packed[k].numpy() for k in trunk._VECS]
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    out = np.full(want.shape, np.nan, np.float32)
    host_kernel.host_trunk(int(bf16), ptrs, out.ctypes.data, 3, s, 3,
                           packed["f_bias"].shape[-1], 3 * factor * factor)
    if bf16:
        assert_bf16_close(out, want)
    else:
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def host_shuffle(tmp_path_factory):
    lib = _compile_shim(tmp_path_factory, "host_shuffle", _SHUFFLE_SHIM)
    lib.host_d2s_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    lib.host_d2s_u8.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    return lib


@pytest.mark.parametrize("factor,shape,dtype", [
    (3, (2, 5, 7, 27), "f32+addend"), (2, (3, 4, 9, 12), "f32+addend"),
    (3, (2, 6, 5, 27), "u8"), (2, (1, 7, 3, 12), "u8")])
def test_shuffle_device_code_on_the_host(host_shuffle, factor, shape, dtype):
    """The shuffle kernel's own code, byte-identical to its plain version
    (one f32 add per element on both sides, then a permutation)."""
    r = np.random.default_rng(factor)
    n, h, w, cff = shape
    c = cff // (factor * factor)
    if dtype == "u8":
        x = r.integers(0, 256, shape, dtype=np.uint8)
        want = depth_to_space(torch.from_numpy(x), factor).numpy()
        out = np.zeros(want.shape, np.uint8)
        host_shuffle.host_d2s_u8(x.ctypes.data, out.ctypes.data, n, h, w, c,
                                 factor)
    else:
        x = r.normal(0, 1, shape).astype(np.float32)
        a = r.normal(0, 1, shape).astype(np.float32)
        want = shuffle.depth_to_space_reference(
            torch.from_numpy(x), factor, torch.from_numpy(a)).numpy()
        out = np.full(want.shape, np.nan, np.float32)
        host_shuffle.host_d2s_f32(x.ctypes.data, a.ctypes.data,
                                  out.ctypes.data, n, h, w, c, factor)
    assert out.tobytes() == want.tobytes()


def test_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    from rusty_sr_tpu_torch.ops.cuda import _build
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
