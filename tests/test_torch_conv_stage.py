"""The xla engine's building blocks against the JAX package's, and the
conv-stage and epilogue kernels' device code run on the host.

- `bf16_split`, the space-to-depth weight packers, `_base_conv_weights`
  and `packed_trunk_params`: bit for bit (the same f32 and bf16 roundings
  of the same values).
- `conv_stage_reference` against `_conv_native(bf16, bf16, f32)`: f32
  out within 1e-5 of the largest output (exact products, f32 sums in
  another order); bf16 out within that f32 bound plus one bf16 ulp (the
  rounding of f32 sums that differ can cross a midpoint), with at most
  1e-3 of the values differing.
- The device code of `csrc/conv_stage.cu`, compiled as plain C++ with
  one OS thread per CUDA thread and the mma replaced by a scalar
  emulation of the PTX ISA's m16n8k16 fragment layout, against the plain
  version at the same bounds; the epilogue of `csrc/shuffle.cu`
  byte-identical to its plain version.
"""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu.ops.conv import _conv_native, bf16_split as j_split
from rusty_sr_tpu.params import load_builtin, load_rsr_file
from rusty_sr_tpu.parallel import tiling as jt
from rusty_sr_tpu_torch.ops.conv import bf16_split
from rusty_sr_tpu_torch.ops.cuda import conv_stage as cs
from rusty_sr_tpu_torch.ops.cuda import shuffle
from rusty_sr_tpu_torch.parallel import tiling
from test_torch_trunk import _HOST_DEFS, _compile_shim, _raw, bits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def params_for(factor):
    return load_builtin("anime") if factor == 3 else load_rsr_file(
        os.path.join(ROOT, "tests", "fixtures", f"factor{factor}.rsr"), factor)


def bf16_values(r, shape, scale=1.0):
    """float32 numpy values that are exact in bf16."""
    v = torch.from_numpy((r.normal(0, scale, shape)).astype(np.float32))
    return v.to(torch.bfloat16).float().numpy()


def test_bf16_split_matches_jax():
    """Normal values, exact ties (low 16 bits 0x8000, odd and even upper
    halves), negatives, zeros and the largest finite values.  Values whose
    residual lo would be subnormal are left out: XLA on the CPU flushes
    subnormals to zero, and weights and pixels never come near them."""
    r = np.random.default_rng(0)
    ties = ((r.integers(0, 2 ** 31, 200, dtype=np.uint32)
             & np.uint32(0x7FFF0000)) | np.uint32(0x8000)).view(np.float32)
    ties = ties[np.isfinite(ties) & (np.abs(ties) > 1e-30)]
    v = np.concatenate([r.normal(0, 1, 2000).astype(np.float32),
                        r.normal(0, 1e4, 100).astype(np.float32), ties,
                        -ties, np.float32([0.0, -0.0, 1.0, -1.0,
                                           3.3e38, -3.3e38])])
    hi, lo = bf16_split(torch.from_numpy(v))
    j_hi, j_lo = j_split(jnp.asarray(v))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(hi), bits(j_hi))
    np.testing.assert_array_equal(bits(lo), bits(j_lo))
    # hi is v rounded to nearest-even, so it agrees with torch's own cast
    np.testing.assert_array_equal(bits(hi),
                                  bits(torch.from_numpy(v).bfloat16()))


@pytest.mark.parametrize("k,blocks", [(3, [5]), (5, [4, 4, 4]),
                                      (3, [4, 4, 3]), (5, [7])])
def test_s2d_conv_weights_match_jax(k, blocks):
    r = np.random.default_rng(k)
    w = r.normal(0, 1, (k, k, 3, sum(blocks))).astype(np.float32)
    got = tiling._s2d_conv_weights(w, blocks)
    want = np.asarray(jt._s2d_conv_weights(jnp.asarray(w), blocks))
    assert got.shape == want.shape == (3, 3, 12, 4 * sum(blocks))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for a, b in zip(tiling._s2d_maps_k(k), jt._s2d_maps_k(k)):
        np.testing.assert_array_equal(a, b)
    if len(blocks) == 1:
        np.testing.assert_array_equal(
            tiling._conv0_s2d_weights(w).view(np.uint32),
            np.asarray(jt._conv0_s2d_weights(jnp.asarray(w))).view(np.uint32))


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_base_conv_weights_match_jax(factor):
    got = tiling._base_conv_weights(factor)
    want = jt._base_conv_weights(factor)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_packed_trunk_params_match_jax(factor):
    params = params_for(factor)
    got = tiling.packed_trunk_params(params, factor)
    want = jt.packed_trunk_params(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.bfloat16, factor)
    assert sorted(got) == sorted(want)
    n, e = 32, 3 * factor * factor
    shapes = {"W0": (3, 3, 24, 4 * n), "WA": (3, 3, 4 * n, 12 * n),
              "WB": (3, 3, 4 * n, 8 * n + 4 * e),
              "WC": (3, 3, 4 * n, 4 * n + 4 * e),
              "WD": (3, 3, 4 * n + 24, 4 * e)}
    for k in want:
        if k in shapes:
            assert got[k].dtype == torch.bfloat16
            assert tuple(got[k].shape) == shapes[k]
        else:
            assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]))


def test_flat_fast_weights_match_jax_splits():
    """The flat fast tier's conv0 weights: JAX's split forms, bit for bit."""
    params = load_builtin("anime")
    p = tiling.flat_trunk_params(params, fast=True)
    w0 = jnp.asarray(params["conv0"])
    hi, lo = j_split(w0 * (256.0 / 255.0))
    np.testing.assert_array_equal(bits(p["conv0_u8"]),
                                  bits(jnp.concatenate([hi, lo], axis=2)))
    hi, lo = j_split(w0)
    np.testing.assert_array_equal(
        bits(p["conv0_f32"]), bits(jnp.concatenate([hi, lo, hi], axis=2)))
    assert "convA_bf16" not in tiling.flat_trunk_params(params, fast=False)


def test_kernel_weights_are_contiguous():
    """The conv-stage kernel reads HWIO weights densely, and its wrapper
    refuses strided ones."""
    params = load_builtin("anime")
    for tree in (tiling.packed_trunk_params(params, 3),
                 tiling.flat_trunk_params(params, fast=True)):
        for k, v in tree.items():
            assert v.is_contiguous(), k


def bf16_excess_ulps(got, want):
    """|got - want| beyond the f32 bound (1e-5 of the largest output), in
    bf16 ulps at the larger magnitude: a bf16 output is the rounding of
    an f32 sum that may differ by the f32 bound, and the rounding may
    then differ by one ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    m = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    excess = np.abs(got - want) - 1e-5 * np.abs(want).max()
    return np.maximum(excess, 0.0) / ulp


def assert_stage_close(got, want, out_dtype):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if out_dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        u = bf16_excess_ulps(got, want)
        share = (got != want).mean()
        assert u.max() <= 1 and share <= 1e-3, (u.max(), share)


STAGES = [(1, 9, 27), (3, 13, 59), (5, 6, 32), (5, 32, 96), (3, 152, 108),
          (3, 24, 91)]


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,cin,cout", STAGES,
                         ids=[f"k{k}-{a}to{b}" for k, a, b in STAGES])
def test_conv_stage_reference_matches_jax(k, cin, cout, out_dtype):
    out_dtype = getattr(torch, out_dtype)
    r = np.random.default_rng(k * 1000 + cin)
    x = bf16_values(r, (2, 11, 17, cin))
    w = bf16_values(r, (k, k, cin, cout), 1.0 / np.sqrt(k * k * cin))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    want = jax.jit(lambda a, b: _conv_native(a, b, jnp.float32, None))(xj, wj)
    if out_dtype == torch.bfloat16:
        want = want.astype(jnp.bfloat16)
    got = cs.conv_stage_reference(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(w).bfloat16(), out_dtype)
    assert got.dtype == out_dtype
    assert_stage_close(got, np.asarray(want.astype(jnp.float32)), out_dtype)


def test_conv_stage_cpu_tensors_take_the_plain_version():
    r = np.random.default_rng(9)
    x = torch.from_numpy(bf16_values(r, (1, 5, 6, 8))).bfloat16()
    w = torch.from_numpy(bf16_values(r, (3, 3, 8, 5))).bfloat16()
    before = cs.LAUNCHES
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(cs.conv_stage(x, w, dt),
                           cs.conv_stage_reference(x, w, dt))
    assert cs.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        cs.conv_stage(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cs.conv_stage(x, w, torch.float16)


def test_epilogue_cpu_tensors_take_the_plain_version():
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.random((2, 12, 12, 27), dtype=np.float32))
    add = torch.from_numpy(r.random((2, 6, 6, 27), dtype=np.float32) - 0.5)
    before = shuffle.EPILOGUE_LAUNCHES
    got = shuffle.epilogue_cuda(x, 3, 6, 3, add, to_u8=True)
    want = shuffle.quantise_u8(add + x[:, 3:9, 3:9])
    from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
    assert torch.equal(got, depth_to_space(want, 3))
    packed = shuffle.epilogue_cuda(tiling._pack_s2d(x), 3, 6, 3, to_u8=True,
                                   packed=True)
    assert torch.equal(packed, depth_to_space(
        shuffle.quantise_u8(x[:, 3:9, 3:9]), 3))
    assert shuffle.EPILOGUE_LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        shuffle.epilogue_cuda(x.to("meta"), 3, 6, 3, add.to("meta"))


# The conv-stage kernel's device code on the host: one OS thread per CUDA
# thread, __syncthreads a barrier of the block's 256 threads, and the
# warp-wide mma an exchange of the 32 lanes' fragments followed by the
# product of the assembled 16x16 and 16x8 operands (f64 sums of the exact
# bf16 products, rounded once to f32 onto the accumulator).
_CONV_SHIM = _HOST_DEFS.replace(
    "static Dim3 threadIdx{0, 0, 0},", "static thread_local Dim3 threadIdx{0, 0, 0};\nstatic Dim3").replace(
    "static inline void __syncthreads() {}", "") + r"""
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
#define __align__(n)
struct uint4 { unsigned x, y, z, w; };
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lk(m_);
    const long gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
    } else {
      cv_.wait(lk, [&] { return gen_ != gen; });
    }
  }
 private:
  std::mutex m_;
  std::condition_variable cv_;
  int n_, count_ = 0;
  long gen_ = 0;
};
struct Warp {
  Barrier bar{32};
  uint32_t a[32][4], b[32][2];
};
static Barrier* block_bar;
static Warp* warps;
static void __syncthreads() { block_bar->wait(); }
static float bf(uint32_t word, int half) {
  const uint32_t u = (half ? word >> 16 : word & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
static void mma_m16n8k16(float* d, const uint32_t* a, const uint32_t* b) {
  const int lane = threadIdx.x % 32;
  Warp& w = warps[threadIdx.x / 32];
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b[0];
  w.b[lane][1] = b[1];
  w.bar.wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int j = 0; j < 2; ++j) {
      A[g][2 * t + j] = bf(w.a[l][0], j);
      A[g + 8][2 * t + j] = bf(w.a[l][1], j);
      A[g][2 * t + 8 + j] = bf(w.a[l][2], j);
      A[g + 8][2 * t + 8 + j] = bf(w.a[l][3], j);
      B[2 * t + j][g] = bf(w.b[l][0], j);
      B[2 * t + 8 + j][g] = bf(w.b[l][1], j);
    }
  }
  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + (i & 1);
    double s = 0.0;
    for (int kk = 0; kk < 16; ++kk) s += (double)A[row][kk] * B[kk][col];
    d[i] = (float)((double)d[i] + s);
  }
  w.bar.wait();
}
#include "conv_stage.cu"
namespace { alignas(16) unsigned char cs_smem[1 << 18]; }
extern "C" int host_conv_stage(const void* x, const void* w, void* out,
                               int batch, int h, int wd, int cin, int cout,
                               int k, int out_bf16, int vec) {
  if (conv_stage_smem(cin, k) > sizeof(cs_smem)) return 1;
  Barrier bar(CS_THREADS);
  std::vector<Warp> ws(CS_THREADS / 32);
  block_bar = &bar;
  warps = ws.data();
  blockDim = {(unsigned)CS_THREADS, 1, 1};
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  const int nbx = ((h + CS_ROWS - 1) / CS_ROWS) * ((wd + CS_COLS - 1) / CS_COLS);
  for (int z = 0; z < batch; ++z)
    for (int y = 0; y < (cout + CS_N - 1) / CS_N; ++y)
      for (int bx = 0; bx < nbx; ++bx) {
        blockIdx = {(unsigned)bx, (unsigned)y, (unsigned)z};
        std::vector<std::thread> th;
        for (int i = 0; i < CS_THREADS; ++i)
          th.emplace_back([=] {
            threadIdx = {(unsigned)i, 0, 0};
            if (out_bf16 && vec)
              conv_stage_kernel<true, true>(xb, wb, out, h, wd, cin, cout, k);
            else if (out_bf16)
              conv_stage_kernel<true, false>(xb, wb, out, h, wd, cin, cout, k);
            else if (vec)
              conv_stage_kernel<false, true>(xb, wb, out, h, wd, cin, cout, k);
            else
              conv_stage_kernel<false, false>(xb, wb, out, h, wd, cin, cout, k);
          });
        for (auto& t : th) t.join();
      }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_conv(tmp_path_factory):
    lib = _compile_shim(tmp_path_factory, "host_conv_stage", _CONV_SHIM,
                        ["-pthread"])
    lib.host_conv_stage.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    lib.host_conv_stage.restype = ctypes.c_int
    return lib


# (k, cin, cout, h, w): every K padding (6, 9, 13 -> 16; 24 -> 32), the
# 16-byte staging path (cin % 8 == 0), two channel blocks with a ragged
# tail (130), and ragged rows and columns.
HOST_STAGES = [(5, 6, 32, 9, 20), (5, 9, 27, 8, 16), (3, 24, 91, 11, 17),
               (1, 13, 130, 5, 18), (3, 32, 59, 10, 33)]


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,cin,cout,h,w", HOST_STAGES,
                         ids=[f"k{s[0]}-{s[1]}to{s[2]}-{s[3]}x{s[4]}"
                              for s in HOST_STAGES])
def test_conv_stage_device_code_on_the_host(host_conv, k, cin, cout, h, w,
                                            out_dtype):
    out_dtype = getattr(torch, out_dtype)
    r = np.random.default_rng(cin * 7 + k)
    x = torch.from_numpy(bf16_values(r, (2, h, w, cin))).bfloat16()
    wt = torch.from_numpy(bf16_values(r, (k, k, cin, cout),
                                      1.0 / np.sqrt(k * k * cin))).bfloat16()
    want = cs.conv_stage_reference(x, wt, out_dtype)
    xr, wr = _raw(x), _raw(wt)
    out = np.full(want.shape, np.nan, np.float32) \
        if out_dtype == torch.float32 else np.zeros(want.shape, np.int16)
    vec = int(cin % 8 == 0 and xr.ctypes.data % 16 == 0)
    assert host_conv.host_conv_stage(
        xr.ctypes.data, wr.ctypes.data, out.ctypes.data, 2, h, w, cin, cout,
        k, int(out_dtype == torch.bfloat16), vec) == 0
    got = out if out_dtype == torch.float32 else \
        torch.from_numpy(out).view(torch.bfloat16).float().numpy()
    assert_stage_close(got, want.float().numpy(), out_dtype)


_EPILOGUE_SHIM = _HOST_DEFS + r"""
#include "shuffle.cu"
extern "C" void host_epilogue(const float* x, const float* a, void* out,
                              int n, int xh, int xw, int off, int tile, int c,
                              int f, int packed, int to_u8) {
  const int rows = n * f * tile;
  auto u8 = static_cast<unsigned char*>(out);
  if (packed)
    d2s_kernel<float, unsigned char, false, true>(x, nullptr, u8, rows, tile,
                                                  tile, xh, xw, off, c, f);
  else if (to_u8)
    d2s_kernel<float, unsigned char, true, false>(x, a, u8, rows, tile, tile,
                                                  xh, xw, off, c, f);
  else
    d2s_kernel<float, float, true, false>(x, a, static_cast<float*>(out),
                                          rows, tile, tile, xh, xw, off, c, f);
}
"""


@pytest.fixture(scope="module")
def host_epilogue(tmp_path_factory):
    lib = _compile_shim(tmp_path_factory, "host_epilogue", _EPILOGUE_SHIM)
    lib.host_epilogue.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    return lib


@pytest.mark.parametrize("mode", ["u8", "f32", "packed"])
@pytest.mark.parametrize("factor,tile,off", [(3, 6, 7), (2, 5, 3), (4, 4, 2)])
def test_epilogue_device_code_on_the_host(host_epilogue, mode, factor, tile,
                                          off):
    """Byte-identical to `epilogue_reference`: the crop read in place, one
    f32 add, the quantisation without contraction, the packed unpack."""
    r = np.random.default_rng(factor * 10 + tile)
    n, side, e = 2, tile + 2 * off, 3 * factor * factor
    if mode == "packed" and side % 2:
        side += 1
    # values around [0, 1] and exact quantisation midpoints (k + 0.5)/255
    x = r.normal(0.5, 0.4, (n, side, side, e)).astype(np.float32)
    near = x.reshape(-1)[::7]
    near[:] = (r.integers(0, 255, near.size) + 0.5) / np.float32(255)
    add = (r.normal(0, 0.1, (n, tile, tile, e)).astype(np.float32)
           if mode != "packed" else None)
    xt = torch.from_numpy(x)
    if mode == "packed":
        xt = tiling._pack_s2d(xt).contiguous()
    want = shuffle.epilogue_reference(
        xt, factor, tile, off, None if add is None else torch.from_numpy(add),
        to_u8=mode != "f32", packed=mode == "packed").numpy()
    out = np.zeros(want.shape, want.dtype)
    xr = np.ascontiguousarray(xt.numpy())
    host_epilogue.host_epilogue(xr.ctypes.data,
                                None if add is None else add.ctypes.data,
                                out.ctypes.data, n, side, side, off, tile,
                                3, factor, int(mode == "packed"),
                                int(mode != "f32"))
    assert out.tobytes() == want.tobytes()
