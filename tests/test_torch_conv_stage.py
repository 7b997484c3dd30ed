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
  one OS thread per CUDA thread and its Hopper instructions (mbarriers,
  the TMA load, the bulk copy, wgmma) replaced by scalar stand-ins that
  read shared memory through the same descriptors, against the plain
  version at the same bounds; with its fused epilogue, byte-identical to
  the kernel without it followed by the plain glue.
- The fused epilogue's plain version, bit for bit the glue the tile
  kernels ran before it; the padded conv0 weights against the unpadded.
- The epilogue of `csrc/shuffle.cu` (the base from the edge tiles, crop,
  quantisation, packed unpack, depth-to-space) byte-identical to its
  plain version, its device code run on the host.
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
from rusty_sr_tpu_torch.ops.activations import belu
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
    """The flat fast tier's conv0 weights: JAX's split forms, bit for bit,
    followed by zero input channels up to 8 and 16."""
    params = load_builtin("anime")
    p = tiling.flat_trunk_params(params, fast=True)
    w0 = jnp.asarray(params["conv0"])
    hi, lo = j_split(w0 * (256.0 / 255.0))
    assert p["conv0_u8"].shape[2] == 8 and p["conv0_f32"].shape[2] == 16
    np.testing.assert_array_equal(bits(p["conv0_u8"][:, :, :6]),
                                  bits(jnp.concatenate([hi, lo], axis=2)))
    hi, lo = j_split(w0)
    np.testing.assert_array_equal(
        bits(p["conv0_f32"][:, :, :9]),
        bits(jnp.concatenate([hi, lo, hi], axis=2)))
    assert not p["conv0_u8"][:, :, 6:].float().any()
    assert not p["conv0_f32"][:, :, 9:].float().any()
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
    from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
    from rusty_sr_tpu_torch.ops.resize import bilinear_phases_cropped
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.random((2, 12, 12, 27), dtype=np.float32))
    edge = torch.from_numpy(r.integers(0, 256, (2, 12, 12, 3),
                                       dtype=np.uint8))
    before = shuffle.EPILOGUE_LAUNCHES
    got = shuffle.epilogue_cuda(x, 3, 6, 3, edge, edge_offset=3, to_u8=True)
    base = bilinear_phases_cropped(edge.float() * (1.0 / 255.0), 3, 3, 3, 6)
    want = shuffle.quantise_u8(base + x[:, 3:9, 3:9])
    assert torch.equal(got, depth_to_space(want, 3))
    packed = shuffle.epilogue_cuda(tiling._pack_s2d(x), 3, 6, 3, to_u8=True,
                                   packed=True)
    assert torch.equal(packed, depth_to_space(
        shuffle.quantise_u8(x[:, 3:9, 3:9]), 3))
    assert shuffle.EPILOGUE_LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        shuffle.epilogue_cuda(x.to("meta"), 3, 6, 3, edge.to("meta"),
                              edge_offset=3)


# The conv-stage kernel's device code on the host: one OS thread per CUDA
# thread, __syncthreads a barrier of the block's 288 threads and the named
# consumer barrier one of its 256 consumers, and the Hopper instructions
# replaced by scalar stand-ins: mbarriers with arrival counts, transaction
# bytes and phases; the TMA load a copy of the box with zero fill outside
# the tensor; the bulk copy a memcpy; and the wgmma a product that reads A
# and B from shared memory through the same descriptor fields (start,
# leading and stride byte offsets of no-swizzle K-major core matrices) and
# writes the PTX ISA's m64nNk16 accumulator fragment (f64 sums of the exact
# bf16 products, rounded once to f32 onto the accumulator).
# The stand-ins are shared with the trunk kernel's host test
# (tests/test_torch_trunk.py); the includer defines smem_base().
_HOPPER_STANDINS = _HOST_DEFS.replace(
    "static Dim3 threadIdx{0, 0, 0},", "static thread_local Dim3 threadIdx{0, 0, 0};\nstatic Dim3").replace(
    "static inline void __syncthreads() {}", "") + r"""
#include <condition_variable>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
#define __align__(n)
#define __grid_constant__
struct uint4 { unsigned x, y, z, w; };
static inline float __fsqrt_rn(float x) { return std::sqrt(x); }
static inline int __shfl_sync(unsigned, int v, int) { return v; }
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
static Barrier* block_bar;
static Barrier* cons_bar;
static void __syncthreads() { block_bar->wait(); }
static void consumer_sync() { cons_bar->wait(); }
static unsigned char* smem_base();
static uint32_t smem_addr(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - smem_base());
}
struct CUtensorMap {
  const unsigned char* base;
  long long dim[5], stride[5];
  int box[5];
};
struct HostBar {
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
};
static std::mutex bar_m;
static std::condition_variable bar_cv;
static std::map<uint32_t, HostBar> bars;
static void bar_check(HostBar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.phase;
    b.pending = b.expected;
    bar_cv.notify_all();
  }
}
static void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lk(bar_m);
  bars[smem_addr(bar)] = HostBar{count, count, 0, 0};
}
static void mbar_fence_init() {}
static void fence_proxy_async() {}
static void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(bar_m);
  HostBar& b = bars.at(smem_addr(bar));
  b.tx += bytes;
  --b.pending;
  bar_check(b);
}
static void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lk(bar_m);
  HostBar& b = bars.at(smem_addr(bar));
  --b.pending;
  bar_check(b);
}
static void tx_done(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(bar_m);
  HostBar& b = bars.at(smem_addr(bar));
  b.tx -= bytes;
  bar_check(b);
}
static void mbar_wait(uint64_t* bar, int parity) {
  std::unique_lock<std::mutex> lk(bar_m);
  const uint32_t key = smem_addr(bar);
  bar_cv.wait(lk, [&] { return (int)(bars.at(key).phase & 1u) != parity; });
}
static void tma_load_window(void* dst, const CUtensorMap* m, uint64_t* bar,
                            int c0, int c1, int c2, int c3, int c4) {
  auto d = static_cast<uint16_t*>(dst);
  size_t i = 0;
  for (int i4 = 0; i4 < m->box[4]; ++i4)
    for (int i3 = 0; i3 < m->box[3]; ++i3)
      for (int i2 = 0; i2 < m->box[2]; ++i2)
        for (int i1 = 0; i1 < m->box[1]; ++i1)
          for (int i0 = 0; i0 < m->box[0]; ++i0, ++i) {
            const long long g[5] = {c0 + i0, c1 + i1, c2 + i2, c3 + i3,
                                    c4 + i4};
            long long off = 0;
            bool in = true;
            for (int a = 0; a < 5; ++a) {
              in = in && g[a] >= 0 && g[a] < m->dim[a];
              off += g[a] * m->stride[a];
            }
            uint16_t v = 0;
            if (in) std::memcpy(&v, m->base + off, 2);
            d[i] = v;
          }
  tx_done(bar, (uint32_t)(i * 2));
}
static void bulk_copy(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  tx_done(bar, bytes);
}
static void wgmma_fence() {}
static void wgmma_commit() {}
// wgmma.wait_group is warpgroup-collective on the card (a group retires
// once all four warps have issued it), so no thread of a warpgroup runs a
// ring cycle ahead of the others: a barrier of the warpgroup's threads.
static Barrier* wg_bars;
template <int N> static void wgmma_wait() { wg_bars[threadIdx.x / 128].wait(); }
template <int NI> static void fence_acc(float*) {}
static float smem_bf16(uint32_t addr) {
  uint16_t h;
  std::memcpy(&h, smem_base() + addr, 2);
  const uint32_t u = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// Element (row, k) of a no-swizzle K-major operand under descriptor d.
static float desc_at(uint64_t d, int row, int k) {
  const uint32_t start = (uint32_t)(d & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((d >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((d >> 32) & 0x3FFF) << 4;
  return smem_bf16(start + (row / 8) * sbo + (k / 8) * lbo + (row % 8) * 16 +
                   (k % 8) * 2);
}
template <int NI>
static void wgmma_bf16(float* d, uint64_t da, uint64_t db) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  for (int i = 0; i < NI / 2; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    double s = 0.0;
    for (int k = 0; k < 16; ++k)
      s += (double)desc_at(da, row, k) * desc_at(db, col, k);
    d[i] = (float)((double)d[i] + s);
  }
}
"""

_CONV_SHIM = _HOPPER_STANDINS + r"""
#include "conv_stage.cu"
namespace { alignas(128) unsigned char cs_smem[1 << 18]; }
static unsigned char* smem_base() { return cs_smem; }
template <int NI, bool B>
static void run_block(const CUtensorMap& map, const __nv_bfloat16* w,
                      void* out, long long out_ps, int h, int wd, int cin,
                      int cout, int k, int nblk, const ConvEpi& epi) {
  conv_stage_kernel<NI, B>(map, w, out, out_ps, h, wd, cin, cout, k, nblk,
                           epi);
}
template <bool B>
static void run_ni(int ni, const CUtensorMap& map, const __nv_bfloat16* w,
                   void* out, long long out_ps, int h, int wd, int cin,
                   int cout, int k, int nblk, const ConvEpi& epi) {
  switch (ni) {
    case 32: run_block<32, B>(map, w, out, out_ps, h, wd, cin, cout, k, nblk, epi); break;
    case 64: run_block<64, B>(map, w, out, out_ps, h, wd, cin, cout, k, nblk, epi); break;
    case 96: run_block<96, B>(map, w, out, out_ps, h, wd, cin, cout, k, nblk, epi); break;
    case 128: run_block<128, B>(map, w, out, out_ps, h, wd, cin, cout, k, nblk, epi); break;
    case 192: run_block<192, B>(map, w, out, out_ps, h, wd, cin, cout, k, nblk, epi); break;
  }
}
extern "C" int host_conv_stage(
    const void* x, long long x_ps, const void* w_img, void* out,
    long long out_ps, int batch, int h, int wd, int cin, int cout, int k,
    int ni, int out_bf16, int n_act, int gap, int cur_bf16, int act,
    const void* bias, const void* slope, const void* add0, long long add0_ps,
    const void* add1, long long add1_ps, const void* mask, int groups) {
  const Plan pl = make_plan(cin, k, ni);
  if (pl.smem > sizeof(cs_smem) || cin % 8 || x_ps % 8) return 1;
  const CUtensorMap map{
      static_cast<const unsigned char*>(x),
      {8, wd, h, cin / 8, batch},
      {2, x_ps * 2, x_ps * 2 * wd, 16, x_ps * 2 * wd * h},
      {8, CS_COLS + k - 1, k, cin / 8 < 4 ? cin / 8 : 4, 1}};
  const ConvEpi epi{n_act, gap, cur_bf16, act,
                    static_cast<const float*>(bias),
                    static_cast<const float*>(slope),
                    static_cast<const __nv_bfloat16*>(add0), add0_ps,
                    static_cast<const __nv_bfloat16*>(add1), add1_ps,
                    static_cast<const __nv_bfloat16*>(mask), groups};
  auto w = static_cast<const __nv_bfloat16*>(w_img);
  const int nblk = (cout + ni - 1) / ni;
  const long long blocks =
      (long long)batch * h * ((wd + CS_COLS - 1) / CS_COLS) * nblk;
  Barrier bar(CS_THREADS), cbar(CS_CONSUMERS);
  block_bar = &bar;
  cons_bar = &cbar;
  Barrier wgb[CS_WGS] = {Barrier(128), Barrier(128)};
  wg_bars = wgb;
  blockDim = {(unsigned)CS_THREADS, 1, 1};
  for (long long b = 0; b < blocks; ++b) {
    // NaN bf16 everywhere: a read of shared memory that no copy wrote
    // poisons the result.
    std::memset(cs_smem, 0xff, pl.smem);
    blockIdx = {(unsigned)b, 0, 0};
    std::vector<std::thread> th;
    for (int i = 0; i < CS_THREADS; ++i)
      th.emplace_back([=, &map, &epi] {
        threadIdx = {(unsigned)i, 0, 0};
        if (out_bf16)
          run_ni<true>(ni, map, w, out, out_ps, h, wd, cin, cout, k, nblk,
                       epi);
        else
          run_ni<false>(ni, map, w, out, out_ps, h, wd, cin, cout, k, nblk,
                        epi);
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
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_conv_stage.argtypes = (
        [ptr, i64, ptr, ptr, i64] + [i32] * 12
        + [ptr, ptr, ptr, i64, ptr, i64, ptr, i32])
    lib.host_conv_stage.restype = i32
    return lib


def host_stage(lib, x, w, out_dtype):
    """The kernel's device code on the host, called as the wrapper calls
    the card: ``x`` (a channel slice of a dense buffer) with Cin
    zero-padded to a multiple of 8, the packed weights (``w`` HWIO or a
    `FusedStage`), an output buffer whose every byte starts as NaN
    bits."""
    hwio, _, epi = cs._split(w)
    cin = x.shape[-1]
    cin8 = -(-cin // 8) * 8
    if cin8 != cin or x.stride(2) % 8:
        x = torch.nn.functional.pad(x, (0, cin8 - cin)).contiguous()
        hwio = torch.nn.functional.pad(hwio, (0, 0, 0, cin8 - cin))
    bsz, h, wd, cin = x.shape
    k, cout = hwio.shape[0], hwio.shape[3]
    sw = cs.prepare_stage(hwio.contiguous())
    out = cs._out_buffer(x, cout, cs._out_dtype(cout, out_dtype, epi), epi)
    out.view(torch.int16 if out.dtype == torch.bfloat16
             else torch.int32).fill_(-1)
    assert lib.host_conv_stage(
        x.data_ptr(), x.stride(2), sw.image.data_ptr(), out.data_ptr(),
        out.stride(2), bsz, h, wd, cin, cout, k, sw.ni,
        int(out.dtype == torch.bfloat16),
        *cs._epilogue_args(epi, x, cout, out_dtype)) == 0
    return out


# (k, cin, cout, h, w): every K padding (6 -> 8 -> 16, 9 -> 16, 13 -> 16,
# 24 -> 32), N tiles of 32 to 192 with ragged tails (27, 59, 91, 130),
# ragged rows and columns, and a row of more than one 128-pixel block.
HOST_STAGES = [(5, 6, 32, 9, 20), (5, 9, 27, 8, 16), (3, 24, 91, 11, 17),
               (1, 13, 130, 5, 18), (3, 32, 59, 3, 133)]


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
    got = host_stage(host_conv, x, wt, out_dtype)
    assert got.shape == want.shape
    assert_stage_close(got, want.float().numpy(), out_dtype)


# The epilogue kernel's device code on the host: one OS thread per CUDA
# thread (fewer than on the card; its loops stride by blockDim), the blocks
# in turn with shared memory poisoned with NaN bits before each,
# __syncthreads a barrier of the block's threads and cp.async a memcpy.
# The shared-memory target is an argument, so that a small one makes the
# blocks take one row and segments of columns.
_SHUFFLE_SHIM = _HOPPER_STANDINS + r"""
static void cp_async16(void* d, const void* s) { std::memcpy(d, s, 16); }
static void cp_async_commit() {}
static void cp_async_wait_all() {}
#include "shuffle.cu"
namespace { alignas(16) unsigned char ep_smem[1 << 18]; }
static unsigned char* smem_base() { return ep_smem; }
template <class TI, class TO, int EDGE, bool PACKED>
static int run_epilogue(EpArgs a, long long target, int threads) {
  const long long smem = ep_plan<TI, TO, EDGE, PACKED>(a, target);
  if (smem < 0 || smem > (long long)sizeof(ep_smem)) return 1;
  Barrier bar(threads);
  block_bar = &bar;
  blockDim = {(unsigned)threads, 1, 1};
  const long long blocks = (long long)a.n * a.strips * a.segs;
  for (long long b = 0; b < blocks; ++b) {
    std::memset(ep_smem, 0xff, sizeof(ep_smem));
    blockIdx = {(unsigned)b, 0, 0};
    std::vector<std::thread> th;
    for (int i = 0; i < threads; ++i)
      th.emplace_back([=] {
        threadIdx = {(unsigned)i, 0, 0};
        if (a.f == 3)   // the launcher's choice of kernel
          epilogue_kernel<TI, TO, EDGE, PACKED, 3>(a);
        else
          epilogue_kernel<TI, TO, EDGE, PACKED, 0>(a);
      });
    for (auto& t : th) t.join();
  }
  return 0;
}
// The kernel form the wrappers launch for these arguments: the plain
// rearrangement of u8 (x_u8), or srt_epilogue's forms.
extern "C" int host_epilogue(const void* x, int x_u8, const void* edge,
                             int edge_kind, void* out, int to_u8, int packed,
                             int n, int th, int tw, int xh, int xw, int off,
                             int eh, int ew, int eoff, int c, int f,
                             long long target, int threads) {
  EpArgs a{};
  a.x = x; a.edge = edge; a.out = out;
  a.n = n; a.th = th; a.tw = tw; a.xh = xh; a.xw = xw; a.off = off;
  a.eh = eh; a.ew = ew; a.eoff = eoff; a.c = c; a.f = f;
  if (x_u8)
    return run_epilogue<unsigned char, unsigned char, 0, false>(a, target,
                                                                threads);
  if (packed)
    return run_epilogue<float, unsigned char, 0, true>(a, target, threads);
  switch (edge_kind * 2 + (to_u8 ? 1 : 0)) {
    case 0: return run_epilogue<float, float, 0, false>(a, target, threads);
    case 1: return run_epilogue<float, unsigned char, 0, false>(a, target, threads);
    case 2: return run_epilogue<float, float, 1, false>(a, target, threads);
    case 3: return run_epilogue<float, unsigned char, 1, false>(a, target, threads);
    case 4: return run_epilogue<float, float, 2, false>(a, target, threads);
    case 5: return run_epilogue<float, unsigned char, 2, false>(a, target, threads);
  }
  return 1;
}
"""


def compile_host_epilogue(tmp_path_factory):
    lib = _compile_shim(tmp_path_factory, "host_epilogue", _SHUFFLE_SHIM,
                        ["-pthread"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_epilogue.argtypes = ([ptr, i32, ptr, i32, ptr] + [i32] * 13
                                  + [ctypes.c_longlong, i32])
    lib.host_epilogue.restype = i32
    return lib


@pytest.fixture(scope="module")
def host_epilogue(tmp_path_factory):
    return compile_host_epilogue(tmp_path_factory)


def _at_offset(a: np.ndarray, shift: int) -> np.ndarray:
    """A copy of ``a`` that starts ``shift`` elements past a 16-byte
    boundary."""
    buf = np.empty(a.size + 32 // a.itemsize, a.dtype)
    a0 = (-buf.ctypes.data % 16) // a.itemsize + shift
    view = buf[a0:a0 + a.size].reshape(a.shape)
    view[...] = a
    return view


def host_epilogue_run(lib, x, factor, th, tw, off, edge=None, eoff=0,
                      to_u8=False, packed=False, shift=0, target=72 * 1024,
                      threads=64):
    """The kernel's device code on numpy ``x`` (and ``edge``), called as
    the wrappers call the card, every input and the output ``shift``
    elements past 16-byte alignment; the output starts as poison (NaN bits
    or 0xab bytes)."""
    n = x.shape[0]
    xh, xw = (2 * x.shape[1], 2 * x.shape[2]) if packed else x.shape[1:3]
    c = x.shape[3] // (4 if packed else 1) // (factor * factor)
    odt = np.uint8 if to_u8 or x.dtype == np.uint8 else np.float32
    out = _at_offset(np.full((n, factor * th, factor * tw, c),
                             0xab if odt == np.uint8 else np.nan, odt), shift)
    xs = _at_offset(x, shift)
    es = None if edge is None else _at_offset(edge, shift)
    kind = 0 if edge is None else 1 if edge.dtype == np.uint8 else 2
    eh, ew = (0, 0) if edge is None else edge.shape[1:3]
    assert lib.host_epilogue(
        xs.ctypes.data, int(x.dtype == np.uint8),
        None if es is None else es.ctypes.data, kind, out.ctypes.data,
        int(to_u8), int(packed), n, th, tw, xh, xw, off, eh, ew, eoff, c,
        factor, target, threads) == 0
    return out


EPI_MODES = ["u8", "f32", "packed", "fused", "u8-f32edge", "crop-u8"]
# (factor, tile, off, shift, shared-memory target): factors 2, 3 and 4;
# ragged tiles (odd, not a multiple of the block's rows); crops at 756
# bytes into a row (7 px x 108 B, off 16-byte alignment) and inputs that
# start off alignment; a target small enough that a block takes one row
# and a segment of its columns.
EPI_CASES = [(3, 6, 7, 0, 72 * 1024), (2, 5, 3, 0, 72 * 1024),
             (4, 4, 2, 0, 72 * 1024), (2, 9, 7, 1, 72 * 1024),
             (3, 11, 5, 3, 2048)]
EPI_IDS = ["3-6-7", "2-5-3", "4-4-2", "2-9-7-shift1", "3-11-5-shift3-smem2K"]


def epilogue_case(mode, factor, tile, off, seed):
    """(x, edge, kwargs of `epilogue_reference`) for one form: x near
    [0, 1] with exact quantisation midpoints (k + 0.5)/255, and tile 0's
    edge tiles all zero (a base of 0, so the midpoints reach the
    quantisation as they are)."""
    r = np.random.default_rng(seed)
    n, e = 2, 3 * factor * factor
    side = tile + 2 * off
    if mode == "packed" and side % 2:
        side += 1
    xs = tile if mode == "fused" else side
    x = r.normal(0.5, 0.4, (n, xs, xs, e)).astype(np.float32)
    near = x.reshape(-1)[::7]
    near[:] = (r.integers(0, 255, near.size) + 0.5) / np.float32(255)
    edge = None
    if mode in ("u8",):
        edge = r.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    elif mode in ("f32", "fused", "u8-f32edge"):
        edge = r.random((n, side, side, 3), dtype=np.float32)
    if edge is not None:
        edge[0] = 0
    kw = dict(to_u8=mode not in ("f32", "fused"), packed=mode == "packed",
              edge_offset=off)
    offset = 0 if mode == "fused" else off
    if mode == "packed":
        x = tiling._pack_s2d(torch.from_numpy(x)).contiguous().numpy()
    return x, edge, offset, kw


@pytest.mark.parametrize("mode", EPI_MODES)
@pytest.mark.parametrize("factor,tile,off,shift,target", EPI_CASES,
                         ids=EPI_IDS)
def test_epilogue_device_code_on_the_host(host_epilogue, mode, factor, tile,
                                          off, shift, target):
    """Byte-identical to `epilogue_reference`: the crop read in place, the
    base from u8 or f32 edge tiles (the same lerps in the same order), one
    f32 add, the quantisation without contraction, the packed unpack."""
    x, edge, offset, kw = epilogue_case(mode, factor, tile, off,
                                        factor * 10 + tile)
    want = shuffle.epilogue_reference(
        torch.from_numpy(x), factor, tile, offset,
        None if edge is None else torch.from_numpy(edge), **kw).numpy()
    got = host_epilogue_run(host_epilogue, x, factor, tile, tile, offset,
                            edge, off, kw["to_u8"], kw["packed"], shift,
                            target)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# The fused epilogue: its plain version against the glue the tile kernels
# ran before it was fused, and the kernel's epilogue code on the host.
from test_torch_cuda import FUSED, fused_case  # noqa: E402


def _glue(name, x, w, epi, odt):
    """The tile kernels' glue as written before it was fused into the
    stages (bit for bit what `_tile_kernel`/`_tile_kernel_packed` ran)."""
    bf = torch.bfloat16
    y = cs.conv_stage_reference(x, w, odt)
    n, bias, slope = epi.n_act, epi.bias, epi.slope
    a = [t[..., :n].float() for t in epi.addends]
    tier, key = name.split("-")
    if tier == "packed" and key != "WD":
        mN = epi.mask.repeat_interleave(n // 4, dim=-1)
        cur = y if key == "W0" else y[..., :n].float()
        s = cur if not a else (a[0] + cur if len(a) == 1
                               else a[0] + a[1] + cur)
        return y, belu(s + bias, slope).to(bf) * mN
    if key in ("WD", "expand"):
        return y, a[0] + a[1] + y.float() + bias
    m = epi.mask.float()
    if key == "conv0":
        return y, (m * belu(y + bias, slope)).to(bf)
    return y, (m * belu(a[0] + a[1] + y[..., :n].float() + bias,
                        slope)).to(bf)


@pytest.mark.parametrize("name", FUSED)
def test_fused_epilogue_reference_matches_the_glue(name):
    """`stage_epilogue_reference` is the glue it replaced, bit for bit, on
    random bf16 activations, addends and masks with the anime weights."""
    x, w, fused, odt = fused_case(name, torch.device("cpu"), bsz=2, s=9)
    epi = fused.epilogue
    got = cs.conv_stage_reference(x, fused, odt)
    y, want = _glue(name, x, w, epi, odt)
    n, cout = epi.n_act, w.shape[3]
    assert got.shape[-1] == cout + epi.gap
    np.testing.assert_array_equal(bits(got[..., :n].contiguous()),
                                  bits(want.contiguous()))
    if n < cout:
        np.testing.assert_array_equal(
            bits(got[..., n + epi.gap:].contiguous()),
            bits(y[..., n:].to(got.dtype).contiguous()))


@pytest.mark.parametrize("form,real", [("u8", 6), ("f32", 9)])
def test_padded_conv0_weights_match_unpadded(form, real):
    """The flat tier's conv0 with its input channels zero-padded (8, 16)
    gives the result of the unpadded 6- and 9-channel conv."""
    p = tiling.flat_trunk_params(load_builtin("anime"), fast=True)
    w = p["conv0_" + form]
    r = np.random.default_rng(real)
    x = torch.from_numpy(r.integers(0, 256, (2, 13, 11, real)).astype(
        np.float32) / 256.0).bfloat16()
    xp = torch.nn.functional.pad(x, (0, w.shape[2] - real))
    got = cs.conv_stage_reference(xp, w)
    want = cs.conv_stage_reference(x, w[:, :, :real].contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["packed-WB", "packed-WC", "packed-WD",
                                  "flat-conv0"])
def test_fused_epilogue_device_code_on_the_host(host_conv, name):
    """The kernel's epilogue on the host: byte-identical to the same kernel
    without it followed by the plain glue, on every written channel; the
    gap channels are not written (they keep the NaN bits the buffer
    starts with)."""
    x, w, fused, odt = fused_case(name, torch.device("cpu"), bsz=1, s=5)
    epi = fused.epilogue
    got = host_stage(host_conv, x, fused, odt)
    plain = host_stage(host_conv, x, w, odt)
    want = cs.stage_epilogue_reference(plain, epi, torch.empty_like(got))
    n, gap, cout = epi.n_act, epi.gap, w.shape[3]
    for sl in (slice(0, n), slice(n + gap, cout + gap)):
        np.testing.assert_array_equal(bits(got[..., sl].contiguous()),
                                      bits(want[..., sl].contiguous()))
    if gap:
        assert (got[..., n:n + gap].contiguous().view(torch.int16)
                == -1).all()
