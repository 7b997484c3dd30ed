// One trunk conv stage on Hopper's tensor cores (sm_90a):
//
//   acc[n][y][x][o] = sum over dy, dx, c of
//       x[n][y + dy - r][x + dx - r][c] * w[dy][dx][c][o]      (r = k / 2)
//
// a stride-1 cross-correlation with Same zero padding, NHWC bf16 input
// (Cin a multiple of 8, read in place with any pixel stride), bf16 weights
// packed once into the wgmma B operand's shared-memory image, k in
// {1, 3, 5}, f32 accumulation, and an optional fused epilogue:
//
//   channels [0, n_act):  v = ((add0 + add1) + cur) + bias[o]
//                         v = belu(v, slope[o])               (if act)
//                         out = round(v) * mask[group(o)]     (bf16 out)
//                         out = v * mask[group(o)]            (f32 out)
//   channels [n_act, Cout), written at o + gap:  out = round(acc) or acc
//
// where cur is acc, or acc rounded to bf16 and widened (cur_bf16), the
// addends are bf16 channel slices of earlier stages' outputs read in place,
// and the mask is a {0,1} bf16 border mask of 1 or 4 groups (channel o
// reads group o / (n_act / groups)).  With n_act = 0 it is the plain conv,
// f32 or rounded to nearest-even bf16.  The sum order is the plain glue's
// (`ops/cuda/conv_stage.py::stage_epilogue_reference`), and every f32
// operation is a __f*_rn intrinsic, so nvcc cannot contract it.
//
// Replaces the TPU conv-stage kernels of scripts/mosaic_probe.py (k_reshape,
// k_scratch, k_rank3, k_scratch_concat: offset dots and K-concatenated
// slices), mosaic_probe2.py (k_store_kmajor, k_lhsT_dot: a 3x3 stage as
// K-major patches), mosaic_probe3.py (kernel_kmajor, kernel_lane_stores: a
// 5x5 stage), mosaic_probe4.py (kernel_slice, kernel_roll: 5x5 as 25 shifted
// dots) and mosaic_probe5.py (kernel_aligned, kernel_copy3, kernel_pack3: 3x3
// as 9 shifted dots), and the BeLU/mask/sum glue that XLA fuses into the
// convs' consumers in `rusty_sr_tpu/parallel/tiling.py`.
//
// What bounds it: the tensor cores on the wide stages (the packed tier's WA,
// WB, WC, WD and the flat convA), memory on the narrow ones (W0, the flat
// conv0).  The weights of a wide stage (WA: 9 x 128 x 384 bf16, 884 KB) do
// not fit in shared memory, so every block streams its N slice of them
// from L2.  What holds this version back (PERF.md): with one block an SM
// on the wide stages, a block's window load, products and epilogue run in
// turn and nothing overlaps them; a persistent grid that loads the next
// window during the epilogue is the next step.  The design:
//
// - A block owns 128 output pixels of one row (two wgmma M tiles of 64, one
//   per consumer warpgroup) and NI output channels (NI <= 192, so the
//   accumulators are NI / 2 registers a thread).  Cout above 192 is split
//   over gridded N blocks.
// - The halo'd input window is loaded once per block by TMA, as a 5-d
//   tiled tensor map over x viewed as (8, W, H, Cin/8, N): the box lands as
//   [c8][row][col][8 bf16], and the map's zero fill outside the image is
//   the Same padding.  It is loaded in chunks of 32 channels, each with its
//   own mbarrier, so the first chunk's products start while the rest lands.
// - In that layout 8 consecutive pixels x 8 channels are one 128-byte
//   no-swizzle core matrix, so the A operand of tap (dy, dx) is the window
//   itself under a wgmma descriptor whose start moves by dy * cols + dx
//   pixels (leading byte offset: the c8 plane; stride byte offset: 128 B).
//   Each tap is an address, not a copy.
// - The weights are packed once (`pack_stage_weights`) as, per N block,
//   K chunk and tap, the exact image of the B operand: [k16 step][k8 half]
//   [NI][8], the steps in the order the products run.  A producer warp
//   streams them with 1-d cp.async.bulk, CS_STEPS k16 steps (across taps
//   and chunks) a slot, into a ring of up to CS_MAX_SLOTS slots guarded by
//   full/empty mbarriers; the consumers issue wgmma.mma_async m64nNIk16 on
//   the slots that have landed and release each slot once its products
//   retire.  Few large slots beat many small ones on the card: each slot
//   costs a barrier round trip, and a small ring keeps shared memory for a
//   second block an SM where the window is small.
// - The producer/consumer role is taken from a warp shuffle, so that ptxas
//   sees it warp-uniform: on a branch it takes for divergent it serialises
//   every wgmma (ptxas C7520).  The window chunks are waited for before a
//   slot's wgmma sequence, not inside it, for the same reason.
// - Epilogue: accumulators -> shared memory -> 8 channels a thread, one
//   16-byte (bf16) or two 16-byte (f32) stores where aligned.
//
// The Hopper-only instructions sit in a handful of __device__ functions
// (mbarrier init/arrive/wait, the TMA load, the bulk copy, the wgmma fence,
// commit, wait and the wgmma itself, the named barrier), shared with the
// trunk kernel in hopper.cuh.  With those
// supplied by the includer (scalar stand-ins that read shared memory
// through the same descriptors) and a few macros for the CUDA keywords, the
// kernel compiles as plain C++ and runs on a host with one OS thread per
// CUDA thread.

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int CS_MT = 64;                      // pixels per wgmma M tile
constexpr int CS_WGS = 2;                      // consumer warpgroups
constexpr int CS_COLS = CS_MT * CS_WGS;        // output pixels per block
constexpr int CS_CONSUMERS = 128 * CS_WGS;
static_assert(CS_CONSUMERS == HOPPER_CONSUMERS, "consumer_sync joins them");
constexpr int CS_THREADS = CS_CONSUMERS + 32;  // + one producer warp
constexpr int CS_KC = 32;                      // channels per K chunk
constexpr int CS_STEPS = 8;                    // k16 steps per ring slot
constexpr int CS_MAX_SLOTS = 2;                // weight ring slots
constexpr int CS_BARS = 256;                   // bytes of barriers
constexpr int CS_MAX_CHUNKS = 8;               // Cin <= 256
constexpr size_t CS_SMEM = 232448;             // a block's shared memory
static_assert((2 * CS_MAX_SLOTS + CS_MAX_CHUNKS) * 8 <= CS_BARS,
              "the barriers overflow their bytes");

struct ConvEpi {
  int n_act, gap, cur_bf16, act;
  const float* bias;
  const float* slope;
  const __nv_bfloat16* add0;
  long long add0_ps;
  const __nv_bfloat16* add1;
  long long add1_ps;
  const __nv_bfloat16* mask;
  int mask_groups;
};

// The shared-memory plan of one block (bytes).  The window's c8 plane is
// k rows x cols pixels x 16 B; chunk j holds planes [4j, 4j + 4).
struct Plan {
  int cols, cin_pad, chunks, slots;
  uint32_t plane, win, slot, ring, stage_off;
  size_t smem;
};

__host__ __device__ inline Plan make_plan(int cin, int k, int ni) {
  Plan p;
  p.cols = CS_COLS + k - 1;
  p.cin_pad = (cin + 15) & ~15;
  p.chunks = (p.cin_pad + CS_KC - 1) / CS_KC;
  p.plane = (uint32_t)(k * p.cols * 16);
  p.win = (uint32_t)p.chunks * 4u * p.plane;
  p.slot = (uint32_t)(CS_STEPS * 16 * ni * 2);  // CS_STEPS k16 steps
  p.stage_off = (uint32_t)CS_BARS + ((p.win + 127u) & ~127u);
  const int fit = p.stage_off < CS_SMEM
                      ? (int)((CS_SMEM - p.stage_off) / p.slot) : 0;
  p.slots = fit > CS_MAX_SLOTS ? CS_MAX_SLOTS : (fit < 2 ? 2 : fit);
  p.ring = p.slots * p.slot;
  const size_t main = (size_t)p.stage_off + p.ring;
  const size_t stg = (size_t)CS_BARS + (size_t)CS_COLS * (ni + 4) * 4;
  p.smem = main > stg ? main : stg;
  return p;
}

// k16 steps of K chunk j.
__device__ __host__ __forceinline__ int chunk_steps(int cin_pad, int j) {
  const int rest = (cin_pad - CS_KC * j) / 16;
  return rest < 2 ? rest : 2;
}

__device__ __forceinline__ float rn_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ void load8_f32(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

__device__ __forceinline__ float belu_rn(float x, float p) {
  return __fadd_rn(
      __fadd_rn(__fmul_rn(p, x), __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), 1.0f))),
      -1.0f);
}


// x viewed through `map`; w_img the packed B images; out (batch, h, wd)
// pixels of stride out_ps elements.  Grid: x over (pixel tile, N block)
// pairs, pixel tiles row-major over (image, row, 128-column segment).
template <int NI, bool OUT_BF16>
__global__ void __launch_bounds__(CS_THREADS, 1)
conv_stage_kernel(const __grid_constant__ CUtensorMap map,
                  const __nv_bfloat16* __restrict__ w_img,
                  void* __restrict__ out, long long out_ps, int h, int wd,
                  int cin, int cout, int k, int nblk, const ConvEpi epi) {
  extern __shared__ __align__(128) unsigned char cs_smem[];
  const Plan pl = make_plan(cin, k, NI);
  const int tid = threadIdx.x;
  const int kk = k * k;
  const int segs = (wd + CS_COLS - 1) / CS_COLS;
  const int nb = (int)(blockIdx.x % (unsigned)nblk);
  const long long tile = blockIdx.x / (unsigned)nblk;
  const int x0 = (int)(tile % segs) * CS_COLS;
  const long long row = tile / segs;  // image * h + y
  const int y = (int)(row % h);
  const int img = (int)(row / h);
  const int n_steps = kk * (pl.cin_pad / 16);  // k16 steps in all
  const int n_stages = (n_steps + CS_STEPS - 1) / CS_STEPS;

  uint64_t* full = reinterpret_cast<uint64_t*>(cs_smem);
  uint64_t* empty = full + CS_MAX_SLOTS;
  uint64_t* winbar = empty + CS_MAX_SLOTS;
  const int S = pl.slots;
  unsigned char* win = cs_smem + CS_BARS;
  unsigned char* ring = cs_smem + pl.stage_off;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CS_WGS);
    }
    for (int j = 0; j < pl.chunks; ++j) mbar_init(&winbar[j], 1);
    mbar_fence_init();
  }
  // Below 32 channels the box holds cin / 8 planes; the k16 steps read up
  // to cin_pad / 8, and those planes are zero.
  const int box_planes = cin / 8 < 4 ? cin / 8 : 4;
  if (cin < CS_KC) {
    const int zbytes = (pl.cin_pad / 8 - box_planes) * (int)pl.plane;
    for (int i = tid * 16; i < zbytes; i += CS_THREADS * 16)
      *reinterpret_cast<uint4*>(win + box_planes * pl.plane + i) =
          uint4{0u, 0u, 0u, 0u};
    fence_proxy_async();
  }
  __syncthreads();

  // The role, warp-uniform as the compiler sees it (a shuffle from lane
  // 0): wgmma must not sit on a path it takes for divergent, or it
  // serialises every wgmma.
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp >= CS_CONSUMERS / 32) {
    // The producer: one lane issues every copy.
    if (tid != CS_CONSUMERS) return;
    const int r = k / 2;
    for (int j = 0; j < pl.chunks; ++j) {
      mbar_expect_tx(&winbar[j], (uint32_t)box_planes * pl.plane);
      tma_load_window(win + (size_t)j * 4 * pl.plane, &map, &winbar[j], 0,
                      x0 - r, y - r, 4 * j, img);
    }
    const __nv_bfloat16* wb = w_img + (size_t)nb * kk * pl.cin_pad * NI;
    for (int q = 0; q < n_stages; ++q) {
      const int slot = q % S;
      const int steps = n_steps - CS_STEPS * q < CS_STEPS
                            ? n_steps - CS_STEPS * q : CS_STEPS;
      if (q >= S) mbar_wait(&empty[slot], ((q / S) - 1) & 1);
      const uint32_t bytes = (uint32_t)(steps * 16 * NI * 2);
      mbar_expect_tx(&full[slot], bytes);
      bulk_copy(ring + (size_t)slot * pl.slot,
                wb + (size_t)CS_STEPS * q * 16 * NI, bytes, &full[slot]);
    }
    return;
  }

  // The consumers: warpgroup wg owns output columns x0 + [64 wg, 64 wg + 64).
  const int wg = warp / 4;
  float acc[NI / 2];
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) acc[i] = 0.0f;
  const uint32_t win_a = smem_addr(win), ring_a = smem_addr(ring);
  int ready = -1;  // the last window chunk waited for
  for (int q = 0; q < n_stages; ++q) {
    const int slot = q % S;
    const int steps = n_steps - CS_STEPS * q < CS_STEPS
                          ? n_steps - CS_STEPS * q : CS_STEPS;
    // The window chunks this stage reads, then the stage's weights.
    const int last = CS_STEPS * q + steps - 1;
    const int jl = last / (2 * kk) < pl.chunks - 1 ? last / (2 * kk)
                                                   : pl.chunks - 1;
    for (; ready < jl; ++ready) mbar_wait(&winbar[ready + 1], 0);
    mbar_wait(&full[slot], (q / S) & 1);
    const uint32_t b0 = ring_a + (uint32_t)slot * pl.slot;
    fence_acc<NI>(acc);
    wgmma_fence();
    for (int st = 0; st < steps; ++st) {
      // k16 step n of the sequence chunk -> tap -> step within the chunk.
      const int n = CS_STEPS * q + st;
      const int j = n / (2 * kk) < pl.chunks - 1 ? n / (2 * kk)
                                                 : pl.chunks - 1;
      const int ks = chunk_steps(pl.cin_pad, j);
      const int t = (n - 2 * kk * j) / ks, sj = (n - 2 * kk * j) % ks;
      const int dy = t / k, dx = t % k;
      const uint32_t a0 = win_a + (uint32_t)(4 * j + 2 * sj) * pl.plane +
                          (uint32_t)((dy * pl.cols + wg * CS_MT + dx) * 16);
      wgmma_bf16<NI>(acc, make_desc(a0, pl.plane, 128u),
                     make_desc(b0 + (uint32_t)(st * NI * 32), NI * 16u, 128u));
    }
    wgmma_commit();
    fence_acc<NI>(acc);
    // The previous stage's products have retired: release its slot.
    wgmma_wait<1>();
    fence_acc<NI>(acc);
    if (q > 0 && tid % 128 == 0) mbar_arrive(&empty[(q - 1) % S]);
  }
  wgmma_wait<0>();
  fence_acc<NI>(acc);

  // Epilogue: the accumulators through shared memory (over the window),
  // then 8 channels of one pixel a thread.
  consumer_sync();
  constexpr int SP = NI + 4;
  float* stg = reinterpret_cast<float*>(cs_smem + CS_BARS);
  {
    const int wwarp = warp % 4, lane = tid % 32;
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) {
      const int prow = wg * CS_MT + 16 * wwarp + lane / 4 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
      stg[prow * SP + col] = acc[i];
    }
  }
  consumer_sync();
  const int groups = epi.mask_groups;
  const int gw = groups > 0 ? epi.n_act / groups : 1;
  // 8 activation channels at once: 16-byte addend reads, one mask read.
  const bool vec_act =
      (!epi.add0 || ((uintptr_t)epi.add0 % 16 == 0 && epi.add0_ps % 8 == 0)) &&
      (!epi.add1 || ((uintptr_t)epi.add1 % 16 == 0 && epi.add1_ps % 8 == 0)) &&
      (uintptr_t)epi.bias % 16 == 0 && (uintptr_t)epi.slope % 16 == 0 &&
      gw % 8 == 0;
  for (int u = tid; u < CS_COLS * (NI / 8); u += CS_CONSUMERS) {
    const int p = u / (NI / 8), g8 = u % (NI / 8);
    const int col = x0 + p;
    if (col >= wd) continue;
    const long long pix = row * wd + col;
    const int o0 = nb * NI + 8 * g8;
    if (o0 >= cout) continue;
    float v[8];
    {
      const float4* sp = reinterpret_cast<const float4*>(stg + p * SP + 8 * g8);
      const float4 q0 = sp[0], q1 = sp[1];
      v[0] = q0.x, v[1] = q0.y, v[2] = q0.z, v[3] = q0.w;
      v[4] = q1.x, v[5] = q1.y, v[6] = q1.z, v[7] = q1.w;
    }
    bool in_act = false, in_rest = false;
    if (vec_act && o0 + 8 <= epi.n_act) {
      in_act = true;
      float a0[8], a1[8], bs[8], sl[8];
      if (epi.add0) load8_bf16(epi.add0 + pix * epi.add0_ps + o0, a0);
      if (epi.add1) load8_bf16(epi.add1 + pix * epi.add1_ps + o0, a1);
      if (epi.bias) load8_f32(epi.bias + o0, bs);
      if (epi.act) load8_f32(epi.slope + o0, sl);
      const float m = groups > 0 ? __bfloat162float(
                                       epi.mask[pix * groups + o0 / gw])
                                 : 1.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float cur = epi.cur_bf16 ? rn_bf16(v[e]) : v[e];
        float s = cur;
        if (epi.add0) {
          s = a0[e];
          if (epi.add1) s = __fadd_rn(s, a1[e]);
          s = __fadd_rn(s, cur);
        }
        if (epi.bias) s = __fadd_rn(s, bs[e]);
        if (epi.act) s = belu_rn(s, sl[e]);
        if (OUT_BF16) s = rn_bf16(s);
        if (groups > 0) s = __fmul_rn(s, m);
        v[e] = s;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int o = o0 + e;
        if (o < cout && o < epi.n_act) {
          in_act = true;
          const float cur = epi.cur_bf16 ? rn_bf16(v[e]) : v[e];
          float s = cur;
          if (epi.add0) {
            s = __bfloat162float(epi.add0[pix * epi.add0_ps + o]);
            if (epi.add1)
              s = __fadd_rn(
                  s, __bfloat162float(epi.add1[pix * epi.add1_ps + o]));
            s = __fadd_rn(s, cur);
          }
          if (epi.bias) s = __fadd_rn(s, epi.bias[o]);
          if (epi.act) s = belu_rn(s, epi.slope[o]);
          if (OUT_BF16) s = rn_bf16(s);
          if (groups > 0)
            s = __fmul_rn(s, __bfloat162float(
                                 epi.mask[pix * groups + o / gw]));
          v[e] = s;
        } else if (o < cout) {
          in_rest = true;
        }
      }
    }
    const int off = in_rest ? epi.gap : 0;
    const long long base = pix * out_ps + o0 + off;
    const bool whole = o0 + 8 <= cout && !(in_act && in_rest);
    if (OUT_BF16) {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
      if (whole && base % 8 == 0) {
        __nv_bfloat16 r8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) r8[e] = __float2bfloat16(v[e]);
        *reinterpret_cast<uint4*>(ob + base) =
            *reinterpret_cast<const uint4*>(r8);
      } else {
        for (int e = 0; e < 8 && o0 + e < cout; ++e) {
          const int o = o0 + e;
          ob[pix * out_ps + o + (o < epi.n_act ? 0 : epi.gap)] =
              __float2bfloat16(v[e]);
        }
      }
    } else {
      float* of = static_cast<float*>(out);
      if (whole && base % 4 == 0) {
        *reinterpret_cast<float4*>(of + base) = float4{v[0], v[1], v[2], v[3]};
        *reinterpret_cast<float4*>(of + base + 4) =
            float4{v[4], v[5], v[6], v[7]};
      } else {
        for (int e = 0; e < 8 && o0 + e < cout; ++e) {
          const int o = o0 + e;
          of[pix * out_ps + o + (o < epi.n_act ? 0 : epi.gap)] = v[e];
        }
      }
    }
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int NI, bool OUT_BF16>
int launch(const CUtensorMap& map, const __nv_bfloat16* w, void* out,
           long long out_ps, int batch, int h, int wd, int cin, int cout,
           int k, const ConvEpi& epi, cudaStream_t stream) {
  const Plan pl = make_plan(cin, k, NI);
  if (pl.smem > CS_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = conv_stage_kernel<NI, OUT_BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (cout + NI - 1) / NI;
  const long long blocks = (long long)batch * h *
                           ((wd + CS_COLS - 1) / CS_COLS) * nblk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, CS_THREADS, pl.smem, stream>>>(
      map, w, out, out_ps, h, wd, cin, cout, k, nblk, epi);
  return (int)cudaGetLastError();
}

template <bool OUT_BF16>
int launch_ni(int ni, const CUtensorMap& map, const __nv_bfloat16* w,
              void* out, long long out_ps, int batch, int h, int wd, int cin,
              int cout, int k, const ConvEpi& epi, cudaStream_t s) {
  switch (ni) {
    case 32: return launch<32, OUT_BF16>(map, w, out, out_ps, batch, h, wd, cin, cout, k, epi, s);
    case 64: return launch<64, OUT_BF16>(map, w, out, out_ps, batch, h, wd, cin, cout, k, epi, s);
    case 96: return launch<96, OUT_BF16>(map, w, out, out_ps, batch, h, wd, cin, cout, k, epi, s);
    case 128: return launch<128, OUT_BF16>(map, w, out, out_ps, batch, h, wd, cin, cout, k, epi, s);
    case 192: return launch<192, OUT_BF16>(map, w, out, out_ps, batch, h, wd, cin, cout, k, epi, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: bf16 pixels of x_ps elements (cin <= x_ps, both multiples of 8,
// x 16-byte aligned), batch x h x wd of them; w_img: the packed weights
// (`pack_stage_weights`, N blocks of ni channels); out: pixels of out_ps
// elements, f32 (out_bf16 = 0) or bf16 (1).  The epilogue arguments as in
// ConvEpi (n_act = 0: the plain conv).  Returns a cudaError_t.
extern "C" int srt_conv_stage(
    const void* x, long long x_ps, const void* w_img, void* out,
    long long out_ps, int batch, int h, int wd, int cin, int cout, int k,
    int ni, int out_bf16, int n_act, int gap, int cur_bf16, int act,
    const void* bias, const void* slope, const void* add0, long long add0_ps,
    const void* add1, long long add1_ps, const void* mask, int mask_groups,
    void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || cin < 8 || cin % 8 || cin > 256 ||
      x_ps < cin || x_ps % 8 || cout < 1 || (k != 1 && k != 3 && k != 5) ||
      (uintptr_t)x % 16 || n_act < 0 || n_act > cout ||
      (mask_groups > 0 && n_act % mask_groups))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  // x as (8, wd, h, cin / 8, batch), innermost first; the box is one K
  // chunk of the halo'd window.
  const cuuint64_t dims[5] = {8, (cuuint64_t)wd, (cuuint64_t)h,
                              (cuuint64_t)(cin / 8), (cuuint64_t)batch};
  const cuuint64_t strides[4] = {(cuuint64_t)x_ps * 2,
                                 (cuuint64_t)x_ps * 2 * wd, 16,
                                 (cuuint64_t)x_ps * 2 * wd * h};
  const cuuint32_t box[5] = {8, (cuuint32_t)(CS_COLS + k - 1), (cuuint32_t)k,
                             (cuuint32_t)(cin / 8 < 4 ? cin / 8 : 4), 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
          dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  ConvEpi epi{n_act,
              gap,
              cur_bf16,
              act,
              static_cast<const float*>(bias),
              static_cast<const float*>(slope),
              static_cast<const __nv_bfloat16*>(add0),
              add0_ps,
              static_cast<const __nv_bfloat16*>(add1),
              add1_ps,
              static_cast<const __nv_bfloat16*>(mask),
              mask_groups};
  auto w = static_cast<const __nv_bfloat16*>(w_img);
  auto s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_ni<true>(ni, map, w, out, out_ps, batch, h, wd,
                                    cin, cout, k, epi, s)
                  : launch_ni<false>(ni, map, w, out, out_ps, batch, h, wd,
                                     cin, cout, k, epi, s);
}

#endif  // __CUDACC__
