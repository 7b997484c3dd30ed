// SwinIR's MLP in one kernel, for Hopper (sm_90a), bf16 in and out:
//
//   g = round_bf16(GELU(h W1^T + b1))      GELU(x) = x/2 (1 + erf(x / sqrt 2))
//   y = round_bf16(g W2^T + b2)
//
// on rows of C channels (the block's norm2 output, token-major), W1
// (hidden, C), W2 (C, hidden), bf16 operands with f32 sums, the biases
// added in f32, erf GELU in f32, g rounded once as fc2's operand.  The
// hidden activation g never leaves the chip.
//
// Replaces no TPU kernel: the JAX package runs no transformer.  It was added
// because fc1, GELU and fc2 as three library calls write the 2C-wide hidden
// to device memory in bf16, read and rewrite it for GELU, and read it again
// for fc2; and because rows of C = 180 bf16 (360 bytes, not a multiple of
// 16) keep cuBLAS on 2-element-aligned sm80 kernels.
//
// What bounds it, by the roofline: the tensor cores.  Per token and block
// it does 4 * C * hidden FLOP (259,200 at SwinIR-M's C = 180, hidden =
// 360) and moves 4 * C bytes (h in, y out: 720), 360 FLOP a byte, just
// above the ~295 at which the card stops being bound by memory.  In
// practice the erf GELU is the limit: about 30 instructions an element on
// the FP32 pipes (measured by taking it out, PERF.md), against 720 FLOP of
// products, so its time is as large as the products' at the tensor
// cores' rate.  The design keeps the tensor cores and the GELU busy at
// once:
//
// - A persistent grid, one block an SM, walks tiles of 128 token rows; two
//   consumer warpgroups own 64 rows each (one wgmma M tile) and one thread
//   of a third warpgroup streams the weights.  setmaxnreg moves registers
//   from the producer's warpgroup to the consumers (232 a thread; at the
//   168 a 384-thread block gets, the accumulators spill and ptxas
//   serialises the wgmmas).
// - Each warpgroup copies its 64 rows of h with 8-byte cp.async into a
//   [k8 group][row][8] image (no-swizzle core matrices), which fc1 reads
//   as its shared-memory A operand: rows of h are 8-byte aligned only (C a
//   multiple of 4), so TMA cannot describe them.  Zeros fill K up to CP (C
//   padded to a multiple of 32) and the rows past the end; the next tile's
//   rows are copied in as soon as this tile's last fc1 has retired, behind
//   its last GELU, fc2 and epilogue.  (Held as register A fragments
//   instead, h took CP / 4 more registers a thread: 2.7% slower at C = 180
//   and spilled at C = 240.)
// - The hidden is walked in chunks of 64 columns (padded with zeros).  For
//   chunk j, S = h W1[j]^T (m64n64k16) lands in registers; + b1, GELU and
//   the bf16 rounding turn the accumulator fragment into the register A
//   fragment of fc2's k16 steps, and Y += G W2[:, j]^T (m64nNk16, N = CP as
//   one or two pieces of at most 128) follows.  Y, 64 x CP in f32, stays in
//   registers for the whole hidden: CP / 2 of them a thread.
// - fc2 of chunk j and fc1 of chunk j + 1 are one group of products, and
//   the two warpgroups take turns at issuing them (named barriers), so
//   that one warpgroup's GELU runs while the other's products do.
// - The weights are packed once on the host (`ops/cuda/swin_mlp.py::
//   prepare`) into the exact shared-memory images of the B operands, in
//   the order they are read: per chunk, fc1's (K = CP) then fc2's (K = 64),
//   CP * 64 bf16 each.  The producer streams them with 1-d cp.async.bulk
//   into a ring of up to 8 such stages (full/empty mbarriers); each tile
//   reads the whole sequence again, from L2 (taking those reads out did
//   not change the time).
// - Epilogue: + b2, rounded to bf16, into a staging copy of the
//   warpgroup's 64 rows, which leave as one bulk copy (rows before the end
//   of h only: 8-byte stores).
//
// The Hopper-only instructions sit in __device__ functions (hopper.cuh,
// and the cp.async, named barrier and packing helpers below); with scalar
// stand-ins for them the kernel compiles as plain C++ and runs on a host
// with one OS thread per CUDA thread (tests/test_torch_swin_mlp.py).

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int MLP_ROWS = 64;                      // rows a consumer warpgroup
constexpr int MLP_WGS = 2;                        // consumer warpgroups
constexpr int MLP_TILE = MLP_ROWS * MLP_WGS;      // rows a tile
constexpr int MLP_CONSUMERS = 128 * MLP_WGS;
static_assert(MLP_CONSUMERS == HOPPER_CONSUMERS, "one consumer count");
constexpr int MLP_THREADS = MLP_CONSUMERS + 128;  // + the producer's warpgroup
constexpr int MLP_PRODUCER_REGS = 40;             // setmaxnreg: 128 * 40 +
constexpr int MLP_CONSUMER_REGS = 232;            // 256 * 232 <= 65,536
constexpr int MLP_NC = 64;                        // hidden columns a chunk
constexpr int MLP_BARS = 256;                     // bytes of barriers
constexpr int MLP_MAX_SLOTS = 8;                  // weight ring stages
constexpr size_t MLP_SMEM = 232448;               // a block's shared memory
static_assert(2 * MLP_MAX_SLOTS * 8 <= MLP_BARS, "barriers overflow");

// The shared-memory plan of a block for C padded to cp (bytes): the
// barriers, each warpgroup's rows of h, each warpgroup's staging rows of y,
// then the weight ring.
struct MlpPlan {
  int slots;
  uint32_t hbytes, stage, ring_off;
  size_t smem;
};

__host__ __device__ inline MlpPlan mlp_plan(int cp) {
  MlpPlan p;
  p.hbytes = (uint32_t)(MLP_ROWS * cp * 2);
  p.stage = (uint32_t)(cp * MLP_NC * 2);
  p.ring_off = (uint32_t)MLP_BARS + 2 * MLP_WGS * p.hbytes;
  const int fit = (int)((MLP_SMEM - p.ring_off) / p.stage);
  p.slots = fit < MLP_MAX_SLOTS ? fit : MLP_MAX_SLOTS;
  p.smem = (size_t)p.ring_off + (size_t)p.slots * p.stage;
  return p;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

#ifdef __CUDACC__
// 8 bytes from global to shared memory; the bytes past src_bytes are zero.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// The 128 threads of consumer warpgroup wg (named barriers 2 and 3).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}
// The consumers' turns at the tensor cores (named barriers 4 and 5): wg
// waits for its turn, and hands the next one to the other warpgroup.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(4 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(5 - wg) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The warpgroup's register budget (setmaxnreg), lowered for the producer
// and raised for the consumers: at the 168 that a block of 384 threads
// gets, Y, S and the A fragments spill and ptxas serialises the wgmmas.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
// A bulk copy from shared to global memory, its group's commit, and the
// waits until the groups have read their shared memory, or completed.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// Keeps the compiler from reusing A-fragment registers before the wgmma
// that reads them has retired.
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
#endif  // __CUDACC__

// Rows [r0, r0 + 64) of h into a warpgroup's [k8 group][row][8] image, 8
// bytes a copy, zeros past C (up to CP) and past the last row.  A warp's
// 32 copies are the 16 bytes of one k8 group in 16 rows: 256 contiguous
// bytes of shared memory, 16 bytes of each row.
template <int CP>
__device__ __forceinline__ void load_rows(unsigned char* hw,
                                          const __nv_bfloat16* h,
                                          long long r0, long long rows, int c,
                                          int wt) {
  for (int i = wt; i < MLP_ROWS * CP / 4; i += 128) {
    const int half = i & 1, r = (i >> 1) % MLP_ROWS, j = (i >> 1) / MLP_ROWS;
    const int col = 8 * j + 4 * half;
    const bool in = r0 + r < rows && col < c;
    cp_async8(hw + j * (MLP_ROWS * 16) + r * 16 + half * 8,
              in ? h + (r0 + r) * c + col : h, in ? 8 : 0);
  }
}

// S += h W1[chunk]^T over K = CP: the warpgroup's rows at ha (the [k8
// group][row][8] image), the stage's B image at sb ([k16 step][k8 half][64
// columns][8]).
template <int CP>
__device__ __forceinline__ void fc1(float* s, uint32_t ha, uint32_t sb) {
#pragma unroll
  for (int k = 0; k < CP / 16; ++k)
    wgmma_bf16<MLP_NC>(s, make_desc(ha + k * 2 * MLP_ROWS * 16,
                                    MLP_ROWS * 16, 128u),
                       make_desc(sb + k * 2 * MLP_NC * 16, MLP_NC * 16, 128u));
}

// Y += G W2[:, chunk]^T: G in the register fragments a (4 a k16 step), the
// stage's B image at sb ([k16 step][k8 half][CP channels][8]); N = CP in
// pieces of at most 128.
template <int CP>
__device__ __forceinline__ void fc2(float* y, const uint32_t* a,
                                    uint32_t sb) {
  constexpr int N0 = CP < 128 ? CP : 128;
  constexpr int N1 = CP - N0;
#pragma unroll
  for (int k = 0; k < MLP_NC / 16; ++k) {
    const uint32_t b = sb + (uint32_t)(k * 2 * CP * 16);
    wgmma_bf16_ra<N0>(y, a + 4 * k, make_desc(b, CP * 16, 128u));
    if constexpr (N1 > 0)
      wgmma_bf16_ra<N1>(y + N0 / 2, a + 4 * k,
                        make_desc(b + N0 * 16, CP * 16, 128u));
  }
}

// The chunk's S fragment (+ b1, GELU, rounded) as fc2's A fragments: the
// accumulators of columns [16k, 16k + 16) are k16 step k's 8 values.
__device__ __forceinline__ void gelu_pack(const float* s, uint32_t* a,
                                          const float* b1, int lane) {
  const int tq = lane % 4;
#pragma unroll
  for (int j = 0; j < MLP_NC / 8; ++j) {
    const float c0 = b1[8 * j + 2 * tq], c1 = b1[8 * j + 2 * tq + 1];
    a[2 * j] = pack_bf16(gelu_erf(s[4 * j] + c0), gelu_erf(s[4 * j + 1] + c1));
    a[2 * j + 1] =
        pack_bf16(gelu_erf(s[4 * j + 2] + c0), gelu_erf(s[4 * j + 3] + c1));
  }
}

// Y + b2, rounded, into the warpgroup's staging rows (row-major, C
// channels, as y holds them), then out: one bulk copy of the 64 rows, or
// 8-byte copies of the rows before the end.
template <int CP>
__device__ __forceinline__ void store_rows(const float* yacc, const float* b2,
                                           unsigned char* stg,
                                           __nv_bfloat16* y, long long r0,
                                           long long rows, int c, int wg,
                                           int wt) {
  const int lane = wt % 32, tq = lane % 4;
  const int row = 16 * (wt / 32) + lane / 4;
  uint32_t v[CP / 4];
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float c0 = b2[col], c1 = b2[col + 1];
    v[2 * j] = pack_bf16(yacc[4 * j] + c0, yacc[4 * j + 1] + c1);
    v[2 * j + 1] = pack_bf16(yacc[4 * j + 2] + c0, yacc[4 * j + 3] + c1);
  }
  // The previous tile's copy has read the staging rows.
  if (wt == 0) bulk_wait_read();
  wg_sync(wg);
#pragma unroll
  for (int j = 0; j < CP / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (col >= c) continue;
    *reinterpret_cast<uint32_t*>(stg + ((size_t)row * c + col) * 2) = v[2 * j];
    *reinterpret_cast<uint32_t*>(stg + ((size_t)(row + 8) * c + col) * 2) =
        v[2 * j + 1];
  }
  fence_proxy_async();
  wg_sync(wg);
  const long long n = rows - r0 < MLP_ROWS ? rows - r0 : MLP_ROWS;
  if (n == MLP_ROWS) {
    if (wt == 0) {
      bulk_store(y + r0 * c, stg, (uint32_t)(MLP_ROWS * c * 2));
      bulk_commit();
    }
  } else {
    uint2* dst = reinterpret_cast<uint2*>(y + r0 * c);
    const uint2* src = reinterpret_cast<const uint2*>(stg);
    for (long long i = wt; i < n * c / 4; i += 128) dst[i] = src[i];
  }
}

// h, y: rows x c bf16; w_img: the packed B images (2 * chunks stages of
// CP * 64 bf16); b1: chunks * 64 f32, b2: CP f32, zero-padded.
template <int CP>
__global__ void __launch_bounds__(MLP_THREADS, 1)
    swin_mlp_kernel(const __nv_bfloat16* __restrict__ h,
                    const __nv_bfloat16* __restrict__ w_img,
                    const float* __restrict__ b1,
                    const float* __restrict__ b2, __nv_bfloat16* __restrict__ y,
                    long long rows, int c, int chunks) {
  extern __shared__ __align__(128) unsigned char mlp_smem[];
  const MlpPlan pl = mlp_plan(CP);
  const int tid = threadIdx.x;
  const long long tiles = (rows + MLP_TILE - 1) / MLP_TILE;
  const int S = pl.slots;
  uint64_t* full = reinterpret_cast<uint64_t*>(mlp_smem);
  uint64_t* empty = full + MLP_MAX_SLOTS;
  unsigned char* ring = mlp_smem + pl.ring_off;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MLP_WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The role, warp-uniform as the compiler sees it (a shuffle from lane 0):
  // wgmma must not sit on a path it takes for divergent.
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp >= MLP_CONSUMERS / 32) {
    // The producer: one lane streams the ring stages, every tile's the same.
    regs_dec<MLP_PRODUCER_REGS>();
    if (tid != MLP_CONSUMERS) return;
    long long q = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
      for (int i = 0; i < 2 * chunks; ++i, ++q) {
        const int slot = (int)(q % S);
        if (q >= S) mbar_wait(&empty[slot], (int)((q / S - 1) & 1));
        mbar_expect_tx(&full[slot], pl.stage);
        bulk_copy(ring + (size_t)slot * pl.stage,
                  w_img + (size_t)i * (pl.stage / 2), pl.stage, &full[slot]);
      }
    return;
  }

  // The consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile.
  regs_inc<MLP_CONSUMER_REGS>();
  const int wg = warp / 4, wt = tid % 128, lane = tid % 32;
  unsigned char* hw = mlp_smem + MLP_BARS + (size_t)wg * pl.hbytes;
  unsigned char* stg = mlp_smem + MLP_BARS + (size_t)(MLP_WGS + wg) * pl.hbytes;
  const uint32_t hw_a = smem_addr(hw), ring_a = smem_addr(ring);
  const long long step = gridDim.x;
  if (wg == 1) turn_pass(1);  // warpgroup 0 issues first
  long long t = blockIdx.x;
  load_rows<CP>(hw, h, t * MLP_TILE + wg * MLP_ROWS, rows, c, wt);
  cp_async_commit();
  long long q = 0;  // the ring stage the next product reads
  // The next tile's rows into hw, once every warp of the warpgroup has seen
  // the tile's last fc1 retire.
  auto next_rows = [&]() {
    wg_sync(wg);
    if (t + step < tiles)
      load_rows<CP>(hw, h, (t + step) * MLP_TILE + wg * MLP_ROWS, rows, c,
                    wt);
    cp_async_commit();
  };
  float yacc[CP / 2];
  float s[MLP_NC / 2];
  uint32_t a[MLP_NC / 4];
  for (; t < tiles; t += step) {
    const long long r0 = t * MLP_TILE + wg * MLP_ROWS;
    // The tile's rows in hw, made visible to the tensor cores.
    cp_async_wait_all();
    fence_proxy_async();
    wg_sync(wg);
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) yacc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < MLP_NC / 2; ++i) s[i] = 0.0f;
    // fc1 of chunk 0.
    mbar_wait(&full[q % S], (int)((q / S) & 1));
    fence_acc<MLP_NC>(s);
    turn_wait(wg);
    wgmma_fence();
    fc1<CP>(s, hw_a, ring_a + (uint32_t)(q % S) * pl.stage);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc<MLP_NC>(s);
    if (wt == 0) mbar_arrive(&empty[q % S]);
    ++q;
    if (chunks == 1) next_rows();
    // fc2 of chunk j with fc1 of chunk j + 1, one group.
    for (int j = 0; j + 1 < chunks; ++j) {
      gelu_pack(s, a, b1 + j * MLP_NC, lane);
#pragma unroll
      for (int i = 0; i < MLP_NC / 2; ++i) s[i] = 0.0f;
      mbar_wait(&full[q % S], (int)((q / S) & 1));
      mbar_wait(&full[(q + 1) % S], (int)(((q + 1) / S) & 1));
      fence_frag<MLP_NC / 4>(a);
      fence_acc<MLP_NC>(s);
      fence_acc<CP>(yacc);
      turn_wait(wg);
      wgmma_fence();
      fc2<CP>(yacc, a, ring_a + (uint32_t)(q % S) * pl.stage);
      fc1<CP>(s, hw_a, ring_a + (uint32_t)((q + 1) % S) * pl.stage);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_frag<MLP_NC / 4>(a);
      fence_acc<MLP_NC>(s);
      fence_acc<CP>(yacc);
      if (wt == 0) {
        mbar_arrive(&empty[q % S]);
        mbar_arrive(&empty[(q + 1) % S]);
      }
      q += 2;
      if (j + 2 == chunks) next_rows();
    }
    gelu_pack(s, a, b1 + (chunks - 1) * MLP_NC, lane);
    mbar_wait(&full[q % S], (int)((q / S) & 1));
    fence_frag<MLP_NC / 4>(a);
    fence_acc<CP>(yacc);
    turn_wait(wg);
    wgmma_fence();
    fc2<CP>(yacc, a, ring_a + (uint32_t)(q % S) * pl.stage);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_frag<MLP_NC / 4>(a);
    fence_acc<CP>(yacc);
    if (wt == 0) mbar_arrive(&empty[q % S]);
    ++q;
    store_rows<CP>(yacc, b2, stg, y, r0, rows, c, wg, wt);
  }
  // The last bulk copy has landed before the block's shared memory goes.
  if (wt == 0) bulk_wait_all();
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <int CP>
int launch(const __nv_bfloat16* h, const __nv_bfloat16* w, const float* b1,
           const float* b2, __nv_bfloat16* y, long long rows, int c,
           int chunks, cudaStream_t stream) {
  const MlpPlan pl = mlp_plan(CP);
  if (pl.slots < 2) return (int)cudaErrorInvalidValue;
  auto kern = swin_mlp_kernel<CP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (rows + MLP_TILE - 1) / MLP_TILE;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, MLP_THREADS, pl.smem, stream>>>(h, w, b1, b2, y, rows, c,
                                               chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// h, y: rows x c bf16 (c a multiple of 4, h 8-byte and y 4-byte aligned);
// w_img: the packed weights (`prepare`: 2 * chunks stages of cp * 64
// bf16, 16-byte aligned); b1: chunks * 64 f32; b2: cp f32; cp: c rounded
// up to a multiple of 32, at most 256.  Returns a cudaError_t.
extern "C" int srt_swin_mlp(const void* h, const void* w_img, const void* b1,
                            const void* b2, void* y, long long rows, int c,
                            int cp, int chunks, void* stream) {
  if (rows < 1 || c < 4 || c % 4 || cp % 32 || c > cp || cp - c >= 32 ||
      cp > 256 || chunks < 1 || (uintptr_t)h % 8 || (uintptr_t)y % 4 ||
      (uintptr_t)w_img % 16 || (uintptr_t)b1 % 8 || (uintptr_t)b2 % 8)
    return (int)cudaErrorInvalidValue;
  auto hh = static_cast<const __nv_bfloat16*>(h);
  auto w = static_cast<const __nv_bfloat16*>(w_img);
  auto f1 = static_cast<const float*>(b1);
  auto f2 = static_cast<const float*>(b2);
  auto yy = static_cast<__nv_bfloat16*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (cp) {
    case 32: return launch<32>(hh, w, f1, f2, yy, rows, c, chunks, s);
    case 64: return launch<64>(hh, w, f1, f2, yy, rows, c, chunks, s);
    case 96: return launch<96>(hh, w, f1, f2, yy, rows, c, chunks, s);
    case 128: return launch<128>(hh, w, f1, f2, yy, rows, c, chunks, s);
    case 160: return launch<160>(hh, w, f1, f2, yy, rows, c, chunks, s);
    case 192: return launch<192>(hh, w, f1, f2, yy, rows, c, chunks, s);
    case 224: return launch<224>(hh, w, f1, f2, yy, rows, c, chunks, s);
    case 256: return launch<256>(hh, w, f1, f2, yy, rows, c, chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

#endif  // __CUDACC__
