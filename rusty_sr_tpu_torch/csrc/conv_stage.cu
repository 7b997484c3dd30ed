// One trunk conv stage on the tensor cores, for Hopper (sm_90a):
//
//   out[n][y][x][o] = sum over dy, dx, c of
//       x[n][y + dy - r][x + dx - r][c] * w[dy][dx][c][o]      (r = k / 2)
//
// a stride-1 cross-correlation with Same zero padding, NHWC bf16 input,
// HWIO bf16 weights, k in {1, 3, 5}, any Cin and Cout, f32 accumulation,
// and an f32 output or one rounded to nearest-even bf16.
//
// Replaces the TPU conv-stage kernels of scripts/mosaic_probe.py (k_reshape,
// k_scratch, k_rank3, k_scratch_concat: offset dots and K-concatenated
// slices), mosaic_probe2.py (k_store_kmajor, k_lhsT_dot: a 3x3 stage as
// K-major patches), mosaic_probe3.py (kernel_kmajor, kernel_lane_stores: a
// 5x5 stage), mosaic_probe4.py (kernel_slice, kernel_roll: 5x5 as 25 shifted
// dots) and mosaic_probe5.py (kernel_aligned, kernel_copy3, kernel_pack3: 3x3
// as 9 shifted dots).  Each of those is one bf16 conv stage of the xla
// engine's fast tiers with f32 accumulation; on the card every bf16 conv of
// those tiers runs here: the packed tier's five 3x3 stages (K up to
// 9 x 152, N up to 384) and the flat tier's 5x5 conv0 and convA and its
// 3x3 convB, convC and conv10.
//
// What bounds it: the tensor cores, in principle; about 1 TFLOP per chunk
// of 24 packed tiles.  This first version issues warp-level
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators) and stages its
// operands in shared memory with plain loads, so its pace is set by those
// loads and the barriers between taps, well below the wgmma/TMA rate.
//
// Design: the shifted-dot form of the probes as an implicit GEMM.  A block
// computes 8 output rows x 16 output columns (M = 128 pixels) x 64 output
// channels.  It stages its (8+k-1) x (16+k-1) x Cin input window in shared
// memory once, zero-filled outside the image and past Cin (K is padded to a
// multiple of 16).  Then, for each of the k*k taps, it stages that tap's
// Cin x 64 weight slice and each of its 8 warps (one per output row: one
// m16 tile is 16 pixels of a row) runs Cin/16 K-steps x 8 n8-tiles of mma
// into 32 f32 accumulators per thread.  The epilogue writes f32 or bf16,
// masking the ragged rows, columns and channels.  Both staged operands are
// laid out so that the fragment loads hit 32 distinct banks: the window
// with a pixel stride of Cin_pad + 8 bf16, the weights as bf16 pairs along
// K with a row stride of 72 words.
//
// The mma is one __device__ function, `mma_m16n8k16`; with it supplied by
// the includer (a scalar emulation of the PTX ISA's fragment layout) and a
// few macros for the CUDA keywords, the kernel compiles as plain C++ and
// runs on a host with one OS thread per CUDA thread.

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif
#include <cstdint>

namespace {

constexpr int CS_ROWS = 8;       // output rows per block, one per warp
constexpr int CS_COLS = 16;      // output columns per block (the mma's M)
constexpr int CS_N = 64;         // output channels per block
constexpr int CS_NT = CS_N / 8;  // n8 tiles per warp
constexpr int CS_THREADS = 32 * CS_ROWS;
constexpr int CS_WROW = CS_N + 8;  // words per K-pair row of staged weights

#ifdef __CUDACC__
// D = A * B + D for one warp: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 f32.  Fragments as in the PTX ISA (groupID g = lane / 4,
// t = lane % 4): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] =
// A[g][2t+8..], a[3] = A[g+8][2t+8..]; b[0] = B[2t..2t+1][g], b[1] =
// B[2t+8..][g]; d[0..1] = D[g][2t..2t+1], d[2..3] = D[g+8][2t..].
__device__ __forceinline__ void mma_m16n8k16(float* d, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// x (batch, h, w, cin), w (k, k, cin, cout), out (batch, h, w, cout).
// Grid: x over the 8x16 pixel blocks (row-major), y over the 64-channel
// blocks, z over the batch.  VEC: cin % 8 == 0 and x 16-byte aligned, so
// the window is staged in 16-byte pieces.
template <bool OUT_BF16, bool VEC>
__global__ void __launch_bounds__(CS_THREADS)
conv_stage_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  void* __restrict__ out, int h, int wd, int cin, int cout,
                  int k) {
  extern __shared__ __align__(16) unsigned char cs_smem[];
  const int tid = threadIdx.x;
  const int cin_pad = (cin + 15) & ~15;
  const int ps = cin_pad + 8;  // window pixel stride, in bf16
  const int wh = CS_ROWS + k - 1, ww = CS_COLS + k - 1;
  const int r = k / 2;
  const int bx = (wd + CS_COLS - 1) / CS_COLS;
  const int y0 = (int)(blockIdx.x / bx) * CS_ROWS;
  const int x0 = (int)(blockIdx.x % bx) * CS_COLS;
  const int n0 = (int)blockIdx.y * CS_N;
  const size_t img = blockIdx.z;

  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(cs_smem);
  uint32_t* wsm = reinterpret_cast<uint32_t*>(win + (size_t)wh * ww * ps);

  // The input window, zero outside the image and past cin.
  const __nv_bfloat16* ximg = x + img * h * wd * cin;
  if constexpr (VEC) {
    const int c8 = cin_pad / 8;
    for (int i = tid; i < wh * ww * c8; i += blockDim.x) {
      const int q = i % c8, p = i / c8;
      const int gy = y0 + p / ww - r, gx = x0 + p % ww - r;
      uint4 v = {0u, 0u, 0u, 0u};
      if (q * 8 < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = *reinterpret_cast<const uint4*>(
            ximg + ((size_t)gy * wd + gx) * cin + q * 8);
      *reinterpret_cast<uint4*>(win + (size_t)p * ps + q * 8) = v;
    }
  } else {
    for (int i = tid; i < wh * ww * cin_pad; i += blockDim.x) {
      const int c = i % cin_pad, p = i / cin_pad;
      const int gy = y0 + p / ww - r, gx = x0 + p % ww - r;
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (c < cin && gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = ximg[((size_t)gy * wd + gx) * cin + c];
      win[(size_t)p * ps + c] = v;
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[CS_NT][4];
#pragma unroll
  for (int j = 0; j < CS_NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int tap = 0; tap < k * k; ++tap) {
    const int dy = tap / k, dx = tap % k;
    __syncthreads();  // the window is staged; the last tap's weights read
    // This tap's weights as K pairs: wsm[kp][n] = (w[2kp][n], w[2kp+1][n]).
    const __nv_bfloat16* wt = w + (size_t)tap * cin * cout + n0;
    for (int i = tid; i < (cin_pad / 2) * CS_N; i += blockDim.x) {
      const int n = i % CS_N, kp = i / CS_N;
      const int c = 2 * kp;
      uint32_t lo = 0, hi = 0;
      if (n0 + n < cout) {
        if (c < cin) lo = bf16_bits(wt[(size_t)c * cout + n]);
        if (c + 1 < cin) hi = bf16_bits(wt[(size_t)(c + 1) * cout + n]);
      }
      wsm[kp * CS_WROW + n] = lo | (hi << 16);
    }
    __syncthreads();
    // A rows: pixels g and g + 8 of this warp's row, shifted by the tap.
    const __nv_bfloat16* a0 = win + ((size_t)(warp + dy) * ww + g + dx) * ps;
    const __nv_bfloat16* a1 = a0 + 8 * ps;
    for (int kc = 0; kc < cin_pad; kc += 16) {
      const uint32_t a[4] = {ld_pair(a0 + kc + 2 * t),
                             ld_pair(a1 + kc + 2 * t),
                             ld_pair(a0 + kc + 2 * t + 8),
                             ld_pair(a1 + kc + 2 * t + 8)};
      const uint32_t* b0 = wsm + (kc / 2 + t) * CS_WROW + g;
#pragma unroll
      for (int j = 0; j < CS_NT; ++j) {
        const uint32_t b[2] = {b0[j * 8], b0[4 * CS_WROW + j * 8]};
        mma_m16n8k16(acc[j], a, b);
      }
    }
  }

  const int oy = y0 + warp;
  if (oy >= h) return;  // after the last barrier
#pragma unroll
  for (int j = 0; j < CS_NT; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (ox >= wd) continue;
      const size_t base = ((img * h + oy) * wd + ox) * cout;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n0 + j * 8 + 2 * t + e;
        if (o >= cout) continue;
        if constexpr (OUT_BF16)
          static_cast<__nv_bfloat16*>(out)[base + o] =
              __float2bfloat16(acc[j][2 * half + e]);
        else
          static_cast<float*>(out)[base + o] = acc[j][2 * half + e];
      }
    }
}

// Dynamic shared memory of one block, in bytes.
inline size_t conv_stage_smem(int cin, int k) {
  const int cin_pad = (cin + 15) & ~15;
  return (size_t)(CS_ROWS + k - 1) * (CS_COLS + k - 1) * (cin_pad + 8) * 2 +
         (size_t)(cin_pad / 2) * CS_WROW * 4;
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <bool OUT_BF16, bool VEC>
int launch_conv_stage(const __nv_bfloat16* x, const __nv_bfloat16* w,
                      void* out, int batch, int h, int wd, int cin, int cout,
                      int k, void* stream) {
  const size_t smem = conv_stage_smem(cin, k);
  auto kern = conv_stage_kernel<OUT_BF16, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((h + CS_ROWS - 1) / CS_ROWS) *
                           ((wd + CS_COLS - 1) / CS_COLS);
  const dim3 grid((unsigned)blocks, (unsigned)((cout + CS_N - 1) / CS_N),
                  (unsigned)batch);
  kern<<<grid, CS_THREADS, smem, (cudaStream_t)stream>>>(x, w, out, h, wd,
                                                         cin, cout, k);
  return (int)cudaGetLastError();
}

}  // namespace

// x (batch, h, w, cin) bf16, w (k, k, cin, cout) bf16 -> out (batch, h, w,
// cout), f32 (out_bf16 = 0) or bf16 (1).  vec: cin % 8 == 0 and x 16-byte
// aligned.  Returns a cudaError_t.
extern "C" int srt_conv_stage(const void* x, const void* w, void* out,
                              int batch, int h, int wd, int cin, int cout,
                              int k, int out_bf16, int vec, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || wd < 1 || cin < 1 || cout < 1 ||
      k < 1 || k % 2 == 0 || (vec && cin % 8))
    return (int)cudaErrorInvalidValue;
  if ((long long)((h + CS_ROWS - 1) / CS_ROWS) * ((wd + CS_COLS - 1) / CS_COLS)
      > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  if (out_bf16)
    return vec ? launch_conv_stage<true, true>(xb, wb, out, batch, h, wd, cin,
                                               cout, k, stream)
               : launch_conv_stage<true, false>(xb, wb, out, batch, h, wd,
                                                cin, cout, k, stream);
  return vec ? launch_conv_stage<false, true>(xb, wb, out, batch, h, wd, cin,
                                              cout, k, stream)
             : launch_conv_stage<false, false>(xb, wb, out, batch, h, wd, cin,
                                               cout, k, stream);
}

#endif  // __CUDACC__
