// SwinIR's and HAT's residual stream in one pass, for Hopper (sm_90a): on
// rows of C channels,
//
//   s = x + float(y)                (written to x_out; only when y is given)
//       [+ zs[r / rows_per_scale] * (float(z) + zb)]   (HAT's third term)
//   h = round(LN(s) * w + b)        (or h = round(s) when no norm is given)
//
// x is the f32 stream (or, with no y, a bf16 or f32 row), y a bf16 GEMM or
// convolution output, (w, b) an f32 LayerNorm, h bf16 (the next GEMM's or
// convolution's operand) or f32 (the patch embedding's norm, which starts
// the stream).  The statistics are f32: the mean first, then the sum of
// squared deviations from it, 1 / sqrtf(var + eps); h is rounded once to
// its type (round to nearest even).  Widening a bf16 is exact, so s is the
// same f32 sum as PyTorch's mixed-type add, bit for bit; x_out may be x
// (in place).  HAT's hybrid attention block adds a third term, its
// convolution branch: z (bf16, the last convolution's sums without its
// bias), zb (f32, that bias, per channel) and zs (f32, conv_scale times
// the channel attention's gate, per frame and channel), as (x + y) + zs *
// (z + zb) with each operation rounded on its own (no fused multiply-add),
// which is PyTorch's order for the same operands.
//
// Replaces no TPU kernel: the JAX package runs no transformer.  It was
// added because PyTorch spends three launches on this pattern (the add,
// LayerNorm, the cast to bf16), each under half the HBM rate at rows of
// 180, and SwinIR repeats it 80 times a frame.
//
// What bounds it: device-memory bytes.  An add-and-normalise reads x (4C)
// and y (2C) and writes x_out (4C) and h (2C): 12 C bytes a row, 2,160 at
// C = 180, against about 10 FLOP an element; the third term reads z too
// (2C: 14 C bytes a row; zs, one row of C a frame, and zb from L2).
//
// Design: one warp a row; the row stays in registers between the add, the
// two warp-shuffle reductions and the stores.  Lane l holds the groups of
// four channels l, l + 32, ... (V of them: C up to 128 V), loaded as one
// 16-byte float4 (f32) or 8-byte group (bf16) each, so C % 4 == 0.  Blocks
// of 8 warps, one row each, at 24-39 registers a thread: a full SM holds
// 64 rows in flight, which covers the memory's latency.  Warps that took
// 2 or 4 rows each, their loads issued before the first reduction, were
// slower on an H100 (0.426 and 0.509 ms against 0.406 for one frame's
// add + norm at C = 180, timed in turns).

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int AL_THREADS = 256;
constexpr int AL_MAX_V = 4;  // C up to 512

struct AlArgs {
  const void* x;
  const __nv_bfloat16* y;  // null: no add
  const __nv_bfloat16* z;  // null: no third term
  const float* zs;         // z's scale, (rows / rows_per_scale, c)
  const float* zb;         // z's bias, (c)
  long long rows_per_scale;
  const float* w;          // null: no norm
  const float* b;
  float* x_out;
  void* h;
  long long rows;
  int c;
  int hw;                  // h's row width: c, or more with zero padding
  int yw;                  // y's row width: c, or more (the rest unread)
  int x_bf16, h_bf16;
  float eps;
};

__device__ __forceinline__ float4 ld_bf16x4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void st_bf16x4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Z: the third term (its own instantiation, so that the two-term path
// runs the same instructions as before it was added).
template <int V, bool Z>
__global__ void __launch_bounds__(AL_THREADS)
    add_layernorm_kernel(AlArgs a) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (AL_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // a whole warp: the shuffles stay full
  const int c4 = a.c >> 2;
  float4 v[V];

  // 1. The row's loads, then the add.
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int g = lane + 32 * i;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < c4) {
      const long long e = row * a.c + 4 * g;
      v[i] = a.x_bf16 ? ld_bf16x4(static_cast<const __nv_bfloat16*>(a.x) + e)
                      : *reinterpret_cast<const float4*>(
                            static_cast<const float*>(a.x) + e);
    }
  }
  if (a.y) {
    const float* zs = Z ? a.zs + (row / a.rows_per_scale) * a.c : nullptr;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int g = lane + 32 * i;
      if (g < c4) {
        const long long e = row * a.c + 4 * g;
        const float4 y = ld_bf16x4(a.y + row * a.yw + 4 * g);
        v[i].x += y.x;
        v[i].y += y.y;
        v[i].z += y.z;
        v[i].w += y.w;
        if (Z) {
          const float4 z = ld_bf16x4(a.z + e);
          const float4 k = *reinterpret_cast<const float4*>(zs + 4 * g);
          const float4 b = *reinterpret_cast<const float4*>(a.zb + 4 * g);
          v[i].x = __fadd_rn(v[i].x, __fmul_rn(k.x, __fadd_rn(z.x, b.x)));
          v[i].y = __fadd_rn(v[i].y, __fmul_rn(k.y, __fadd_rn(z.y, b.y)));
          v[i].z = __fadd_rn(v[i].z, __fmul_rn(k.z, __fadd_rn(z.z, b.z)));
          v[i].w = __fadd_rn(v[i].w, __fmul_rn(k.w, __fadd_rn(z.w, b.w)));
        }
        *reinterpret_cast<float4*>(a.x_out + e) = v[i];
      }
    }
  }

  // 2. The statistics: the mean, then the squared deviations from it.
  float mean = 0.f, rstd = 1.f;
  if (a.w) {
    const float fc = (float)a.c;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    mean = warp_sum(s) / fc;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (lane + 32 * i < c4) {
        const float dx = v[i].x - mean, dy = v[i].y - mean;
        const float dz = v[i].z - mean, dw = v[i].w - mean;
        q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
    }
    rstd = 1.f / sqrtf(warp_sum(q) / fc + a.eps);
  }

  // 3. h, rounded once to its type.
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int g = lane + 32 * i;
    if (g >= c4) continue;
    float4 o = v[i];
    if (a.w) {
      const float4 w4 = *reinterpret_cast<const float4*>(a.w + 4 * g);
      const float4 b4 = *reinterpret_cast<const float4*>(a.b + 4 * g);
      o.x = (o.x - mean) * rstd * w4.x + b4.x;
      o.y = (o.y - mean) * rstd * w4.y + b4.y;
      o.z = (o.z - mean) * rstd * w4.z + b4.z;
      o.w = (o.w - mean) * rstd * w4.w + b4.w;
    }
    const long long e = row * a.hw + 4 * g;
    if (a.h_bf16)
      st_bf16x4(static_cast<__nv_bfloat16*>(a.h) + e, o);
    else
      *reinterpret_cast<float4*>(static_cast<float*>(a.h) + e) = o;
  }
  // h's padding columns, zero.
  for (int j = a.c + lane; j < a.hw; j += 32) {
    if (a.h_bf16)
      static_cast<__nv_bfloat16*>(a.h)[row * a.hw + j] = __float2bfloat16(0.f);
    else
      static_cast<float*>(a.h)[row * a.hw + j] = 0.f;
  }
}

template <bool Z>
int al_launch(const AlArgs& a, dim3 grid, cudaStream_t s) {
  switch ((a.c + 127) / 128) {
    case 1: add_layernorm_kernel<1, Z><<<grid, AL_THREADS, 0, s>>>(a); break;
    case 2: add_layernorm_kernel<2, Z><<<grid, AL_THREADS, 0, s>>>(a); break;
    case 3: add_layernorm_kernel<3, Z><<<grid, AL_THREADS, 0, s>>>(a); break;
    default: add_layernorm_kernel<4, Z><<<grid, AL_THREADS, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x f32 (or bf16 when y is null) (rows, c); y bf16 (rows, yw) or null, its
// first c channels read (yw >= c, yw % 4 == 0);
// z bf16 (rows, c) or null (only with y), zs f32 (rows / rows_per_scale,
// c) and zb f32 (c) with it; w, b f32 (c) or both null; x_out f32 (rows, c), may be x,
// needed when y is given; h bf16 (h_bf16) or f32 (rows, hw), its columns
// from c on written zero (hw >= c, hw % 4 == 0).  c % 4 == 0,
// 4 <= c <= 512; every pointer 16-byte aligned (8 for a bf16 one).
extern "C" int srt_add_layernorm(const void* x, const void* y, const void* z,
                                 const float* zs, const float* zb,
                                 const float* w,
                                 const float* b, float* x_out, void* h,
                                 long long rows, long long rows_per_scale,
                                 int c, int hw, int yw, int x_bf16,
                                 int h_bf16, float eps,
                                 void* stream) {
  if (c % 4 || c < 4 || c > 128 * AL_MAX_V || rows < 0 || !x || !h ||
      hw < c || hw % 4 || (y && (yw < c || yw % 4)) ||
      (y && (x_bf16 || !x_out)) || (!w != !b) ||
      (z && (!y || !zs || !zb || rows_per_scale < 1)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const long long blocks = (rows + AL_THREADS / 32 - 1) / (AL_THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  AlArgs a;
  a.x = x;
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.z = static_cast<const __nv_bfloat16*>(z);
  a.zs = zs;
  a.zb = zb;
  a.rows_per_scale = rows_per_scale < 1 ? 1 : rows_per_scale;
  a.w = w;
  a.b = b;
  a.x_out = x_out;
  a.h = h;
  a.rows = rows;
  a.c = c;
  a.x_bf16 = x_bf16;
  a.h_bf16 = h_bf16;
  a.hw = hw;
  a.yw = y ? yw : c;
  a.eps = eps;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (z) return al_launch<true>(a, grid, s);
  return al_launch<false>(a, grid, s);
}

#endif  // __CUDACC__
