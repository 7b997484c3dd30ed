// SwinIR's shifted-window multi-head self-attention, fused, for Hopper
// (sm_90a), bf16 in and out:
//
//   out[t] = concat_h softmax(q_h(i) k_h(j)^T * scale + B[h][i][j]
//                             + M_s(i, j)) v_h(j)
//
// over the 64 tokens j of the 8x8 window that holds token t once the
// token grid (P x Q) is rolled by (-s, -s).  qkv is the `qkv` projection's
// token-major output (frames, P*Q, ldi), ldi >= 3*C, C = heads * hd, its
// first 3*C channels read, channel part*C + h*hd + d (part 0 q, 1 k, 2 v:
// SwinIR's reshape(.., 3, heads, hd)); out is (frames, P*Q, ldo), ldo >=
// C, channel h*hd + d and exact zeros in channels C..ldo-1, in the grid's
// own (un-rolled) token order, so `proj` reads it as it is.  The fast
// tier pads both to whole 16-byte groups (ldi 544 and ldo 192 at C = 180)
// so that cuBLAS takes its sm90 kernels for qkv and proj; the zeros that
// this kernel writes meet proj's zero weights, which would not cancel
// garbage or a NaN.  With ldi = 3*C and ldo = C the rows are SwinIR's own.
// B is the relative-position bias gathered per block (heads, 64, 64),
// f32.  M_s is SwinIR's `calculate_mask`: rolled rows and columns are
// labelled by the slices [0, P-8), [P-8, P-s), [P-s, P) (and likewise for
// Q); a pair of tokens whose labels differ gets -100, and s = 0 has no
// mask.
//
// Replaces no TPU kernel: the JAX package runs no attention.  It was added
// because `roll`, the window partition and merge, and the bias and mask
// materialised for every window would each be a pass over the block's
// activations around a library attention call, at a head width (30) that
// such calls pad anyway.
//
// What bounds it: device-memory bytes.  Per token and block it reads q, k
// and v once (3 * C * 2 bytes) and writes its output once (C * 2), 1,440
// bytes at C = 180, against 46,080 FLOP of products: 32 FLOP a byte, far
// under the ~295 at which the tensor cores would be the limit.
//
// Design: one block of 256 threads per window, all heads.
// 1. The window's 64 token indices (with the roll) and mask labels are
//    computed from blockIdx; each warp then copies 8 tokens' rows of qkv
//    into shared memory, q and k as [head][token][dim] and v transposed
//    as [head][dim][token], the head width padded to 32 with zeros, a
//    4-byte word at a time (a word never straddles a head).  Rows of whole
//    16-byte groups (ldi and ldo multiples of 8) are read 16 bytes a lane,
//    9 loads a lane in flight before their stores (on an H100, 0.774 ms a
//    frame against 0.832 for 4-byte loads of the same rows); others (a
//    row of 3C = 540 is only 4-byte aligned) 4 bytes a lane.  Row strides
//    (40 and 72 bf16) make the fragment loads below free of bank
//    conflicts.
// 2. Each warp takes (head, 16 query rows) tasks: S = q k^T with
//    mma.sync m16n8k16 (bf16 in, f32 sums; 8 key tiles x 2 depth steps),
//    then scale, + B, + M_s, the row max and sum over the quad's lanes
//    in f32, P = exp(S - max) rounded to bf16 as the A operand of
//    O = P v (4 key steps x the dim tiles), O / sum.
// 3. O is staged, rounded to bf16, in the task's own q rows, and after a
//    barrier each warp writes 8 tokens' rows of the output with the zero
//    words of the padding columns, 16 or 4 bytes a lane as it read.

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WA_THREADS = 256;
constexpr int WA_TOK = 64;    // tokens of an 8 x 8 window
constexpr int WA_D = 32;      // the head width, padded
constexpr int WA_QS = 40;     // q, k row stride in shared memory (bf16)
constexpr int WA_VS = 72;     // v^T row stride in shared memory (bf16)
constexpr int WA_WARPS = WA_THREADS / 32;
constexpr int WA_WTOK = WA_TOK / WA_WARPS;  // tokens a warp copies
constexpr int WA_U = 9;       // 16-byte loads a lane keeps in flight

struct WaArgs {
  const __nv_bfloat16* qkv;
  const float* bias;
  __nv_bfloat16* out;
  int heads, hd, P, Q, shift, wy, wx;
  long long ldi, ldo;  // row strides of qkv (>= 3C) and out (>= C), in bf16
  float scale;
};

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A word of a qkv row (channels 2i, 2i+1) to its place ``off`` in shared
// memory for token t: q and k words as they are, v's two halves into
// v^T's rows.
__device__ __forceinline__ void wa_put(__nv_bfloat16* sq, int off, int t,
                                       bool qk, uint32_t v) {
  if (qk) {
    *reinterpret_cast<uint32_t*>(sq + off + t * WA_QS) = v;
  } else {
    __nv_bfloat16* p = sq + off + t;
    reinterpret_cast<unsigned short*>(p)[0] = (unsigned short)(v & 0xffffu);
    reinterpret_cast<unsigned short*>(p + WA_VS)[0] = (unsigned short)(v >> 16);
  }
}

__device__ __forceinline__ uint32_t wa_word(const uint4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// A rolled row (or column) r of n: its label for the shift mask.
__device__ __forceinline__ int mask_label(int r, int n, int shift) {
  return r < n - 8 ? 0 : (r < n - shift ? 1 : 2);
}

// V16: rows of whole 16-byte groups (ldi and ldo multiples of 8, both
// bases 16-byte aligned), copied 16 bytes a lane; else 4 bytes a lane.
template <bool V16>
__global__ void __launch_bounds__(WA_THREADS)
    window_attn_kernel(WaArgs a) {
  extern __shared__ __align__(16) unsigned char wa_smem[];
  const int H = a.heads, C = a.heads * a.hd;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(wa_smem);
  __nv_bfloat16* sk = sq + H * WA_TOK * WA_QS;
  __nv_bfloat16* sv = sk + H * WA_TOK * WA_QS;
  long long* stok = reinterpret_cast<long long*>(sv + H * WA_D * WA_VS);
  int* slab = reinterpret_cast<int*>(stok + WA_TOK);
  int* stab = slab + WA_TOK;  // word of a qkv row -> its place in smem

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_frame = a.wy * a.wx;
  const int frame = blockIdx.x / per_frame, w = blockIdx.x % per_frame;
  const int wr = w / a.wx, wc = w % a.wx;
  const int hw = a.hd >> 1, cw = C >> 1, rw = 3 * cw;
  const int lw = (int)(a.ldo >> 1);  // words of an output row

  if (tid < WA_TOK) {
    const int r = wr * 8 + (tid >> 3), c = wc * 8 + (tid & 7);
    int y = r + a.shift, x = c + a.shift;
    if (y >= a.P) y -= a.P;
    if (x >= a.Q) x -= a.Q;
    stok[tid] = ((long long)frame * a.P + y) * a.Q + x;
    slab[tid] = a.shift ? mask_label(r, a.P, a.shift) * 3 +
                              mask_label(c, a.Q, a.shift)
                        : 0;
  }
  for (int wd = tid; wd < rw; wd += WA_THREADS) {
    const int part = wd / cw, rem = wd - part * cw, h = rem / hw;
    const int d = (rem - h * hw) * 2;
    stab[wd] = part < 2 ? (part * H + h) * WA_TOK * WA_QS + d
                        : 2 * H * WA_TOK * WA_QS + (h * WA_D + d) * WA_VS;
  }
  // The padded dims: zero in q and k, and in v^T's rows.
  for (int i = tid; i < 2 * H * WA_TOK; i += WA_THREADS)
    for (int d = a.hd; d < WA_D; d += 2)
      *reinterpret_cast<uint32_t*>(sq + i * WA_QS + d) = 0u;
  for (int i = tid; i < H * (WA_D - a.hd) * WA_VS; i += WA_THREADS) {
    const int h = i / ((WA_D - a.hd) * WA_VS);
    const int rest = i - h * (WA_D - a.hd) * WA_VS;
    sv[(h * WA_D + a.hd) * WA_VS + rest] = __float2bfloat16(0.f);
  }
  __syncthreads();

  // 1. The window's q, k, v into shared memory: the warp's tokens are
  // warp, warp + 8, ...
  if (V16) {
    // The warp's 8 rows as one run of 16-byte groups (ng a row: those
    // that hold channels of the 3C), WA_U loads a lane in flight before
    // their stores; lanes rotate the order of a group's 4 words by their
    // octet, so that one store's lanes spread over the banks (in step,
    // lanes 4 words apart would meet 8).
    const int ng = (rw + 3) >> 2, n = WA_WTOK * ng, rot = (lane >> 3) & 3;
    for (int i0 = lane; i0 < n; i0 += 32 * WA_U) {
      uint4 v[WA_U];
#pragma unroll
      for (int u = 0; u < WA_U; ++u) {
        const int i = i0 + 32 * u;
        if (i < n) {
          const int tl = i / ng;
          v[u] = __ldg(reinterpret_cast<const uint4*>(
                           a.qkv + stok[warp + WA_WARPS * tl] * a.ldi) +
                       (i - tl * ng));
        }
      }
#pragma unroll
      for (int u = 0; u < WA_U; ++u) {
        const int i = i0 + 32 * u;
        if (i < n) {
          const int tl = i / ng, gi = i - tl * ng;
          const int t = warp + WA_WARPS * tl;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = (k + rot) & 3, wd = 4 * gi + j;
            if (wd < rw) wa_put(sq, stab[wd], t, wd < 2 * cw, wa_word(v[u], j));
          }
        }
      }
    }
  } else {
    for (int t = warp; t < WA_TOK; t += WA_WARPS) {
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(a.qkv + stok[t] * a.ldi);
      for (int wd = lane; wd < rw; wd += 32)
        wa_put(sq, stab[wd], t, wd < 2 * cw, __ldg(row + wd));
    }
  }
  __syncthreads();

  // 2. Attention, one (head, 16 query rows) task at a time.
  const int g = lane >> 2, tq = lane & 3;
  const int n_dt = (a.hd + 7) >> 3;  // dim tiles of 8 that hold data
  for (int task = warp; task < H * 4; task += WA_WARPS) {
    const int h = task >> 2, rb = task & 3;
    __nv_bfloat16* q = sq + (h * WA_TOK + rb * 16) * WA_QS;
    const __nv_bfloat16* k = sk + h * WA_TOK * WA_QS;
    const __nv_bfloat16* vt = sv + h * WA_D * WA_VS;
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      qa[ks][0] = ld32(q + g * WA_QS + ks * 16 + tq * 2);
      qa[ks][1] = ld32(q + (g + 8) * WA_QS + ks * 16 + tq * 2);
      qa[ks][2] = ld32(q + g * WA_QS + ks * 16 + 8 + tq * 2);
      qa[ks][3] = ld32(q + (g + 8) * WA_QS + ks * 16 + 8 + tq * 2);
    }
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const __nv_bfloat16* kr = k + (nt * 8 + g) * WA_QS + ks * 16 + tq * 2;
        mma_bf16(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }
    const int i0 = rb * 16 + g, i1 = i0 + 8;
    const int l0 = slab[i0], l1 = slab[i1];
    const float* b0 = a.bias + ((long long)h * WA_TOK + i0) * WA_TOK;
    const float* b1 = b0 + 8 * WA_TOK;
    float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = nt * 8 + tq * 2;
      const float2 bb0 = __ldg(reinterpret_cast<const float2*>(b0 + j));
      const float2 bb1 = __ldg(reinterpret_cast<const float2*>(b1 + j));
      s[nt][0] = s[nt][0] * a.scale + bb0.x;
      s[nt][1] = s[nt][1] * a.scale + bb0.y;
      s[nt][2] = s[nt][2] * a.scale + bb1.x;
      s[nt][3] = s[nt][3] * a.scale + bb1.y;
      if (a.shift) {
        const int lj0 = slab[j], lj1 = slab[j + 1];
        if (l0 != lj0) s[nt][0] += -100.f;
        if (l0 != lj1) s[nt][1] += -100.f;
        if (l1 != lj0) s[nt][2] += -100.f;
        if (l1 != lj1) s[nt][3] += -100.f;
      }
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m0);
      s[nt][1] = __expf(s[nt][1] - m0);
      s[nt][2] = __expf(s[nt][2] - m1);
      s[nt][3] = __expf(s[nt][3] - m1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);

    float o[4][4];
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        if (dt < n_dt) {
          const __nv_bfloat16* vr = vt + (dt * 8 + g) * WA_VS + ks * 16 + tq * 2;
          mma_bf16(o[dt], pa, ld32(vr), ld32(vr + 8));
        }
      }
    }
    // 3a. O / sum, rounded, into this task's own q rows (only this warp
    // reads them, and its fragments are in registers).
    const float r0 = 1.f / sum0, r1 = 1.f / sum1;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int d = dt * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(q + g * WA_QS + d) =
          pack_bf16(o[dt][0] * r0, o[dt][1] * r0);
      *reinterpret_cast<uint32_t*>(q + (g + 8) * WA_QS + d) =
          pack_bf16(o[dt][2] * r1, o[dt][3] * r1);
    }
  }
  __syncthreads();

  // 3b. The window's output rows, in the grid's token order, with zero
  // words past the C channels.
  if (V16) {
    const int ng = lw >> 2, n = WA_WTOK * ng;
    for (int i = lane; i < n; i += 32) {
      const int tl = i / ng, gi = i - tl * ng, t = warp + WA_WARPS * tl;
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int wd = 4 * gi + j;
        o[j] = wd < cw ? *reinterpret_cast<const uint32_t*>(sq + stab[wd] +
                                                            t * WA_QS)
                       : 0u;
      }
      reinterpret_cast<uint4*>(a.out + stok[t] * a.ldo)[gi] =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (int t = warp; t < WA_TOK; t += WA_WARPS) {
      uint32_t* row = reinterpret_cast<uint32_t*>(a.out + stok[t] * a.ldo);
      for (int wd = lane; wd < lw; wd += 32)
        row[wd] = wd < cw ? *reinterpret_cast<const uint32_t*>(sq + stab[wd] +
                                                               t * WA_QS)
                          : 0u;
    }
  }
}

}  // namespace

// qkv bf16 (frames, P*Q, ldi) (its first 3*heads*hd channels read), bias
// f32 (heads, 64, 64), out bf16 (frames, P*Q, ldo) (channels from
// heads*hd on written zero); ldi and ldo even, P and Q multiples of 8, hd
// even and at most 32, 0 <= shift < 8.
extern "C" int srt_window_attn(const void* qkv, const float* bias, void* out,
                               int frames, int P, int Q, int heads, int hd,
                               int ldi, int ldo, int shift, float scale,
                               void* stream) {
  if (P % 8 || Q % 8 || P < 8 || Q < 8 || hd < 2 || hd > WA_D || hd % 2 ||
      heads < 1 || shift < 0 || shift >= 8 || frames < 1 ||
      ldi < 3 * heads * hd || ldo < heads * hd || ldi % 2 || ldo % 2)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)frames * (P / 8) * (Q / 8);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)heads * (2 * WA_TOK * WA_QS + WA_D * WA_VS) +
      sizeof(long long) * WA_TOK + sizeof(int) * (WA_TOK + 3 * heads * hd / 2);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const bool v16 = ldi % 8 == 0 && ldo % 8 == 0 &&
                   ((uintptr_t)qkv % 16 | (uintptr_t)out % 16) == 0;
  void (*kernel)(WaArgs) =
      v16 ? window_attn_kernel<true> : window_attn_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  WaArgs a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.bias = bias;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.heads = heads;
  a.hd = hd;
  a.P = P;
  a.Q = Q;
  a.shift = shift;
  a.wy = P / 8;
  a.wx = Q / 8;
  a.ldi = ldi;
  a.ldo = ldo;
  a.scale = scale;
  kernel<<<(unsigned)blocks, WA_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
