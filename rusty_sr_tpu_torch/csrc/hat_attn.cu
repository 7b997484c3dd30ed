// HAT's two attentions, fused, for Hopper (sm_90a), bf16 in and out:
//
//   out[t] = concat_h softmax(q_h(i) k_h(j)^T * scale + T_h[off(i, j)]
//                             + M_s(i, j)) v_h(j)
//
// for the 256 queries i of each 16x16 window and its keys j:
// - `hat_sa16_kernel`, HAB's shifted-window self-attention: the 256 keys
//   of the same window once the token grid (P x Q) is rolled by (-s, -s);
//   M_s is Swin's `calculate_mask` at window 16 (rolled rows and columns
//   labelled by [0, P-16), [P-16, P-s), [P-s, P); -100 between labels
//   that differ; no mask at s = 0);
// - `hat_oca_kernel`, OCAB's overlapping cross-attention: the 576 keys of
//   the 24x24 square centred on the window (4 tokens beyond each side, as
//   `nn.Unfold(24, stride 16, padding 4)` cuts it), no shift and no mask.
//   A key outside the grid has k = v = 0: it scores exactly its bias and
//   adds to the softmax's denominator, not to its numerator.
// qkv is the `qkv` projection's token-major output (frames, P*Q, 3*C),
// C = heads * hd, channel part*C + h*hd + d (part 0 q, 1 k, 2 v); out is
// (frames, P*Q, C), channel h*hd + d, in the grid's own (un-rolled) token
// order, so `proj` reads it as it is.  Either may have wider rows (ldi,
// ldo): a GEMM whose rows are whole 16-byte groups takes cuBLAS's sm90
// kernels (on an H100, qkv at K = 184 and N = 544 took 0.323 ms a frame
// against 0.983 ms at N = 540), so the fast tier pads qkv's output to 544
// channels and the attention's to 192 with zero columns, which this kernel
// writes.  T_h is the block's relative-position
// table laid out by the key's offset from the query inside their windows,
// (heads, TW * TW) f32, TW = KW + 15, off(i, j) = (yk - yq + 15) * TW +
// (xk - xq + 15) (`ops/cuda/hat_attn.py::offset_table`, which folds in
// HAT's `calculate_rpi_sa` and `calculate_rpi_oca`, wrap included).
//
// Replaces no TPU kernel: the JAX package runs no attention.  It was added
// because SwinIR's `window_attn_kernel` holds one 64-token window for all
// heads in shared memory, and a 16x16 window's q, k and v for 6 heads take
// more than a block may hold; and because a library attention call would
// need the roll, the window partition, an unfold copy of k and v (2.25x)
// and the bias and mask materialised around it.
//
// What bounds it: device-memory bytes, near the ridge for the overlapping
// form.  Per token and block it reads q, k and v once (3 * C * 2 bytes;
// the overlapping keys are read again by neighbouring windows, from L2)
// and writes its output once (C * 2): 1,440 bytes at C = 180, against
// 184,320 FLOP of products (window 16) or 414,720 (24x24 keys).
//
// Design: one block of 256 threads (8 warps) per (window, head).
// 1. The window's q rows and its keys' k and v rows are copied to shared
//    memory by 4-byte cp.async (a head's 60 bytes of a 1,080-byte qkv row
//    are 4-byte aligned only), two tokens a warp at a time, all in flight
//    before one wait; keys outside the grid are zero-filled by the copy
//    itself.  Rows are [token][dim] of 32 bf16, the head width padded with
//    zeros, their 16-byte chunks swizzled so that the fragment loads and
//    ldmatrix meet no bank conflict.  The head's table goes to shared
//    memory while the copies fly (3.8 KB; 6.1 KB for 24x24 keys), so the
//    bias is a shared-memory read per score and no (256 x keys) bias is
//    read.  The overlapping form's 94 KB let two blocks share an SM.
// 2. Each warp takes 16-query-row tasks (2 of the 16): over key tiles of
//    64, S = q k^T with mma.sync m16n8k16 (bf16 in, f32 sums), then
//    scale, + T, + M_s, an online softmax in f32 (the running row max and
//    sum over the quad's lanes, the output rescaled when the max moves),
//    P = exp(S - max) rounded to bf16 as the A operand of O += P v, whose
//    B operand ldmatrix.trans reads from v's rows.
// 3. O / sum is staged, rounded to bf16, in the task's own q rows, and
//    after a barrier the block writes the window's output rows.
//
// On an H100 (one 544x960 frame, 6 heads of 30) the first form, plain
// 4-byte loads into registers and v stored transposed, took 1.354 ms at
// window 16 and 2.208 ms for 24x24 keys; this one 1.023 and 2.108 ms,
// bit-identical (timed in turns).

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HA_THREADS = 256;
constexpr int HA_WS = 16;             // the query window's side
constexpr int HA_NQ = HA_WS * HA_WS;  // queries a window
constexpr int HA_D = 32;              // the head width, padded

struct HaArgs {
  const __nv_bfloat16* qkv;
  const float* table;
  __nv_bfloat16* out;
  int heads, hd, P, Q, shift, wy, wx;
  int ldi, ldo;  // row strides of qkv (>= 3C) and out (>= C), in bf16
  float scale;
};

__device__ __forceinline__ void ha_mma(float* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ha_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ha_ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A rolled row (or column) r of n: its label for the shift mask.
__device__ __forceinline__ int ha_label(int r, int n, int shift) {
  return r < n - HA_WS ? 0 : (r < n - shift ? 1 : 2);
}

// The grid position of token (ty, tx) of a window whose first row and
// column are (y0, x0), rolled by `shift` (wrapping) when the window is the
// query's own; -1 outside the grid.
template <int OV>
__device__ __forceinline__ int ha_token(int y0, int x0, int ty, int tx,
                                        int shift, int P, int Q) {
  int y = y0 - OV + ty + shift, x = x0 - OV + tx + shift;
  if (OV == 0) {
    if (y >= P) y -= P;
    if (x >= Q) x -= Q;
    return y * Q + x;
  }
  return (y >= 0 && y < P && x >= 0 && x < Q) ? y * Q + x : -1;
}

// q, k and v rows in shared memory: 32 bf16 (64 bytes) a row, its four
// 16-byte chunks swizzled (chunk c of row r at c ^ ((r >> 1) & 3)) so that
// eight consecutive rows meet eight bank groups.
__device__ __forceinline__ int ha_sw(int r, int d) {
  // the bf16 offset of dim d of row r
  return r * HA_D + ((((d >> 3) ^ (r >> 1)) & 3) << 3) + (d & 7);
}

__device__ __forceinline__ void ha_cp4(void* dst, const void* src,
                                       bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(inside ? 4 : 0)
               : "memory");
}

template <int KW>
struct HaShape {
  static constexpr int NK = KW * KW;
  static constexpr int OV = (KW - HA_WS) / 2;
  static constexpr int TW = KW + HA_WS - 1;
  static constexpr int TAB = (TW * TW + 3) / 4 * 4;
  static constexpr bool MASK = KW == HA_WS;
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)(HA_NQ + 2 * NK) * HA_D +
      sizeof(float) * TAB + (MASK ? sizeof(int) * NK : 0);
};

template <int KW>
__device__ __forceinline__ void hat_attn_body(const HaArgs& a) {
  using S = HaShape<KW>;
  extern __shared__ __align__(16) unsigned char ha_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(ha_smem);
  __nv_bfloat16* sk = sq + HA_NQ * HA_D;
  __nv_bfloat16* sv = sk + S::NK * HA_D;
  float* stab = reinterpret_cast<float*>(sv + S::NK * HA_D);
  int* sklab = reinterpret_cast<int*>(stab + S::TAB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.heads, hd = a.hd, C = H * hd, hw = hd >> 1;
  const int h = blockIdx.x % H;
  const int win = blockIdx.x / H, per_frame = a.wy * a.wx;
  const int frame = win / per_frame, wi = win - frame * per_frame;
  const int wr = wi / a.wx, wc = wi - (wi / a.wx) * a.wx;
  const int y0 = wr * HA_WS, x0 = wc * HA_WS;
  const __nv_bfloat16* base = a.qkv + (long long)frame * a.P * a.Q * a.ldi;

  // 1. The copies: q rows, then k and v rows, two tokens a warp at a time;
  // the padded dims are zeroed by plain stores (other words).
  const int half = lane >> 4, wd = lane & 15;
  for (int t2 = warp * 2; t2 < HA_NQ; t2 += 2 * (HA_THREADS / 32)) {
    const int t = t2 + half;
    __nv_bfloat16* dst = sq + ha_sw(t, 2 * wd);
    if (wd < hw) {
      const int tok = ha_token<0>(y0, x0, t >> 4, t & 15, a.shift, a.P, a.Q);
      ha_cp4(dst, base + (long long)tok * a.ldi + h * hd + 2 * wd, true);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = 0u;
    }
  }
  for (int t2 = warp * 2; t2 < S::NK; t2 += 2 * (HA_THREADS / 32)) {
    const int t = t2 + half;
    __nv_bfloat16* dk = sk + ha_sw(t, 2 * wd);
    __nv_bfloat16* dv = sv + ha_sw(t, 2 * wd);
    if (wd < hw) {
      const int tok = ha_token<S::OV>(y0, x0, t / KW, t % KW, a.shift, a.P,
                                      a.Q);
      const __nv_bfloat16* row =
          base + (long long)(tok < 0 ? 0 : tok) * a.ldi + h * hd + 2 * wd;
      ha_cp4(dk, row + C, tok >= 0);
      ha_cp4(dv, row + 2 * C, tok >= 0);
    } else {
      *reinterpret_cast<uint32_t*>(dk) = 0u;
      *reinterpret_cast<uint32_t*>(dv) = 0u;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = tid; i < S::TW * S::TW; i += HA_THREADS)
    stab[i] = __ldg(a.table + (long long)h * S::TW * S::TW + i);
  if (S::MASK && a.shift) {
    for (int j = tid; j < S::NK; j += HA_THREADS)
      sklab[j] = ha_label(y0 + j / KW, a.P, a.shift) * 3 +
                 ha_label(x0 + j % KW, a.Q, a.shift);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // 2. Attention, one task of 16 query rows at a time.
  const int g = lane >> 2, tq = lane & 3;
  const int n_dt = (hd + 7) >> 3;
  // ldmatrix.x4.trans row addresses for P v: keys ks*16 + (lane & 15),
  // dim chunk (lane >> 4) of each pair of dim tiles.
  const int lrow = lane & 15, lchunk = lane >> 4;
  for (int rb = warp; rb < HA_NQ / 16; rb += HA_THREADS / 32) {
    __nv_bfloat16* q = sq;
    const int r0 = rb * 16 + g, r1 = r0 + 8;
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      qa[ks][0] = ha_ld32(q + ha_sw(r0, ks * 16 + tq * 2));
      qa[ks][1] = ha_ld32(q + ha_sw(r1, ks * 16 + tq * 2));
      qa[ks][2] = ha_ld32(q + ha_sw(r0, ks * 16 + 8 + tq * 2));
      qa[ks][3] = ha_ld32(q + ha_sw(r1, ks * 16 + 8 + tq * 2));
    }
    int l0 = 0, l1 = 0;
    if (S::MASK && a.shift) {
      const int lr = ha_label(y0 + rb, a.P, a.shift) * 3;
      l0 = lr + ha_label(x0 + g, a.Q, a.shift);
      l1 = lr + ha_label(x0 + g + 8, a.Q, a.shift);
    }
    const int b0 = (HA_WS - 1) * S::TW + (HA_WS - 1) - rb * S::TW - g;
    const int b1 = b0 - 8;
    float m0 = -3.0e38f, m1 = -3.0e38f, sum0 = 0.f, sum1 = 0.f;
    float o[4][4];
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

    for (int kt = 0; kt < S::NK / 64; ++kt) {
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const int kr = kt * 64 + nt * 8 + g;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          ha_mma(s[nt], qa[ks], ha_ld32(sk + ha_sw(kr, ks * 16 + tq * 2)),
                 ha_ld32(sk + ha_sw(kr, ks * 16 + 8 + tq * 2)));
      }
      float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = kt * 64 + nt * 8 + tq * 2;
        const int off = j + (S::TW - KW) * ((kt * 64 + nt * 8) / KW);
        s[nt][0] = s[nt][0] * a.scale + stab[b0 + off];
        s[nt][1] = s[nt][1] * a.scale + stab[b0 + off + 1];
        s[nt][2] = s[nt][2] * a.scale + stab[b1 + off];
        s[nt][3] = s[nt][3] * a.scale + stab[b1 + off + 1];
        if (S::MASK && a.shift) {
          const int lj0 = sklab[j], lj1 = sklab[j + 1];
          if (l0 != lj0) s[nt][0] += -100.f;
          if (l0 != lj1) s[nt][1] += -100.f;
          if (l1 != lj0) s[nt][2] += -100.f;
          if (l1 != lj1) s[nt][3] += -100.f;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float al0 = __expf(m0 - n0), al1 = __expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      sum0 *= al0;
      sum1 *= al1;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        o[dt][0] *= al0;
        o[dt][1] *= al0;
        o[dt][2] *= al1;
        o[dt][3] *= al1;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = __expf(s[nt][0] - m0);
        s[nt][1] = __expf(s[nt][1] - m0);
        s[nt][2] = __expf(s[nt][2] - m1);
        s[nt][3] = __expf(s[nt][3] - m1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t pa[4];
        pa[0] = ha_pack(s[2 * ks][0], s[2 * ks][1]);
        pa[1] = ha_pack(s[2 * ks][2], s[2 * ks][3]);
        pa[2] = ha_pack(s[2 * ks + 1][0], s[2 * ks + 1][1]);
        pa[3] = ha_pack(s[2 * ks + 1][2], s[2 * ks + 1][3]);
        const int vr = kt * 64 + ks * 16 + lrow;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          if (2 * dp < n_dt) {
            uint32_t b[4];
            const unsigned addr = (unsigned)__cvta_generic_to_shared(
                sv + ha_sw(vr, (2 * dp + lchunk) * 8));
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                "{%0,%1,%2,%3}, [%4];\n"
                : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                : "r"(addr));
            ha_mma(o[2 * dp], pa, b[0], b[1]);
            if (2 * dp + 1 < n_dt) ha_mma(o[2 * dp + 1], pa, b[2], b[3]);
          }
        }
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float i0 = 1.f / sum0, i1 = 1.f / sum1;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int d = dt * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(q + ha_sw(r0, d)) =
          ha_pack(o[dt][0] * i0, o[dt][1] * i0);
      *reinterpret_cast<uint32_t*>(q + ha_sw(r1, d)) =
          ha_pack(o[dt][2] * i1, o[dt][3] * i1);
    }
  }
  __syncthreads();

  __nv_bfloat16* obase = a.out + (long long)frame * a.P * a.Q * a.ldo;
  for (int t2 = warp * 2; t2 < HA_NQ; t2 += 2 * (HA_THREADS / 32)) {
    const int t = t2 + half;
    const int tok = ha_token<0>(y0, x0, t >> 4, t & 15, a.shift, a.P, a.Q);
    uint32_t* row = reinterpret_cast<uint32_t*>(obase + (long long)tok * a.ldo);
    if (wd < hw)
      row[h * hw + wd] =
          *reinterpret_cast<const uint32_t*>(sq + ha_sw(t, 2 * wd));
    if (h == 0)   // the padding columns of the row, zero
      for (int w = C / 2 + wd; w < a.ldo / 2; w += 16) row[w] = 0u;
  }
}

__global__ void __launch_bounds__(HA_THREADS, 2) hat_sa16_kernel(HaArgs a) {
  hat_attn_body<16>(a);
}

__global__ void __launch_bounds__(HA_THREADS, 2) hat_oca_kernel(HaArgs a) {
  hat_attn_body<24>(a);
}

template <int KW>
int ha_launch(void (*kernel)(HaArgs), const HaArgs& a, long long blocks,
              cudaStream_t stream) {
  const size_t smem = HaShape<KW>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, HA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv bf16 (frames, P*Q, ldi) (its first 3*heads*hd channels read), table
// f32 (heads, TW*TW), out bf16 (frames, P*Q, ldo) (channels from heads*hd
// on written zero); ldi and ldo even; P and Q multiples of 16, hd even and
// at most 32; key_window 16 (shifted windows, 0 <= shift < 16) or 24
// (overlapping cross-attention, shift 0).
extern "C" int srt_hat_attn(const void* qkv, const float* table, void* out,
                            int frames, int P, int Q, int heads, int hd,
                            int ldi, int ldo, int shift, int key_window,
                            float scale, void* stream) {
  if (P % HA_WS || Q % HA_WS || P < HA_WS || Q < HA_WS || hd < 2 ||
      hd > HA_D || hd % 2 || heads < 1 || frames < 1 || shift < 0 ||
      shift >= HA_WS || (key_window != 16 && key_window != 24) ||
      (key_window == 24 && shift != 0) || ldi < 3 * heads * hd ||
      ldo < heads * hd || ldi % 2 || ldo % 2)
    return (int)cudaErrorInvalidValue;
  if ((long long)P * Q * (ldi > ldo ? ldi : ldo) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)frames * (P / HA_WS) * (Q / HA_WS) * heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  HaArgs a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.table = table;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.heads = heads;
  a.hd = hd;
  a.P = P;
  a.Q = Q;
  a.shift = shift;
  a.wy = P / HA_WS;
  a.wx = Q / HA_WS;
  a.ldi = ldi;
  a.ldo = ldo;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  return key_window == 16 ? ha_launch<16>(hat_sa16_kernel, a, blocks, s)
                          : ha_launch<24>(hat_oca_kernel, a, blocks, s);
}

#endif  // __CUDACC__
