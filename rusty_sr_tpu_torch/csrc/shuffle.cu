// The output epilogue of the tile paths, and depth-to-space in the
// reference's (fy, fx, c) channel order, as one CUDA kernel family for
// Hopper (sm_90a):
//
//   out[n][f*y + fy][f*x + fx][c] =
//       q(x[n][y + off][x + off][(fy*f + fx)*C + c]
//         (+ base[n][y][x][(fy*f + fx)*C + c]))
//
// for the LR pixels (y, x) of a th x tw window of x that starts at (off,
// off).  base is `ops/resize.py::bilinear_phases_cropped(e, f, eo, eo,
// tile)`: the half-pixel bilinear xf upsample's LR-space phases over the
// window at (eo, eo) of the edge tiles e, computed here from e itself, u8
// (each value float(v) * f32(1/255), as the plain version casts it) or
// f32.  q is the identity, or the u8 quantisation floor(clip(v, 0, 1) *
// 255 + 0.5) of an f32 value.  x may also be stored 2x2 space-to-depth
// packed, block-major: pixel (Y, X) of the (xh, xw) grid at packed pixel
// (Y/2, X/2), channel ((Y%2)*2 + X%2)*f*f*C + ch.
//
// Replaces the TPU kernel rusty_sr_tpu/ops/pallas/shuffle.py::
// _row_slice_kernel (launched by depth_to_space_pallas) and fuses the
// steps around it on each path:
// - the fused engine: depth_to_space(expand + base), f32 edge tiles;
// - the xla engine's exact and flat fast tiers: the halo crop of `expand`
//   (read in place at off = 7), the base from the u8 (or f32) edge tiles
//   and, for u8 images, the quantisation, so the tile comes back as u8;
// - the packed fast tier: the quantisation, unpack, crop and shuffle of
//   the packed sum (its base is already in the sum);
// - the bilinear mode: the plain rearrangement of u8 or f32 phases.
// Each lerp is lo*f32(1-w) + hi*f32(w) (lo itself when w == 0), rows
// first, then columns, with the phase weights computed on the host as the
// plain version computes them; the sum is one f32 add; every product and
// sum is written __fmul_rn/__fadd_rn, so nvcc cannot contract them into
// an FMA.  So the result is byte-identical to the plain PyTorch version.
//
// What bounds it: device-memory bytes.  At factor 3 an LR pixel costs 108
// bytes read from `expand` and 27 (u8) or 108 (f32) written; the base's
// inputs are 3 (u8) or 12 (f32) bytes a pixel where the plain version
// wrote and read back a 108-byte f32 base.  A few FLOPs a value are far
// below the card's rate.
//
// Design: a block owns a strip of LR rows (and, for wide tiles, a segment
// of their columns) of one tile, whose f HR rows per LR row are contiguous
// runs of the output.
// 1. It stages the strip's `expand` rows in shared memory with 16-byte
//    cp.async copies.  A row's crop starts 7 px x 108 B = 756 B into it,
//    off 16-byte alignment, so each run lands at the offset (its address
//    mod 16) that keeps the copies aligned; the partial chunks at either
//    end go one value at a time.  The packed form stages the packed row
//    that holds two LR rows.  Beside it, the (rows + 2) x (cols + 2) x C
//    edge window, converted to f32 once as it is stored (staging the raw
//    u8 window with the copies and converting each of pass 2's reads
//    measured slower: 0.140 against 0.113 ms for the u8 form).
// 2. One thread per (LR pixel, channel) computes the f x f phases of the
//    base from the window (9 reads, 3f + f^2 lerps), adds `expand`,
//    quantises, and writes each value to its place in the strip's HR rows,
//    staged in shared memory at the alignment of their global address.
// 3. The block copies the staged HR rows out with 16-byte stores (the
//    partial chunks at either end of a row one value at a time).
// Shared memory is sized so that about three blocks fit on an SM.  Factor
// 3 has its own instantiation: its phase loops unroll, the taps fold at
// compile time and the weights are read from the kernel's parameters, so
// pass 2 costs a few instructions a value (on an H100 80GB HBM3 at 700 W
// this took the u8 form from 0.155 to 0.113 ms at 24 x 242^2; ablations
// show the three passes each cost about as much as the others).
//
// The launchers are guarded by __CUDACC__, so with a few macros for the
// CUDA keywords and cp.async as a memcpy the device code compiles as plain
// C++ and runs on a host (tests/test_torch_conv_stage.py).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int EP_THREADS = 256;
// A block's shared memory target: about three blocks to an SM.
constexpr int EP_SMEM = 72 * 1024;
// LR rows a block of the flat forms takes (one, or fewer columns, where
// a strip of them passes EP_SMEM).
constexpr int EP_ROWS = 2;
// The largest factor of the forms with a base (its phase table).
constexpr int EP_MAXF = 8;
constexpr float EP_INV255 = (float)(1.0 / 255.0);

#ifdef __CUDACC__
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
#endif

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The reference's u8 rule, without contraction: floor(clip(v,0,1)*255+0.5).
__device__ __forceinline__ unsigned char quantise_u8(float v) {
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  return (unsigned char)floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f));
}

// `ops/resize.py::_lerp`: lo*(1-w) + hi*w, each product and the sum
// rounded to f32; lo itself at the middle phase (w == 0).
__device__ __forceinline__ float lerp(float lo, float hi, float w, float omw,
                                      bool mid) {
  return mid ? lo : __fadd_rn(__fmul_rn(lo, omw), __fmul_rn(hi, w));
}

// Phase p of f samples at alpha = (p + 0.5)/f - 0.5, in (-0.5, 0.5): its
// lo tap is one pixel up (left) when alpha < 0, and w == 0 at alpha == 0.
__host__ __device__ __forceinline__ bool tap_up(int p, int f) {
  return 2 * p + 1 < f;
}
__host__ __device__ __forceinline__ bool tap_mid(int p, int f) {
  return 2 * p + 1 == f;
}

__device__ __forceinline__ float to_f32(unsigned char v) {
  return __fmul_rn((float)v, EP_INV255);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

template <class TO>
__device__ __forceinline__ TO store_as(float v);
template <>
__device__ __forceinline__ unsigned char store_as<unsigned char>(float v) {
  return quantise_u8(v);
}
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return v;
}

// EDGE: 0 no base, 1 u8 edge tiles, 2 f32 edge tiles.
template <int EDGE>
struct EdgeType {
  using T = float;
};
template <>
struct EdgeType<1> {
  using T = unsigned char;
};

struct EpArgs {
  const void* x;     // (n, xh, xw, f*f*c); packed (n, xh/2, xw/2, 4*f*f*c)
  const void* edge;  // (n, eh, ew, c), or null
  void* out;         // (n, f*th, f*tw, c)
  int n, th, tw;     // tiles; the window's rows and columns
  int xh, xw, off;   // x's (unpacked) pixel grid; the window's origin
  int eh, ew, eoff;  // the edge tiles' grid; the base window's origin
  int c, f;
  int rows, cols;    // a block's LR rows (packed: 2) and columns
  int strips, segs;  // blocks along a tile's rows and along its columns
  int xpitch;        // elements of a staged x row
  int opitch;        // bytes of a staged HR row
  int xofs, oofs, eofs;  // byte offsets of the staged x, HR rows and edge
  float w[EP_MAXF];      // phase p's hi weight f32(alpha - floor(alpha))
  float omw[EP_MAXF];    // and its lo weight f32(1 - w)
};

// Copies n values of T from global src to shared dst so that value i
// lands at dst[lead + i], lead = (src mod 16) / sizeof(T): the 16-byte
// chunks wholly inside the run by cp.async, the values outside them one by
// one.  dst is 16-byte aligned and holds lead + n values.
template <class T>
__device__ __forceinline__ int stage_run(T* dst, const T* src, int n) {
  constexpr int V = 16 / (int)sizeof(T);
  const int lead = (int)((uintptr_t)src & 15) / (int)sizeof(T);
  const T* base = src - lead;
  const int end = lead + n;
  const int c0 = (lead + V - 1) / V, c1 = end / V;
  for (int k = c0 + (int)threadIdx.x; k < c1; k += (int)blockDim.x)
    cp_async16(dst + k * V, base + k * V);
  const int h1 = imin(c0 * V, end);
  for (int i = lead + (int)threadIdx.x; i < h1; i += (int)blockDim.x)
    dst[i] = base[i];
  for (int i = imax(c1 * V, h1) + (int)threadIdx.x; i < end;
       i += (int)blockDim.x)
    dst[i] = base[i];
  return lead;
}

// TI float or unsigned char (the plain rearrangement only); TO float, or
// unsigned char (quantised from f32, or copied from u8).  F is the factor,
// or 0 for any factor (F > 0 unrolls the phase loops and folds the taps).
template <class TI, class TO, int EDGE, bool PACKED, int F>
__global__ void __launch_bounds__(EP_THREADS)
epilogue_kernel(const EpArgs a) {
  extern __shared__ __align__(16) unsigned char ep_smem[];
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const int C = a.c, f = F > 0 ? F : a.f, fc = f * C, ffc = f * fc;
  int b = (int)blockIdx.x;
  const int seg = b % a.segs;
  b /= a.segs;
  const int strip = b % a.strips;
  const int img = b / a.strips;
  const int xa = seg * a.cols, nc = imin(a.cols, a.tw - xa);
  const int pr = a.off / 2 + strip;  // the packed form's packed row
  int ya, nr;                        // the strip's LR rows [ya, ya + nr)
  if constexpr (PACKED) {
    ya = imax(2 * pr - a.off, 0);
    nr = imin(2 * pr + 2 - a.off, a.th) - ya;
  } else {
    ya = strip * a.rows;
    nr = imin(a.rows, a.th - ya);
  }
  int* xlead = reinterpret_cast<int*>(ep_smem);  // [rows]
  int* olead = xlead + a.rows;                   // [rows * f]
  TI* sx = reinterpret_cast<TI*>(ep_smem + a.xofs);
  unsigned char* so = ep_smem + a.oofs;
  float* se = reinterpret_cast<float*>(ep_smem + a.eofs);
  TO* out = static_cast<TO*>(a.out);
  const TI* x = static_cast<const TI*>(a.x);

  // 1. Stage x's rows (or packed row) and the edge window.
  int p0 = 0;
  if constexpr (PACKED) {
    p0 = (a.off + xa) / 2;
    const int p1 = (a.off + xa + nc - 1) / 2;
    const TI* src =
        x + (((size_t)img * (a.xh / 2) + pr) * (a.xw / 2) + p0) * 4 * ffc;
    const int lead = stage_run(sx, src, (p1 - p0 + 1) * 4 * ffc);
    if (tid == 0) xlead[0] = lead;
  } else {
    for (int r = 0; r < nr; ++r) {
      const TI* src =
          x + (((size_t)img * a.xh + ya + r + a.off) * a.xw + a.off + xa) *
                  ffc;
      const int lead = stage_run(sx + (size_t)r * a.xpitch, src, nc * ffc);
      if (tid == 0) xlead[r] = lead;
    }
  }
  const int erun = (nc + 2) * C;  // values of a staged edge row
  if constexpr (EDGE != 0) {
    using TE = typename EdgeType<EDGE>::T;
    const TE* e = static_cast<const TE*>(a.edge);
    for (int r = 0; r < nr + 2; ++r) {
      const TE* src = e + (((size_t)img * a.eh + a.eoff + ya - 1 + r) * a.ew +
                           a.eoff + xa - 1) * C;
      for (int i = tid; i < erun; i += nt) se[r * erun + i] = to_f32(src[i]);
    }
  }
  // Each staged HR row sits at the alignment of its global address.
  const size_t hr_len = (size_t)a.tw * fc;
  for (int i = tid; i < nr * f; i += nt) {
    const int r = i / f;
    const TO* g =
        out + (((size_t)img * a.th + ya + r) * f + (i - r * f)) * hr_len +
        (size_t)xa * fc;
    olead[i] = (int)((uintptr_t)g & 15);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // 2. One thread per (LR pixel, channel): its f x f values.
  const int units = nr * nc * C;
  for (int u = tid; u < units; u += nt) {
    const int r = u / (nc * C);
    const int rem = u - r * nc * C;
    const int px = rem / C, ch = rem - px * C;
    int s;  // staged x index of phase 0
    if constexpr (PACKED) {
      const int ys = ya + r + a.off, X = xa + px + a.off;
      s = xlead[0] + (X / 2 - p0) * 4 * ffc + ((ys & 1) * 2 + (X & 1)) * ffc +
          ch;
    } else {
      s = r * a.xpitch + xlead[r] + px * ffc + ch;
    }
    // Phase fy's staged HR row, at this unit's first value.
    auto orow = [&](int fy) {
      const int hr = r * f + fy;
      return reinterpret_cast<TO*>(so + (size_t)hr * a.opitch + olead[hr]) +
             px * fc + ch;
    };
    if constexpr (EDGE != 0) {
      float e3[3][3];  // LR rows y-1..y+1, columns x-1..x+1 of channel ch
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          e3[i][j] = se[(r + i) * erun + (px + j) * C + ch];
      // The phase loops unrolled (to the factor, or to EP_MAXF), so the
      // weights are read from the parameters at constant offsets.
      constexpr int FU = F > 0 ? F : EP_MAXF;
#pragma unroll
      for (int fy = 0; fy < FU; ++fy) {
        if (F == 0 && fy >= f) break;
        const bool up = tap_up(fy, f), mid = tap_mid(fy, f);
        const float wy = a.w[fy], oy = a.omw[fy];
        float xr[3];  // the row lerp at columns x-1..x+1
#pragma unroll
        for (int j = 0; j < 3; ++j)
          xr[j] = lerp(up ? e3[0][j] : e3[1][j], up ? e3[1][j] : e3[2][j], wy,
                       oy, mid);
        TO* o = orow(fy);
#pragma unroll
        for (int fx = 0; fx < FU; ++fx) {
          if (F == 0 && fx >= f) break;
          const bool left = tap_up(fx, f);
          const float base = lerp(left ? xr[0] : xr[1], left ? xr[1] : xr[2],
                                  a.w[fx], a.omw[fx], tap_mid(fx, f));
          o[fx * C] = store_as<TO>(__fadd_rn(base, sx[s + (fy * f + fx) * C]));
        }
      }
    } else {
      for (int fy = 0; fy < f; ++fy) {
        TO* o = orow(fy);
        for (int fx = 0; fx < f; ++fx) {
          const TI v = sx[s + (fy * f + fx) * C];
          if constexpr (sizeof(TI) == sizeof(TO))
            o[fx * C] = (TO)v;
          else
            o[fx * C] = store_as<TO>(v);
        }
      }
    }
  }
  __syncthreads();

  // 3. The staged HR rows out, 16 bytes a store.
  const int row_bytes = nc * fc * (int)sizeof(TO);
  const int chunks = row_bytes / 16 + 2;  // chunks a row spans at most
  for (int i = tid; i < nr * f * chunks; i += nt) {
    const int hr = i / chunks, k = i - hr * chunks;
    const int r = hr / f;
    const int lead = olead[hr];
    unsigned char* g = reinterpret_cast<unsigned char*>(
                           out + (((size_t)img * a.th + ya + r) * f +
                                  (hr - r * f)) * hr_len +
                           (size_t)xa * fc) -
                       lead;  // 16-byte aligned
    const unsigned char* s = so + (size_t)hr * a.opitch;
    const int lo = imax(16 * k, lead), hi = imin(16 * k + 16, lead + row_bytes);
    if (hi - lo == 16) {
      *reinterpret_cast<uint4*>(g + lo) =
          *reinterpret_cast<const uint4*>(s + lo);
    } else {
      for (int j = lo; j < hi; j += (int)sizeof(TO))
        *reinterpret_cast<TO*>(g + j) = *reinterpret_cast<const TO*>(s + j);
    }
  }
}

// Fills a's block geometry and phase table for a block of at most
// smem_target bytes of shared memory; returns the block's bytes, or -1 if
// the arguments are out of range.
template <class TI, class TO, int EDGE, bool PACKED>
long long ep_plan(EpArgs& a, long long smem_target) {
  if (a.n < 1 || a.th < 1 || a.tw < 1 || a.c < 1 || a.f < 1 || a.off < 0 ||
      a.off + a.th > a.xh || a.off + a.tw > a.xw ||
      (PACKED && (a.xh % 2 || a.xw % 2)))
    return -1;
  if (EDGE != 0 && (a.f > EP_MAXF || a.eoff < 1 || a.eoff + a.th + 1 > a.eh ||
                    a.eoff + a.tw + 1 > a.ew))
    return -1;
  const long long fc = (long long)a.f * a.c, ffc = a.f * fc;
  if (ffc * 4 * (a.tw + 4) > 0x7fffffffLL ||
      (long long)a.n * a.th * a.tw > 0x7fffffffLL)
    return -1;
  const int V = 16 / (int)sizeof(TI);
  auto layout = [&](int rows, int cols) -> long long {
    const long long meta = round_up(4 * (rows + rows * a.f), 16);
    const long long run = PACKED ? (cols / 2 + 2) * 4 * ffc : cols * ffc;
    const long long xpitch = (run + 2 * V - 2) / V * V;  // room for the lead
    const long long xbytes = (PACKED ? 1 : rows) * xpitch * (long long)sizeof(TI);
    const long long opitch = (cols * fc * (long long)sizeof(TO) + 31) / 16 * 16;
    const long long obytes = rows * a.f * opitch;
    const long long ebytes =
        EDGE != 0 ? (long long)(rows + 2) * (cols + 2) * a.c * 4 : 0;
    a.rows = rows;
    a.cols = cols;
    a.xpitch = (int)xpitch;
    a.opitch = (int)opitch;
    a.xofs = (int)meta;
    a.oofs = (int)(meta + round_up((int)xbytes, 16));
    a.eofs = (int)(a.oofs + obytes);
    return a.eofs + ebytes;
  };
  int rows = PACKED ? 2 : imin(EP_ROWS, a.th);
  if (!PACKED && layout(rows, a.tw) > smem_target) rows = 1;
  int cols = a.tw;
  while (cols > 1 && layout(rows, cols) > smem_target) cols = (cols + 1) / 2;
  const long long smem = layout(rows, cols);
  a.strips = PACKED ? (a.off + a.th - 1) / 2 - a.off / 2 + 1
                    : (a.th + rows - 1) / rows;
  a.segs = (a.tw + cols - 1) / cols;
  if ((long long)a.n * a.strips * a.segs > 0x7fffffffLL) return -1;
  // The phase weights of `ops/resize.py::_phase_taps_padded`, in its
  // arithmetic: alpha = (p + 0.5)/f - 0.5 in double, w = f32(alpha -
  // floor(alpha)), and the lo weight 1 - w in double, rounded to f32 where
  // the plain version multiplies by it.
  for (int p = 0; p < EP_MAXF; ++p) {
    const double alpha = p < a.f ? (p + 0.5) / a.f - 0.5 : 0.0;
    const float w = (float)(alpha - std::floor(alpha));
    a.w[p] = w;
    a.omw[p] = (float)(1.0 - (double)w);
  }
  return smem;
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <class TI, class TO, int EDGE, bool PACKED>
int launch_epilogue(EpArgs a, void* stream) {
  const long long smem = ep_plan<TI, TO, EDGE, PACKED>(a, EP_SMEM);
  if (smem < 0 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = a.f == 3 ? epilogue_kernel<TI, TO, EDGE, PACKED, 3>
                         : epilogue_kernel<TI, TO, EDGE, PACKED, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(a.n * a.strips * a.segs), EP_THREADS, (size_t)smem,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

EpArgs ep_args(const void* x, const void* edge, void* out, int n, int th,
               int tw, int xh, int xw, int off, int eh, int ew, int eoff,
               int c, int f) {
  EpArgs a{};
  a.x = x;
  a.edge = edge;
  a.out = out;
  a.n = n;
  a.th = th;
  a.tw = tw;
  a.xh = xh;
  a.xw = xw;
  a.off = off;
  a.eh = eh;
  a.ew = ew;
  a.eoff = eoff;
  a.c = c;
  a.f = f;
  return a;
}

}  // namespace

// x (n, h, w, f*f*c), f32 or u8 (u8 != 0) -> out (n, f*h, f*w, c), the
// same type.
extern "C" int srt_depth_to_space(const void* x, void* out, int u8, int n,
                                  int h, int w, int c, int f, void* stream) {
  const EpArgs a = ep_args(x, nullptr, out, n, h, w, h, w, 0, 0, 0, 0, c, f);
  if (u8)
    return launch_epilogue<unsigned char, unsigned char, 0, false>(a, stream);
  return launch_epilogue<float, float, 0, false>(a, stream);
}

// The tiles' epilogue: x f32 (n, xh, xw, f*f*c) (packed: (n, xh/2, xw/2,
// 4*f*f*c)); its tile x tile window at (off, off), plus the bilinear base
// of the edge tiles (n, eh, ew, c) (edge_kind 1 u8, 2 f32; 0 none) over
// their window at (eoff, eoff), quantised to u8 if to_u8, shuffled into
// out (n, f*tile, f*tile, c), u8 or f32.  The packed form takes no edge
// tiles and writes u8.
extern "C" int srt_epilogue(const float* x, const void* edge, int edge_kind,
                            void* out, int to_u8, int packed, int n, int xh,
                            int xw, int off, int tile, int eh, int ew,
                            int eoff, int c, int f, void* stream) {
  const EpArgs a =
      ep_args(x, edge, out, n, tile, tile, xh, xw, off, eh, ew, eoff, c, f);
  if (packed) {
    if (edge_kind != 0 || !to_u8) return (int)cudaErrorInvalidValue;
    return launch_epilogue<float, unsigned char, 0, true>(a, stream);
  }
  if ((edge_kind != 0) != (edge != nullptr)) return (int)cudaErrorInvalidValue;
  switch (edge_kind * 2 + (to_u8 ? 1 : 0)) {
    case 0: return launch_epilogue<float, float, 0, false>(a, stream);
    case 1: return launch_epilogue<float, unsigned char, 0, false>(a, stream);
    case 2: return launch_epilogue<float, float, 1, false>(a, stream);
    case 3: return launch_epilogue<float, unsigned char, 1, false>(a, stream);
    case 4: return launch_epilogue<float, float, 2, false>(a, stream);
    case 5: return launch_epilogue<float, unsigned char, 2, false>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

#endif  // __CUDACC__
