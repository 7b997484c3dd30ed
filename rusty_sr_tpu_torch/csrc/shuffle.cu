// Depth-to-space in the reference's (fy, fx, c) channel order, as one CUDA
// kernel for Hopper (sm_90a), and the output epilogue of the tile paths:
//
//   out[n][f*y + fy][f*x + fx][c] =
//       q(x[n][y + off][x + off][(fy*f + fx)*C + c]
//         (+ addend[n][y][x][(fy*f + fx)*C + c]))
//
// for the LR pixels (y, x) of a th x tw window of x that starts at (off,
// off).  q is the identity, or the u8 quantisation floor(clip(v, 0, 1) *
// 255 + 0.5) of an f32 value.  x may also be stored 2x2 space-to-depth
// packed, block-major: pixel (Y, X) of the (xh, xw) grid at packed pixel
// (Y/2, X/2), channel ((Y%2)*2 + X%2)*f*f*C + ch.
//
// Replaces the TPU kernel rusty_sr_tpu/ops/pallas/shuffle.py::
// _row_slice_kernel (launched by depth_to_space_pallas) and fuses the
// steps around it on each path:
// - the fused engine: depth_to_space(base + expand), the LR-space bilinear
//   base as the addend, so the (B, S, S, f^2 C) sum never goes to device
//   memory; the bilinear mode rearranges its u8 result;
// - the xla engine's exact and flat fast tiers: the halo crop of `expand`
//   (read in place at off = 7), the base addend and, for u8 images, the
//   quantisation, so the tile comes back to the host as u8;
// - the packed fast tier: the unpack of the quantised packed sum, the crop
//   and the shuffle in one index map.
// The add is one f32 add per element and the quantisation uses
// __fmul_rn/__fadd_rn (no contraction into an FMA), as the plain
// PyTorch version computes them, so the result is byte-identical to it.
//
// What bounds it: device-memory bandwidth.  It does no arithmetic beyond
// the add and the quantisation; at factor 3 in f32 an LR pixel costs 108
// bytes read from x, 108 read from the addend and 108 written (27 in u8).
// On an H100 the f32 form moves the 455 MB of 24 tiles of 242^2 in
// 0.25-0.28 ms (1.6-1.8 TB/s, about half the HBM peak): its 36-byte input
// runs use the 32-byte sectors poorly.
//
// Design: input channels [fy*fC, (fy+1)*fC) of LR pixel (y, x) are one
// contiguous run of fC values in output row f*y + fy, starting at column
// f*x.  A block row of threads walks one output row, consecutive threads
// writing consecutive elements (coalesced stores), and reads the input in
// runs of fC consecutive values; the f output rows of one LR row read the
// same input lines, which the L2 cache keeps.  The grid's y dimension
// walks the output rows (striding past 65535 of them), its x dimension the
// elements of a row.
//
// The launchers are guarded by __CUDACC__, so with a few macros for the
// CUDA keywords the device code compiles as plain C++, and running it with
// one thread in one block walks every element on a host.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int D2S_THREADS = 256;

// The reference's u8 rule, without contraction: floor(clip(v,0,1)*255+0.5).
__device__ __forceinline__ unsigned char quantise_u8(float v) {
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  return (unsigned char)floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f));
}

// rows = N*f*th output rows of f*tw*C elements each; x holds (N, xh, xw,
// f*f*C) pixels (PACKED: (N, xh/2, xw/2, 4*f*f*C)); addend (N, th, tw,
// f*f*C).  TI float and TO unsigned char quantise.
template <class TI, class TO, bool ADD, bool PACKED>
__global__ void __launch_bounds__(D2S_THREADS)
d2s_kernel(const TI* __restrict__ x, const float* __restrict__ addend,
           TO* __restrict__ out, int rows, int th, int tw, int xh, int xw,
           int off, int c, int f) {
  const int fc = f * c;
  const int ffc = f * fc;
  const int rowlen = tw * fc;      // elements of one output row
  const int fth = f * th;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int img = row / fth;
    const int yy = row - img * fth;
    const int y = yy / f;
    const int fy = yy - y * f;
    const int ys = y + off;          // source row in x's pixel grid
    // The run of LR pixel 0 for this output row.
    const size_t add0 = ((size_t)img * th + y) * tw * ffc + (size_t)fy * fc;
    const size_t in0 =
        PACKED ? (((size_t)img * (xh / 2) + ys / 2) * (xw / 2)) * 4 * ffc +
                     (size_t)(ys & 1) * 2 * ffc + (size_t)fy * fc
               : (((size_t)img * xh + ys) * xw + off) * ffc + (size_t)fy * fc;
    TO* orow = out + (size_t)row * rowlen;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < rowlen;
         j += gridDim.x * blockDim.x) {
      const int px = j / fc;                 // LR column in the window
      const int rem = j - px * fc;
      size_t src;
      if constexpr (PACKED) {
        const int xs = px + off;
        src = in0 + (size_t)(xs / 2) * 4 * ffc + (size_t)(xs & 1) * ffc + rem;
      } else {
        src = in0 + (size_t)px * ffc + rem;
      }
      float v = x[src];
      if constexpr (ADD) v = v + addend[add0 + (size_t)px * ffc + rem];
      if constexpr (sizeof(TI) == 4 && sizeof(TO) == 1)
        orow[j] = quantise_u8(v);
      else
        orow[j] = (TO)v;
    }
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <class TI, class TO, bool ADD, bool PACKED>
int launch_d2s(const TI* x, const float* addend, TO* out, int n, int th,
               int tw, int xh, int xw, int off, int c, int f, void* stream) {
  if (n < 1 || th < 1 || tw < 1 || c < 1 || f < 1 || off < 0 ||
      off + th > xh || off + tw > xw || (PACKED && (xh % 2 || xw % 2)))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * f * th;
  const long long rowlen = (long long)tw * f * c;
  if (rows > 0x7fffffffLL || rowlen > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long bx = (rowlen + D2S_THREADS - 1) / D2S_THREADS;
  const dim3 grid((unsigned)(bx < 0x7fffffffLL ? bx : 0x7fffffffLL),
                  (unsigned)(rows < 65535 ? rows : 65535));
  d2s_kernel<TI, TO, ADD, PACKED>
      <<<grid, D2S_THREADS, 0, (cudaStream_t)stream>>>(
          x, addend, out, (int)rows, th, tw, xh, xw, off, c, f);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, h, w, f*f*c) f32 -> out (n, f*h, f*w, c); addend may be null.
extern "C" int srt_depth_to_space_f32(const float* x, const float* addend,
                                      float* out, int n, int h, int w, int c,
                                      int f, void* stream) {
  if (addend)
    return launch_d2s<float, float, true, false>(x, addend, out, n, h, w, h,
                                                 w, 0, c, f, stream);
  return launch_d2s<float, float, false, false>(x, nullptr, out, n, h, w, h,
                                                w, 0, c, f, stream);
}

// The same for u8, without an addend.
extern "C" int srt_depth_to_space_u8(const unsigned char* x,
                                     unsigned char* out, int n, int h, int w,
                                     int c, int f, void* stream) {
  return launch_d2s<unsigned char, unsigned char, false, false>(
      x, nullptr, out, n, h, w, h, w, 0, c, f, stream);
}

// The flat tiles' epilogue: x f32 (n, xh, xw, f*f*c); its tile x tile
// window at (off, off) plus the addend (n, tile, tile, f*f*c), quantised to
// u8 if to_u8, shuffled into out (n, f*tile, f*tile, c), u8 or f32.
extern "C" int srt_epilogue(const float* x, const float* addend, void* out,
                            int n, int xh, int xw, int off, int tile, int c,
                            int f, int to_u8, void* stream) {
  if (!addend) return (int)cudaErrorInvalidValue;
  if (to_u8)
    return launch_d2s<float, unsigned char, true, false>(
        x, addend, static_cast<unsigned char*>(out), n, tile, tile, xh, xw,
        off, c, f, stream);
  return launch_d2s<float, float, true, false>(
      x, addend, static_cast<float*>(out), n, tile, tile, xh, xw, off, c, f,
      stream);
}

// The packed tiles' epilogue: x f32 (n, xh/2, xw/2, 4*f*f*c), 2x2
// space-to-depth packed; the tile x tile window at (off, off), quantised to
// u8, shuffled into out (n, f*tile, f*tile, c) u8.
extern "C" int srt_epilogue_packed(const float* x, unsigned char* out, int n,
                                   int xh, int xw, int off, int tile, int c,
                                   int f, void* stream) {
  return launch_d2s<float, unsigned char, false, true>(
      x, nullptr, out, n, tile, tile, xh, xw, off, c, f, stream);
}

#endif  // __CUDACC__
