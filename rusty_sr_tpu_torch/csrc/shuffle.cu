// Depth-to-space in the reference's (fy, fx, c) channel order, as one CUDA
// kernel for Hopper (sm_90a), with an optional f32 addend:
//
//   out[n][f*y + fy][f*x + fx][c] = x[n][y][x][(fy*f + fx)*C + c]
//                                   (+ addend[n][y][x][(fy*f + fx)*C + c])
//
// Replaces the TPU kernel rusty_sr_tpu/ops/pallas/shuffle.py::
// _row_slice_kernel (launched by depth_to_space_pallas).  On the fused path
// the addend is the LR-space bilinear base, so one pass computes
// depth_to_space(base + expand) and the (B, S, S, f^2 C) sum never goes to
// device memory; the bilinear mode rearranges its u8 result with it.  The
// add is one f32 add per element, the same as the plain
// depth_to_space(x + addend), so the result is byte-identical to it.
//
// What bounds it: device-memory bandwidth.  It does no arithmetic beyond
// the add; at factor 3 in f32 an LR pixel costs 108 bytes read from x,
// 108 read from the addend and 108 written.  On an H100 it moves the
// 455 MB of 24 tiles of 242^2 in 0.25-0.28 ms (1.6-1.8 TB/s, about half
// the HBM peak): its 36-byte input runs use the 32-byte sectors poorly.
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

// rows = N*f*H output rows of f*W*C elements each.
template <class T, bool ADD>
__global__ void __launch_bounds__(D2S_THREADS)
d2s_kernel(const T* __restrict__ x, const float* __restrict__ addend,
           T* __restrict__ out, int rows, int h, int w, int c, int f) {
  const int fc = f * c;
  const int rowlen = w * fc;       // elements of one output row
  const int fh = f * h;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int img = row / fh;
    const int yy = row - img * fh;
    const int y = yy / f;
    const int fy = yy - y * f;
    // x[img][y][0][fy*fC]: the run of LR pixel 0 for this output row.
    const size_t in0 = ((size_t)img * h + y) * w * f * fc + (size_t)fy * fc;
    T* orow = out + (size_t)row * rowlen;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < rowlen;
         j += gridDim.x * blockDim.x) {
      const int px = j / fc;                 // LR column
      const size_t src = in0 + (size_t)px * f * fc + (j - px * fc);
      if constexpr (ADD)
        orow[j] = x[src] + addend[src];
      else
        orow[j] = x[src];
    }
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <class T, bool ADD>
int launch_d2s(const T* x, const float* addend, T* out, int n, int h, int w,
               int c, int f, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || f < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * f * h;
  const long long rowlen = (long long)w * f * c;
  if (rows > 0x7fffffffLL || rowlen > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long bx = (rowlen + D2S_THREADS - 1) / D2S_THREADS;
  const dim3 grid((unsigned)(bx < 0x7fffffffLL ? bx : 0x7fffffffLL),
                  (unsigned)(rows < 65535 ? rows : 65535));
  d2s_kernel<T, ADD><<<grid, D2S_THREADS, 0, (cudaStream_t)stream>>>(
      x, addend, out, (int)rows, h, w, c, f);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, h, w, f*f*c) f32 -> out (n, f*h, f*w, c); addend may be null.
extern "C" int srt_depth_to_space_f32(const float* x, const float* addend,
                                      float* out, int n, int h, int w, int c,
                                      int f, void* stream) {
  if (addend)
    return launch_d2s<float, true>(x, addend, out, n, h, w, c, f, stream);
  return launch_d2s<float, false>(x, nullptr, out, n, h, w, c, f, stream);
}

// The same for u8, without an addend.
extern "C" int srt_depth_to_space_u8(const unsigned char* x,
                                     unsigned char* out, int n, int h, int w,
                                     int c, int f, void* stream) {
  return launch_d2s<unsigned char, false>(x, nullptr, out, n, h, w, c, f,
                                          stream);
}

#endif  // __CUDACC__
