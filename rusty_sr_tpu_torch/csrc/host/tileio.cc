// Host-side tile I/O for overlap-tile inference (parallel/tiling.py).
//
// The PyTorch port's own copy of the JAX package's tile I/O, built into
// rusty_sr_tpu_torch/_build/host/ by rusty_sr_tpu_torch/utils/native.py.
// The equivalent of the native data-staging layer the reference gets
// from alumina's Rust suppliers (reference src/main.rs:187-188): the Python
// orchestration stays thin while the per-image hot path — building the
// zero-padded / edge-padded / mask tile batches (float32) and scattering
// HR tile results back into the output canvases (any dtype, on several
// threads) — runs as compiled C++ over raw buffers.  Exposed as a plain
// C ABI for ctypes (no pybind11 in this image).
//
// Layout contracts match tiling.py exactly:
//   image:  (H, W, 3) f32 row-major
//   tiles:  (ny*nx, side, side, 3) with side = tile + 2*halo
//   mask:   (ny*nx, side, side, 1)
//   canvas: (crop_h, crop_w, C) — row stride crop_w; ragged right/bottom
//           tile parts beyond the crop are clipped on scatter

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// Gather zero-padded, edge-padded and mask tiles in one pass, for the
// tile index range [t0, t1) of the row-major ny*nx grid — output buffers
// hold (t1-t0) tiles.  Ranged so the tile loops can gather per
// dispatch chunk (O(chunk) host memory at any image size) instead of
// materialising every tile upfront.
// zero semantics: out-of-image texels = 0 (conv Same pad at true border).
// edge semantics: out-of-image texels replicate the nearest edge texel
// (bilinear clamp).  mask: 1 inside the image else 0.
void sr_gather_tiles_range(const float* img, int64_t H, int64_t W,
                           int64_t tile, int64_t halo, int64_t nx,
                           int64_t t0, int64_t t1, float* zero_t,
                           float* edge_t, float* mask_t) {
  const int64_t side = tile + 2 * halo;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t iy = t / nx, ix = t % nx;
    const int64_t y0 = iy * tile - halo, x0 = ix * tile - halo;
    float* zt = zero_t + (t - t0) * side * side * 3;
    float* et = edge_t + (t - t0) * side * side * 3;
    float* mt = mask_t + (t - t0) * side * side;
    for (int64_t r = 0; r < side; ++r) {
      const int64_t yy = y0 + r;
      const bool y_in = yy >= 0 && yy < H;
      const int64_t yc = clampi(yy, 0, H - 1);
      const float* src_row = img + yc * W * 3;
      float* zr = zt + r * side * 3;
      float* er = et + r * side * 3;
      float* mr = mt + r * side;
      // interior columns of this row can be bulk-copied
      const int64_t c_lo = clampi(-x0, 0, side);
      const int64_t c_hi = clampi(W - x0, 0, side);
      if (y_in && c_lo < c_hi) {
        std::memcpy(zr + c_lo * 3, src_row + (x0 + c_lo) * 3,
                    sizeof(float) * 3 * (c_hi - c_lo));
        std::memcpy(er + c_lo * 3, src_row + (x0 + c_lo) * 3,
                    sizeof(float) * 3 * (c_hi - c_lo));
        for (int64_t c = c_lo; c < c_hi; ++c) mr[c] = 1.0f;
      }
      // out-of-image (or out-of-row) columns
      for (int64_t c = 0; c < side; ++c) {
        if (y_in && c >= c_lo && c < c_hi) continue;
        const int64_t xx = x0 + c;
        const int64_t xc = clampi(xx, 0, W - 1);
        zr[c * 3] = zr[c * 3 + 1] = zr[c * 3 + 2] = 0.0f;
        const float* s = src_row + xc * 3;
        er[c * 3] = s[0];
        er[c * 3 + 1] = s[1];
        er[c * 3 + 2] = s[2];
        mr[c] = 0.0f;
      }
    }
  }
}

// Scatter HR tile results into output canvases, byte for byte (any
// dtype).  `runs` holds n_runs records of 7 int64 each:
//   j0, count, start, nx, crop_h, crop_w, canvas address
// — results tiles [j0, j0 + count) are tiles start.. of that canvas's
// row-major grid of nx columns.  results: (*, tile_f, tile_f) pixels of
// px bytes; canvas: (crop_h, crop_w) pixels of px bytes, row stride
// crop_w; tile rows/cols beyond (crop_h, crop_w) are skipped (ragged
// right/bottom edge tiles).  The tile rows are split evenly over
// `threads` threads, the caller's among them; a thread that cannot be
// started leaves its share to the caller.
void sr_scatter_runs(const uint8_t* results, int64_t tile_f, int64_t px,
                     const int64_t* runs, int64_t n_runs, int64_t threads) {
  struct Piece {
    const uint8_t* src;
    uint8_t* dst;
    int64_t row_bytes, dst_stride;
  };
  std::vector<Piece> pieces;
  std::vector<int64_t> first_row{0};  // prefix sums of the pieces' rows
  const int64_t tile_bytes = tile_f * tile_f * px;
  for (int64_t r = 0; r < n_runs; ++r) {
    const int64_t* run = runs + 7 * r;
    const int64_t j0 = run[0], count = run[1], start = run[2], nx = run[3];
    const int64_t crop_h = run[4], crop_w = run[5];
    uint8_t* canvas = reinterpret_cast<uint8_t*>(run[6]);
    for (int64_t j = 0; j < count; ++j) {
      const int64_t k = start + j;
      const int64_t y_base = (k / nx) * tile_f, x_base = (k % nx) * tile_f;
      const int64_t rows = clampi(crop_h - y_base, 0, tile_f);
      const int64_t cols = clampi(crop_w - x_base, 0, tile_f);
      if (rows == 0 || cols == 0) continue;
      pieces.push_back({results + (j0 + j) * tile_bytes,
                        canvas + (y_base * crop_w + x_base) * px, cols * px,
                        crop_w * px});
      first_row.push_back(first_row.back() + rows);
    }
  }
  const int64_t total = first_row.back();
  const int64_t src_stride = tile_f * px;
  auto copy_rows = [&](int64_t lo, int64_t hi) {  // global rows [lo, hi)
    size_t p = std::upper_bound(first_row.begin(), first_row.end(), lo) -
               first_row.begin() - 1;
    for (int64_t g = lo; g < hi; ++p) {
      const Piece& pc = pieces[p];
      const int64_t end = std::min(hi, first_row[p + 1]);
      for (int64_t r = g - first_row[p]; g < end; ++g, ++r)
        std::memcpy(pc.dst + r * pc.dst_stride, pc.src + r * src_stride,
                    pc.row_bytes);
    }
  };
  const int64_t n = clampi(threads, 1, std::max<int64_t>(total, 1));
  std::vector<std::thread> workers;
  for (int64_t t = 1; t < n; ++t) {
    const int64_t lo = total * t / n, hi = total * (t + 1) / n;
    try {
      workers.emplace_back(copy_rows, lo, hi);
    } catch (...) {
      copy_rows(lo, hi);
    }
  }
  copy_rows(0, total / n);
  for (auto& w : workers) w.join();
}

}  // extern "C"
