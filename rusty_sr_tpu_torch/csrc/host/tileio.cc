// Host-side tile I/O for overlap-tile inference (parallel/tiling.py).
//
// The PyTorch port's own copy of the JAX package's tile I/O, built into
// rusty_sr_tpu_torch/_build/host/ by rusty_sr_tpu_torch/utils/native.py.
// The equivalent of the native data-staging layer the reference gets
// from alumina's Rust suppliers (reference src/main.rs:187-188): the Python
// orchestration stays thin while the per-image hot path — building the
// zero-padded / edge-padded / mask tile batches and scattering HR tile
// results back into the output canvas — runs as compiled C++ over raw
// float32 buffers.  Exposed as a plain C ABI for ctypes (no pybind11 in
// this image).
//
// Layout contracts match tiling.py exactly:
//   image:  (H, W, 3) f32 row-major
//   tiles:  (ny*nx, side, side, 3) with side = tile + 2*halo
//   mask:   (ny*nx, side, side, 1)
//   canvas: (crop_h, crop_w, 3) — row stride crop_w; ragged right/bottom
//           tile parts beyond the crop are clipped on scatter

#include <algorithm>
#include <cstdint>
#include <cstring>

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

// Scatter a chunk of HR tile results into the output canvas.
// results: (count, tile_f, tile_f, 3); canvas: (crop_h, crop_w, 3) —
// the row stride IS crop_w (every caller allocates the crop-sized
// canvas); tile rows/cols beyond (crop_h, crop_w) are skipped (ragged
// right/bottom edge tiles).
void sr_scatter_tiles(const float* results, int64_t count, int64_t start,
                      int64_t nx, int64_t tile_f, float* canvas,
                      int64_t crop_h, int64_t crop_w) {
  for (int64_t j = 0; j < count; ++j) {
    const int64_t k = start + j;
    const int64_t iy = k / nx, ix = k % nx;
    const float* src = results + j * tile_f * tile_f * 3;
    const int64_t y_base = iy * tile_f, x_base = ix * tile_f;
    const int64_t rows = clampi(crop_h - y_base, 0, tile_f);
    const int64_t cols = clampi(crop_w - x_base, 0, tile_f);
    for (int64_t r = 0; r < rows; ++r) {
      std::memcpy(canvas + ((y_base + r) * crop_w + x_base) * 3,
                  src + r * tile_f * 3, sizeof(float) * 3 * cols);
    }
  }
}

}  // extern "C"
