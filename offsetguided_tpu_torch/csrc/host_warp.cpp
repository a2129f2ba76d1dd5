// Host-side bicubic affine warp of uint8 images: the value OpenCV 5.0's
// cv2.warpAffine(src, M, dsize, INTER_CUBIC, BORDER_CONSTANT, border)
// computes, in its operation order (`data/pixels.py::warp_affine_u8` is the
// numpy definition; a CPU test holds the two equal).
//
// Built for the host by the port's build step (`ops/cuda/_build.py`, with
// -ffp-contract=off so that only the fmaf calls below fuse) and called
// through ctypes, which releases the GIL: loader threads and worker
// processes warp in parallel. The body is compiled twice, with the FMA
// instruction set (each fmaf one instruction) and without it (a libm
// call); both round the same, and the CPU picks one at run time.
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

#define OG_INLINE __attribute__((always_inline)) inline

// OpenCV's float32 cubic (A = -0.75) weights of the taps at -1, 0, 1, 2
// for the fraction t in [0, 1).
OG_INLINE void cubic_weights(float t, float w[4]) {
  const float a = -0.75f;
  const float u = 1.f - t;
  const float tt = t * t;
  w[0] = a * (t * (u * u));
  w[1] = __builtin_fmaf(__builtin_fmaf(a + 2.f, t, -(a + 3.f)), tt, 1.f);
  w[3] = a * (u * tt);
  w[2] = ((1.f - w[0]) - w[1]) - w[3];
}

OG_INLINE uint8_t saturate_u8(float v) {
  const float r = std::nearbyintf(v);
  return static_cast<uint8_t>(std::min(std::max(r, 0.f), 255.f));
}

OG_INLINE void warp(const uint8_t* src, int h, int w, int c,
                    const float* inv, const float* border, uint8_t* dst,
                    int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    const float fy = static_cast<float>(y);
    const float row_x = inv[1] * fy + inv[2];
    const float row_y = inv[4] * fy + inv[5];
    for (int x = 0; x < ow; ++x) {
      const float fx = static_cast<float>(x);
      const float sx = inv[0] * fx + row_x;
      const float sy = inv[3] * fx + row_y;
      const float flx = std::floor(sx);
      const float fly = std::floor(sy);
      const long ix = static_cast<long>(
          std::min(std::max(flx, -8.f), static_cast<float>(w + 8))) - 1;
      const long iy = static_cast<long>(
          std::min(std::max(fly, -8.f), static_cast<float>(h + 8))) - 1;
      uint8_t* out = dst + (static_cast<size_t>(y) * ow + x) * c;
      if (ix + 3 < 0 || ix >= w || iy + 3 < 0 || iy >= h) {
        for (int ch = 0; ch < c; ++ch) out[ch] = saturate_u8(border[ch]);
        continue;
      }
      float wx[4], wy[4];
      cubic_weights(sx - flx, wx);
      cubic_weights(sy - fly, wy);
      const bool inside = ix >= 0 && ix + 3 < w && iy >= 0 && iy + 3 < h;
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int i = 0; i < 4; ++i) {
          const long ty = iy + i;
          const bool y_in = ty >= 0 && ty < h;
          float row = 0.f;
          for (int j = 0; j < 4; ++j) {
            const long tx = ix + j;
            const float v = (inside || (y_in && tx >= 0 && tx < w))
                                ? static_cast<float>(src[(ty * w + tx) * c + ch])
                                : border[ch];
            row = j == 0 ? v * wx[0] : __builtin_fmaf(v, wx[j], row);
          }
          acc = i == 0 ? row * wy[0] : __builtin_fmaf(row, wy[i], acc);
        }
        out[ch] = saturate_u8(acc);
      }
    }
  }
}

__attribute__((target("fma"))) void warp_fma(
    const uint8_t* src, int h, int w, int c, const float* inv,
    const float* border, uint8_t* dst, int oh, int ow) {
  warp(src, h, w, c, inv, border, dst, oh, ow);
}

void warp_libm(const uint8_t* src, int h, int w, int c, const float* inv,
               const float* border, uint8_t* dst, int oh, int ow) {
  warp(src, h, w, c, inv, border, dst, oh, ow);
}

}  // namespace

// src: (h, w, c) uint8, row-major; inv: the dst->src matrix (a, b, cc, d,
// e, f) in float32, src_x = a x + (b y + cc), src_y = d x + (e y + f);
// border: c floats; dst: (oh, ow, c) uint8. Returns 0.
extern "C" int og_warp_affine_u8(const uint8_t* src, int h, int w, int c,
                                 const float* inv, const float* border,
                                 uint8_t* dst, int oh, int ow) {
  static const bool has_fma = __builtin_cpu_supports("fma");
  (has_fma ? warp_fma : warp_libm)(src, h, w, c, inv, border, dst, oh, ow);
  return 0;
}
