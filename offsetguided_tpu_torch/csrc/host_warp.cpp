// Host-side bicubic affine warp and resize of uint8 images: the values
// OpenCV 5.0's cv2.warpAffine(src, M, dsize, INTER_CUBIC, BORDER_CONSTANT,
// border) and cv2.resize(src, dsize, interpolation=INTER_CUBIC) compute, in
// their operation order (`data/pixels.py::warp_affine_u8` and
// `resize_cubic_u8` are the numpy definitions; CPU tests hold each pair
// equal).
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
#include <new>
#include <vector>

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

// The cubic kernel (A = -0.75) at 0 <= t <= 2, in double precision.
OG_INLINE double keys(double t) {
  const double a = -0.75;
  return t <= 1 ? ((a + 2) * t - (a + 3)) * t * t + 1
                : ((a * t - 5 * a) * t + 8 * a) * t - 4 * a;
}

// One axis of the resize: output i reads the source at (i + 0.5) * n_in /
// n_out - 0.5; its fraction, rounded to float32 and then to a multiple of
// 2^-23, gives the four float32 weights of the taps first[i] + 0..3
// (clamped to the source by the caller).
void resize_taps(int n_in, int n_out, int* first, float* wt) {
  const double s = static_cast<double>(n_in) / n_out;
  for (int i = 0; i < n_out; ++i) {
    const double pos = (i + 0.5) * s - 0.5;
    const double lo = std::floor(pos);
    double t = static_cast<float>(pos - lo);
    t = std::nearbyint(t * 8388608.0) * (1.0 / 8388608.0);
    first[i] = static_cast<int>(lo) - 1;
    wt[4 * i] = static_cast<float>(keys(t + 1));
    wt[4 * i + 1] = static_cast<float>(keys(t));
    wt[4 * i + 2] = static_cast<float>(keys(1 - t));
    wt[4 * i + 3] = static_cast<float>(keys(2 - t));
  }
}

OG_INLINE int clamp_tap(int i, int n) { return std::min(std::max(i, 0), n - 1); }

// Rows first, into float32 (three channels: an fma chain left to right;
// one channel: the rounded products summed in pairs), then the columns,
// fma(v0, w0, v1 w1) + fma(v2, w2, v3 w3), rounded half to even.
OG_INLINE void resize(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                      int oh, int ow, const int* fx, const float* wx,
                      const int* fy, const float* wy, float* rows) {
  const size_t rw = static_cast<size_t>(ow) * c;
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = src + static_cast<size_t>(y) * w * c;
    float* out = rows + y * rw;
    for (int x = 0; x < ow; ++x) {
      const float* k = wx + 4 * x;
      int tap[4];
      for (int j = 0; j < 4; ++j) tap[j] = clamp_tap(fx[x] + j, w) * c;
      for (int ch = 0; ch < c; ++ch) {
        float v[4];
        for (int j = 0; j < 4; ++j) v[j] = static_cast<float>(in[tap[j] + ch]);
        float r;
        if (c == 3) {
          r = v[0] * k[0];
          for (int j = 1; j < 4; ++j) r = __builtin_fmaf(v[j], k[j], r);
        } else {
          const float p0 = v[0] * k[0], p1 = v[1] * k[1];
          const float p2 = v[2] * k[2], p3 = v[3] * k[3];
          r = (p0 + p1) + (p2 + p3);
        }
        out[x * c + ch] = r;
      }
    }
  }
  for (int y = 0; y < oh; ++y) {
    const float* k = wy + 4 * y;
    const float* r[4];
    for (int i = 0; i < 4; ++i) r[i] = rows + clamp_tap(fy[y] + i, h) * rw;
    uint8_t* out = dst + y * rw;
    for (size_t i = 0; i < rw; ++i) {
      const float p1 = r[1][i] * k[1], p3 = r[3][i] * k[3];
      out[i] = saturate_u8(__builtin_fmaf(r[0][i], k[0], p1) +
                           __builtin_fmaf(r[2][i], k[2], p3));
    }
  }
}

__attribute__((target("fma"))) void resize_fma(
    const uint8_t* src, int h, int w, int c, uint8_t* dst, int oh, int ow,
    const int* fx, const float* wx, const int* fy, const float* wy,
    float* rows) {
  resize(src, h, w, c, dst, oh, ow, fx, wx, fy, wy, rows);
}

void resize_libm(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                 int oh, int ow, const int* fx, const float* wx,
                 const int* fy, const float* wy, float* rows) {
  resize(src, h, w, c, dst, oh, ow, fx, wx, fy, wy, rows);
}

}  // namespace

// src: (h, w, c) uint8, row-major, c 1 or 3; dst: (oh, ow, c) uint8.
// Returns 0, 1 for bad arguments, 2 when the row buffer cannot be had.
extern "C" int og_resize_cubic_u8(const uint8_t* src, int h, int w, int c,
                                  uint8_t* dst, int oh, int ow) {
  if ((c != 1 && c != 3) || h < 1 || w < 1 || oh < 1 || ow < 1) return 1;
  static const bool has_fma = __builtin_cpu_supports("fma");
  try {
    std::vector<int> fx(ow), fy(oh);
    std::vector<float> wx(4 * static_cast<size_t>(ow)),
        wy(4 * static_cast<size_t>(oh)),
        rows(static_cast<size_t>(h) * ow * c);
    resize_taps(w, ow, fx.data(), wx.data());
    resize_taps(h, oh, fy.data(), wy.data());
    (has_fma ? resize_fma : resize_libm)(src, h, w, c, dst, oh, ow,
                                         fx.data(), wx.data(), fy.data(),
                                         wy.data(), rows.data());
  } catch (const std::bad_alloc&) {
    return 2;
  }
  return 0;
}

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
