// Fused peak finding for the x4 upsampled heatmaps: bicubic upsample,
// 3x3 NMS with a zero border, 2x2 block max with a first-wins code, and the
// top-k blocks of every map (value descending, ties to the lowest flat block
// index). The full-resolution map never reaches device memory.
//
// Replaces offsetguided_tpu/ops/pallas/peaks_pallas.py::fused_peaks_topk_pallas
// (and its map-batched form _fused_peaks_batched).
//
// Bound on an H100 SXM: operations. At the main path's shapes (136 maps of
// 160x160, k=32) the kernel reads 13.9 MB (4 us at 3.35 TB/s) but does about
// 25 fp32 operations per full-resolution pixel (separable 4-tap upsample,
// 3x3 max, block compare) over 55.7 M pixels, about 21 us at 67 TFLOP/s.
// Design against that bound: every CTA computes its upsampled tile once in
// shared memory (H pass into `hbuf`, W pass into `up`), so each source value
// is read from L2 a handful of times and no full-resolution value is
// written out; the top-k is a two-launch selection (per tile, then per map)
// over 64-bit keys, exact by the segment argument (a global top-k block is a
// top-k block of its tile). Each selection runs as warp-level rounds (one
// scan + five shuffles per round, no block barrier) over per-warp slices,
// then one warp over the slices' lists (csrc/topk_select.cuh, shared with
// topk.cu and nms_topk.cu).
//
// Bit parity with the plain PyTorch version (ops/resize.py::upsample2d):
// the same term order (H pass then W pass, taps in offset order, zero taps
// skipped) with __fmul_rn/__fadd_rn, so nvcc cannot contract a multiply and
// an add into one FMA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using og::KEY_NONE;
using og::key_value;
using og::make_key;

constexpr int FACTOR = 4;         // upsampling factor (phases per axis)
constexpr int MAX_TAPS = 5;
constexpr int TB = 32;            // tile edge in 2x2 blocks
constexpr int UP = 2 * TB + 2;    // upsampled tile edge incl. 1 px NMS halo
constexpr int UPP = UP + 1;       // padded row pitch
constexpr int HC = 22;            // source columns one tile's W pass reads
constexpr int THREADS = 256;

struct Taps {
  int n[FACTOR];
  int off[FACTOR][MAX_TAPS];
  float w[FACTOR][MAX_TAPS];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floordiv4(int v) { return v >> 2; }  // arithmetic

// One CTA per (tile of TB x TB blocks, map): upsample the tile with its halo,
// NMS, block max, then the tile's k smallest keys into `cand`.
__global__ void __launch_bounds__(THREADS)
peaks_tile_kernel(const float* __restrict__ maps, int h, int w, int k,
                  Taps taps, unsigned long long* __restrict__ cand) {
  __shared__ float hbuf[UP][HC];
  __shared__ float up[UP][UPP];
  __shared__ unsigned long long keys_s[TB * TB];
  __shared__ unsigned long long wcand[TB * TB];

  const int H = h * FACTOR, W = w * FACTOR;
  const int HB = H / 2, WB = W / 2;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int Y0 = 2 * TB * ty, X0 = 2 * TB * tx;  // first full-res px of tile
  const int c0 = floordiv4(X0 - 1) - 2;          // first source column
  const float* x = maps + (size_t)b * h * w;

  // H pass: full-res rows Y0-1 .. Y0+2TB, source columns clamp(c0 + c)
  for (int e = threadIdx.x; e < UP * HC; e += blockDim.x) {
    const int r = e / HC, c = e % HC;
    const int Y = Y0 - 1 + r;
    float acc = 0.0f;
    if (Y >= 0 && Y < H) {
      const int i = floordiv4(Y), p = Y & (FACTOR - 1);
      const int col = clampi(c0 + c, 0, w - 1);
      for (int t = 0; t < taps.n[p]; ++t) {
        const float term = __fmul_rn(
            __ldg(x + (size_t)clampi(i + taps.off[p][t], 0, h - 1) * w + col),
            taps.w[p][t]);
        acc = t == 0 ? term : __fadd_rn(acc, term);
      }
    }
    hbuf[r][c] = acc;
  }
  __syncthreads();

  // W pass; pixels outside the image are the NMS zero border
  for (int e = threadIdx.x; e < UP * UP; e += blockDim.x) {
    const int r = e / UP, c = e % UP;
    const int Y = Y0 - 1 + r, X = X0 - 1 + c;
    float acc = 0.0f;
    if (Y >= 0 && Y < H && X >= 0 && X < W) {
      const int j = floordiv4(X), p = X & (FACTOR - 1);
      for (int t = 0; t < taps.n[p]; ++t) {
        const int cc = clampi(j + taps.off[p][t], 0, w - 1) - c0;
        const float term = __fmul_rn(hbuf[r][cc], taps.w[p][t]);
        acc = t == 0 ? term : __fadd_rn(acc, term);
      }
    }
    up[r][c] = acc;
  }
  __syncthreads();

  // NMS + 2x2 block max per block, one key per block
  constexpr int PER = TB * TB / THREADS;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int lb = threadIdx.x + q * THREADS;
    const int lby = lb / TB, lbx = lb % TB;
    const int by = TB * ty + lby, bx = TB * tx + lbx;
    unsigned long long key = KEY_NONE;
    if (by < HB && bx < WB) {
      float best = 0.0f;
      uint32_t code = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = 1 + 2 * lby + (s >> 1), c = 1 + 2 * lbx + (s & 1);
        const float v = up[r][c];
        float m = v;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, up[r + dy][c + dx]);
        const float nms = (v == m) ? v : 0.0f;
        if (s == 0) {
          best = nms;
        } else if (nms > best) {
          best = nms;
          code = s;
        }
      }
      key = make_key(best, (uint32_t)(by * WB + bx) * 4u + code);
    }
    keys_s[lb] = key;
  }
  __syncthreads();

  // top-k in two warp-level selections: each warp's k smallest of its
  // TB*TB/8 keys, then warp 0 over those 8 lists
  const int tiles = gridDim.x * gridDim.y;
  og::block_select(keys_s, TB * TB / (THREADS / 32), k, wcand,
                   cand + ((size_t)b * tiles + (size_t)ty * gridDim.x + tx) * k);
}

// One CTA per map: the k smallest of its tiles' candidate keys, again as
// per-warp selections over slices and one selection over their lists.
// Dynamic shared memory: (THREADS/32 + 1) * k keys.
__global__ void __launch_bounds__(THREADS)
peaks_merge_kernel(const unsigned long long* __restrict__ cand, int n_cand,
                   int k, int WB, float* __restrict__ vals,
                   int* __restrict__ ys, int* __restrict__ xs) {
  extern __shared__ unsigned long long wc[];
  unsigned long long* best = wc + (THREADS / 32) * k;
  const int b = blockIdx.x;
  og::merge_select(cand + (size_t)b * n_cand, n_cand, k, wc, best);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const unsigned long long key = best[r];
    const uint32_t lo32 = (uint32_t)key;
    const uint32_t gb = lo32 >> 2, code = lo32 & 3u;
    vals[(size_t)b * k + r] = key_value(key);
    ys[(size_t)b * k + r] = 2 * (int)(gb / WB) + (int)(code >> 1);
    xs[(size_t)b * k + r] = 2 * (int)(gb % WB) + (int)(code & 1u);
  }
}

}  // namespace

extern "C" {

// Number of tiles per map; the caller sizes `cand` as B * tiles * k keys.
int og_peaks_tiles(int h, int w) {
  const int HB = 2 * h, WB = 2 * w;
  return ((HB + TB - 1) / TB) * ((WB + TB - 1) / TB);
}

// maps (B, h, w) f32 -> vals (B, k) f32, ys/xs (B, k) i32 at full resolution.
// k <= 512 (the merge kernel keeps 9 lists of k keys in shared memory).
// tap_n (4), tap_off (4x5), tap_w (4x5) are HOST arrays: the phase table.
int og_peaks_topk(const float* maps, int B, int h, int w, int k,
                  const int* tap_n, const int* tap_off, const float* tap_w,
                  unsigned long long* cand, float* vals, int* ys, int* xs,
                  void* stream) {
  Taps taps;
  for (int p = 0; p < FACTOR; ++p) {
    taps.n[p] = tap_n[p];
    for (int t = 0; t < MAX_TAPS; ++t) {
      taps.off[p][t] = tap_off[p * MAX_TAPS + t];
      taps.w[p][t] = tap_w[p * MAX_TAPS + t];
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int HB = 2 * h, WB = 2 * w;
  dim3 grid((WB + TB - 1) / TB, (HB + TB - 1) / TB, B);
  peaks_tile_kernel<<<grid, THREADS, 0, s>>>(maps, h, w, k, taps, cand);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t merge_smem = sizeof(unsigned long long) * (THREADS / 32 + 1) * k;
  peaks_merge_kernel<<<B, THREADS, merge_smem, s>>>(
      cand, grid.x * grid.y * k, k, WB, vals, ys, xs);
  return (int)cudaGetLastError();
}

}  // extern "C"
