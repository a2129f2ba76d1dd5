// Fused 3x3 peak NMS + exact top-k over each (h, w) f32 map: the NMS keeps
// a cell where it equals the max of its 3x3 window (zero border outside the
// map, so equal neighbours both survive) and zeroes it elsewhere; the top-k
// runs over the flat row-major h*w index, values descending, ties to the
// lowest index.
//
// Replaces offsetguided_tpu/ops/pallas/nms_topk_pallas.py::nms_topk_pallas
// (eight shifted max-compares and k max/argmin/mask rounds over one map in
// VMEM), i.e. lax.top_k(hmp_nms(x).reshape(-1), k).
//
// Bound on an H100 SXM: bytes. On the stride-resolution decode path at
// long edge 640 and batch 8 the input is (136, 160, 160) f32, 13.9 MB read
// once (4.2 us at 3.35 TB/s); the work is nine compares and one key per
// cell. Design against that: two launches, as in topk.cu. The first gives
// one CTA per (32x32-cell tile, map); it loads the tile with a 1-cell halo
// into shared memory once (zeros outside the map, as the zero-padded
// window), computes the NMS there and selects the tile's k smallest keys;
// the NMS'd map never reaches device memory. The second merges each map's
// tile lists and recomputes the NMS value at the k chosen cells, so -0.0
// comes out as the plain version gives it.
//
// NaN: jnp.maximum and F.max_pool2d propagate NaN, so a NaN anywhere in the
// window makes the max NaN and zeroes the cell; fmaxf would drop it, hence
// `nanmax`. Flat indices are row-major over the whole map, never per tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int T = 32;              // tile edge in cells
constexpr int TP = T + 2;          // with the 1-cell halo
constexpr int PER_THREAD = T * T / THREADS;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float at_or_zero(const float* x, int h, int w,
                                            int y, int xx) {
  return (y >= 0 && y < h && xx >= 0 && xx < w) ? __ldg(x + (size_t)y * w + xx)
                                                : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
nms_topk_tile_kernel(const float* __restrict__ maps, int h, int w, int k,
                     unsigned long long* __restrict__ cand) {
  __shared__ float tile[TP][TP + 1];
  __shared__ unsigned long long keys[T * T];
  __shared__ unsigned long long wcand[T * T];
  const int tx = blockIdx.x, ty = blockIdx.y, m = blockIdx.z;
  const int y0 = ty * T, x0 = tx * T;
  const float* x = maps + (size_t)m * h * w;

  for (int e = threadIdx.x; e < TP * TP; e += THREADS) {
    const int r = e / TP, c = e % TP;
    tile[r][c] = at_or_zero(x, h, w, y0 - 1 + r, x0 - 1 + c);
  }
  __syncthreads();

#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int l = q * THREADS + threadIdx.x;
    const int ly = l / T, lx = l % T;
    const int y = y0 + ly, xx = x0 + lx;
    unsigned long long key = og::KEY_NONE;
    if (y < h && xx < w) {
      const float v = tile[ly + 1][lx + 1];
      float mx = v;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) mx = nanmax(mx, tile[ly + dy][lx + dx]);
      key = og::make_key(v == mx ? v : 0.0f, (uint32_t)(y * w + xx));
    }
    keys[l] = key;
  }
  __syncthreads();
  const int tiles = gridDim.x * gridDim.y;
  og::block_select(keys, T * T / (THREADS / 32), k, wcand,
                   cand + ((size_t)m * tiles + (size_t)ty * gridDim.x + tx) * k);
}

// One CTA per map: the k smallest of its tiles' keys, then the NMS value at
// each chosen cell. Dynamic shared memory: (THREADS/32 + 1) * k keys.
__global__ void __launch_bounds__(THREADS)
nms_topk_merge_kernel(const float* __restrict__ maps, int h, int w,
                      const unsigned long long* __restrict__ cand, int n_cand,
                      int k, float* __restrict__ vals, int* __restrict__ inds) {
  extern __shared__ unsigned long long wc[];
  unsigned long long* best = wc + (THREADS / 32) * k;
  const int m = blockIdx.x;
  og::merge_select(cand + (size_t)m * n_cand, n_cand, k, wc, best);
  const float* x = maps + (size_t)m * h * w;
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int i = (int)og::key_index(best[r]);
    const int y = i / w, xx = i % w;
    const float v = x[i];
    float mx = v;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        mx = nanmax(mx, at_or_zero(x, h, w, y + dy, xx + dx));
    vals[(size_t)m * k + r] = v == mx ? v : 0.0f;
    inds[(size_t)m * k + r] = i;
  }
}

}  // namespace

extern "C" {

// Number of tiles per map; the caller sizes `cand` as M * tiles * k keys.
int og_nms_topk_tiles(int h, int w) {
  return ((h + T - 1) / T) * ((w + T - 1) / T);
}

// maps (M, h, w) f32 on the device -> vals (M, k) f32, inds (M, k) i32 flat
// row-major. Requires 0 < k <= min(h * w, 512).
int og_nms_topk(const float* maps, int M, int h, int w, int k,
                unsigned long long* cand, float* vals, int* inds,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((w + T - 1) / T, (h + T - 1) / T, M);
  nms_topk_tile_kernel<<<grid, THREADS, 0, s>>>(maps, h, w, k, cand);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(unsigned long long) * (THREADS / 32 + 1) * k;
  nms_topk_merge_kernel<<<M, THREADS, smem, s>>>(
      maps, h, w, cand, grid.x * grid.y * k, k, vals, inds);
  return (int)cudaGetLastError();
}

}  // extern "C"
