// Exact top-k over each row of an (M, n) f32 matrix: values descending,
// ties to the lowest index, distinct indices. On the decode path the rows
// are the 2x2 block maxima of the NMS'd x4 heatmaps, (N*17, H/2 * W/2).
//
// Replaces offsetguided_tpu/ops/pallas/topk_pallas.py::topk_pallas (k
// rounds of max, lowest-index argmax, mask-out over one map in VMEM). Where
// that kernel and lax.top_k differ, on -inf inputs whose mask repeats an
// index, this kernel follows lax.top_k: indices are always distinct.
//
// Bound on an H100 SXM: bytes. At fixed height 640 and batch 8 the widest
// input is (136, 320 * 512) f32, 89.1 MB read once (26.6 us at 3.35 TB/s);
// the work is one key build and a few compares per element. A (320, 512)
// map is 640 KB, more than a block's 227 KB of shared memory, so one CTA
// cannot hold a map the way one TPU grid step held it in VMEM. Design
// against that: two launches. The first gives one CTA per (row, tile of
// 2048 elements), reads the tile once with coalesced loads into 64-bit keys
// in shared memory and selects the tile's k smallest keys (warp-level
// rounds, topk_select.cuh); the second merges each row's tile lists. Exact
// by the segment argument: a row's top-k key is a top-k key of its tile.
// The output value is read back from the input at the chosen index, so
// -0.0 and NaN payloads come out bit-equal to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;                  // elements per CTA of launch 1
constexpr int PER_THREAD = TILE / THREADS;

__global__ void __launch_bounds__(THREADS)
topk_tile_kernel(const float* __restrict__ x, int n, int k,
                 unsigned long long* __restrict__ cand) {
  __shared__ unsigned long long keys[TILE];
  __shared__ unsigned long long wcand[TILE];
  const int tile = blockIdx.x, row = blockIdx.y;
  const size_t base = (size_t)row * n;
  const int t0 = tile * TILE;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = t0 + q * THREADS + threadIdx.x;
    keys[q * THREADS + threadIdx.x] =
        i < n ? og::make_key(__ldg(x + base + i), (uint32_t)i) : og::KEY_NONE;
  }
  __syncthreads();
  og::block_select(keys, TILE / (THREADS / 32), k, wcand,
                   cand + ((size_t)row * gridDim.x + tile) * k);
}

// One CTA per row: the k smallest of its tiles' keys. Dynamic shared
// memory: (THREADS/32 + 1) * k keys.
__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(const float* __restrict__ x, int n,
                  const unsigned long long* __restrict__ cand, int n_cand,
                  int k, float* __restrict__ vals, int* __restrict__ inds) {
  extern __shared__ unsigned long long wc[];
  unsigned long long* best = wc + (THREADS / 32) * k;
  const int row = blockIdx.x;
  og::merge_select(cand + (size_t)row * n_cand, n_cand, k, wc, best);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const uint32_t i = og::key_index(best[r]);
    vals[(size_t)row * k + r] = x[(size_t)row * n + i];
    inds[(size_t)row * k + r] = (int)i;
  }
}

}  // namespace

extern "C" {

// Number of tiles per row; the caller sizes `cand` as M * tiles * k keys.
int og_topk_tiles(int n) { return (n + TILE - 1) / TILE; }

// x (M, n) f32 on the device -> vals (M, k) f32, inds (M, k) i32.
// Requires 0 < k <= min(n, 512) (the merge keeps 9 lists of k keys in
// shared memory).
int og_topk(const float* x, int M, int n, int k, unsigned long long* cand,
            float* vals, int* inds, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = og_topk_tiles(n);
  topk_tile_kernel<<<dim3(tiles, M), THREADS, 0, s>>>(x, n, k, cand);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(unsigned long long) * (THREADS / 32 + 1) * k;
  topk_merge_kernel<<<M, THREADS, smem, s>>>(x, n, cand, tiles * k, k, vals,
                                             inds);
  return (int)cudaGetLastError();
}

}  // extern "C"
