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
// the work is one key and a few compares per element. A (320, 512) map is
// 640 KB, more than a block's 227 KB of shared memory, so one CTA cannot hold
// a map the way one TPU grid step held it in VMEM: two launches. The first
// gives one CTA per (row, tile of TILE elements) and selects the tile's k
// smallest 64-bit keys; the second merges each row's tile lists. Exact by
// the segment argument: a row's top-k key is a top-k key of its tile.
//
// The first design (tiles of 2,048 keys in shared memory, k serial warp
// rounds each, O(n * k)) spent 0.48 of its 0.52 ms tile launch selecting
// and 0.04 ms loading (PERF.md, `kernel_phases.py`), and lost to
// torch.topk. Now each thread loads its TILE / 256 values with 16-byte
// loads where the row allows it (n % 4 == 0 and a 16-byte aligned base;
// else 4-byte loads) and keeps only their keys' high words, in shared
// memory (in registers they cost the occupancy that hides each CTA's chain
// of selection barriers); the selection is the linear-time radix select of
// topk_select.cuh. Larger tiles cut the merge's input (tiles * k keys per
// row), smaller ones put more CTAs in flight: TILE = 4096 measured faster
// than 2048 and 8192 (PERF.md).
// The output value is read back from the input at the chosen index, so
// -0.0 and NaN payloads come out bit-equal to the plain version.
// k is bounded by shared memory only: a tile selects min(k, TILE) keys and
// pads its list with KEY_NONE, and both launches keep their selection
// scratch in dynamic shared memory (`og_topk_smem_bytes`).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int THREADS = og::SELECT_THREADS;
constexpr int TILE = 4096;                  // elements per CTA of launch 1
constexpr int PER = TILE / THREADS;         // keys a thread
// static shared bytes of each launch: the tile's high words, and each
// launch's og::SelectShared
constexpr int TILE_STATIC = TILE * 4 + og::SELECT_SHARED_BYTES;
constexpr int MERGE_STATIC = og::SELECT_SHARED_BYTES;

// Dynamic shared bytes of each launch at k: the tile's selection scratch
// (it selects min(k, TILE) keys), the merge's scratch and its k winners.
size_t tile_dynamic(int k) {
  return sizeof(unsigned long long) * og::win_keys(k < TILE ? k : TILE);
}
size_t merge_dynamic(int k) {
  return sizeof(unsigned long long) * (og::win_keys(k) + k);
}

// Slot 4g + j of thread t is element (g * THREADS + t) * 4 + j of the
// tile: one float4 load where VEC (n % 4 == 0, 16-byte aligned rows), else
// four 4-byte loads.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
topk_tile_kernel(const float* __restrict__ x, int n, int k,
                 unsigned long long* __restrict__ cand) {
  __shared__ uint4 hs[TILE / 4];
  extern __shared__ unsigned long long win[];   // tile_dynamic(k)
  const int tile = blockIdx.x, row = blockIdx.y;
  const float* xr = x + (size_t)row * n;
  const int t0 = tile * TILE;
#pragma unroll
  for (int g = 0; g < PER / 4; ++g) {
    const int i = t0 + (g * THREADS + (int)threadIdx.x) * 4;
    uint4 q;
    if (VEC && i < n) {  // n % 4 == 0: the whole float4 is in the row
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + i));
      q = make_uint4(og::key_hi(v.x), og::key_hi(v.y), og::key_hi(v.z),
                     og::key_hi(v.w));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = i + j < n ? og::key_hi(__ldg(xr + i + j)) : og::FULL;
      q = make_uint4(w[0], w[1], w[2], w[3]);
    }
    hs[g * THREADS + threadIdx.x] = q;   // read back by this thread only
  }
  const og::RowTile<PER> keys{reinterpret_cast<const uint32_t*>(hs),
                              (uint32_t)t0};
  unsigned long long* dst = cand + ((size_t)row * gridDim.x + tile) * k;
  const int kt = k < TILE ? k : TILE;
  og::select_smallest(keys, kt, win, dst);
  for (int i = kt + threadIdx.x; i < k; i += THREADS) dst[i] = og::KEY_NONE;
}

// One CTA per row: the k smallest of its tiles' keys. Dynamic shared
// memory: merge_dynamic(k).
__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(const float* __restrict__ x, int n,
                  const unsigned long long* __restrict__ cand, int n_cand,
                  int k, float* __restrict__ vals, int* __restrict__ inds) {
  extern __shared__ unsigned long long wc[];
  unsigned long long* best = wc + og::win_keys(k);
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

// The larger of the two launches' shared bytes at k (static as the runtime
// reports it, plus dynamic); ops/cuda/topk.py::smem_bytes computes the same.
long long og_topk_smem_bytes(int k) {
  const long long tile =
      og::kernel_smem_bytes(topk_tile_kernel<true>, tile_dynamic(k));
  const long long merge =
      og::kernel_smem_bytes(topk_merge_kernel, merge_dynamic(k));
  if (tile < 0 || merge < 0) return -1;
  return tile > merge ? tile : merge;
}

// x (M, n) f32 on the device -> vals (M, k) f32, inds (M, k) i32.
// Requires 0 < k <= n and og_topk_smem_bytes(k) <= 227 KB; any M >= 1.
int og_topk(const float* x, int M, int n, int k, unsigned long long* cand,
            float* vals, int* inds, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = og_topk_tiles(n);
  const size_t tile_smem = tile_dynamic(k), merge_smem = merge_dynamic(k);
  const bool vec = n % 4 == 0 && ((uintptr_t)x & 15u) == 0;
  cudaError_t err = vec ? og::allow_dynamic_smem(topk_tile_kernel<true>,
                                                 TILE_STATIC, tile_smem)
                        : og::allow_dynamic_smem(topk_tile_kernel<false>,
                                                 TILE_STATIC, tile_smem);
  if (err != cudaSuccess) return (int)err;
  // rows are grid y, at most og::MAX_GRID_YZ a launch: any M in chunks
  for (int m0 = 0; m0 < M; m0 += og::MAX_GRID_YZ) {
    const dim3 grid(tiles, M - m0 < og::MAX_GRID_YZ ? M - m0
                                                    : og::MAX_GRID_YZ);
    const float* xc = x + (size_t)m0 * n;
    unsigned long long* cc = cand + (size_t)m0 * tiles * k;
    if (vec)
      topk_tile_kernel<true><<<grid, THREADS, tile_smem, s>>>(xc, n, k, cc);
    else
      topk_tile_kernel<false><<<grid, THREADS, tile_smem, s>>>(xc, n, k, cc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = og::allow_dynamic_smem(topk_merge_kernel, MERGE_STATIC, merge_smem);
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<M, THREADS, merge_smem, s>>>(x, n, cand, tiles * k, k,
                                                   vals, inds);
  return (int)cudaGetLastError();
}

}  // extern "C"
