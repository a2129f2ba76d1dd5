// Exact top-k selection over 64-bit keys, shared by peaks.cu, topk.cu and
// nms_topk.cu.
//
// A key is the order-mapped value in the high word (ascending key ==
// descending value) and an index in the low word, so "the k smallest keys"
// is "the k largest values, ties to the lowest index" with no tie rule of
// its own. Keys are unique while the indices are. -0.0 ties with +0.0 (as a
// value compare, torch.sort and topk_pallas's max/argmin rounds do; note
// that lax.top_k orders +0.0 first) and every NaN sorts as the largest
// value, as torch.sort(descending=True) and lax.top_k put NaN first.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace og {

constexpr unsigned long long KEY_NONE = ~0ull;

__device__ __forceinline__ unsigned long long make_key(float v, uint32_t idx) {
  uint32_t u = __float_as_uint(v);
  const uint32_t mag = u & 0x7fffffffu;
  if (mag == 0u) u = 0u;                         // -0 -> +0
  else if (mag > 0x7f800000u) u = 0x7fc00000u;   // any NaN -> +NaN
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)(~ord) << 32) | idx;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const uint32_t ord = ~(uint32_t)(key >> 32);
  const uint32_t u = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  return __uint_as_float(u);
}

__device__ __forceinline__ uint32_t key_index(unsigned long long key) {
  return (uint32_t)key;
}

// The k smallest of src[0..n) in ascending order into dst[0..k), padded with
// KEY_NONE. Called by a whole warp; each round is one scan and five
// shuffles, with no block barrier. Keys are unique, so "smallest above the
// previous pick" walks them in order.
__device__ inline void warp_select(const unsigned long long* src, int n, int k,
                                   unsigned long long* dst) {
  const int lane = threadIdx.x & 31;
  unsigned long long last = 0;
  for (int r = 0; r < k; ++r) {
    unsigned long long v = KEY_NONE;
    for (int i = lane; i < n; i += 32) {
      const unsigned long long key = src[i];
      if ((r == 0 || key > last) && key < v) v = key;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long t = __shfl_xor_sync(0xffffffffu, v, o);
      v = t < v ? t : v;
    }
    if (lane == 0) dst[r] = v;
    if (v == KEY_NONE) {  // exhausted: pad the rest
      for (int s = r + 1 + lane; s < k; s += 32) dst[s] = KEY_NONE;
      break;
    }
    last = v;
  }
}

// The k smallest of a block's `n_per_warp * (blockDim.x / 32)` keys in
// shared memory `keys`, ascending, into `dst` (shared or global): each warp
// selects from its slice into `wcand`, then warp 0 selects over those lists
// (exact: a block top-k key is a top-k key of its warp's slice). `wcand`
// holds (blockDim.x / 32) * min(k, n_per_warp) keys. Ends with a barrier.
__device__ inline void block_select(const unsigned long long* keys,
                                    int n_per_warp, int k,
                                    unsigned long long* wcand,
                                    unsigned long long* dst) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int kw = k < n_per_warp ? k : n_per_warp;
  warp_select(keys + warp * n_per_warp, n_per_warp, kw, wcand + warp * kw);
  __syncthreads();
  if (warp == 0) warp_select(wcand, nw * kw, k, dst);
  __syncthreads();
}

// One block's k smallest of `n` keys in global memory `cand` (the per-tile
// lists of one map), into shared `best`: per-warp selections over
// contiguous chunks into `wc` ((blockDim.x / 32) * k keys), then warp 0 over
// their lists. Ends with a barrier.
__device__ inline void merge_select(const unsigned long long* cand, int n,
                                    int k, unsigned long long* wc,
                                    unsigned long long* best) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int chunk = (n + nw - 1) / nw;
  const int lo = warp * chunk < n ? warp * chunk : n;
  const int hi = lo + chunk < n ? lo + chunk : n;
  warp_select(cand + lo, hi - lo, k, wc + warp * k);
  __syncthreads();
  if (warp == 0) warp_select(wc, nw * k, k, best);
  __syncthreads();
}

}  // namespace og
