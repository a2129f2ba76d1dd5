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
//
// Bound on an H100: instructions and barriers, not bytes: a tile's keys are
// on chip (registers or shared memory) when the selection starts. The first
// design translated the TPU kernels' k max/argmax/mask rounds: each warp
// made k serial rounds over its slice (a rescan plus five 64-bit shuffles
// per round), then warp 0 alone made k more over the warps' lists while
// seven warps waited: O(n * k) work per tile, most of the top-k kernel's
// time and a quarter of the peaks kernel's (PERF.md). This selection is a
// block-wide radix select, linear in n:
//   1. up to four passes over the high word's 8-bit digits, most
//      significant first: a shared histogram of the candidates' digit (a
//      thread counts a run of equal digits in a register and a warp adds
//      the runs that share a digit in one atomic, so a run of equal values,
//      such as the zeros NMS leaves, costs one atomic a warp, not one a
//      key), then warp 0 alone scans the 256 bins and finds the one that
//      holds the k-th key: two barriers a pass. The search stops when a bin
//      holds exactly the keys still needed, or, checked after the first
//      pass, when all of the bin's keys share one high word (a threshold
//      inside a run of equal values, the common case after NMS);
//   2. keys tied on the threshold's high word are resolved by their index:
//      in a tile whose slot order is index order (`block_select`, topk.cu's
//      row tile) by a prefix count in that order; in the merge, whose
//      concatenated tile lists interleave indices, by up to four more digit
//      passes over the low word;
//   3. the k winners are compacted, one shared atomic each;
//   4. and sorted: one warp's bitonic network for k <= 32, else a
//      shared-memory bitonic sort over every thread, of the next power of
//      two >= k keys (`win_keys(k)`).
// Work per tile: O(n) per pass for at most 8 passes, plus O(k log^2 k) for
// the sort. No k-round rescan is left. k has no fixed limit: each caller
// keeps its `win_keys(k)` keys of scratch in dynamic shared memory, so k is
// bounded by the 227 KB a block can have (the wrappers compute the bytes).
#pragma once

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace og {

constexpr unsigned long long KEY_NONE = ~0ull;
constexpr int SELECT_THREADS = 256;   // every selecting block: one bin a thread
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// Keys of scratch the selection of k keys needs (`win` of select_smallest):
// k for the warp sort (k <= 32), else the next power of two >= max(k, 64).
__host__ __device__ constexpr int win_keys(int k) {
  int p = 64;
  while (p < k) p <<= 1;
  return k <= 32 ? k : p;
}

// Bytes of og::SelectShared, the static shared memory of every selecting
// block (the wrappers add it to each kernel's dynamic bytes).
constexpr int SELECT_SHARED_BYTES = 1056;

// The most blocks a launch can have along grid y or z; the launchers loop
// over chunks of maps this size.
constexpr int MAX_GRID_YZ = 65535;

__device__ __forceinline__ unsigned long long make_key(float v, uint32_t idx) {
  uint32_t u = __float_as_uint(v);
  const uint32_t mag = u & 0x7fffffffu;
  if (mag == 0u) u = 0u;                         // -0 -> +0
  else if (mag > 0x7f800000u) u = 0x7fc00000u;   // any NaN -> +NaN
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)(~ord) << 32) | idx;
}

// The high word of make_key(v, .); never 0xffffffff (KEY_NONE's).
__device__ __forceinline__ uint32_t key_hi(float v) {
  return (uint32_t)(make_key(v, 0u) >> 32);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const uint32_t ord = ~(uint32_t)(key >> 32);
  const uint32_t u = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  return __uint_as_float(u);
}

__device__ __forceinline__ uint32_t key_index(unsigned long long key) {
  return (uint32_t)key;
}

struct __align__(16) SelectShared {
  unsigned hist[SELECT_THREADS];   // digit histogram, then prefix counts
  unsigned bin, below, in_bin;     // the last pass's threshold bin
  unsigned wmin, wmax;             // its candidates' words (settle_if_equal)
  unsigned cursor;                 // compaction
};

static_assert(sizeof(SelectShared) == SELECT_SHARED_BYTES,
              "SELECT_SHARED_BYTES, and the wrappers' copies of it");

__device__ __forceinline__ SelectShared& select_shared() {
  __shared__ SelectShared s;
  return s;
}

// Warp 0 alone: lane l reads a[8l..8l+7] (two 16-byte loads) into c[] and
// gets each entry's exclusive prefix sum over a[0..256) in ex[], so a scan
// needs no barrier of its own.
__device__ __forceinline__ void warp_scan_256(const unsigned* a,
                                              unsigned (&c)[8],
                                              unsigned (&ex)[8]) {
  static_assert(SELECT_THREADS == 8 * 32, "one warp scans 8 entries a lane");
  const int lane = threadIdx.x & 31;
  const uint4 q0 = reinterpret_cast<const uint4*>(a)[2 * lane];
  const uint4 q1 = reinterpret_cast<const uint4*>(a)[2 * lane + 1];
  c[0] = q0.x; c[1] = q0.y; c[2] = q0.z; c[3] = q0.w;
  c[4] = q1.x; c[5] = q1.y; c[6] = q1.z; c[7] = q1.w;
  unsigned sum = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ex[i] = sum;
    sum += c[i];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) ex[i] += incl - sum;
}

// Warp 0 alone: a[8l..8l+7] = v[0..8) for lane l.
__device__ __forceinline__ void warp_store_256(unsigned* a,
                                               const unsigned (&v)[8]) {
  const int lane = threadIdx.x & 31;
  reinterpret_cast<uint4*>(a)[2 * lane] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(a)[2 * lane + 1] =
      make_uint4(v[4], v[5], v[6], v[7]);
}

// hist[d] += c, the lanes that share the first counting lane's digit in
// one atomic, the others one each. Warp-collective.
__device__ __forceinline__ void add_count(unsigned* hist, unsigned d,
                                          unsigned c) {
  const unsigned any = __ballot_sync(FULL, c != 0u);
  if (any == 0u) return;
  const int lead = __ffs(any) - 1;
  const unsigned d0 = __shfl_sync(FULL, d, lead);
  const bool same = c != 0u && d == d0;
  const unsigned sum = __reduce_add_sync(FULL, same ? c : 0u);
  if ((int)(threadIdx.x & 31) == lead) atomicAdd(&hist[d0], sum);
  else if (c != 0u && !same) atomicAdd(&hist[d], c);
}

// One 8-bit digit of a radix select over the words that `cand(s, w)` yields
// for this thread's slots: counts the digit at `shift` of the candidates that
// match (prefix, mask), then narrows (prefix, mask) to the bin that holds the
// need-th smallest and leaves in `need` how many of that bin are still
// needed. `exact` when the bin holds just that many. `hist` is zero on entry
// and on exit; two barriers.
template <class Src, class Cand>
__device__ __forceinline__ void radix_pass(const Src& src, Cand cand, int shift,
                                           uint32_t& prefix, uint32_t& mask,
                                           unsigned& need, bool& exact) {
  SelectShared& sh = select_shared();
  // a thread's run of equal digits is counted in a register and added at
  // its end, so a run of equal values costs one atomic a warp, not a slot
  unsigned run_d = 0u, run_c = 0u;
  src.for_slots([&](int s) {
    uint32_t w = 0u;
    if (cand(s, w) && (w & mask) == prefix) {
      const unsigned d = (w >> shift) & 0xffu;
      if (d != run_d && run_c != 0u) {
        atomicAdd(&sh.hist[run_d], run_c);
        run_c = 0u;
      }
      run_d = d;
      ++run_c;
    }
  });
  add_count(sh.hist, run_d, run_c);
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned c[8], ex[8];
    warp_scan_256(sh.hist, c, ex);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (ex[i] < need && need <= ex[i] + c[i]) {
        sh.bin = 8 * threadIdx.x + i;
        sh.below = ex[i];
        sh.in_bin = c[i];
      }
    const unsigned zero[8] = {};
    warp_store_256(sh.hist, zero);
  }
  __syncthreads();
  prefix |= sh.bin << shift;
  mask |= 0xffu << shift;
  need -= sh.below;
  exact = sh.in_bin == need;
}

// After the first pass: if every candidate left in the bin has the same
// word (the common case of a threshold inside a run of equal values, such
// as the zeros NMS leaves), the word is the threshold and the rest of its
// passes are skipped. One slot loop, a min and a max.
template <class Src, class Cand>
__device__ __forceinline__ void settle_if_equal(const Src& src, Cand cand,
                                                uint32_t& prefix,
                                                uint32_t& mask) {
  SelectShared& sh = select_shared();
  uint32_t lo = FULL, hi = 0u;
  src.for_slots([&](int s) {
    uint32_t w = 0u;
    if (cand(s, w) && (w & mask) == prefix) {
      lo = w < lo ? w : lo;
      hi = w > hi ? w : hi;
    }
  });
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&sh.wmin, lo);
    atomicMax(&sh.wmax, hi);
  }
  __syncthreads();
  if (sh.wmin == sh.wmax) {
    prefix = sh.wmin;
    mask = FULL;
  }
}

// Appends a winner to win[] (at most k of them a block: one atomic each).
__device__ __forceinline__ void emit(unsigned long long key,
                                     unsigned long long* win) {
  win[atomicAdd(&select_shared().cursor, 1u)] = key;
}

// win[0..k) ascending into dst[0..k). `win` holds at least the next power of
// two >= k keys. Ends with a barrier.
__device__ inline void sort_into(unsigned long long* win, int k,
                                 unsigned long long* dst) {
  if (k <= 32) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      unsigned long long v = lane < k ? win[lane] : KEY_NONE;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const unsigned long long o = __shfl_xor_sync(FULL, v, stride);
          const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
          v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
        }
      if (lane < k) dst[lane] = v;
    }
    __syncthreads();
    return;
  }
  int p = 64;
  while (p < k) p <<= 1;
  for (int i = k + threadIdx.x; i < p; i += blockDim.x) win[i] = KEY_NONE;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = 2 * stride * (i / stride) + (i % stride);
        const unsigned long long a = win[lo], b = win[lo + stride];
        if ((a > b) == ((lo & size) == 0)) {
          win[lo] = b;
          win[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  for (int i = threadIdx.x; i < k; i += blockDim.x) dst[i] = win[i];
  __syncthreads();
}

// The k smallest keys of a block's slots, ascending, into dst[0..k), with
// `win` (win_keys(k) keys) as scratch; the slots hold at least k valid
// keys. dst may alias the slots' keys (they are read before dst is written). `Src` gives each
// thread's slots: for_slots(f), valid(s), hi(s), key(s), and
// BY_POSITION: if true, slot s = g * V + j of thread t lies at position
// (g * SELECT_THREADS + t) * V + j of the tile, and position order is index
// order, so keys tied on the high word go by position; SLOTS is then a
// constant. Padding slots are valid KEY_NONE keys (they come out after every
// real key); invalid slots are no keys at all. Ends with a barrier.
template <class Src>
__device__ void select_smallest(const Src& src, int k, unsigned long long* win,
                                unsigned long long* dst) {
  SelectShared& sh = select_shared();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sh.hist[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    sh.cursor = 0u;
    sh.wmin = FULL;
    sh.wmax = 0u;
  }
  __syncthreads();
  uint32_t phi = 0u, mhi = 0u;
  unsigned need = (unsigned)k;
  bool exact = false;
  const auto hi_word = [&](int s, uint32_t& w) {
    w = src.hi(s);
    return src.valid(s);
  };
  for (int shift = 24; shift >= 0 && !exact && mhi != FULL; shift -= 8) {
    radix_pass(src, hi_word, shift, phi, mhi, need, exact);
    if (shift == 24 && !exact) settle_if_equal(src, hi_word, phi, mhi);
  }

  if constexpr (Src::BY_POSITION) {
    constexpr int V = Src::V, G = Src::SLOTS / V;
    static_assert(G * SELECT_WARPS <= SELECT_THREADS, "too many slot groups");
    // rank of each key tied at phi, in position order: warp-exclusive counts
    // per slot group (ballots of the count's bits), then warp 0's scan over
    // (group, warp) in the zeroed histogram
    unsigned ex[G] = {};
    if (!exact) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        unsigned cnt = 0u;
#pragma unroll
        for (int j = 0; j < V; ++j) cnt += src.hi(g * V + j) == phi ? 1u : 0u;
        unsigned e = 0u;
#pragma unroll
        for (int b = 0; (1 << b) <= V; ++b)
          e += (unsigned)__popc(__ballot_sync(FULL, (cnt >> b) & 1u) &
                                ((1u << lane) - 1u)) << b;
        ex[g] = e;
        if (lane == 31) sh.hist[g * SELECT_WARPS + warp] = e + cnt;
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        unsigned c[8], ex8[8];
        warp_scan_256(sh.hist, c, ex8);
        warp_store_256(sh.hist, ex8);
      }
      __syncthreads();
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      unsigned rank = exact ? 0u : sh.hist[g * SELECT_WARPS + warp] + ex[g];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int s = g * V + j;
        const uint32_t hm = src.hi(s) & mhi;
        if (hm < phi || (hm == phi && (exact || rank < need)))
          emit(src.key(s), win);
        rank += hm == phi ? 1u : 0u;
      }
    }
  } else {
    // the merge: resolve a tie on the high word by the low word's digits
    uint32_t plo = 0u, mlo = 0u;
    const bool tie = !exact;
    if (tie) {
      bool done = false;
      for (int shift = 24; shift >= 0 && !done; shift -= 8)
        radix_pass(src, [&](int s, uint32_t& w) {
                     const unsigned long long key = src.key(s);
                     w = (uint32_t)key;
                     return src.valid(s) && (uint32_t)(key >> 32) == phi;
                   }, shift, plo, mlo, need, done);
      exact = done;
    }
    src.for_slots([&](int s) {
      const unsigned long long key = src.key(s);
      const uint32_t hm = (uint32_t)(key >> 32) & mhi, l = (uint32_t)key & mlo;
      if (src.valid(s) &&
          (hm < phi || (hm == phi && (!tie ? exact
                                      : (l < plo || (exact && l == plo))))))
        emit(key, win);
    });
    if (!exact) {  // equal keys (KEY_NONE padding) fill the rest
      __syncthreads();
      const unsigned c = sh.cursor;
      for (unsigned i = c + threadIdx.x; i < (unsigned)k; i += blockDim.x)
        win[i] = ((unsigned long long)phi << 32) | plo;
    }
  }
  __syncthreads();
  sort_into(win, k, dst);
}

// A tile's keys in shared memory, four slots a thread, position order =
// array order (= index order, asserted).
struct SharedTile {
  static constexpr bool BY_POSITION = true;
  static constexpr int SLOTS = 4, V = 1;
  unsigned long long k_[SLOTS];
  __device__ SharedTile(const unsigned long long* keys, int n) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int p = s * SELECT_THREADS + threadIdx.x;
      k_[s] = p < n ? keys[p] : KEY_NONE;
      assert(p == 0 || p >= n || k_[s] == KEY_NONE || keys[p - 1] == KEY_NONE ||
             (uint32_t)k_[s] > (uint32_t)keys[p - 1]);
    }
  }
  template <class F> __device__ __forceinline__ void for_slots(F f) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) f(s);
  }
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ uint32_t hi(int s) const { return (uint32_t)(k_[s] >> 32); }
  __device__ __forceinline__ unsigned long long key(int s) const { return k_[s]; }
};

// A row tile of PER values a thread as high words in shared memory: slot
// 4g + j of thread t is position (g * SELECT_THREADS + t) * 4 + j, word p of
// `h`, whose four words a thread reads as one 16-byte load; a slot's index
// is `base` plus its position. High word 0xffffffff is padding.
template <int PER>
struct RowTile {
  static constexpr bool BY_POSITION = true;
  static constexpr int SLOTS = PER, V = 4;
  const uint32_t* h;
  uint32_t base;
  template <class F> __device__ __forceinline__ void for_slots(F f) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) f(s);
  }
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ uint32_t hi(int s) const {
    const uint4 q = reinterpret_cast<const uint4*>(h)[(s / V) * SELECT_THREADS +
                                                      threadIdx.x];
    return s % V == 0 ? q.x : s % V == 1 ? q.y : s % V == 2 ? q.z : q.w;
  }
  __device__ __forceinline__ unsigned long long key(int s) const {
    const uint32_t w = hi(s);
    const uint32_t pos = ((s / V) * SELECT_THREADS + threadIdx.x) * V + s % V;
    return w == FULL ? KEY_NONE : ((unsigned long long)w << 32) | (base + pos);
  }
};

// n keys in shared memory in any order, read again on every pass.
struct SharedKeys {
  static constexpr bool BY_POSITION = false;
  const unsigned long long* keys;
  int n, slots;
  __device__ SharedKeys(const unsigned long long* c, int n_)
      : keys(c), n(n_), slots((n_ + SELECT_THREADS - 1) / SELECT_THREADS) {}
  template <class F> __device__ __forceinline__ void for_slots(F f) const {
    for (int s = 0; s < slots; ++s) f(s);
  }
  __device__ __forceinline__ bool valid(int s) const {
    return s * SELECT_THREADS + (int)threadIdx.x < n;
  }
  __device__ __forceinline__ unsigned long long key(int s) const {
    return valid(s) ? keys[s * SELECT_THREADS + threadIdx.x] : KEY_NONE;
  }
  __device__ __forceinline__ uint32_t hi(int s) const { return (uint32_t)(key(s) >> 32); }
};

// n keys in device memory in any order (concatenated sorted tile lists),
// read again on every pass.
struct GlobalKeys {
  static constexpr bool BY_POSITION = false;
  const unsigned long long* keys;
  int n, slots;
  __device__ GlobalKeys(const unsigned long long* c, int n_)
      : keys(c), n(n_), slots((n_ + SELECT_THREADS - 1) / SELECT_THREADS) {}
  template <class F> __device__ __forceinline__ void for_slots(F f) const {
    for (int s = 0; s < slots; ++s) f(s);
  }
  __device__ __forceinline__ bool valid(int s) const {
    return s * SELECT_THREADS + (int)threadIdx.x < n;
  }
  __device__ __forceinline__ unsigned long long key(int s) const {
    return valid(s) ? __ldg(keys + s * SELECT_THREADS + threadIdx.x) : KEY_NONE;
  }
  __device__ __forceinline__ uint32_t hi(int s) const { return (uint32_t)(key(s) >> 32); }
};

// The k smallest of a block's `n_per_warp * (blockDim.x / 32)` <= 1024 keys
// in shared memory `keys`, ascending, into `dst` (shared or global). The
// caller's array order must be index order: a key's low word grows with its
// position (asserted between neighbours). k <= n; `wcand` holds
// win_keys(k) keys of scratch. blockDim.x must be SELECT_THREADS. Ends with
// a barrier.
__device__ inline void block_select(const unsigned long long* keys,
                                    int n_per_warp, int k,
                                    unsigned long long* wcand,
                                    unsigned long long* dst) {
  const int n = n_per_warp * (int)(blockDim.x >> 5);
  if (blockDim.x != SELECT_THREADS || n > SharedTile::SLOTS * SELECT_THREADS)
    __trap();
  select_smallest(SharedTile(keys, n), k, wcand, dst);
}

// One block's k smallest of `n` >= k keys in global memory `cand` (the
// per-tile lists of one map), into shared `best`, with `wc` (win_keys(k)
// keys) as scratch. Ends with a barrier.
__device__ inline void merge_select(const unsigned long long* cand, int n,
                                    int k, unsigned long long* wc,
                                    unsigned long long* best) {
  if (blockDim.x != SELECT_THREADS) __trap();
  select_smallest(GlobalKeys(cand, n), k, wc, best);
}

// Host side: a launch whose static plus dynamic shared memory passes 48 KB
// must first raise the kernel's dynamic limit (up to 227 KB a block).
template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int static_bytes,
                                      size_t dynamic_bytes) {
  if (static_bytes + dynamic_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dynamic_bytes);
}

// Host side: a kernel's static shared bytes as the runtime reports them
// plus `dynamic_bytes`, or -1 where the runtime cannot say.
template <class Kernel>
inline long long kernel_smem_bytes(Kernel kernel, size_t dynamic_bytes) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return -1;
  return (long long)a.sharedSizeBytes + (long long)dynamic_bytes;
}

}  // namespace og
