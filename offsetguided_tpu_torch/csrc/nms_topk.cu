// Fused 3x3 peak NMS + exact top-k over each (h, w) f32 map: the NMS keeps
// a cell where it equals the max of its 3x3 window (zero border outside the
// map, so equal neighbours both survive) and zeroes it elsewhere; the top-k
// runs over the flat row-major h*w index, values descending, ties to the
// lowest index, -0.0 tied with +0.0.
//
// Replaces offsetguided_tpu/ops/pallas/nms_topk_pallas.py::nms_topk_pallas
// (eight shifted max-compares and k max/argmin/mask rounds over one map in
// VMEM), i.e. lax.top_k(hmp_nms(x).reshape(-1), k).
//
// Bound on an H100 SXM: bytes. On the stride-resolution decode path at
// long edge 640 and batch 8 the input is (136, 160, 160) f32, 13.9 MB read
// once (4.2 us at 3.35 TB/s); the work is nine compares per cell.
//
// What held the first design back (a CTA per 32x32 tile, then a merge
// launch), measured by phase on the card (PERF.md, kernel_phases.py):
// of its 0.045 ms on the device, the tile's load + NMS took 0.019, the
// tile's selection over all 1,024 keys (most of them one run of NMS zeros)
// 0.019 and the merge launch 0.007, and the wrapper's host work (a buffer,
// a tile-count call, a widening cast) added 0.015-0.027 ms of card waiting.
//
// This design rests on the top-k order being fixed by value class: positive
// survivors in descending order, then zero-valued cells in index order (+0
// and -0 alike), then negative survivors. Split a map into bands: every key
// of the map's top k is among its band's top k, and a band's top k is its
// positive survivors (the k largest if it has more), then its first zero
// cells, then, only if those run short, its largest negative survivors.
// So one launch does the whole map: one thread-block cluster of BANDS CTAs
// per map, each CTA a band of ceil(h / BANDS) rows:
//   1. a CTA stages its band with a 1-cell halo (zeros outside the map, as
//      the zero-padded window) in shared memory by `cp.async`; each value
//      becomes an int in value order (`ordered`), NaN above all;
//   2. NMS by column strips (three shared loads and four integer maxima a
//      cell) in one pass that appends the positive survivors' 64-bit keys
//      to a shared list with warp ballots and one atomic a warp (tens to
//      hundreds of keys, not a band's thousands of mostly-zero ones) and
//      marks the zero cells in a bit mask. A band short of positives takes
//      its first zero cells by popcount ranks over the mask; only when
//      those run short too does it take a selection over its cells in
//      index order that recomputes the NMS from device memory (slow, rare,
//      exact);
//   3. the band's k smallest: warp 0 sorts at most 64 keys with a bitonic
//      network for k <= 32, else the radix select of topk_select.cuh;
//   4. the band's list goes into the leader CTA's shared memory through
//      distributed shared memory; after a cluster barrier the leader merges
//      the BANDS lists (warp 0's bitonic merges for k <= 32, else the radix
//      select) and writes the values and int64 indices. A value is its
//      key's own, except a zero, whose sign the NMS recomputes at the cell
//      (-0.0 survives as -0.0).
// A band of several tiles (a map over BANDS * TR rows or MAX_COLS columns)
// cuts its list back to k before the next tile.
//
// What bounds it, measured (PERF.md, kernel_phases.py): latency, not bytes
// or issue. Staging alone, with the cluster barrier and the merge, takes
// 0.015-0.017 ms of the 0.037-0.040 on the model's maps, about four times
// the bytes' time: 1,088 CTAs in about two rounds of 5-6 an SM, each
// waiting on its copies, barriers and cluster. Capping registers for 6 an SM
// beat 4 and 8. The warp sort and merges of k <= 32 beat the radix select
// alone by 0.004 ms on the model's maps and 0.005 on person scenes (9-17 %;
// `radix_only` in kernel_phases.py). Tried and dropped: a histogram pass
// that admits only the positives the top k can hold (faster on
// random-weight maps, slower on person scenes, where positives are few), a
// cluster taking two maps with the next one in flight, four bands a map,
// and a warp-register top-32 (each slower on the model's maps).
// No candidate buffer in device memory, no second launch. A "last CTA of
// the map merges" design would need a global candidate buffer and a counter
// reset per call; the cluster keeps both in shared memory.
// The maps are contiguous: the decode copies the head's (N, H, W, C)
// channel slice into (N*C, h, w) maps first (0.036 ms). Read in place
// through its strides (W stride 75 floats, a 32-byte sector a 4-byte copy)
// the kernel took 0.091 ms against 0.039, and the whole stride-resolution
// decode of a batch gained nothing resolvable on the host clock.
//
// NaN: jnp.maximum and F.max_pool2d propagate NaN, so a NaN anywhere in the
// window makes the max NaN and zeroes the cell; fmaxf would drop it, hence
// `nanmax`. So no NaN is ever selected.
//
// OG_PHASE(name) marks the end of a phase. It expands to nothing here;
// kernel_phases.py defines it to time each phase on the card.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

#ifndef OG_PHASE
#define OG_PHASE(name)
#endif

namespace cg = cooperative_groups;

namespace {

using og::KEY_NONE;

constexpr int THREADS = og::SELECT_THREADS;
constexpr int BANDS = 8;             // CTAs of a map's cluster
constexpr int WARPS = THREADS / 32;
constexpr int TILE_FLOATS = 6144;    // most floats of a staged tile (24 KB)
constexpr int MAX_COLS = TILE_FLOATS / 3 - 2;  // widest tile: 1 row + halo
constexpr int MASK_WORDS = 256;      // zero-cell bits of a band's first cells
constexpr int NAN_ORD = 0x7fffffff;  // `ordered` of every NaN
constexpr int STRIP = 5;             // rows of a thread's column strip

constexpr int SMALL_K = 32;          // k a warp sorts and merges alone

// The shared memory of one CTA at (h, w, k), the same on host and device:
// the positive list (a tile's cells plus the k kept), the selection's
// scratch, the leader's BANDS lists (of at least SMALL_K keys), the staged
// tile with its halo, the zero-cell mask, and 16 bytes of counters.
struct Layout {
  int R, TR, TC, tile, list, win, cand;
  __host__ __device__ Layout(int h, int w, int k) {
    R = (h + BANDS - 1) / BANDS;
    TC = w < MAX_COLS ? w : MAX_COLS;
    TR = TILE_FLOATS / (TC + 2) - 2;
    if (TR > R) TR = R;
    tile = (TR + 2) * (TC + 2);
    list = TR * TC + k;
    win = og::win_keys(k);
    cand = BANDS * (k < SMALL_K ? SMALL_K : k);
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(unsigned long long) * (size_t)(list + win + cand) +
           sizeof(int) * (size_t)(tile + MASK_WORDS) + 16;
  }
};

// A float's bits as an int whose order is the values' order: -0 and +0 are
// both 0, every NaN is NAN_ORD, above +inf. The 3x3 max is then an integer
// max, and "the window holds a NaN" is "its max is NAN_ORD".
__device__ __forceinline__ int ordered(float v) {
  const int u = __float_as_int(v), mag = u & 0x7fffffff;
  return mag > 0x7f800000 ? NAN_ORD : (u < 0 ? -mag : mag);
}

// og::make_key(v, cell) of the positive value whose bits are o.
__device__ __forceinline__ unsigned long long positive_key(int o, int cell) {
  return ((unsigned long long)(0x7fffffffu - (uint32_t)o) << 32) |
         (uint32_t)cell;
}

// A warp's keys (one a lane) sorted ascending over the lanes.
__device__ __forceinline__ unsigned long long sort32(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(og::FULL, v, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  return v;
}

// The 32 smallest of `r` (sorted ascending over the lanes) and `y` (sorted
// descending), ascending: min(r, y) lane by lane is the 32 smallest of both
// as a bitonic sequence, and five compare-exchange steps sort it.
__device__ __forceinline__ unsigned long long merge32(unsigned long long r,
                                                      unsigned long long y) {
  const int lane = threadIdx.x & 31;
  r = y < r ? y : r;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned long long o = __shfl_xor_sync(og::FULL, r, s);
    r = (lane & s) ? (o > r ? o : r) : (o < r ? o : r);
  }
  return r;
}

// Shared memory's `n_lists` lists of 32 keys, each ascending: their 32
// smallest, ascending over the lanes of the calling warp.
__device__ __forceinline__ unsigned long long merge_lists(
    const unsigned long long* lists, int n_lists) {
  const int lane = threadIdx.x & 31;
  unsigned long long r = lists[lane];
  for (int j = 1; j < n_lists; ++j) r = merge32(r, lists[32 * j + 31 - lane]);
  return r;
}

// The 32 smallest of keys[0..n), n <= 64, ascending over the lanes of the
// calling warp (KEY_NONE past n).
__device__ __forceinline__ unsigned long long smallest32(
    const unsigned long long* keys, int n) {
  const int lane = threadIdx.x & 31;
  unsigned long long r = sort32(lane < n ? keys[lane] : KEY_NONE);
  if (n > 32) {
    const unsigned long long y =
        sort32(32 + lane < n ? keys[32 + lane] : KEY_NONE);
    r = merge32(r, __shfl_sync(og::FULL, y, 31 - lane));
  }
  return r;
}

// NMS over a staged tile of `ordered` ints, by column strips of STRIP rows:
// strip v is column v % cols, rows STRIP * (v / cols) on; a thread walks
// down its strips keeping the row maxima of the last three staged rows, so
// a cell costs three shared loads and four integer maxima. Calls
// f(live, survives, value, cell) for every (strip, row) slot of every
// thread, the same number of times in every warp (f may be
// warp-collective); `live` is false on slots past the tile.
template <class F>
__device__ __forceinline__ void nms_cells(const int* tile, int pitch,
                                          int rows, int cols, int cell0,
                                          int w, F f) {
  const int strips = (rows + STRIP - 1) / STRIP * cols;
  for (int v0 = 0; v0 < strips; v0 += THREADS) {
    const int v = v0 + threadIdx.x;
    const int c = v % cols, r0 = v / cols * STRIP;
    const int r1 = v < strips ? min(rows, r0 + STRIP) : r0;
    const int* t = tile + r0 * pitch + c;   // the window's top-left
    int hm0 = 0, hm1 = 0, mid = 0;
    if (r0 < r1) {
      hm0 = max(max(t[0], t[1]), t[2]);
      mid = t[pitch + 1];
      hm1 = max(max(t[pitch], mid), t[pitch + 2]);
    }
    for (int i = 0; i < STRIP; ++i) {
      bool live = false, survives = false;
      int val = 0;
      if (r0 + i < r1) {
        const int* a = t + (i + 2) * pitch;
        const int mid2 = a[1];
        const int hm2 = max(max(a[0], mid2), a[2]);
        const int mx = max(max(hm0, hm1), hm2);
        val = mid;
        live = true;
        survives = val == mx && mx != NAN_ORD;
        hm0 = hm1;
        hm1 = hm2;
        mid = mid2;
      }
      f(live, survives, val, cell0 + (r0 + i) * w + c);
    }
  }
}

__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One contiguous (h, w) map.
struct Map {
  const float* p;
  int h, w;
  __device__ __forceinline__ bool inside(int y, int x) const {
    return y >= 0 && y < h && x >= 0 && x < w;
  }
  __device__ __forceinline__ const float* at(int y, int x) const {
    return p + (long long)y * w + x;
  }
  __device__ float at_or_zero(int y, int x) const {
    return inside(y, x) ? __ldg(at(y, x)) : 0.0f;
  }
  // dst = the value at (y, x), or 0 outside the map, by an asynchronous
  // 4-byte copy (zero-filled outside): a thread keeps all of its copies in
  // flight at once
  __device__ __forceinline__ void stage(int* dst, int y, int x) const {
    const bool in = inside(y, x);
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(in ? at(y, x) : p), "r"(in ? 4 : 0)
                 : "memory");
  }
  // hmp_nms's value at flat index i, from device memory
  __device__ float nms(int i) const {
    const int y = i / w, x = i % w;
    const float v = at_or_zero(y, x);
    float mx = v;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) mx = nanmax(mx, at_or_zero(y + dy, x + dx));
    return v == mx ? v : 0.0f;
  }
};

// The rare path's keys: the band's cells [c0, c1) in index order whose NMS
// value is not positive, recomputed from device memory on every pass.
struct BandRest {
  static constexpr bool BY_POSITION = false;
  Map map;
  int c0, c1, slots;
  __device__ BandRest(const Map& m, int c0_, int c1_)
      : map(m), c0(c0_), c1(c1_),
        slots((c1_ - c0_ + THREADS - 1) / THREADS) {}
  template <class F> __device__ __forceinline__ void for_slots(F f) const {
    for (int s = 0; s < slots; ++s) f(s);
  }
  __device__ __forceinline__ int cell(int s) const {
    return c0 + s * THREADS + (int)threadIdx.x;
  }
  __device__ __forceinline__ bool valid(int s) const {
    return cell(s) < c1 && !(map.nms(cell(s)) > 0.0f);
  }
  __device__ __forceinline__ unsigned long long key(int s) const {
    return cell(s) < c1 ? og::make_key(map.nms(cell(s)), (uint32_t)cell(s))
                        : KEY_NONE;
  }
  __device__ __forceinline__ uint32_t hi(int s) const {
    return (uint32_t)(key(s) >> 32);
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// grid (BANDS, M), one cluster per map m.
__global__ void __cluster_dims__(BANDS, 1, 1) __launch_bounds__(THREADS, 6)
nms_topk_kernel(const float* __restrict__ x, int h, int w, int k,
                float* __restrict__ vals, long long* __restrict__ inds) {
  extern __shared__ unsigned long long smem[];
  const Layout L(h, w, k);
  unsigned long long* list = smem;
  unsigned long long* win = list + L.list;
  unsigned long long* cand = win + L.win;
  int* tile = reinterpret_cast<int*>(cand + L.cand);
  unsigned* zmask = reinterpret_cast<unsigned*>(tile + L.tile);
  unsigned* count = zmask + MASK_WORDS;
  cg::cluster_group cluster = cg::this_cluster();
  // (arrive now, wait before the first write into the leader: every CTA of
  // the cluster has then started)
  cluster_arrive_relaxed();

  const int band = (int)cluster.block_rank();
  const int m = blockIdx.y;
  const Map map{x + (long long)m * h * w, h, w};
  const int y0 = band * L.R, y1 = min(h, y0 + L.R);
  const int cells = y1 > y0 ? (y1 - y0) * w : 0;
  const int want = min(k, cells);   // the keys the band passes on
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pitch = L.TC + 2;
  for (int i = threadIdx.x; i < MASK_WORDS; i += THREADS) zmask[i] = 0u;
  if (threadIdx.x < 4) count[threadIdx.x] = 0u;
  __syncthreads();

  // appends the keys of `pos` cells to the list, one atomic a warp
  const auto append = [&](bool pos, int val, int cell) {
    const unsigned bal = __ballot_sync(og::FULL, pos);
    if (bal != 0u) {
      const int lead = __ffs(bal) - 1;
      unsigned at = 0u;
      if (lane == lead) at = atomicAdd(count, (unsigned)__popc(bal));
      at = __shfl_sync(og::FULL, at, lead);
      if (pos) list[at + __popc(bal & ((1u << lane) - 1u))] =
          positive_key(val, cell);
    }
  };
  // sets the bits of `zero` cells among the band's first 32 * MASK_WORDS
  const auto mark_zeros = [&](bool zero, int cell, bool lanes_in_row) {
    const int b = cell - y0 * w;
    const bool mark = zero && b < 32 * MASK_WORDS;
    if (lanes_in_row) {   // 32 neighbouring cells of one row: one ballot
      const unsigned zb = __ballot_sync(og::FULL, mark);
      const int b0 = __shfl_sync(og::FULL, b, 0);
      if (lane == 0 && zb != 0u) {
        atomicOr(zmask + (b0 >> 5), zb << (b0 & 31));
        if ((b0 & 31) != 0 && (zb >> (32 - (b0 & 31))) != 0u)
          atomicOr(zmask + (b0 >> 5) + 1, zb >> (32 - (b0 & 31)));
      }
    } else {
      const unsigned word = mark ? (unsigned)b >> 5 : og::FULL;
      const unsigned peers = __match_any_sync(og::FULL, word);
      const unsigned bits =
          __reduce_or_sync(peers, mark ? 1u << (b & 31) : 0u);
      if (mark && lane == __ffs(peers) - 1) atomicOr(zmask + word, bits);
    }
  };

  for (int ty = y0; ty < y1; ty += L.TR) {
    for (int tx = 0; tx < w; tx += L.TC) {
      const int rows = min(L.TR, y1 - ty), cols = min(L.TC, w - tx);
      // stage rows + 2 by cols + 2 values, a warp a row; each thread turns
      // its own copies into `ordered` ints once they have landed
      for (int r = warp; r < rows + 2; r += WARPS)
        for (int c = lane; c < cols + 2; c += 32)
          map.stage(tile + r * pitch + c, ty - 1 + r, tx - 1 + c);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      for (int r = warp; r < rows + 2; r += WARPS)
        for (int c = lane; c < cols + 2; c += 32)
          tile[r * pitch + c] = ordered(__int_as_float(tile[r * pitch + c]));
      __syncthreads();
      OG_PHASE(load);
      // a warp's lanes are 32 neighbouring cells of one row when cols is a
      // multiple of 32
      const bool lanes_in_row = cols % 32 == 0;
      const int cell0 = ty * w + tx;
      // one NMS pass: the positive survivors into the list, the zero cells
      // into the mask
      nms_cells(tile, pitch, rows, cols, cell0, w,
                [&](bool live, bool survives, int val, int cell) {
                  append(survives && val > 0, val, cell);
                  mark_zeros(live && (!survives || val == 0), cell,
                             lanes_in_row);
                });
      __syncthreads();
      OG_PHASE(nms);
      // another tile follows: keep the k smallest, so its cells fit
      const int n = (int)count[0];
      if (n > k && (tx + L.TC < w || ty + L.TR < y1)) {
        og::select_smallest(og::SharedKeys(list, n), k, win, list);
        if (threadIdx.x == 0) count[0] = (unsigned)k;
        __syncthreads();
        OG_PHASE(reduce);
      }
    }
  }

  // the band's list: its `want` smallest keys
  int n = (int)count[0];
  if (n > k && !(k <= SMALL_K && n <= 64)) {
    og::select_smallest(og::SharedKeys(list, n), k, win, list);
    n = k;
  } else if (n < want) {
    // fewer positive survivors than the band gives: its first zero cells,
    // by index from the mask (warp 0: popcount ranks over 32 words a step)
    const int need = want - n;
    if (warp == 0) {
      const int words = min(MASK_WORDS, (cells + 31) / 32);
      int done = 0;
      for (int w0 = 0; w0 < words && done < need; w0 += 32) {
        unsigned bitsw = w0 + lane < words ? zmask[w0 + lane] : 0u;
        const int cnt = __popc(bitsw);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(og::FULL, incl, o);
          if (lane >= o) incl += y;
        }
        for (int rank = done + incl - cnt; bitsw != 0u && rank < need; ++rank) {
          const int bit = __ffs(bitsw) - 1;
          bitsw &= bitsw - 1u;
          list[n + rank] = og::make_key(
              0.0f, (uint32_t)(y0 * w + (w0 + lane) * 32 + bit));
        }
        done += __shfl_sync(og::FULL, incl, 31);
      }
      if (lane == 0) count[3] = (unsigned)min(done, need);
    }
    __syncthreads();
    if ((int)count[3] < need)
      // the mask's cells hold too few zeros: every zero and negative cell of
      // the band, by a selection that recomputes the NMS (slow, exact)
      og::select_smallest(BandRest(map, y0 * w, y0 * w + cells), need, win, list + n);
    n = want;
    __syncthreads();
  }
  OG_PHASE(band_select);

  if (k <= SMALL_K) {
    // warp 0 sorts the band's (at most 64) keys, keeps 32 and writes them
    // into the leader's shared memory; the leader's warp 0 merges the
    // BANDS sorted lists
    if (warp == 0) {
      const unsigned long long r = smallest32(list, n);
      cluster_wait();
      cluster.map_shared_rank(cand, 0)[band * SMALL_K + lane] = r;
    } else {
      cluster_wait();
    }
    cluster.sync();
    OG_PHASE(to_leader);
    if (band != 0 || warp != 0) return;
    const unsigned long long key = merge_lists(cand, BANDS);
    OG_PHASE(merge);
    if (lane < k) {
      const int i = (int)og::key_index(key);
      const float v = og::key_value(key);
      vals[(size_t)m * k + lane] = v == 0.0f ? map.nms(i) : v;
      inds[(size_t)m * k + lane] = i;
    }
    OG_PHASE(write);
    return;
  }

  cluster_wait();
  unsigned long long* dst = cluster.map_shared_rank(cand, 0) + band * k;
  for (int i = threadIdx.x; i < k; i += THREADS)
    dst[i] = i < n ? list[i] : KEY_NONE;
  cluster.sync();
  OG_PHASE(to_leader);
  if (band != 0) return;

  og::select_smallest(og::SharedKeys(cand, L.cand), k, win, cand);
  OG_PHASE(merge);
  for (int r = threadIdx.x; r < k; r += THREADS) {
    const unsigned long long key = cand[r];
    const int i = (int)og::key_index(key);
    const float v = og::key_value(key);
    vals[(size_t)m * k + r] = v == 0.0f ? map.nms(i) : v;
    inds[(size_t)m * k + r] = i;
  }
  OG_PHASE(write);
}

constexpr int KERNEL_STATIC = og::SELECT_SHARED_BYTES;

}  // namespace

extern "C" {

// Shared bytes of one CTA at (h, w, k) (static as the runtime reports it,
// plus dynamic); ops/cuda/nms_topk.py::smem_bytes computes the same.
long long og_nms_topk_smem_bytes(int h, int w, int k) {
  return og::kernel_smem_bytes(nms_topk_kernel, Layout(h, w, k).bytes());
}

// x (M, h, w) f32 contiguous on the device -> vals (M, k) f32, inds (M, k)
// int64 flat row-major. Requires 0 < k <= h * w < 2^31, M >= 1,
// and og_nms_topk_smem_bytes(h, w, k) <= 227 KB.
int og_nms_topk(const float* x, int M, int h, int w, int k, float* vals,
                long long* inds, void* stream) {
  const size_t smem = Layout(h, w, k).bytes();
  cudaError_t err =
      og::allow_dynamic_smem(nms_topk_kernel, KERNEL_STATIC, smem);
  if (err != cudaSuccess) return (int)err;
  // maps are grid y, at most og::MAX_GRID_YZ a launch: any M in chunks
  for (int m0 = 0; m0 < M; m0 += og::MAX_GRID_YZ) {
    const int mc = M - m0 < og::MAX_GRID_YZ ? M - m0 : og::MAX_GRID_YZ;
    nms_topk_kernel<<<dim3(BANDS, mc), THREADS, smem, (cudaStream_t)stream>>>(
        x + (size_t)m0 * h * w, h, w, k, vals + (size_t)m0 * k,
        inds + (size_t)m0 * k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
