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
// Every CTA computes its upsampled tile once in shared memory, so no
// full-resolution value is written out, and the top-k is a two-launch
// selection (per tile, then per map) over 64-bit keys, exact by the segment
// argument (a global top-k block is a top-k block of its tile).
//
// What held the first design back, measured by phase on the card (PERF.md,
// `kernel_phases.py`): the upsample took two thirds of the tile launch. It
// indexed the phase table with each pixel's runtime phase, so a warp, whose
// lanes hold four phases, read four constant-bank addresses per tap,
// serialised, and its H pass read every tap from L2. The selection (k
// serial warp rounds per tile, O(n * k)) took most of the rest. Now the
// tile's source patch is loaded into shared memory once; each thread reads
// the five source values around one source position once and computes its
// four phases from them, the phase and offset loops unrolled over a dense
// weight table, so every table read is a uniform constant operand; the W
// pass stores the four phases as one float4; and the selection is the
// linear-time radix select of topk_select.cuh.
//
// k is bounded by shared memory only: a tile selects min(k, TB * TB) keys
// and pads its list with KEY_NONE, and the merge keeps its scratch and its
// k winners in dynamic shared memory (`og_peaks_smem_bytes`).
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

constexpr int FACTOR = 4;           // upsampling factor (phases per axis)
constexpr int MAX_TAPS = 5;         // taps of one phase in the C interface
constexpr int REACH = 2;            // taps reach at most 2 source px away
constexpr int SPAN = 2 * REACH + 1; // source px one output px can read
constexpr int TB = 32;              // tile edge in 2x2 blocks
constexpr int UP = 2 * TB + 2;      // upsampled tile edge incl. 1 px NMS halo
constexpr int QB = UP / FACTOR + 2; // source px whose 4 phases cover UP px
constexpr int SRC = QB + 2 * REACH; // source px a tile reads, with the reach
constexpr int UPX = FACTOR * QB;    // `up` row pitch: the QB px' phases
constexpr int UX = 3;               // `up` column of full-res column X0 - 1
constexpr int THREADS = og::SELECT_THREADS;
constexpr int MERGE_STATIC = og::SELECT_SHARED_BYTES;

// Dynamic shared bytes of the merge at k: its selection scratch and its k
// winners.
size_t merge_dynamic(int k) {
  return sizeof(unsigned long long) * (og::win_keys(k) + k);
}

// Each phase's weights over the offsets -REACH..REACH, 0 where it has no
// tap; its taps in ascending offset order are the table's tap order.
struct Taps {
  float w[FACTOR][SPAN];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floordiv4(int v) { return v >> 2; }  // arithmetic

// Phase P's taps over the SPAN source values v (offsets -REACH..REACH), in
// offset order, zero taps skipped. P and the offset are constants after
// unrolling, so every table read is a uniform constant operand; a missing
// tap is a select, not a branch, so the four phases schedule as one block.
template <int P>
__device__ __forceinline__ float taps_dot(const Taps& taps,
                                          const float (&v)[SPAN]) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int o = 0; o < SPAN; ++o) {
    const float wt = taps.w[P][o];
    const float term = __fmul_rn(v[o], wt);
    const float sum = first ? term : __fadd_rn(acc, term);
    acc = wt != 0.0f ? sum : acc;
    first = first && wt == 0.0f;
  }
  return acc;
}

// One CTA per (tile of TB x TB blocks, map): upsample the tile with its halo,
// NMS, block max, then the tile's k smallest keys into `cand`.
// Source row/col ib + a (jb + a) of the map has its phases at full-res rows
// (cols) FACTOR * (ib + a) + p = Y0 - 1 + FACTOR * a + p - UX.
__global__ void __launch_bounds__(THREADS)
peaks_tile_kernel(const float* __restrict__ maps, int h, int w, int k,
                  Taps taps, unsigned long long* __restrict__ cand) {
  __shared__ float src[SRC][SRC + 1];
  __shared__ float hbuf[UP][SRC + 1];
  __shared__ __align__(16) float up[UP][UPX];
  __shared__ unsigned long long keys_s[TB * TB];
  __shared__ unsigned long long wcand[TB * TB];

  const int H = h * FACTOR, W = w * FACTOR;
  const int HB = H / 2, WB = W / 2;
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int Y0 = 2 * TB * ty, X0 = 2 * TB * tx;  // first full-res px of tile
  const int ib = floordiv4(Y0 - 1), jb = floordiv4(X0 - 1);
  const float* x = maps + (size_t)b * h * w;

  // source patch: rows ib-2 .., cols jb-2 .., clamped into the map
  for (int e = threadIdx.x; e < SRC * SRC; e += THREADS) {
    const int r = e / SRC, c = e % SRC;
    src[r][c] = __ldg(x + (size_t)clampi(ib - 2 + r, 0, h - 1) * w +
                      clampi(jb - 2 + c, 0, w - 1));
  }
  __syncthreads();

  // H pass: the FACTOR phases of source row ib + a at every patch column
  for (int e = threadIdx.x; e < QB * SRC; e += THREADS) {
    const int a = e / SRC, c = e % SRC;
    float col[SPAN];
#pragma unroll
    for (int o = 0; o < SPAN; ++o) col[o] = src[a + o][c];
    float v[FACTOR] = {taps_dot<0>(taps, col), taps_dot<1>(taps, col),
                       taps_dot<2>(taps, col), taps_dot<3>(taps, col)};
#pragma unroll
    for (int p = 0; p < FACTOR; ++p) {
      const int r = FACTOR * a + p - UX, Y = Y0 - 1 + r;
      if (r >= 0 && r < UP) hbuf[r][c] = (Y >= 0 && Y < H) ? v[p] : 0.0f;
    }
  }
  __syncthreads();

  // W pass: the FACTOR phases of source column jb + q in row r, one float4;
  // pixels outside the image are the NMS zero border
  for (int e = threadIdx.x; e < UP * QB; e += THREADS) {
    const int r = e / QB, q = e % QB;
    const int Y = Y0 - 1 + r, X = X0 - 1 + FACTOR * q - UX;
    float row[SPAN];
#pragma unroll
    for (int o = 0; o < SPAN; ++o) row[o] = hbuf[r][q + o];
    float v[FACTOR] = {taps_dot<0>(taps, row), taps_dot<1>(taps, row),
                       taps_dot<2>(taps, row), taps_dot<3>(taps, row)};
#pragma unroll
    for (int p = 0; p < FACTOR; ++p)
      if (Y < 0 || Y >= H || X + p < 0 || X + p >= W) v[p] = 0.0f;
    *reinterpret_cast<float4*>(&up[r][FACTOR * q]) =
        make_float4(v[0], v[1], v[2], v[3]);
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
        const int r = 1 + 2 * lby + (s >> 1), c = UX + 1 + 2 * lbx + (s & 1);
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

  // top-k of the tile's keys; array order lb = lby * TB + lbx is index
  // order, since the key's index (by * WB + bx) * 4 + code grows with lb
  // (k past the tile's TB * TB keys: all of them, then KEY_NONE padding)
  const int tiles = gridDim.x * gridDim.y;
  const int kt = k < TB * TB ? k : TB * TB;
  unsigned long long* dst =
      cand + ((size_t)b * tiles + (size_t)ty * gridDim.x + tx) * k;
  og::block_select(keys_s, TB * TB / (THREADS / 32), kt, wcand, dst);
  for (int i = kt + threadIdx.x; i < k; i += THREADS) dst[i] = KEY_NONE;
}

// One CTA per map: the k smallest of its tiles' candidate keys.
// Dynamic shared memory: merge_dynamic(k).
__global__ void __launch_bounds__(THREADS)
peaks_merge_kernel(const unsigned long long* __restrict__ cand, int n_cand,
                   int k, int WB, float* __restrict__ vals,
                   int* __restrict__ ys, int* __restrict__ xs) {
  extern __shared__ unsigned long long wc[];
  unsigned long long* best = wc + og::win_keys(k);
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

// The merge launch's shared bytes at k (static as the runtime reports it,
// plus dynamic), the only launch whose bytes grow with k;
// ops/cuda/peaks.py::smem_bytes computes the same.
long long og_peaks_smem_bytes(int k) {
  return og::kernel_smem_bytes(peaks_merge_kernel, merge_dynamic(k));
}

// maps (B, h, w) f32 -> vals (B, k) f32, ys/xs (B, k) i32 at full resolution.
// Requires 0 < k <= 4 h w blocks and og_peaks_smem_bytes(k) <= 227 KB.
// tap_n (4), tap_off (4x5), tap_w (4x5) are HOST arrays: the phase table,
// each phase's taps nonzero, in ascending offset order within [-2, 2]
// (cudaErrorInvalidValue otherwise).
int og_peaks_topk(const float* maps, int B, int h, int w, int k,
                  const int* tap_n, const int* tap_off, const float* tap_w,
                  unsigned long long* cand, float* vals, int* ys, int* xs,
                  void* stream) {
  Taps taps = {};
  for (int p = 0; p < FACTOR; ++p) {
    if (tap_n[p] < 0 || tap_n[p] > MAX_TAPS) return (int)cudaErrorInvalidValue;
    for (int t = 0; t < tap_n[p]; ++t) {
      const int off = tap_off[p * MAX_TAPS + t];
      const float wt = tap_w[p * MAX_TAPS + t];
      if (off < -REACH || off > REACH || wt == 0.0f ||
          (t > 0 && off <= tap_off[p * MAX_TAPS + t - 1]))
        return (int)cudaErrorInvalidValue;
      taps.w[p][off + REACH] = wt;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int HB = 2 * h, WB = 2 * w;
  const int tiles_x = (WB + TB - 1) / TB, tiles_y = (HB + TB - 1) / TB;
  cudaError_t err;
  // maps are grid z, at most og::MAX_GRID_YZ a launch: any B in chunks
  for (int b0 = 0; b0 < B; b0 += og::MAX_GRID_YZ) {
    const dim3 grid(tiles_x, tiles_y,
                    B - b0 < og::MAX_GRID_YZ ? B - b0 : og::MAX_GRID_YZ);
    peaks_tile_kernel<<<grid, THREADS, 0, s>>>(
        maps + (size_t)b0 * h * w, h, w, k, taps,
        cand + (size_t)b0 * tiles_x * tiles_y * k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t merge_smem = merge_dynamic(k);
  err = og::allow_dynamic_smem(peaks_merge_kernel, MERGE_STATIC, merge_smem);
  if (err != cudaSuccess) return (int)err;
  peaks_merge_kernel<<<B, THREADS, merge_smem, s>>>(
      cand, tiles_x * tiles_y * k, k, WB, vals, ys, xs);
  return (int)cudaGetLastError();
}

}  // extern "C"
