// Greedy skeleton grouping of packed candidate limbs, one CTA per image.
//
// Replaces offsetguided_tpu/ops/pallas/grouping_pallas.py::group_skeletons_pallas
// with the semantics of offsetguided_tpu/ops/grouping.py::_group_single
// (validity gate, dedup per end keypoint, redundant-limb score refresh,
// one-joint extension, one merge pass with one mergee per target, new rows
// from free slots; then `settle` merge passes and the finalize: masked-mean
// score, person threshold, stable sort to max_poses, -1 -> 0).
//
// What bounds it on an H100 SXM: neither bytes nor operations. The main
// path moves 8 x 19 x 32 x 13 floats in and 8 x 40 x 17 x 6 out (under
// 0.2 MB, well under a microsecond at 3.35 TB/s) and does a few million
// compares. Each image is a dependency chain of 19 limb steps and `settle`
// merge passes, each step a few phases that need the previous phase's
// whole result, so the time is the number of barriers times the length of
// the longest phase, with only N of the 132 SMs busy. The design attacks
// both factors:
// - barriers: 4 per limb step (rows, merge find, merge copy, new rows), 2
//   per settle pass. The next limb's candidate block arrives by cp.async
//   into a second buffer while the current step runs, and its dedup runs
//   in the new-rows phase beside warp 0's new rows, so neither a global
//   load nor the dedup has a barrier of its own; phases that need nothing
//   from the other warps (the first mergee of a target, the free-row
//   rank) run inside one warp on ballots;
// - phase length: every phase is spread over the CTA's 32 warps, a warp
//   per candidate (dedup, lanes over rivals), per skeleton row (matching,
//   lanes over candidates), per mergee row (merge find, lanes over
//   targets) or per target (merge copy, lanes over the row's J x 6
//   values), with warp votes, shuffles and popcounts in place of serial
//   scans. The keypoint indices sit in their own (M, J|1) array, an odd
//   pitch so a warp's 32 rows fall in 32 banks; for the COCO skeleton's
//   J = 17 a build with J known holds the merge find's row in registers
//   (CrowdPose's J = 14 runs the general build).
//   What is left is the merge find's M^2 J / 2 index compares a pass, the
//   one phase whose work grows with the square of the capacity.
// Masks are words of 32 rows or candidates, so capacity and top-k are
// bounded only by shared memory (`smem_bytes`, mirrored by the wrapper).
//
// Numeric rules follow jnp: every compare with NaN is false; max propagates
// NaN (fmaxf does not, so `jmax` is used); argmax takes the first index and
// treats NaN as the largest value; keypoint indices are compared with == on
// fp32, as the plain version compares them, whatever their values.
//
// OG_PHASE(name) marks the end of a phase. It expands to nothing here;
// kernel_phases.py defines it to time each phase on the card.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#ifndef OG_PHASE
#define OG_PHASE(name)
#endif

namespace {

constexpr int THREADS = 1024;
constexpr int NW = THREADS / 32;
// warp 0 ORs the warps' touched words, a lane each
static_assert(NW == 32, "one warp's lanes span the warps");
constexpr unsigned FULL = 0xffffffffu;
constexpr int NCOL = 13;   // packed limb columns
constexpr int C_LSC = 4, C_IND = 5;
constexpr int MAX_SMEM = 232448;   // Hopper's opt-in shared memory per block

__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// a key whose unsigned order is the order of the non-NaN floats, and back
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// position of the n-th (0-based) set bit of m; m has more than n set bits
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w; w >>= 1) {
    const unsigned lo = m & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    } else {
      m = lo;
    }
  }
  return pos;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Params {
  int L, K, J, M, max_poses, settle, sort_dim, use_scale;
  float dist_max, person_thre;
};

struct Smem {
  float* sub;        // (M, J, 6)
  float* ind;        // (M, JP): the keypoint-index column of `sub`, again
  float* conns0;     // (K, 13): the candidates of even limbs
  float* conns1;     // (K, 13): of odd limbs, loaded during the even step
  int* skel;         // (L, 2)
  int* used;         // (M)
  int* a_sel;        // (M) first merge target of each row, -1 when none
  float* score;      // (M) finalize scores
  int* keepm;        // (M)
  int* keep0;        // (K) candidate survives the gate and the dedup,
  int* keep1;        //   of even and of odd limbs
  unsigned* touched; // (NW, KW) candidates a warp's rows matched, a bit each
  int JP, KW;
};

__host__ __device__ inline size_t smem_bytes(int K, int J, int M, int L) {
  const size_t JP = J | 1, KW = (K + 31) / 32;
  return 4 * ((size_t)M * J * 6 + M * JP + 2 * (size_t)K * NCOL + 2 * L +
              4 * (size_t)M + 2 * (size_t)K + NW * KW);
}

__device__ __forceinline__ float& S(const Smem& s, const Params& p, int m,
                                    int j, int c) {
  return s.sub[(m * p.J + j) * 6 + c];
}

// joint j (side 0: the limb's start, 1: its end) of row m takes the value
// of column c from candidate k; the limb-score column takes `lsc`
__device__ __forceinline__ void set_field(const Smem& s, const Params& p,
                                          const float* cn, int m, int j,
                                          int side, int c, float lsc) {
  // x, y, v; scale; keypoint index (the limb-score lane loads one unused)
  const int col = c < 3 ? 3 * side + c : c == 3 ? 11 + side : 6 + side;
  const float v = c == C_LSC ? lsc : cn[col];
  S(s, p, m, j, c) = v;
  if (c == C_IND) s.ind[m * s.JP + j] = v;
}

// One merge pass: rows sharing exactly two keypoint indices fold into the
// lowest matching target row; at most one mergee per target, and a target
// that is itself a mergee waits for a later pass. JT > 0: J is JT, known
// at compile time, and a warp holds row b's indices in registers.
template <int JT>
__device__ __forceinline__ void merge_pass(const Smem& s, const Params& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, M = p.M;
  const int JP = s.JP;
  // a_sel[b]: the lowest a < b, both used, sharing exactly two indices
  for (int b = warp; b < M; b += NW) {
    int sel = -1;
    if (s.used[b]) {
      const float* ib = s.ind + b * JP;
      float vb[JT > 0 ? JT : 1];   // NaN for -1: one compare per index
#pragma unroll
      for (int j = 0; j < JT; ++j)
        vb[j] = ib[j] == -1.0f ? __int_as_float(0x7fc00000) : ib[j];
      for (int w = 0; 32 * w < b && sel < 0; ++w) {
        const int a = 32 * w + lane;
        bool ok = false;
        if (a < b && s.used[a]) {
          const float* ia = s.ind + a * JP;
          int shared = 0;
          if (JT > 0) {
#pragma unroll
            for (int j = 0; j < JT; ++j) shared += ia[j] == vb[j];
          } else {
#pragma unroll 6
            for (int j = 0; j < p.J; ++j) {
              const float v = ia[j];
              shared += (v == ib[j]) & (v != -1.0f);
            }
          }
          ok = shared == 2;
        }
        const unsigned bal = __ballot_sync(FULL, ok);
        if (bal) sel = 32 * w + __ffs(bal) - 1;
      }
    }
    if (lane == 0) s.a_sel[b] = sel;
  }
  cp_async_wait_all();   // the next limb's candidates, for its dedup
  __syncthreads();
  OG_PHASE(merge_find);
  // each target that is no mergee absorbs its first mergee: a warp per
  // target, so no two warps touch one row
  for (int a = warp; a < M; a += NW) {
    if (s.a_sel[a] >= 0 || !s.used[a]) continue;   // a mergee waits
    int r = -1;
    for (int w = (a + 1) / 32; 32 * w < M && r < 0; ++w) {
      const int b = 32 * w + lane;
      const unsigned bal = __ballot_sync(FULL, b < M && s.a_sel[b] == a);
      if (bal) r = 32 * w + __ffs(bal) - 1;
    }
    if (r < 0) continue;
    float* dst = s.sub + a * p.J * 6;
    float* src = s.sub + r * p.J * 6;
    for (int e = lane; e < p.J * 6; e += 32) {
      dst[e] = jmax(dst[e], src[e]);
      src[e] = -1.0f;
    }
    for (int j = lane; j < p.J; j += 32) {
      s.ind[a * JP + j] = jmax(s.ind[a * JP + j], s.ind[r * JP + j]);
      s.ind[r * JP + j] = -1.0f;
    }
    if (lane == 0) s.used[r] = 0;
  }
  __syncthreads();
  OG_PHASE(merge_copy);
}

__device__ __forceinline__ void prefetch(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
}

// Validity gate + dedup per end keypoint of one limb's candidates `cn`, by
// warps w0 and up: a warp per candidate k, lanes over its rivals q (same
// end index, valid, higher score or an equal score at a lower index).
__device__ __forceinline__ void dedup(const Params& p, const float* cn,
                                      int* keep, int w0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, K = p.K;
#define CN(k, c) cn[(k) * NCOL + (c)]
  auto valid = [&](int q) {
    const float delta = CN(q, 8);
    const float lim = p.use_scale ? jmax(p.dist_max, CN(q, 12)) : p.dist_max;
    return (delta < lim) && CN(q, 0) > 0.0f && CN(q, 1) > 0.0f &&
           CN(q, 3) > 0.0f && CN(q, 4) > 0.0f;
  };
  for (int k = warp - w0; k < K; k += NW - w0) {
    bool kp = valid(k);
    if (kp) {
      const float ind = CN(k, 7), sc = CN(k, 10);
      bool beaten = false;
      for (int q = lane; q < K; q += 32) {
        if (q != k && CN(q, 7) == ind && valid(q)) {
          const float sq = CN(q, 10);
          beaten |= sq > sc || (sq == sc && q < k);
        }
      }
      kp = !__any_sync(FULL, beaten);
    }
    if (lane == 0) keep[k] = kp;
  }
#undef CN
}

// Step l of the limb chain. Its candidates' dedup ran in the previous
// step's last phase; this step's last phase runs the next one's.
template <int JT>
__device__ __forceinline__ void limb_step(const Smem& s, const Params& p,
                                          const float* __restrict__ next,
                                          int l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = p.K, M = p.M, JP = s.JP;
  const int jf = s.skel[2 * l], jt = s.skel[2 * l + 1];
  const bool odd = l & 1;
  const float* cn = odd ? s.conns1 : s.conns0;
  const int* keep = odd ? s.keep1 : s.keep0;
  // this warp's matched-candidate bits; warp 0 ORs all warps' in new rows
  unsigned* touched = s.touched + warp * s.KW;
  // the other buffer was last read before the barrier that began this step
  if (next) prefetch(odd ? s.conns0 : s.conns1, next, K * NCOL);
#define CN(k, c) cn[(k) * NCOL + (c)]
  // per skeleton row (a warp each, lanes over candidates): match, redundant
  // refresh, one-joint extension; candidates some row matched are marked
  // in the warp's `touched` words
  for (int kw = lane; kw < s.KW; kw += 32) touched[kw] = 0;
  __syncwarp();
  for (int m = warp; m < M; m += NW) {
    if (!s.used[m]) continue;
    const float jid_f = s.ind[m * JP + jf], jid_t = s.ind[m * JP + jt];
    const float sc_f = S(s, p, m, jf, C_LSC), sc_t = S(s, p, m, jt, C_LSC);
    float best2 = -INFINITY, kval = -INFINITY;
    int ksel = INT_MAX;
    bool have2 = false, have1 = false;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      int ms = 0;
      if (k < K && keep[k])
        ms = (jid_f == CN(k, 6)) + (jid_t == CN(k, 7));
      const unsigned tb = __ballot_sync(FULL, ms != 0);
      if (lane == 0 && tb) touched[k0 >> 5] |= tb;
      if (k < K) {
        const float sc = CN(k, 10);
        const bool rep = sc > sc_t || sc > sc_f;
        if (ms == 2 && rep) { best2 = jmax(best2, sc); have2 = true; }
        const bool cand = ms == 1 && rep;
        have1 |= cand;
        const float v = cand ? sc : -INFINITY;
        // each lane's own best, its k ascending: NaN first, then larger
        if (ksel == INT_MAX || (!isnan(kval) && (isnan(v) || v > kval))) {
          kval = v;
          ksel = k;
        }
      }
    }
    have2 = __any_sync(FULL, have2);
    have1 = __any_sync(FULL, have1);
    if (have2)   // max over the warp, NaN propagating
      best2 = __any_sync(FULL, isnan(best2))
                  ? __int_as_float(0x7fc00000)
                  : key_float(__reduce_max_sync(FULL, order_key(best2)));
    if (have1) {   // argmax: NaN largest, ties to the lowest index
      const bool nan = isnan(kval);
      const float top = __any_sync(FULL, nan)
                            ? kval
                            : key_float(__reduce_max_sync(FULL, order_key(kval)));
      ksel = __reduce_min_sync(FULL, (nan || kval == top) ? ksel : INT_MAX);
    }
    if (have2 && lane < 2) {
      const int j = lane ? jt : jf;
      S(s, p, m, j, C_LSC) = jmax(S(s, p, m, j, C_LSC), best2);
    }
    __syncwarp();
    if (have1 && lane < 12) {
      const int side = lane / 6, c = lane % 6, j = side ? jt : jf;
      const float lsc = jmax(S(s, p, m, j, C_LSC), CN(ksel, 10));
      set_field(s, p, cn + ksel * NCOL, m, j, side, c, lsc);
    }
  }
  __syncthreads();
  OG_PHASE(rows);
  merge_pass<JT>(s, p);
  // new rows (warp 0): kept candidates no row matched, in index order onto
  // the free rows in ascending order, dropped once the free rows run out.
  // Free rows are counted after the merge pass, matches before it. One
  // word of 32 candidates at a time: the free rows a word's candidates take
  // are the lowest free ones left, so ranks restart at each word. The other
  // warps dedup the next limb's candidates meanwhile.
  if (warp == 0) {
    for (int kw = 0; kw < s.KW; ++kw) {
      const int k = 32 * kw + lane;
      const unsigned hit = __reduce_or_sync(FULL, s.touched[lane * s.KW + kw]);
      const bool nk = k < K && keep[k] && !((hit >> lane) & 1u);
      const unsigned nb = __ballot_sync(FULL, nk);
      if (!nb) continue;
      const int rank = __popc(nb & ((1u << lane) - 1u));
      int slot = -1, base = 0;
      for (int rw = 0; 32 * rw < M; ++rw) {
        const int r = 32 * rw + lane;
        const unsigned fb = __ballot_sync(FULL, r < M && !s.used[r]);
        const int c = __popc(fb);
        if (nk && slot < 0 && rank < base + c)
          slot = 32 * rw + nth_bit(fb, rank - base);
        base += c;
      }
      __syncwarp();
      if (slot >= 0) {
        for (int f = 0; f < 12; ++f)
          set_field(s, p, cn + k * NCOL, slot, f < 6 ? jf : jt, f / 6, f % 6,
                    CN(k, 10));
        s.used[slot] = 1;
      }
      __syncwarp();
    }
  } else if (next) {
    dedup(p, odd ? s.conns0 : s.conns1, odd ? s.keep0 : s.keep1, 1);
  }
#undef CN
  __syncthreads();
  OG_PHASE(new_rows);
}

template <int JT>
__global__ void __launch_bounds__(THREADS, 1)
group_kernel(const float* __restrict__ packed, const int* __restrict__ skel,
             Params p, float* __restrict__ poses, float* __restrict__ scores,
             int* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];
  const int M = p.M, J = p.J, K = p.K, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  Smem s;
  s.JP = J | 1;
  s.KW = (K + 31) / 32;
  float* q = smem;
  s.sub = q;              q += (size_t)M * J * 6;
  s.ind = q;              q += (size_t)M * s.JP;
  s.conns0 = q;           q += (size_t)K * NCOL;
  s.conns1 = q;           q += (size_t)K * NCOL;
  s.skel = (int*)q;       q += 2 * p.L;
  s.used = (int*)q;       q += M;
  s.a_sel = (int*)q;      q += M;
  s.score = q;            q += M;
  s.keepm = (int*)q;      q += M;
  s.keep0 = (int*)q;      q += K;
  s.keep1 = (int*)q;      q += K;
  s.touched = (unsigned*)q;

  const int n = blockIdx.x;
  const float* img = packed + (size_t)n * p.L * K * NCOL;
  prefetch(s.conns0, img, K * NCOL);
  for (int e = t; e < M * J * 6; e += blockDim.x) s.sub[e] = -1.0f;
  for (int e = t; e < M * s.JP; e += blockDim.x) s.ind[e] = -1.0f;
  for (int m = t; m < M; m += blockDim.x) s.used[m] = 0;
  for (int e = t; e < 2 * p.L; e += blockDim.x) s.skel[e] = skel[e];
  cp_async_wait_all();
  __syncthreads();
  OG_PHASE(init);
  if (p.L > 0) dedup(p, s.conns0, s.keep0, 0);
  __syncthreads();
  OG_PHASE(dedup);

  for (int l = 0; l < p.L; ++l)
    limb_step<JT>(s, p, l + 1 < p.L ? img + (size_t)(l + 1) * K * NCOL : nullptr,
              l);
  for (int r = 0; r < p.settle; ++r) merge_pass<JT>(s, p);

  // finalize: masked-mean score over positive keypoints, threshold
  for (int m = t; m < M; m += blockDim.x) {
    int npos = 0;
    float sum = 0.0f;
    for (int j = 0; j < J; ++j) {
      const float v = S(s, p, m, j, p.sort_dim);
      const bool pos = v > 0.0f && s.used[m];
      npos += pos;
      sum += v * (pos ? 1.0f : 0.0f);
    }
    const float sc = npos > 0 ? sum / (float)(npos > 1 ? npos : 1) : 0.0f;
    s.score[m] = sc;
    s.keepm[m] = s.used[m] && sc >= p.person_thre;
  }
  __syncthreads();
  OG_PHASE(final_score);
  // stable descending sort of (kept ? score : -1): a warp per row counts
  // the rows ahead of it, then writes the row to its rank
  for (int m = warp; m < M; m += NW) {
    const bool km = s.keepm[m];
    const float key = km ? s.score[m] : -1.0f;
    int rank = 0;
    for (int o0 = 0; o0 < M; o0 += 32) {
      const int o = o0 + lane;
      bool ahead = false;
      if (o < M) {
        const float ko = s.keepm[o] ? s.score[o] : -1.0f;
        ahead = ko > key || (ko == key && o < m);
      }
      rank += __popc(__ballot_sync(FULL, ahead));
    }
    if (rank >= p.max_poses) continue;
    float* dst = poses + ((size_t)n * p.max_poses + rank) * J * 6;
    for (int e = lane; e < J * 6; e += 32) {
      const float v = km ? s.sub[m * J * 6 + e] : 0.0f;
      dst[e] = v == -1.0f ? 0.0f : v;
    }
    if (lane == 0) scores[(size_t)n * p.max_poses + rank] = km ? s.score[m] : 0.0f;
  }
  // ranks from M to max_poses hold no row: zeros with score 0, as the
  // TPU kernel's selection rows past the kept ones
  if (p.max_poses > M) {
    float* tail = poses + ((size_t)n * p.max_poses + M) * J * 6;
    for (int e = t; e < (p.max_poses - M) * J * 6; e += blockDim.x)
      tail[e] = 0.0f;
    for (int r = M + t; r < p.max_poses; r += blockDim.x)
      scores[(size_t)n * p.max_poses + r] = 0.0f;
  }
  if (warp == 0) {
    int c = 0;
    for (int o0 = 0; o0 < M; o0 += 32)
      c += __popc(__ballot_sync(FULL, o0 + lane < M && s.keepm[o0 + lane]));
    if (lane == 0) counts[n] = c;
  }
  OG_PHASE(final_write);
}

}  // namespace

extern "C" {

// Shared memory bytes of one CTA; the wrapper mirrors this formula.
long long og_group_smem_bytes(int K, int J, int M, int L) {
  return (long long)smem_bytes(K, J, M, L);
}

// packed (N, L, K, 13) f32, skel (L, 2) i32 on the device ->
// poses (N, max_poses, J, 6) f32, scores (N, max_poses) f32, counts (N) i32.
// Requires smem_bytes(K, J, M, L) <= 227 KB; max_poses may pass M (the
// ranks from M on are zeros).
int og_group_skeletons(const float* packed, const int* skel, int N, int L,
                       int K, int J, int M, int max_poses, int settle,
                       int sort_dim, int use_scale, float dist_max,
                       float person_thre, float* poses, float* scores,
                       int* counts, void* stream) {
  Params p{L, K, J, M, max_poses, settle, sort_dim, use_scale, dist_max,
           person_thre};
  const size_t bytes = smem_bytes(K, J, M, L);
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the COCO skeleton's 17 keypoints get a build with J known; any other J
  // (CrowdPose's 14, the small skeletons of the adversarial inputs) takes
  // the general one
  const auto kernel = J == 17 ? group_kernel<17> : group_kernel<0>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<N, THREADS, bytes, (cudaStream_t)stream>>>(packed, skel, p, poses,
                                                      scores, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
