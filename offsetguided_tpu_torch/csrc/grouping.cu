// Greedy skeleton grouping of packed candidate limbs, one CTA per image.
//
// Replaces offsetguided_tpu/ops/pallas/grouping_pallas.py::group_skeletons_pallas
// with the semantics of offsetguided_tpu/ops/grouping.py::_group_single
// (validity gate, dedup per end keypoint, redundant-limb score refresh,
// one-joint extension, one merge pass with one mergee per target, new rows
// from free slots; then `settle` merge passes and the finalize: masked-mean
// score, person threshold, stable sort to max_poses, -1 -> 0).
//
// Bound on an H100 SXM: neither bytes nor operations. The main path moves
// 8 x 19 x 32 x 13 floats in and 8 x 40 x 17 x 6 out (under 0.2 MB, well
// under a microsecond at 3.35 TB/s) and does a few million compares. The
// work is a chain of 19 limb steps + 2 settle passes, each a handful of
// dependent phases separated by __syncthreads, so the time is latency: the
// number of barriers times the phase length, with only N CTAs busy. Design
// against that: the whole (M, J, 6) state (26 KB at M=64, J=17) and the
// `used` flags stay in shared memory for the kernel's life, each phase uses
// real indexed loads and stores (no one-hot products), and per-row work runs
// one thread per skeleton row so most phases need a single barrier.
//
// Numeric rules follow jnp: every compare with NaN is false; max propagates
// NaN (fmaxf does not, so `jmax` is used); argmax takes the first index and
// treats NaN as the largest value; keypoint indices are compared with == on
// fp32 (exact below 2^24).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NCOL = 13;   // packed limb columns
constexpr int C_X = 0, C_Y = 1, C_V = 2, C_S = 3, C_LSC = 4, C_IND = 5;

__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Params {
  int L, K, J, M, max_poses, settle, sort_dim, use_scale;
  float dist_max, person_thre;
};

struct Smem {
  float* sub;        // (M, J, 6)
  int* used;         // (M)
  float* conns;      // (K, 13)
  int* keep;         // (K)
  uint8_t* msum;     // (M, K)
  unsigned long long* mmask;  // (4, M) partial mergeable masks
  int* a_sel;        // (M)
  int* do_merge;     // (M)
  int* first_b;      // (M), -1 when none
  float* score;      // (M) finalize scores
  int* keepm;        // (M)
};

__device__ __forceinline__ float& S(const Smem& s, const Params& p, int m,
                                    int j, int c) {
  return s.sub[(m * p.J + j) * 6 + c];
}

// One merge pass: rows sharing exactly two keypoint indices fold into the
// lowest matching target row; at most one mergee per target.
__device__ void merge_pass(const Smem& s, const Params& p) {
  const int t = threadIdx.x, M = p.M;
  // mergeable[a][b]: a < b, both used, exactly two shared non -1 indices
  for (int e = t; e < 4 * M; e += blockDim.x) {
    const int b = e % M, part = e / M;
    const int a_lo = part * 16, a_hi = min(a_lo + 16, b);
    unsigned long long mask = 0;
    if (s.used[b]) {
      for (int a = a_lo; a < a_hi; ++a) {
        if (!s.used[a]) continue;
        int shared = 0;
        for (int j = 0; j < p.J; ++j) {
          const float ia = S(s, p, a, j, C_IND);
          shared += (ia == S(s, p, b, j, C_IND)) && (ia != -1.0f);
        }
        if (shared == 2) mask |= 1ull << a;
      }
    }
    s.mmask[part * M + b] = mask;
  }
  __syncthreads();
  // first target per mergee; a mergee whose target merges away waits
  for (int b = t; b < M; b += blockDim.x) {
    const unsigned long long mask = s.mmask[b] | s.mmask[M + b] |
                                    s.mmask[2 * M + b] | s.mmask[3 * M + b];
    s.a_sel[b] = mask ? __ffsll((long long)mask) - 1 : -1;
  }
  __syncthreads();
  for (int b = t; b < M; b += blockDim.x) {
    const int a = s.a_sel[b];
    s.do_merge[b] = a >= 0 && s.a_sel[a] < 0;
  }
  __syncthreads();
  for (int a = t; a < M; a += blockDim.x) {
    int fb = -1;
    for (int b = 0; b < M; ++b)
      if (s.do_merge[b] && s.a_sel[b] == a) { fb = b; break; }
    s.first_b[a] = fb;
  }
  __syncthreads();
  // each target has at most one mergee and is itself no mergee: no races
  for (int a = t; a < M; a += blockDim.x) {
    const int r = s.first_b[a];
    if (r < 0) continue;
    for (int e = 0; e < p.J * 6; ++e) {
      float& dst = s.sub[a * p.J * 6 + e];
      float& src = s.sub[r * p.J * 6 + e];
      dst = jmax(dst, src);
      src = -1.0f;
    }
    s.used[r] = 0;
  }
  __syncthreads();
}

__device__ void limb_step(const Smem& s, const Params& p,
                          const float* __restrict__ limbs, int jf, int jt) {
  const int t = threadIdx.x, K = p.K, M = p.M;
  for (int e = t; e < K * NCOL; e += blockDim.x) s.conns[e] = limbs[e];
  __syncthreads();
#define CN(k, c) s.conns[(k) * NCOL + (c)]
  // validity gate + dedup per end keypoint
  for (int k = t; k < K; k += blockDim.x) {
    auto valid = [&](int q) {
      const float delta = CN(q, 8);
      const float lim = p.use_scale ? jmax(p.dist_max, CN(q, 12)) : p.dist_max;
      return (delta < lim) && CN(q, 0) > 0.0f && CN(q, 1) > 0.0f &&
             CN(q, 3) > 0.0f && CN(q, 4) > 0.0f;
    };
    bool kp = valid(k);
    if (kp) {
      const float ind = CN(k, 7), sc = CN(k, 10);
      for (int q = 0; q < K && kp; ++q) {
        if (q == k || CN(q, 7) != ind || !valid(q)) continue;
        const float sq = CN(q, 10);
        if (sq > sc || (sq == sc && q < k)) kp = false;
      }
    }
    s.keep[k] = kp;
  }
  __syncthreads();
  // per skeleton row: match, redundant refresh, one-joint extension
  for (int m = t; m < M; m += blockDim.x) {
    const bool um = s.used[m];
    const float jid_f = S(s, p, m, jf, C_IND), jid_t = S(s, p, m, jt, C_IND);
    const float sc_f = S(s, p, m, jf, C_LSC), sc_t = S(s, p, m, jt, C_LSC);
    float best2 = -INFINITY;
    bool have2 = false, have1 = false;
    int ksel = 0;
    float kval = -INFINITY;
    for (int k = 0; k < K; ++k) {
      int ms = 0;
      if (um && s.keep[k])
        ms = (jid_f == CN(k, 6)) + (jid_t == CN(k, 7));
      s.msum[m * K + k] = (uint8_t)ms;
      const float sc = CN(k, 10);
      const bool rep = sc > sc_t || sc > sc_f;
      if (ms == 2 && rep) { best2 = jmax(best2, sc); have2 = true; }
      const bool cand = ms == 1 && rep;
      have1 |= cand;
      const float v = cand ? sc : -INFINITY;   // argmax, NaN largest
      if (k == 0) {
        kval = v;
      } else if (!isnan(kval) && (isnan(v) || v > kval)) {
        kval = v;
        ksel = k;
      }
    }
    if (have2) {
      S(s, p, m, jf, C_LSC) = jmax(S(s, p, m, jf, C_LSC), best2);
      S(s, p, m, jt, C_LSC) = jmax(S(s, p, m, jt, C_LSC), best2);
    }
    if (have1) {
      const float sel = CN(ksel, 10);
      const int cols[2] = {jf, jt};
      for (int side = 0; side < 2; ++side) {
        const int j = cols[side], o = 3 * side;
        S(s, p, m, j, C_IND) = CN(ksel, 6 + side);
        S(s, p, m, j, C_X) = CN(ksel, o + 0);
        S(s, p, m, j, C_Y) = CN(ksel, o + 1);
        S(s, p, m, j, C_V) = CN(ksel, o + 2);
        S(s, p, m, j, C_S) = CN(ksel, 11 + side);
        S(s, p, m, j, C_LSC) = jmax(S(s, p, m, j, C_LSC), sel);
      }
    }
  }
  __syncthreads();
  merge_pass(s, p);
  // new rows: kept conns no row matched, in rank order onto free rows
  // (ascending), dropped once the free rows run out
  int n_free = 0;
  for (int m = 0; m < M; ++m) n_free += !s.used[m];
  int slot = -1, kk = -1;
  if (t < K) {
    kk = t;
    bool nk = s.keep[kk];
    for (int m = 0; m < M && nk; ++m) nk = s.msum[m * K + kk] == 0;
    if (nk) {
      int rank = 0;
      for (int q = 0; q < kk; ++q) {
        bool nq = s.keep[q];
        for (int m = 0; m < M && nq; ++m) nq = s.msum[m * K + q] == 0;
        rank += nq;
      }
      if (rank < n_free) {
        for (int m = 0, f = 0; m < M; ++m) {
          if (s.used[m]) continue;
          if (f++ == rank) { slot = m; break; }
        }
      }
    }
  }
  __syncthreads();   // every thread has read `used` before it changes
  if (slot >= 0) {
    const int cols[2] = {jf, jt};
    for (int side = 0; side < 2; ++side) {
      const int j = cols[side], o = 3 * side;
      S(s, p, slot, j, C_IND) = CN(kk, 6 + side);
      S(s, p, slot, j, C_X) = CN(kk, o + 0);
      S(s, p, slot, j, C_Y) = CN(kk, o + 1);
      S(s, p, slot, j, C_V) = CN(kk, o + 2);
      S(s, p, slot, j, C_S) = CN(kk, 11 + side);
      S(s, p, slot, j, C_LSC) = CN(kk, 10);
    }
    s.used[slot] = 1;
  }
  __syncthreads();
#undef CN
}

__global__ void __launch_bounds__(THREADS)
group_kernel(const float* __restrict__ packed, const int* __restrict__ skel,
             Params p, float* __restrict__ poses, float* __restrict__ scores,
             int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, J = p.J, K = p.K, t = threadIdx.x;
  Smem s;
  unsigned char* q = smem;
  s.mmask = (unsigned long long*)q; q += sizeof(unsigned long long) * 4 * M;
  s.sub = (float*)q;    q += sizeof(float) * M * J * 6;
  s.conns = (float*)q;  q += sizeof(float) * K * NCOL;
  s.score = (float*)q;  q += sizeof(float) * M;
  s.used = (int*)q;     q += sizeof(int) * M;
  s.keep = (int*)q;     q += sizeof(int) * K;
  s.a_sel = (int*)q;    q += sizeof(int) * M;
  s.do_merge = (int*)q; q += sizeof(int) * M;
  s.first_b = (int*)q;  q += sizeof(int) * M;
  s.keepm = (int*)q;    q += sizeof(int) * M;
  s.msum = (uint8_t*)q;

  const int n = blockIdx.x;
  for (int e = t; e < M * J * 6; e += blockDim.x) s.sub[e] = -1.0f;
  for (int m = t; m < M; m += blockDim.x) s.used[m] = 0;
  __syncthreads();

  const float* img = packed + (size_t)n * p.L * K * NCOL;
  for (int l = 0; l < p.L; ++l)
    limb_step(s, p, img + (size_t)l * K * NCOL, skel[2 * l], skel[2 * l + 1]);
  for (int r = 0; r < p.settle; ++r) merge_pass(s, p);

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
  // stable descending sort of (kept ? score : -1): rank by counting
  for (int m = t; m < M; m += blockDim.x) {
    const float key = s.keepm[m] ? s.score[m] : -1.0f;
    int rank = 0;
    for (int o = 0; o < M; ++o) {
      const float ko = s.keepm[o] ? s.score[o] : -1.0f;
      rank += ko > key || (ko == key && o < m);
    }
    if (rank >= p.max_poses) continue;
    float* dst = poses + ((size_t)n * p.max_poses + rank) * J * 6;
    for (int e = 0; e < J * 6; ++e) {
      const float v = s.keepm[m] ? s.sub[m * J * 6 + e] : 0.0f;
      dst[e] = v == -1.0f ? 0.0f : v;
    }
    scores[(size_t)n * p.max_poses + rank] = s.keepm[m] ? s.score[m] : 0.0f;
  }
  if (t == 0) {
    int c = 0;
    for (int m = 0; m < M; ++m) c += s.keepm[m];
    counts[n] = c;
  }
}

size_t smem_bytes(int K, int J, int M) {
  return sizeof(unsigned long long) * 4 * M + sizeof(float) * M * J * 6 +
         sizeof(float) * K * NCOL + sizeof(float) * M + sizeof(int) * M * 5 +
         sizeof(int) * K + (size_t)M * K;
}

}  // namespace

extern "C" {

// packed (N, L, K, 13) f32, skel (L, 2) i32 on the device ->
// poses (N, max_poses, J, 6) f32, scores (N, max_poses) f32, counts (N) i32.
// Requires M <= 64 (merge masks are 64-bit), K <= 256, max_poses <= M.
int og_group_skeletons(const float* packed, const int* skel, int N, int L,
                       int K, int J, int M, int max_poses, int settle,
                       int sort_dim, int use_scale, float dist_max,
                       float person_thre, float* poses, float* scores,
                       int* counts, void* stream) {
  Params p{L, K, J, M, max_poses, settle, sort_dim, use_scale, dist_max,
           person_thre};
  const size_t bytes = smem_bytes(K, J, M);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  group_kernel<<<N, THREADS, bytes, (cudaStream_t)stream>>>(
      packed, skel, p, poses, scores, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
