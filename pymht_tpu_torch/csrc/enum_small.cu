// Tier 2 of the selection: the exact solve of every small cluster (2 to 4
// targets) over each member's top-C candidate leaves, hand-written for
// Hopper (sm_90a).
//
// It replaces no TPU kernel.  The JAX package leaves this enumeration to
// XLA (`_enum_small_clusters` / `_enum_buckets`, pymht_tpu/core/select.py),
// and the port's plain twin is `core/select._enum_buckets`, which builds
// for every bucket the score and feasibility of all C^4 combinations as
// broadcast planes, whether the bucket holds four members, two or none.
// Here one block solves one bucket and walks only the C^k combinations of
// its k members.
//
// Per bucket (one row of `members`, K = 4 target ids, T for "none"):
//   k      = the leading members that are < T
//   conf_ab[ca] bit cb = some slot s of candidate ca of member a, with
//            s < n_slots, equals some slot of candidate cb of member b
//   value  = ((f_0 + f_1) + f_2) + f_3 in f32 over the members' chosen
//            candidates, a padded member adding +0.0
//   best   = the lowest flat index c_0 C^3 + c_1 C^2 + c_2 C + c_3 (the
//            padded members' digits 0) among the feasible combinations of
//            least value, and `val` that value; (0, +inf) when none is
//            feasible or the least value is +inf, (0, +0.0) when k = 0
// which is, bit for bit, the `argmin` and `amin` of the twin's planes: a
// combination that differs from another only in a padded member's digit
// has the same value and feasibility and a higher index, so it never
// wins the tie.  Scores are finite or +inf (dead leaves are 1e4); a NaN
// is not ordered as torch's argmin orders it.
//
// What bounds it on an H100: neither bytes nor operations, but a launch
// and one block's chain of work.  At the swarm's shape (512 buckets,
// C=16, W=6) the inputs a bucket reads are a few kilobytes (its members'
// C scores and C x 2W slot ids), 3.3 MB over all buckets if every bucket
// were full, about 1 us at 3.35 TB/s; a full bucket is 65,536 adds and
// compares.  The twin moved ~1.9 GB a scan to do the same.
//
// The design:
// 1. Grid.  One block per bucket over the flat [prod(lead) * B] buckets,
//    one launch per selection.  A block whose first member is T writes
//    (0, +0.0) and leaves: an empty bucket costs one read.
// 2. Gather.  The block reads its members' candidates itself: the scores
//    cand_f[s, m, :] and, through cand_idx[s, m, :], the slot ids
//    slots[s, m, leaf, :] (s the bucket's scenario), into shared memory,
//    slots as [member][window][candidate] so that the lanes of a warp,
//    on neighbouring candidates, read neighbouring words.  A slot id is
//    kept as a 32-bit code: the id where it is < n_slots, else NO_SLOT,
//    which no kept id equals (the launch refuses n_slots >= NO_SLOT; the
//    ids select makes lie in [0, n_slots]).
// 3. Conflicts.  For each of the k(k-1)/2 pairs (a, b) and each candidate
//    ca of a, one warp builds the C-bit row conf_ab[ca] with a ballot:
//    lane cb compares candidate cb's slots with ca's.  Where C <= 16 the
//    warp's 32 / Cp lane groups (Cp: C rounded up to a power of two) split
//    ca's slots between them and the ballot's groups are ORed.  Up to
//    REG_W2 slot columns a lane holds cb's slots in registers, so each of
//    ca's slots costs one shared-memory read and W2 compares; the loads do
//    not wait on one another (a kernel instance for wider windows reads
//    them from shared memory).  Each compare waiting on its own load was
//    most of a bucket's time (PERF.md, section 6).
// 4. Walk.  A thread takes prefixes (the first k - 1 digits, C^(k-1) of
//    them) in turn, skips a prefix whose own pairs conflict, ANDs the rows
//    of the last member's candidates that the prefix allows into one mask,
//    and walks that mask's bits in ascending order, keeping the least
//    (value, index) with a strict compare: its first hit of a value is its
//    lowest index.  The digits are scalars, per k, so nothing spills to
//    local memory.
// 5. Reduce.  Lexicographic (value, index) minimum over the warp by
//    shuffles, then over the warps in shared memory; thread 0 writes the
//    flat index and the value, and adds 1 to the program's counter of
//    solved buckets (an int64 slot of utils/timing's counters, or none).
//    Thread 0 of block 0 adds 1 to a second slot, the launches, first of
//    all, so that a launch counts itself on the device even where its
//    first bucket is empty (a graph's replay counts only what ran).
// 6. Block.  512 threads.  Timed with 256, 512 and 1,024 on a swarm
//    scan's buckets, a coastal scan's, Monte-Carlo's 1,024 buckets of two
//    and 256 full buckets, 512 came within 5.1 us of the fastest on each;
//    1,024 fell 13.3 us behind on Monte-Carlo's, 256 up to 19.7 on the
//    swarm's (PERF.md, section 6).
// The launch allocates nothing and synchronises nothing; it raises the
// kernel's dynamic shared-memory limit only when a bucket's staging needs
// more than 48 KB (2W above 96 at C = 32).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define ENUM_THREADS 512
#define ENUM_WARPS (ENUM_THREADS / 32)
#define ENUM_MAX_K 4
#define ENUM_MAX_C 32
#define ENUM_PAIRS 6
#define REG_W2 16                // slot columns a lane holds in registers
#define NO_SLOT 0x7fffffff
// a block's shared memory less the kernel's static arrays
#define ENUM_MAX_SMEM (232448 - 2048)

namespace {

struct EnumArgs {
  const float* cand_f;      // [nb, T, C]
  const int64_t* cand_idx;  // [nb, T, C], leaf ids in [0, L)
  const int64_t* slots;     // [nb, T, L, W2]
  const int64_t* members;   // [nb, B, K], target ids, T for none
  int64_t* best;            // [nb, B]
  float* val;               // [nb, B]
  unsigned long long* counter;  // solved buckets, or null
  unsigned long long* calls;    // launches, or null
  int64_t n_slots;
  int T, L, C, W2, B, K;
};

// Dynamic shared memory of one block: the members' slot codes.
inline size_t enum_smem(int K, int C, int W2) {
  return (size_t)K * W2 * C * sizeof(int);
}

__device__ inline bool lex_less(float v, int j, float bv, int bj) {
  return v < bv || (v == bv && j < bj);
}

// W2R > 0: W2 <= W2R, each lane's row of the later member in registers;
// W2R == 0: any W2, both rows read from shared memory.
template <int W2R>
__global__ void __launch_bounds__(ENUM_THREADS)
enum_small_kernel(EnumArgs a) {
  extern __shared__ int ss[];                   // [k][W2][C] slot codes
  __shared__ float sf[ENUM_MAX_K * ENUM_MAX_C];  // [k][C] scores
  // conf[pair * C + ca], pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
  __shared__ uint32_t conf[ENUM_PAIRS * ENUM_MAX_C];
  __shared__ int sm[ENUM_MAX_K];
  __shared__ float red_v[ENUM_WARPS];
  __shared__ int red_j[ENUM_WARPS];

  const int bucket = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, W2 = a.W2, K = a.K;
  if (bucket == 0 && tid == 0 && a.calls) atomicAdd(a.calls, 1ull);
  if (tid < K) sm[tid] = (int)a.members[(int64_t)bucket * K + tid];
  __syncthreads();
  int k = 0;
  while (k < K && sm[k] < a.T) ++k;
  if (k == 0) {
    if (tid == 0) {
      a.best[bucket] = 0;
      a.val[bucket] = 0.0f;
    }
    return;
  }

  // 2. gather the members' candidates
  const int64_t row0 = (int64_t)(bucket / a.B) * a.T;
  for (int e = tid; e < k * C; e += ENUM_THREADS) {
    const int i = e / C;
    sf[e] = a.cand_f[(row0 + sm[i]) * C + (e - i * C)];
  }
  for (int e = tid; e < k * C * W2; e += ENUM_THREADS) {
    const int i = e / (C * W2), r = e - i * C * W2;
    const int c = r / W2, w = r - c * W2;
    const int64_t row = row0 + sm[i];
    const int64_t leaf = a.cand_idx[row * C + c];
    const int64_t v = a.slots[(row * a.L + leaf) * W2 + w];
    ss[(i * W2 + w) * C + c] = v < a.n_slots ? (int)v : NO_SLOT;
  }
  __syncthreads();

  // 3. the pairs' conflict rows, one warp per (pair, ca)
  int cp = 1;
  while (cp < C) cp <<= 1;
  const int groups = 32 / cp, cb = lane & (cp - 1), grp = lane / cp;
  const int npairs = k * (k - 1) / 2;
  for (int r = warp; r < npairs * C; r += ENUM_WARPS) {
    const int p = r / C, ca = r - p * C;
    int i = 0, j = 1, q = 0;            // the p-th pair (i, j), i < j < k
    for (int x = 0; x < k; ++x)
      for (int y = x + 1; y < k; ++y)
        if (q++ == p) {
          i = x;
          j = y;
        }
    bool hit = false;
    if (cb < C) {
      const int* sa = ss + i * W2 * C + ca;
      const int* sb = ss + j * W2 * C + cb;
      if constexpr (W2R > 0) {
        int bv[W2R];
#pragma unroll
        for (int w2 = 0; w2 < W2R; ++w2)
          bv[w2] = w2 < W2 ? sb[w2 * C] : NO_SLOT;
        for (int w = grp; w < W2; w += groups) {
          const int v = sa[w * C];
          if (v != NO_SLOT) {
#pragma unroll
            for (int w2 = 0; w2 < W2R; ++w2) hit |= v == bv[w2];
          }
        }
      } else {
        for (int w = grp; w < W2; w += groups) {
          const int v = sa[w * C];
          if (v != NO_SLOT) {
#pragma unroll 4
            for (int w2 = 0; w2 < W2; ++w2) hit |= v == sb[w2 * C];
          }
        }
      }
    }
    uint32_t bits = __ballot_sync(0xffffffffu, hit);
    for (int sh = cp; sh < 32; sh <<= 1) bits |= bits >> sh;
    if (lane == 0) {
      const int pid = i == 0 ? j - 1 : (i == 1 ? j + 1 : 5);
      conf[pid * C + ca] = cp == 32 ? bits : bits & ((1u << cp) - 1);
    }
  }
  __syncthreads();

  // 4. walk the prefixes; the last member's candidates by mask
  const uint32_t all = C == 32 ? 0xffffffffu : (1u << C) - 1;
  const int prefixes = k == 1 ? 1 : (k == 2 ? C : (k == 3 ? C * C
                                                          : C * C * C));
  const float* fl = sf + (k - 1) * C;
  float best_v = CUDART_INF_F;
  int best_j = 0;
  for (int pf = tid; pf < prefixes; pf += ENUM_THREADS) {
    uint32_t allowed = all;
    float pre = 0.0f;
    if (k == 2) {
      allowed &= ~conf[pf];                               // (0,1)
      pre = sf[pf];
    } else if (k == 3) {
      const int d0 = pf / C, d1 = pf - d0 * C;
      if ((conf[d0] >> d1) & 1u) continue;                // (0,1)
      allowed &= ~conf[C + d0] & ~conf[3 * C + d1];       // (0,2) (1,2)
      pre = sf[d0] + sf[C + d1];
    } else if (k == 4) {
      const int t = pf / C, d2 = pf - t * C;
      const int d0 = t / C, d1 = t - d0 * C;
      if (((conf[d0] >> d1) | (conf[C + d0] >> d2)        // (0,1) (0,2)
           | (conf[3 * C + d1] >> d2)) & 1u)              // (1,2)
        continue;
      allowed &= ~conf[2 * C + d0] & ~conf[4 * C + d1]    // (0,3) (1,3)
                 & ~conf[5 * C + d2];                     // (2,3)
      pre = (sf[d0] + sf[C + d1]) + sf[2 * C + d2];
    }
    while (allowed) {
      const int c = __ffs(allowed) - 1;
      allowed &= allowed - 1;
      float v = k == 1 ? fl[c] : pre + fl[c];
      for (int x = k; x < K; ++x) v = v + 0.0f;   // the padded members
      if (v < best_v) {
        best_v = v;
        best_j = pf * C + c;
      }
    }
  }

  // 5. the least (value, index) over the block
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
    if (lex_less(ov, oj, best_v, best_j)) {
      best_v = ov;
      best_j = oj;
    }
  }
  if (lane == 0) {
    red_v[warp] = best_v;
    red_j[warp] = best_j;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < ENUM_WARPS; ++w)
      if (lex_less(red_v[w], red_j[w], best_v, best_j)) {
        best_v = red_v[w];
        best_j = red_j[w];
      }
    int64_t scale = 1;
    for (int x = k; x < K; ++x) scale *= C;
    a.best[bucket] = (int64_t)best_j * scale;
    a.val[bucket] = best_v;
    if (a.counter) atomicAdd(a.counter, 1ull);
  }
}

}  // namespace

// Loads the kernel's module (a query of each instance's attributes), so
// that a later launch inside a stream capture loads nothing.  Returns a
// CUDA error code.
extern "C" int enum_small_prepare() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, enum_small_kernel<REG_W2>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, enum_small_kernel<0>);
  return (int)err;
}

// One block per bucket (n_buckets = prod(lead) * B) on `stream`; `counter`
// and `calls` (uint64 slots, or null) gain the non-empty buckets and 1.
// Returns cudaGetLastError() (0 on success), or -1 for a shape the kernel
// does not take (K outside 1..4, C outside 1..32, W2 < 1, n_slots outside
// [0, NO_SLOT), shared memory above what a block may have).
extern "C" int enum_small_launch(
    const void* cand_f, const void* cand_idx, const void* slots,
    const void* members, void* best, void* val, void* counter, void* calls,
    long long n_slots, int n_buckets, int T, int L, int C, int W2, int B,
    int K, void* stream) {
  if (K < 1 || K > ENUM_MAX_K || C < 1 || C > ENUM_MAX_C || W2 < 1 ||
      T < 1 || L < 1 || B < 1 || n_buckets < 0 || n_buckets % B ||
      n_slots < 0 || n_slots >= NO_SLOT)
    return -1;
  const size_t smem = enum_smem(K, C, W2);
  if (smem > ENUM_MAX_SMEM) return -1;
  if (n_buckets == 0) return 0;
  const void* kernel = W2 <= REG_W2 ? (const void*)enum_small_kernel<REG_W2>
                                    : (const void*)enum_small_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  EnumArgs a;
  a.cand_f = (const float*)cand_f;
  a.cand_idx = (const int64_t*)cand_idx;
  a.slots = (const int64_t*)slots;
  a.members = (const int64_t*)members;
  a.best = (int64_t*)best;
  a.val = (float*)val;
  a.counter = (unsigned long long*)counter;
  a.calls = (unsigned long long*)calls;
  a.n_slots = n_slots;
  a.T = T;
  a.L = L;
  a.C = C;
  a.W2 = W2;
  a.B = B;
  a.K = K;
  if (W2 <= REG_W2)
    enum_small_kernel<REG_W2>
        <<<n_buckets, ENUM_THREADS, smem, (cudaStream_t)stream>>>(a);
  else
    enum_small_kernel<0>
        <<<n_buckets, ENUM_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
