// K1: fused constant-velocity predict + innovation + all-pairs gate and
// score + the radar update's gain and covariance, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` launched by `gate_and_score_pallas`
// (pymht_tpu/ops/gate_kernel.py:34-202, the repo's only pl.pallas_call),
// and returns what the JAX package's fused default path returns beside
// it (`radar_candidates_planes`, pymht_tpu/ops/ais_fused.py:397-482).
// Per hypothesis leaf n and measurement m:
//   x_bar = A x,  P_bar = A P A^T + Q   (closed form, the reference's
//                                        T^3/3 off-diagonal kept)
//   S     = P_bar[:2,:2] + r I           (analytic 2x2 inverse and det)
//   K     = P_bar[:, :2] S^-1,  P_hat = P_bar - K P_bar[:2, :]
//   nis   = (z_m - x_bar[:2])^T S^-1 (z_m - x_bar[:2])
//   ok    = nis <= eta2 and zmask[m] and mask[n]
//   score[n, 1+m] = cnllr + nis/2 + ln lambda_ex + (2 ln 2pi + ln det S)/2
//                   - ln P_d            if ok, else 1e9
//   score[n, 0]   = cnllr - ln(1 - P_d) if the leaf is live, else 1e9
//   count[n]      = number of m with ok;  used[m] = 1 if any n has ok
// The count, the used mask and the score come from the same `ok`, so
// (score < 1e9 / 2) is the gate by construction.
//
// What bounds it on an H100: bytes.  At N=4096, M=512 it reads 0.37 MB
// and writes the 8.4 MB f32 score plane plus 0.74 MB of per-leaf outputs,
// 9.5 MB in all (2.8 us at HBM's 3.35 TB/s); the arithmetic is ~15 flops
// per pair (0.5 us at the f32 peak).  On the card the kernel is a launch,
// one chain of dependent loads and arithmetic (the prologue), and then
// the plane going out as fast as the memory system takes stores; the
// first two are not bytes and are most of the gap to the bound.
//
// The design, point by point (what was measured on the H100 is in
// PERF.md, under Findings):
// 1. Prologue.  One block owns TILE_N leaves; one lane per leaf loads x
//    and P as five float4 (64 contiguous bytes of P per lane, the lanes
//    on neighbouring leaves, so every 32-byte sector fetched is used),
//    runs the predict, S^-1, K, P_hat and the two logs, stores the
//    per-leaf outputs as float4 and leaves the 32 bytes that the pair
//    loop needs in shared memory.  The other threads load their z_m
//    meanwhile, so the barrier waits for one load latency, not two.
// 2. Stores.  Threads stand on the measurement axis and walk the tile's
//    rows: a warp writes 128 contiguous bytes of one row per store.  The
//    rows' odd stride (1+M floats) makes those stores unaligned, and a
//    flat walk of the tile with aligned 128-bit stores was built to
//    mend that, in five variants (measurements read through L1 or staged
//    in shared memory, a box test ahead of the exact gate, the plane
//    filled first and patched after, a warp kept for the prologue).
//    Every one was slower on the card than this layout: a warp issues
//    its stores in order and waits on the memory system for each, so
//    what counts is how many warps have a store in flight, not how wide
//    each store is, and the walk here gives every thread two registers
//    of z and nothing else to wait for.
// 3. Grid.  One block per tile; at the bench shape all 256 blocks are on
//    the card at once (gate_score_occupancy reports what it holds).
//    Larger and smaller tiles and blocks measured the same or slower.
// 4. Scalars.  dt is read from a device pointer (it is a device value in
//    grow and is never read back); q, r, eta2 and ln lambda_ex are kernel
//    arguments.  The launch needs no host-to-device copy.
// 5. Epilogue.  K and P_hat come from the prologue's S^-1.  A thread
//    ORs `ok` over the tile's rows in a register and touches used[m]
//    only then, and only to store a 1; gated pairs are rare, so each adds
//    to its row's counter in shared memory, and the counters go out once
//    per tile.  `used` must be zero before the launch (the wrapper
//    allocates it zeroed: one M-byte fill); the kernel only stores ones
//    into it, so blocks need no order among them.
// 6. Per-target measurements (gate_score_sub_kernel).  Under grow's
//    spatial pre-gate each target t brings its own Km nearest
//    measurements, z_sub[t] with mask zmask_sub[t], and zidx[t] says which
//    real measurement each column is (what `radar_candidates_planes(...,
//    z_sub, zmask_sub)` computes, pymht_tpu/ops/ais_fused.py:438-452, and
//    the scatter of pymht_tpu/core/grow.py:548-554).  Tiles are cut inside
//    a target (T * ceil(L / TILE_N) blocks), so a block still has one z
//    per thread and column; the plane is [N, 1 + Km] and `used` stays on
//    the real axis: used[zidx[t, k]] = 1 where a leaf of t gates column k.
//    It reuses the prologue and the row layout, and writes the pair loop
//    out a second time so that the shared-scan kernel's code, and with it
//    its measured times, stays exactly as it was.  With Km columns only
//    Km of a block's threads walk rows, so it moves ~2.3 MB at the bench
//    shape (Km = 64) and is a launch and a prologue, not a stream of
//    stores (4.3 us against a bound of 0.68 us on an H100).
// 7. A batch of scenarios (parallel/scenario.py) goes through the same
//    entry point with one "target" per scenario: L = T_s * L_s leaves of
//    scenario b meet its own scan, z_sub[b] = z[b] ([B, M, 2]), and
//    zidx[b, m] = b * M + m keeps `used` per scenario on a flat [B * M]
//    axis.  Scenarios are stepped to their own scan times, so dt is an
//    array with one entry per target, read at dt[t * dt_step]: the batch
//    passes dt_step = 1, the pre-gate its one dt with dt_step = 0 (the
//    scalar expanded, no copy).  Offsets into the plane and into z_sub
//    are size_t; the
//    leaf index n and zidx are int, and the wrapper refuses a call whose
//    16 * N or M does not fit (ops/gate_kernel.py).
#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 16;     // leaves per block
constexpr int THREADS = 256;
constexpr float BIG = 1e9f;
constexpr float LOG2PI = 1.8378770664093453f;

static_assert(TILE_N <= THREADS, "one prologue lane per leaf of the tile");

// What the pair loop needs of one leaf.
struct __align__(16) Row {
  float px, py;            // predicted position
  float i11, ioff, i22;    // S^-1, ioff = i12 + i21
  float base;              // cnllr + ln lambda_ex + log_norm - ln P_d
  float zero;              // zero-hypothesis score (BIG for a dead leaf)
  int live;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Predict, innovation, gain and updated covariance of leaf n; writes
// x_bar, P_bar, K, P_hat and returns the pair loop's row.
__device__ __forceinline__ Row leaf_prologue(
    int n, float T, float q, float r_var, float log_lam,
    const float* __restrict__ x, const float* __restrict__ P,
    const float* __restrict__ cnllr, const float* __restrict__ pd,
    const bool* __restrict__ mask, float* __restrict__ xbar,
    float* __restrict__ pbar, float* __restrict__ kgain,
    float* __restrict__ phat) {
  const float4 xv = ld4(x + 4 * n);
  float g[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = ld4(P + 16 * n + 4 * i);
    g[4 * i + 0] = v.x;
    g[4 * i + 1] = v.y;
    g[4 * i + 2] = v.z;
    g[4 * i + 3] = v.w;
  }
  const float pdv = pd[n];
  const float cn = cnllr[n];
  const bool live = mask[n];
#define G(i, j) g[4 * (i) + (j)]
  const float T2 = T * T;
  const float T3 = T2 * T / 3.0f;
  const float T4 = T2 * T2 / 4.0f;
  float pb[16];
#define PB(i, j) pb[4 * (i) + (j)]
  // (pos, vel) pairs (0,2) and (1,3)
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int a = k, b = k + 2;
    PB(a, a) = G(a, a) + T * (G(a, b) + G(b, a)) + T2 * G(b, b) + T4 * q;
    PB(a, b) = G(a, b) + T * G(b, b) + T3 * q;
    PB(b, a) = G(b, a) + T * G(b, b) + T3 * q;
    PB(b, b) = G(b, b) + T2 * q;
  }
  PB(0, 1) = G(0, 1) + T * (G(0, 3) + G(2, 1)) + T2 * G(2, 3);
  PB(1, 0) = G(1, 0) + T * (G(1, 2) + G(3, 0)) + T2 * G(3, 2);
  PB(0, 3) = G(0, 3) + T * G(2, 3);
  PB(3, 0) = G(3, 0) + T * G(3, 2);
  PB(1, 2) = G(1, 2) + T * G(3, 2);
  PB(2, 1) = G(2, 1) + T * G(2, 3);
  PB(2, 3) = G(2, 3);
  PB(3, 2) = G(3, 2);
#undef G
  const float xb0 = xv.x + T * xv.z, xb1 = xv.y + T * xv.w;
  st4(xbar + 4 * n, xb0, xb1, xv.z, xv.w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st4(pbar + 16 * n + 4 * i, PB(i, 0), PB(i, 1), PB(i, 2), PB(i, 3));

  const float s11 = PB(0, 0) + r_var, s12 = PB(0, 1);
  const float s21 = PB(1, 0), s22 = PB(1, 1) + r_var;
  const float det = s11 * s22 - s12 * s21;
  const float inv_det = 1.0f / det;
  const float i11 = s22 * inv_det, i12 = -s12 * inv_det;
  const float i21 = -s21 * inv_det, i22 = s11 * inv_det;

  // K = P_bar[:, :2] S^-1  ([4, 2], row-major)
  float kg[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kg[2 * i + 0] = PB(i, 0) * i11 + PB(i, 1) * i21;
    kg[2 * i + 1] = PB(i, 0) * i12 + PB(i, 1) * i22;
  }
  st4(kgain + 8 * n, kg[0], kg[1], kg[2], kg[3]);
  st4(kgain + 8 * n + 4, kg[4], kg[5], kg[6], kg[7]);
  // P_hat = P_bar - K P_bar[:2, :]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ph[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ph[j] = PB(i, j) - (kg[2 * i] * PB(0, j) + kg[2 * i + 1] * PB(1, j));
    st4(phat + 16 * n + 4 * i, ph[0], ph[1], ph[2], ph[3]);
  }
#undef PB

  const float log_norm = 0.5f * (2.0f * LOG2PI + logf(fmaxf(det, 1e-20f)));
  Row row;
  row.px = xb0;
  row.py = xb1;
  row.i11 = i11;
  row.ioff = i12 + i21;
  row.i22 = i22;
  row.base = cn + (log_lam + log_norm - logf(pdv));
  row.zero = live ? cn - logf(1.0f - pdv) : BIG;
  row.live = live ? 1 : 0;
  return row;
}

__global__ void __launch_bounds__(THREADS)
gate_score_kernel(const float* __restrict__ x,       // [N, 4]
                  const float* __restrict__ P,       // [N, 16]
                  const float* __restrict__ cnllr,   // [N]
                  const float* __restrict__ pd,      // [N]
                  const bool* __restrict__ mask,     // [N]
                  const float* __restrict__ z,       // [M, 2]
                  const bool* __restrict__ zmask,    // [M]
                  const float* __restrict__ dt,      // [] time step
                  float q, float r_var, float eta2, float log_lam,
                  float* __restrict__ scores,        // [N, 1 + M]
                  float* __restrict__ xbar,          // [N, 4]
                  float* __restrict__ pbar,          // [N, 16]
                  float* __restrict__ kgain,         // [N, 8]
                  float* __restrict__ phat,          // [N, 16]
                  int* __restrict__ counts,          // [N]
                  unsigned char* __restrict__ used,  // [M], zero on entry
                  int N, int M) {
  __shared__ Row s_row[TILE_N];
  __shared__ int s_cnt[TILE_N];

  const int n0 = blockIdx.x * TILE_N;
  const int rows = min(TILE_N, N - n0);
  const size_t stride = (size_t)M + 1;
  const float2* __restrict__ z2 = reinterpret_cast<const float2*>(z);

  // this thread's first measurement, asked for before the barrier
  int m = threadIdx.x;
  float2 zz = make_float2(0.0f, 0.0f);
  bool zok = false;
  if (m < M) {
    zz = __ldg(z2 + m);
    zok = zmask[m];
  }

  // ---- per-leaf prologue: one lane per leaf of the tile ----------------
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const Row row = leaf_prologue(n0 + r, __ldg(dt), q, r_var, log_lam, x, P,
                                  cnllr, pd, mask, xbar, pbar, kgain, phat);
    s_row[r] = row;
    s_cnt[r] = 0;
    scores[(size_t)(n0 + r) * stride] = row.zero;
  }
  __syncthreads();

  // ---- all-pairs NIS, gate and score: threads on the measurement axis --
  while (m < M) {
    float* __restrict__ out = scores + (size_t)n0 * stride + 1 + m;
    bool any = false;
    for (int r = 0; r < rows; ++r) {
      const Row rw = s_row[r];
      const float dx = zz.x - rw.px;
      const float dy = zz.y - rw.py;
      const float nis =
          rw.i11 * dx * dx + rw.ioff * dx * dy + rw.i22 * dy * dy;
      const bool ok = (nis <= eta2) && zok && rw.live;
      if (ok) {
        atomicAdd(&s_cnt[r], 1);
        any = true;
      }
      out[(size_t)r * stride] = ok ? rw.base + 0.5f * nis : BIG;
    }
    if (any) used[m] = 1;
    m += THREADS;
    if (m < M) {
      zz = __ldg(z2 + m);
      zok = zmask[m];
    }
  }
  __syncthreads();

  if (threadIdx.x < rows) counts[n0 + threadIdx.x] = s_cnt[threadIdx.x];
}

// Per-target variant: leaf n = t * L + l is gated against z_sub[t].
__global__ void __launch_bounds__(THREADS)
gate_score_sub_kernel(const float* __restrict__ x,       // [T * L, 4]
                      const float* __restrict__ P,       // [T * L, 16]
                      const float* __restrict__ cnllr,   // [T * L]
                      const float* __restrict__ pd,      // [T * L]
                      const bool* __restrict__ mask,     // [T * L]
                      const float* __restrict__ z_sub,   // [T, Km, 2]
                      const bool* __restrict__ zmask_sub,  // [T, Km]
                      const int* __restrict__ zidx,      // [T, Km] in [0, M)
                      const float* __restrict__ dt,      // [T] time steps
                      float q, float r_var, float eta2, float log_lam,
                      float* __restrict__ scores,        // [T * L, 1 + Km]
                      float* __restrict__ xbar,          // [T * L, 4]
                      float* __restrict__ pbar,          // [T * L, 16]
                      float* __restrict__ kgain,         // [T * L, 8]
                      float* __restrict__ phat,          // [T * L, 16]
                      int* __restrict__ counts,          // [T * L]
                      unsigned char* __restrict__ used,  // [M], zero on entry
                      int L, int Km, int M, int tiles, int dt_step) {
  __shared__ Row s_row[TILE_N];
  __shared__ int s_cnt[TILE_N];

  const int t = blockIdx.x / tiles;
  const int l0 = (blockIdx.x % tiles) * TILE_N;
  const int rows = min(TILE_N, L - l0);
  const int n0 = t * L + l0;
  const size_t stride = (size_t)Km + 1;
  const float2* __restrict__ z2 =
      reinterpret_cast<const float2*>(z_sub) + (size_t)t * Km;
  const bool* __restrict__ zm = zmask_sub + (size_t)t * Km;
  const int* __restrict__ zi = zidx + (size_t)t * Km;

  int m = threadIdx.x;
  float2 zz = make_float2(0.0f, 0.0f);
  bool zok = false;
  if (m < Km) {
    zz = __ldg(z2 + m);
    zok = zm[m];
  }

  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const Row row = leaf_prologue(n0 + r, __ldg(dt + (size_t)t * dt_step), q,
                                  r_var, log_lam, x, P, cnllr, pd, mask, xbar,
                                  pbar, kgain, phat);
    s_row[r] = row;
    s_cnt[r] = 0;
    scores[(size_t)(n0 + r) * stride] = row.zero;
  }
  __syncthreads();

  while (m < Km) {
    float* __restrict__ out = scores + (size_t)n0 * stride + 1 + m;
    bool any = false;
    for (int r = 0; r < rows; ++r) {
      const Row rw = s_row[r];
      const float dx = zz.x - rw.px;
      const float dy = zz.y - rw.py;
      const float nis =
          rw.i11 * dx * dx + rw.ioff * dx * dy + rw.i22 * dy * dy;
      const bool ok = (nis <= eta2) && zok && rw.live;
      if (ok) {
        atomicAdd(&s_cnt[r], 1);
        any = true;
      }
      out[(size_t)r * stride] = ok ? rw.base + 0.5f * nis : BIG;
    }
    // a masked column's index may point anywhere: it is read only under
    // `ok`, and an index outside [0, M) is never stored through
    if (any) {
      const int j = zi[m];
      if ((unsigned)j < (unsigned)M) used[j] = 1;
    }
    m += THREADS;
    if (m < Km) {
      zz = __ldg(z2 + m);
      zok = zm[m];
    }
  }
  __syncthreads();

  if (threadIdx.x < rows) counts[n0 + threadIdx.x] = s_cnt[threadIdx.x];
}

}  // namespace

// C interface, loaded with ctypes.

// SMs of the current device and the blocks of K1 each can hold at once;
// returns 0 on success.
extern "C" int gate_score_occupancy(int* sms, int* blocks_per_sm) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, gate_score_kernel, THREADS, 0) != cudaSuccess)
    return 1;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller allocates every output and zeroes `used`.
extern "C" int gate_score_launch(
    const void* x, const void* P, const void* cnllr, const void* pd,
    const void* mask, const void* z, const void* zmask, const void* dt,
    float q, float r_var, float eta2, float log_lam, void* scores,
    void* xbar, void* pbar, void* kgain, void* phat, void* counts,
    void* used, int N, int M, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + TILE_N - 1) / TILE_N;
  gate_score_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)P, (const float*)cnllr,
      (const float*)pd, (const bool*)mask, (const float*)z,
      (const bool*)zmask, (const float*)dt, q, r_var, eta2, log_lam,
      (float*)scores, (float*)xbar, (float*)pbar, (float*)kgain,
      (float*)phat, (int*)counts, (unsigned char*)used, N, M);
  return (int)cudaGetLastError();
}

// The per-target entry point: leaf n of target n / L against z_sub[n / L]
// ([T, Km, 2]) at time step dt[(n / L) * dt_step], scores [T * L, 1 + Km],
// used [M] through zidx [T, Km].
extern "C" int gate_score_sub_launch(
    const void* x, const void* P, const void* cnllr, const void* pd,
    const void* mask, const void* z_sub, const void* zmask_sub,
    const void* zidx, const void* dt, float q, float r_var, float eta2,
    float log_lam, void* scores, void* xbar, void* pbar, void* kgain,
    void* phat, void* counts, void* used, int T, int L, int Km, int M,
    int dt_step, void* stream) {
  if (T <= 0 || L <= 0) return 0;
  const int tiles = (L + TILE_N - 1) / TILE_N;
  gate_score_sub_kernel<<<T * tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)P, (const float*)cnllr,
      (const float*)pd, (const bool*)mask, (const float*)z_sub,
      (const bool*)zmask_sub, (const int*)zidx, (const float*)dt, q, r_var,
      eta2, log_lam, (float*)scores, (float*)xbar, (float*)pbar,
      (float*)kgain, (float*)phat, (int*)counts, (unsigned char*)used, L, Km,
      M, tiles, dt_step);
  return (int)cudaGetLastError();
}
