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
// 6. Per-target measurements (gate_score_sub_kernel, redesigned for this
//    card on its own, apart from the shared-scan kernel above, whose code
//    and measured times stay as they were).  Under grow's spatial
//    pre-gate each target t brings its own Km nearest measurements,
//    z_sub[t] with mask zmask_sub[t], and zidx[t] says which real
//    measurement each column is (what `radar_candidates_planes(...,
//    z_sub, zmask_sub)` computes, pymht_tpu/ops/ais_fused.py:438-452, and
//    the scatter of pymht_tpu/core/grow.py:548-554).  The plane is
//    [N, 1 + Km] and `used` stays on the real axis: used[zidx[t, k]] = 1
//    where a leaf of t gates column k.  With threads on the column axis
//    (the shared-scan layout) three warps in four would wait at Km <= 64,
//    so the design is its own:
//    a. Tiles run across targets.  Tile k is leaves [kR, kR + R) of the
//       flat N axis, R a multiple of 16, so every tile but the last is
//       full whatever L is.  Each row finds its target t = n / L, its dt
//       and its columns; the z_sub, zmask_sub and zidx of the targets the
//       tile touches (at most (R + L - 2) / L + 1 of them) are staged in
//       shared memory.
//    b. Every thread on the plane.  2^cols_log2 threads share a row's
//       columns, SUB_COLS each, and each of the block's row groups walks
//       at most 32 contiguous rows: a thread holds its columns' z in
//       registers while its rows stream past (rows of one target, the
//       rule at L >= 16, run without a branch).  A thread keeps one bit
//       per (row, column) gated; per row, a ballot and popc over the warp
//       give its share of the count, so no atomics; a column that gated
//       marks its (target, column) in a shared byte array, and after the
//       tile each mark stores one 1 into `used`.
//    c. Bulk asynchronous copies.  Lanes of the last warp load the tile's
//       leaf inputs and its targets' columns with cp.async.bulk, one
//       buffer each, completed on an mbarrier; the prologue (one thread
//       per leaf, the first R / 32 warps) and the pair loop build the
//       plane tile and the per-leaf outputs in shared memory, and the same
//       lanes write them back with cp.async.bulk, each in its own
//       bulk_group (wait_group.read before a buffer is reused).  Rows
//       n0 ... n0 + R - 1 of the plane are one contiguous range, 16-byte
//       aligned whenever n0 = 0 (mod 4), so one copy writes the whole
//       tile whatever Km's parity.  A buffer sits in shared memory at its
//       global address's offset modulo 128; its 16-byte-aligned middle
//       goes by bulk copy and a head or tail of under 16 bytes by plain
//       loads or stores of its lane (the last, ragged tile; zmask_sub when
//       Km is not a multiple of 16; a caller's view off a 16-byte
//       boundary).  Nothing falls back to another kernel.
//    d. A persistent grid with a two-stage ring (stages = 2): as many
//       blocks as the card holds at once walk the tiles; a block loads
//       tile i + 1 while it computes tile i, and tile i's stores drain
//       while tile i + 1 is built in the other stage's buffers.  With
//       stages = 1 each block takes one tile.
//    e. The tile plan (R, threads, cols_log2, grid, shared memory,
//       stages) is Python (ops/gate_kernel.sub_plan), chosen per shape
//       from what was measured on the H100 (PERF.md, Findings): the ring
//       only where a shape has many tiles per SM; 128 threads at Km <= 32
//       and Km >= 256.  The launcher recomputes the shared-memory layout
//       and refuses a plan that disagrees with it; above 48 KB it raises
//       the kernel's dynamic shared-memory limit.  At Km >= 256 (a row
//       over a kilobyte), and wherever even 16 rows cannot be staged, the
//       plane goes out by plain coalesced stores and the columns are read
//       from global memory (staged = false): the same kernel, one template
//       argument.  Measured on the H100, that is 1 % faster at Km = 512;
//       at Km <= 64 the staged plane and its bulk copy are faster at every
//       timed shape but the swarm's (PERF.md, Findings).
//    f. No tensor cores.  The kernel does ~15 f32 operations per pair on
//       data it reads once and writes once; it is bound by bytes, and a
//       matrix unit has nothing to multiply.
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

#include <cstddef>
#include <cstdint>

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

// ---- the per-target entry point (design point 6) ---------------------

constexpr int SUB_MAX_THREADS = 256;
constexpr int SUB_MAX_DEVICES = 64;
constexpr int SUB_ALIGN = 128;     // a buffer's placement in shared memory
constexpr int SUB_SLOTS = SUB_MAX_THREADS / 32;   // count partials per row
constexpr int SUB_LOADS = 8;       // bulk loads per tile (lanes of a warp)
constexpr int SUB_STORES = 6;      // bulk stores per tile (lanes of a warp)
constexpr int SUB_UNROLL = 2;      // rows a thread works on at once
constexpr int SUB_COLS = 4;        // columns a thread works on at once

// What the pair loop needs of one leaf of the per-target kernel.
struct __align__(16) SubRow {
  float px, py;            // predicted position
  float i11, ioff, i22;    // S^-1, ioff = i12 + i21
  float base;              // cnllr + ln lambda_ex + log_norm - ln P_d
  int t;                   // the leaf's target
  float gate;              // eta2 for a live leaf, NaN for a dead one
};

// A NaN: no comparison with it holds, so a NIS compared with it (or made
// from it) is never within a gate.
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// The arguments of one launch; passed by value.
struct SubArgs {
  const float* x;          // [N, 4]
  const float* P;          // [N, 16]
  const float* cnllr;      // [N]
  const float* pd;         // [N]
  const bool* mask;        // [N]
  const float* z_sub;      // [T, Km, 2]
  const bool* zmask_sub;   // [T, Km]
  const int* zidx;         // [T, Km], used only where in [0, M)
  const float* dt;         // dt[t * dt_step]
  float q, r_var, eta2, log_lam;
  float* scores;           // [N, 1 + Km]
  float* xbar;             // [N, 4]
  float* pbar;             // [N, 16]
  float* kgain;            // [N, 8]
  float* phat;             // [N, 16]
  int* counts;             // [N]
  unsigned char* used;     // [M], zero on entry
  int N, L, Km, M, dt_step;
  int R;                   // leaves per tile, a multiple of 16
  int cols_log2;           // 2^cols_log2 threads share a row's columns
  int nt;                  // targets a tile may touch
  int stages;              // 1 or 2 buffers of inputs and outputs
};

__host__ __device__ inline uint32_t round_up(uint32_t n, uint32_t align) {
  return (n + align - 1) / align * align;
}

// A region for `n` bytes placed at any offset modulo SUB_ALIGN.
__host__ __device__ inline uint32_t sub_region(uint32_t n) {
  return round_up(n, SUB_ALIGN) + SUB_ALIGN;
}

// Byte offsets of the dynamic shared memory: two mbarriers, the rows, the
// rows' count partials, the (target, column) marks, then `stages` copies
// of the stage (its inputs, then its outputs).  The buffers of a stage
// are in the order of the lanes that copy them.  ops/gate_kernel.
// sub_smem_bytes mirrors `total`.
struct SubLayout {
  uint32_t buf[SUB_LOADS + SUB_STORES];   // x, P, cnllr, pd, mask, z_sub,
  // zmask_sub, zidx; plane, xbar, pbar, kgain, phat, counts
  uint32_t stage, rows, parts, marks, first, total;
};

__host__ __device__ inline SubLayout sub_layout(int R, int nt, int Km,
                                                int stages, bool staged) {
  SubLayout s{};
  const uint32_t r = R, z = static_cast<uint32_t>(nt) * Km;
  const uint32_t bytes[SUB_LOADS + SUB_STORES] = {
      r * 16, r * 64, r * 4, r * 4, r, z * 8, z, z * 4,
      r * (Km + 1) * 4, r * 16, r * 64, r * 32, r * 64, r * 4};
  uint32_t o = 0;
  for (int i = 0; i < SUB_LOADS + SUB_STORES; ++i) {
    s.buf[i] = o;
    const bool columns = i >= 5 && i <= SUB_LOADS;   // z family, plane
    if (staged || !columns) o += sub_region(bytes[i]);
  }
  s.stage = o;
  s.rows = 16;
  s.parts = s.rows + r * sizeof(SubRow);
  s.marks = s.parts + r * SUB_SLOTS * 4;
  s.first = round_up(s.marks + (staged ? z : 0), SUB_ALIGN);
  s.total = s.first + static_cast<uint32_t>(stages) * s.stage;
  return s;
}

// lay.buf[i] for a run-time i, without indexing a register array.
__device__ __forceinline__ uint32_t buf_at(const SubLayout& lay, int i) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < SUB_LOADS + SUB_STORES; ++j)
    if (j == i) o = lay.buf[j];
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar,
                                                     uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Global -> shared, `n` a multiple of 16, both addresses 16-byte aligned;
// completes `n` bytes of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

// Shared -> global in the thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_u32(src)), "r"(n) : "memory");
}

// Where a buffer whose tile starts at global address g lies in its
// region: at g's offset modulo SUB_ALIGN, so that the two addresses agree
// modulo 16 (what a bulk copy needs) and modulo 128.
template <typename T>
__device__ __forceinline__ T* placed(unsigned char* region, const void* g) {
  return reinterpret_cast<T*>(
      region + (reinterpret_cast<uintptr_t>(g) & (SUB_ALIGN - 1)));
}

// The three parts of a copy of n bytes at global address g: a head up to
// the first 16-byte boundary, a middle of whole 16-byte blocks, a tail.
struct Split {
  uint32_t head, mid;
};

__device__ __forceinline__ Split split(const void* g, uint32_t n) {
  const uint32_t off = static_cast<uint32_t>(
      reinterpret_cast<uintptr_t>(g) & 15);
  const uint32_t head = min(n, (16u - off) & 15u);
  return {head, (n - head) & ~15u};
}

__device__ __forceinline__ float4 lds4(const float* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// The per-leaf outputs are 16-byte aligned (the wrapper checks), and so
// are their staged rows.
__device__ __forceinline__ void sts4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Leaves [n0, n0 + rows) of targets [t0, t0 + nt).
struct Tile {
  int n0, rows, t0, nt;
};

__device__ __forceinline__ Tile tile_at(const SubArgs& a, int k) {
  Tile t;
  t.n0 = k * a.R;
  t.rows = min(a.R, a.N - t.n0);
  t.t0 = t.n0 / a.L;
  t.nt = (t.n0 + t.rows - 1) / a.L - t.t0 + 1;
  return t;
}

// Buffer i of tile `tl` in global memory and its size in bytes: the loads
// (i < SUB_LOADS) and then the stores, in the layout's order.
__device__ __forceinline__ unsigned char* tile_buffer(const SubArgs& a,
                                                      const Tile& tl, int i,
                                                      uint32_t& n) {
  const size_t n0 = tl.n0, z0 = static_cast<size_t>(tl.t0) * a.Km;
  const uint32_t r = tl.rows, zn = static_cast<uint32_t>(tl.nt) * a.Km;
  const void* p = nullptr;
  switch (i) {
    case 0: p = a.x + 4 * n0; n = r * 16; break;
    case 1: p = a.P + 16 * n0; n = r * 64; break;
    case 2: p = a.cnllr + n0; n = r * 4; break;
    case 3: p = a.pd + n0; n = r * 4; break;
    case 4: p = a.mask + n0; n = r; break;
    case 5: p = a.z_sub + 2 * z0; n = zn * 8; break;
    case 6: p = a.zmask_sub + z0; n = zn; break;
    case 7: p = a.zidx + z0; n = zn * 4; break;
    case 8: p = a.scores + (static_cast<size_t>(a.Km) + 1) * n0;
            n = r * (a.Km + 1) * 4; break;
    case 9: p = a.xbar + 4 * n0; n = r * 16; break;
    case 10: p = a.pbar + 16 * n0; n = r * 64; break;
    case 11: p = a.kgain + 8 * n0; n = r * 32; break;
    case 12: p = a.phat + 16 * n0; n = r * 64; break;
    default: p = a.counts + n0; n = r * 4; break;
  }
  return static_cast<unsigned char*>(const_cast<void*>(p));
}

// The copying warp: every input of tile k into stage buffer `st`, lane i
// copying buffer i: its head and tail by plain loads, then lane 0's
// arrival with the bytes to come (which releases the plain loads), then
// the middles by bulk copies completing on `bar`.
template <bool STAGED>
__device__ void issue_tile(const SubArgs& a, const SubLayout& lay, int k,
                           unsigned char* st, uint64_t* bar, int lane) {
  const Tile tl = tile_at(a, k);
  uint32_t n = 0, mid = 0, head = 0;
  const unsigned char* g = nullptr;
  unsigned char* d = nullptr;
  if (lane < (STAGED ? SUB_LOADS : 5)) {
    g = tile_buffer(a, tl, lane, n);
    d = placed<unsigned char>(st + buf_at(lay, lane), g);
    const Split p = split(g, n);
    head = p.head;
    mid = p.mid;
    for (uint32_t i = 0; i < head; ++i) d[i] = g[i];
    for (uint32_t i = head + mid; i < n; ++i) d[i] = g[i];
  }
  const uint32_t total = __reduce_add_sync(0xffffffffu, mid);
  __syncwarp();
  if (lane == 0) bar_arrive_expect_tx(bar, total);
  __syncwarp();
  if (mid) bulk_load(d + head, g + head, mid, bar);
}

// Column c of target t, from the staged columns (STAGED) or from global
// memory; a masked column's position is NaN, so its NIS is never within a
// gate.
template <bool STAGED>
__device__ __forceinline__ float2 load_column(const SubArgs& a,
                                              const float2* zs,
                                              const unsigned char* zms,
                                              int t, int t0, int c) {
  float2 zz;
  bool zok;
  if constexpr (STAGED) {
    const int zo = (t - t0) * a.Km + c;
    zz = zs[zo];
    zok = zms[zo];
  } else {
    const size_t zo = static_cast<size_t>(t) * a.Km + c;
    zz = __ldg(reinterpret_cast<const float2*>(a.z_sub) + zo);
    zok = a.zmask_sub[zo];
  }
  return zok ? zz : make_float2(nan_f(), nan_f());
}

// One pair's score: cnllr + nis / 2 + ... where gated (nis <= eta2, the
// leaf live and the column valid: rw.gate and load_column fold the last
// two into the first, with NaNs), else exactly BIG.
__device__ __forceinline__ float pair(const SubRow& rw, float2 zz,
                                      bool& ok) {
  const float dx = zz.x - rw.px;
  const float dy = zz.y - rw.py;
  const float nis = rw.i11 * dx * dx + rw.ioff * dx * dy + rw.i22 * dy * dy;
  ok = nis <= rw.gate;
  return ok ? rw.base + 0.5f * nis : BIG;
}

// Where row r's measurement columns start: in the staged plane tile
// (STAGED) or in the plane in global memory.
template <bool STAGED>
__device__ __forceinline__ float* row_out(const SubArgs& a, float* plane,
                                          int n0, int r) {
  if constexpr (STAGED)
    return plane + r * (a.Km + 1) + 1;
  else
    return a.scores + (static_cast<size_t>(a.Km) + 1) * (n0 + r) + 1;
}

// Column c of target t gated a leaf: mark it for `used` (STAGED: in the
// tile's marks, stored through zidx after the tile), or store through
// zidx now.  A masked column's index may point anywhere: it is read only
// where a leaf gated, and an index outside [0, M) is never stored through.
template <bool STAGED>
__device__ __forceinline__ void mark_used(const SubArgs& a,
                                          unsigned char* marks, int t,
                                          int t0, int c) {
  if constexpr (STAGED) {
    marks[(t - t0) * a.Km + c] = 1;
  } else {
    const int j = __ldg(a.zidx + static_cast<size_t>(t) * a.Km + c);
    if ((unsigned)j < (unsigned)a.M) a.used[j] = 1;
  }
}

// Predict, innovation, gain and updated covariance of one leaf from its
// staged inputs; the same arithmetic as leaf_prologue.  Writes x_bar,
// P_bar, K and P_hat to their staged rows and returns the zero score.
__device__ __forceinline__ float sub_prologue(
    const float* xs, const float* Ps, float cn, float pdv, bool live,
    float T, float q, float r_var, float eta2, float log_lam, float* xb,
    float* pb_out, float* kg_out, float* ph_out, SubRow& row) {
  const float4 xv = lds4(xs);
  float g[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = lds4(Ps + 4 * i);
    g[4 * i + 0] = v.x;
    g[4 * i + 1] = v.y;
    g[4 * i + 2] = v.z;
    g[4 * i + 3] = v.w;
  }
#define G(i, j) g[4 * (i) + (j)]
  const float T2 = T * T;
  const float T3 = T2 * T / 3.0f;
  const float T4 = T2 * T2 / 4.0f;
  float pb[16];
#define PB(i, j) pb[4 * (i) + (j)]
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
  sts4(xb, xb0, xb1, xv.z, xv.w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sts4(pb_out + 4 * i, PB(i, 0), PB(i, 1), PB(i, 2), PB(i, 3));

  const float s11 = PB(0, 0) + r_var, s12 = PB(0, 1);
  const float s21 = PB(1, 0), s22 = PB(1, 1) + r_var;
  const float det = s11 * s22 - s12 * s21;
  const float inv_det = 1.0f / det;
  const float i11 = s22 * inv_det, i12 = -s12 * inv_det;
  const float i21 = -s21 * inv_det, i22 = s11 * inv_det;

  float kg[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kg[2 * i + 0] = PB(i, 0) * i11 + PB(i, 1) * i21;
    kg[2 * i + 1] = PB(i, 0) * i12 + PB(i, 1) * i22;
  }
  sts4(kg_out, kg[0], kg[1], kg[2], kg[3]);
  sts4(kg_out + 4, kg[4], kg[5], kg[6], kg[7]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ph[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ph[j] = PB(i, j) - (kg[2 * i] * PB(0, j) + kg[2 * i + 1] * PB(1, j));
    sts4(ph_out + 4 * i, ph[0], ph[1], ph[2], ph[3]);
  }
#undef PB

  const float log_norm = 0.5f * (2.0f * LOG2PI + logf(fmaxf(det, 1e-20f)));
  row.px = xb0;
  row.py = xb1;
  row.i11 = i11;
  row.ioff = i12 + i21;
  row.i22 = i22;
  row.base = cn + (log_lam + log_norm - logf(pdv));
  row.gate = live ? eta2 : nan_f();
  return live ? cn - logf(1.0f - pdv) : BIG;
}

// Leaf n = t * L + l against z_sub[t] at dt[t * dt_step].  STAGED: the
// targets' columns and the plane tile in shared memory (design point 6c);
// otherwise the columns are read from global memory and the plane is
// stored directly (6e).
template <bool STAGED>
__global__ void __launch_bounds__(SUB_MAX_THREADS, 2)
gate_score_sub_kernel(const SubArgs a) {
  extern __shared__ __align__(SUB_ALIGN) unsigned char smem[];
  const SubLayout lay = sub_layout(a.R, a.nt, a.Km, a.stages, STAGED);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  SubRow* s_row = reinterpret_cast<SubRow*>(smem + lay.rows);
  int* parts = reinterpret_cast<int*>(smem + lay.parts);
  unsigned char* marks = smem + lay.marks;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the last warp issues the bulk copies; the first R / 32 run the
  // prologue
  const bool copier = warp == (nthr >> 5) - 1;
  const size_t W = static_cast<size_t>(a.Km) + 1;
  const int tiles = (a.N + a.R - 1) / a.R;
  // the pair loop: CS threads share a row's columns (thread cs takes
  // columns cs + j CS, j < SUB_COLS, then the next CS * SUB_COLS), and
  // each of the nthr / CS row groups walks `rpg` rows
  const int CS = 1 << a.cols_log2;
  const int cs = tid & (CS - 1);
  const int rpg = (a.R + (nthr >> a.cols_log2) - 1) / (nthr >> a.cols_log2);
  const int r_first = (tid >> a.cols_log2) * rpg;
  const int slot = CS > 32 ? cs >> 5 : 0;
  const unsigned group = CS >= 32 ? 0xffffffffu
                                  : ((1u << CS) - 1) << (lane & ~(CS - 1));

  // the copying warp sets up the barriers and asks for the first tile at
  // once; the others clear the marks meanwhile
  if (copier) {
    if (lane == 0) {
      bar_init(&bars[0]);
      bar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    if (blockIdx.x < tiles)
      issue_tile<STAGED>(a, lay, blockIdx.x, smem + lay.first, &bars[0],
                         lane);
  }
  if (STAGED)
    for (int i = tid; i < a.nt * a.Km; i += nthr) marks[i] = 0;
  __syncthreads();

  int it = 0;
  for (int k = blockIdx.x; k < tiles; k += gridDim.x, ++it) {
    const int s = a.stages == 2 ? (it & 1) : 0;
    unsigned char* st = smem + lay.first + s * lay.stage;
    const Tile tl = tile_at(a, k);
    if (a.stages == 1 && it > 0) {
      __syncthreads();   // the last tile's inputs are read
      if (copier) issue_tile<STAGED>(a, lay, k, st, &bars[0], lane);
    }
    // the prologue's time step, asked for before the wait
    const int t_mine = tid < tl.rows ? (tl.n0 + tid) / a.L : 0;
    const float dt_mine =
        tid < tl.rows ? __ldg(a.dt + static_cast<size_t>(t_mine) * a.dt_step)
                      : 0.0f;
    if (copier && lane < SUB_STORES) {   // this stage's stores are read
      if (a.stages == 2)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      else
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    bar_wait(&bars[s], (it / a.stages) & 1);
    __syncthreads();
    if (a.stages == 2 && copier && k + gridDim.x < tiles)
      issue_tile<STAGED>(a, lay, k + gridDim.x,
                         smem + lay.first + (s ^ 1) * lay.stage,
                         &bars[s ^ 1], lane);

    const size_t n0 = tl.n0;
    const float* xs = placed<float>(st + lay.buf[0], a.x + 4 * n0);
    const float* Ps = placed<float>(st + lay.buf[1], a.P + 16 * n0);
    const float* cns = placed<float>(st + lay.buf[2], a.cnllr + n0);
    const float* pds = placed<float>(st + lay.buf[3], a.pd + n0);
    const bool* ms = placed<bool>(st + lay.buf[4], a.mask + n0);
    const size_t z0 = static_cast<size_t>(tl.t0) * a.Km;
    const float2* zs = placed<float2>(st + lay.buf[5], a.z_sub + 2 * z0);
    const unsigned char* zms =
        placed<unsigned char>(st + lay.buf[6], a.zmask_sub + z0);
    const int* zis = placed<int>(st + lay.buf[7], a.zidx + z0);
    float* plane = placed<float>(st + lay.buf[8], a.scores + W * n0);
    float* xbs = placed<float>(st + lay.buf[9], a.xbar + 4 * n0);
    float* pbs = placed<float>(st + lay.buf[10], a.pbar + 16 * n0);
    float* kgs = placed<float>(st + lay.buf[11], a.kgain + 8 * n0);
    float* phs = placed<float>(st + lay.buf[12], a.phat + 16 * n0);
    int* cnts = placed<int>(st + lay.buf[13], a.counts + n0);

    // ---- per-leaf prologue: one thread per leaf ------------------------
    for (int r = tid; r < tl.rows; r += nthr) {
      SubRow row;
      row.t = r == tid ? t_mine : (tl.n0 + r) / a.L;
      const float T = r == tid ? dt_mine
                               : __ldg(a.dt + static_cast<size_t>(row.t) *
                                                  a.dt_step);
      const float zero = sub_prologue(
          xs + 4 * r, Ps + 16 * r, cns[r], pds[r], ms[r], T, a.q, a.r_var,
          a.eta2, a.log_lam, xbs + 4 * r, pbs + 16 * r, kgs + 8 * r,
          phs + 16 * r, row);
      s_row[r] = row;
#pragma unroll
      for (int i = 0; i < SUB_SLOTS; ++i) parts[SUB_SLOTS * r + i] = 0;
      if (STAGED)
        plane[W * r] = zero;
      else
        a.scores[W * (tl.n0 + r)] = zero;
    }
    __syncthreads();

    // ---- all pairs: SUB_COLS columns per thread held while its rows ----
    // ---- stream, SUB_UNROLL rows at a time ------------------------------
    // A thread keeps bit i of bits[j] for its row r_first + i (rpg <= 32)
    // and column j; the counts and the marks are taken from the bits once
    // per chunk of columns, off the pairs' path.  Where all the thread's
    // rows are of one target (L >= 16 makes that the rule) its columns
    // are loaded once and the rows run without a branch; otherwise each
    // row checks its target.
    const int r_end = min(r_first + rpg, tl.rows);
    const int t_first = r_first < tl.rows ? (tl.n0 + r_first) / a.L : -1;
    const bool one_target =
        r_first < tl.rows && (tl.n0 + r_end - 1) / a.L == t_first;
    for (int c0 = 0; c0 < a.Km; c0 += CS * SUB_COLS) {
      int c[SUB_COLS];
      bool col[SUB_COLS];
      unsigned bits[SUB_COLS];
      float2 zz[SUB_COLS];
#pragma unroll
      for (int j = 0; j < SUB_COLS; ++j) {
        c[j] = c0 + cs + j * CS;
        col[j] = c[j] < a.Km;
        bits[j] = 0;
        zz[j] = make_float2(nan_f(), nan_f());
      }
      if (one_target) {
#pragma unroll
        for (int j = 0; j < SUB_COLS; ++j)
          if (col[j]) zz[j] = load_column<STAGED>(a, zs, zms, t_first, tl.t0,
                                                  c[j]);
        for (int i = 0; i < rpg; i += SUB_UNROLL) {
          SubRow rw[SUB_UNROLL];
#pragma unroll
          for (int u = 0; u < SUB_UNROLL; ++u) {
            rw[u] = s_row[min(r_first + i + u, r_end - 1)];
            if (r_first + i + u >= r_end) rw[u].gate = nan_f();  // a copy
          }
#pragma unroll
          for (int u = 0; u < SUB_UNROLL; ++u) {
            const int r = r_first + i + u;
            const bool in = r < r_end;
            float* out = row_out<STAGED>(a, plane, tl.n0, r);
#pragma unroll
            for (int j = 0; j < SUB_COLS; ++j) {
              bool ok;
              const float v = pair(rw[u], zz[j], ok);
              if (ok) bits[j] |= 1u << (i + u);
              if (in && col[j]) out[c[j]] = v;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < SUB_COLS; ++j)
          if (bits[j]) mark_used<STAGED>(a, marks, t_first, tl.t0, c[j]);
      } else {
        int zt = -1;
        bool tgated[SUB_COLS];
#pragma unroll
        for (int j = 0; j < SUB_COLS; ++j) tgated[j] = false;
        for (int r = r_first; r < r_end; ++r) {
          const SubRow rw = s_row[r];
          if (rw.t != zt) {      // a new target: mark the last, load this
#pragma unroll
            for (int j = 0; j < SUB_COLS; ++j) {
              if (tgated[j]) mark_used<STAGED>(a, marks, zt, tl.t0, c[j]);
              tgated[j] = false;
              if (col[j])
                zz[j] = load_column<STAGED>(a, zs, zms, rw.t, tl.t0, c[j]);
            }
            zt = rw.t;
          }
          float* out = row_out<STAGED>(a, plane, tl.n0, r);
#pragma unroll
          for (int j = 0; j < SUB_COLS; ++j) {
            bool ok;
            const float v = pair(rw, zz[j], ok);
            if (ok) bits[j] |= 1u << (r - r_first);
            tgated[j] |= ok;
            if (col[j]) out[c[j]] = v;
          }
        }
#pragma unroll
        for (int j = 0; j < SUB_COLS; ++j)
          if (tgated[j]) mark_used<STAGED>(a, marks, zt, tl.t0, c[j]);
      }
      // each row's gated count: for the rows where any lane of the warp
      // gated, this warp's share by ballot and popc over the columns,
      // into the row's slot for this warp (no other thread writes it)
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < SUB_COLS; ++j) any |= bits[j];
      any = __reduce_or_sync(0xffffffffu, any);
      while (any) {
        const int i = __ffs(any) - 1;
        any &= any - 1;
        int n = 0;
#pragma unroll
        for (int j = 0; j < SUB_COLS; ++j)
          n += __popc(__ballot_sync(0xffffffffu, (bits[j] >> i) & 1) &
                      group);
        if (n && (cs & 31) == 0) parts[SUB_SLOTS * (r_first + i) + slot] += n;
      }
    }
    __syncthreads();

    // ---- counts: the sum of each row's partials --------------------------
    for (int r = tid; r < tl.rows; r += nthr) {
      int n = 0;
#pragma unroll
      for (int i = 0; i < SUB_SLOTS; ++i) n += parts[SUB_SLOTS * r + i];
      cnts[r] = n;
    }
    if (STAGED) {
      // a masked column's index may point anywhere: it is marked only
      // where a leaf gated, and an index outside [0, M) is never stored
      // through
      for (int i = tid; i < tl.nt * a.Km; i += nthr) {
        if (marks[i]) {
          marks[i] = 0;
          const int j = zis[i];
          if ((unsigned)j < (unsigned)a.M) a.used[j] = 1;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    // lane i of the copying warp writes buffer SUB_LOADS + i back, in its
    // own bulk group
    if (copier && lane < SUB_STORES && (STAGED || lane > 0)) {
      uint32_t n = 0;
      unsigned char* g = tile_buffer(a, tl, SUB_LOADS + lane, n);
      const unsigned char* d =
          placed<unsigned char>(st + buf_at(lay, SUB_LOADS + lane), g);
      const Split p = split(g, n);
      if (p.mid) bulk_store(g + p.head, d + p.head, p.mid);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      for (uint32_t i = 0; i < p.head; ++i) g[i] = d[i];
      for (uint32_t i = p.head + p.mid; i < n; ++i) g[i] = d[i];
    }
  }
  if (copier && lane < SUB_STORES)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// An empty kernel, launched at a plan's grid, block and shared memory:
// the start-up floor of the per-target kernel.
__global__ void gate_score_sub_startup_kernel() {}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device (the default limit is 48 KB).  Returns a CUDA error code.
int allow_smem(const void* kernel, int slot, int smem) {
  static int granted[3][SUB_MAX_DEVICES] = {};
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < SUB_MAX_DEVICES && granted[slot][dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < SUB_MAX_DEVICES) granted[slot][dev] = smem;
  return 0;
}

const void* sub_kernel(int staged) {
  return staged ? (const void*)gate_score_sub_kernel<true>
                : (const void*)gate_score_sub_kernel<false>;
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
// used [M] through zidx [T, Km], on the tile plan of
// ops/gate_kernel.sub_plan (R leaves per tile, `threads` threads of which
// 2^cols_log2 share a row's columns, `grid` blocks, `smem` bytes of shared
// memory, tiles touching at most `nt` targets, `stages` buffers, the
// columns and the plane staged or not).  Returns a CUDA error code, or -1
// for a plan the kernel cannot run (its shared-memory layout disagrees
// with `smem`, or a count is out of range).
extern "C" int gate_score_sub_launch(
    const void* x, const void* P, const void* cnllr, const void* pd,
    const void* mask, const void* z_sub, const void* zmask_sub,
    const void* zidx, const void* dt, float q, float r_var, float eta2,
    float log_lam, void* scores, void* xbar, void* pbar, void* kgain,
    void* phat, void* counts, void* used, int T, int L, int Km, int M,
    int dt_step, int R, int threads, int cols_log2, int grid, int smem,
    int nt, int stages, int staged, void* stream) {
  if (T <= 0 || L <= 0) return 0;
  const int span = (R + L - 2) / L + 1;   // targets a tile may touch
  if (R < 16 || R % 16 || threads < 32 || threads > SUB_MAX_THREADS ||
      threads % 32 || cols_log2 < 0 || (1 << cols_log2) > threads ||
      (R - 1) / (threads >> cols_log2) >= 32 ||   // rows per group <= 32
      grid < 1 || (stages != 1 && stages != 2) || Km < 1 ||
      nt < (span < T ? span : T) ||
      sub_layout(R, nt, Km, stages, staged != 0).total != (uint32_t)smem)
    return -1;
  const int err = allow_smem(sub_kernel(staged), staged ? 0 : 1, smem);
  if (err) return err;
  SubArgs a;
  a.x = (const float*)x;
  a.P = (const float*)P;
  a.cnllr = (const float*)cnllr;
  a.pd = (const float*)pd;
  a.mask = (const bool*)mask;
  a.z_sub = (const float*)z_sub;
  a.zmask_sub = (const bool*)zmask_sub;
  a.zidx = (const int*)zidx;
  a.dt = (const float*)dt;
  a.q = q;
  a.r_var = r_var;
  a.eta2 = eta2;
  a.log_lam = log_lam;
  a.scores = (float*)scores;
  a.xbar = (float*)xbar;
  a.pbar = (float*)pbar;
  a.kgain = (float*)kgain;
  a.phat = (float*)phat;
  a.counts = (int*)counts;
  a.used = (unsigned char*)used;
  a.N = T * L;
  a.L = L;
  a.Km = Km;
  a.M = M;
  a.dt_step = dt_step;
  a.R = R;
  a.cols_log2 = cols_log2;
  a.nt = nt;
  a.stages = stages;
  if (staged)
    gate_score_sub_kernel<true>
        <<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  else
    gate_score_sub_kernel<false>
        <<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of the per-target kernel that one SM holds at once with
// `threads` threads and `smem` bytes of shared memory, and the device's
// SMs; returns a CUDA error code.
extern "C" int gate_score_sub_occupancy(int threads, int smem, int staged,
                                        int* sms, int* blocks_per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int e = allow_smem(sub_kernel(staged), staged ? 0 : 1, smem);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, sub_kernel(staged), threads, smem);
}

// Launches the empty kernel at a plan's grid, block and shared memory;
// returns a CUDA error code.
extern "C" int gate_score_sub_startup_launch(int grid, int threads,
                                             int smem, void* stream) {
  const int err =
      allow_smem((const void*)gate_score_sub_startup_kernel, 2, smem);
  if (err) return err;
  gate_score_sub_startup_kernel<<<grid, threads, smem,
                                  (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
