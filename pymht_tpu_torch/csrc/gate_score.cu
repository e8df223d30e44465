// K1: fused constant-velocity predict + innovation + all-pairs gate and
// score, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` launched by `gate_and_score_pallas`
// (pymht_tpu/ops/gate_kernel.py:34-202, the repo's only pl.pallas_call).
// It computes the same thing, per hypothesis leaf n and measurement m:
//   x_bar = A x,  P_bar = A P A^T + Q   (closed form, the reference's
//                                        T^3/3 off-diagonal kept)
//   S     = P_bar[:2,:2] + r I           (analytic 2x2 inverse and det)
//   nis   = (z_m - x_bar[:2])^T S^-1 (z_m - x_bar[:2])
//   score[n, 1+m] = cnllr + nis/2 + ln lambda_ex + (2 ln 2pi + ln det S)/2
//                   - ln P_d            if nis <= eta2, zmask, leaf mask
//                 = 1e9                 otherwise
//   score[n, 0]   = cnllr - ln(1 - P_d) if the leaf is live, else 1e9
//
// What bounds it on an H100: writing the [N, 1+M] f32 score plane
// (8.4 MB at N=4096, M=512, a few microseconds of HBM time); the
// arithmetic is ~15 flops per pair.  The design keeps every read small:
// one block owns a tile of TILE_N leaves, computes their prologue
// (x_bar, P_bar, S^-1, the log term, the miss score) once into shared
// memory, then walks the measurement axis with threads on m, so each
// thread loads its z_m once and every score row is written coalesced.
// Fusing the per-target beam top-L in here, so the plane never reaches
// HBM, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 16;
constexpr int THREADS = 256;
constexpr float BIG = 1e9f;
constexpr float LOG2PI = 1.8378770664093453f;

__global__ void __launch_bounds__(THREADS)
gate_score_kernel(const float* __restrict__ params,
                  const float* __restrict__ x,       // [N, 4]
                  const float* __restrict__ P,       // [N, 16]
                  const float* __restrict__ cnllr,   // [N]
                  const float* __restrict__ pd,      // [N]
                  const bool* __restrict__ mask,     // [N]
                  const float* __restrict__ z,       // [M, 2]
                  const bool* __restrict__ zmask,    // [M]
                  float* __restrict__ scores,        // [N, 1 + M]
                  float* __restrict__ xbar,          // [N, 4]
                  float* __restrict__ pbar,          // [N, 16]
                  int N, int M) {
  __shared__ float s_px[TILE_N], s_py[TILE_N];
  __shared__ float s_i11[TILE_N], s_ioff[TILE_N], s_i22[TILE_N];
  __shared__ float s_cn[TILE_N], s_log[TILE_N];
  __shared__ bool s_live[TILE_N];

  // params: (dt, q_scale, r_var, eta2, ln lambda_ex, unused x3)
  const float T = params[0];
  const float q = params[1];
  const float r_var = params[2];
  const float eta2 = params[3];
  const float log_lam = params[4];
  const int n0 = blockIdx.x * TILE_N;
  const int rows = min(TILE_N, N - n0);
  const size_t stride = (size_t)M + 1;

  // ---- per-leaf prologue: one thread per leaf of the tile -------------
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const int n = n0 + r;
    const float px = x[4 * n + 0], py = x[4 * n + 1];
    const float vx = x[4 * n + 2], vy = x[4 * n + 3];
    float g[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) g[i] = P[16 * n + i];
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
#pragma unroll
    for (int i = 0; i < 16; ++i) pbar[16 * n + i] = pb[i];
    const float xb0 = px + T * vx, xb1 = py + T * vy;
    xbar[4 * n + 0] = xb0;
    xbar[4 * n + 1] = xb1;
    xbar[4 * n + 2] = vx;
    xbar[4 * n + 3] = vy;

    const float s11 = PB(0, 0) + r_var, s12 = PB(0, 1);
    const float s21 = PB(1, 0), s22 = PB(1, 1) + r_var;
#undef PB
#undef G
    const float det = s11 * s22 - s12 * s21;
    const float inv_det = 1.0f / det;
    s_px[r] = xb0;
    s_py[r] = xb1;
    s_i11[r] = s22 * inv_det;
    s_ioff[r] = 0.5f * ((-s12 * inv_det) + (-s21 * inv_det));
    s_i22[r] = s11 * inv_det;
    const float log_norm = 0.5f * (2.0f * LOG2PI + logf(fmaxf(det, 1e-20f)));
    const float pdv = pd[n];
    const float cn = cnllr[n];
    const bool live = mask[n];
    s_cn[r] = cn;
    s_log[r] = log_lam + log_norm - logf(pdv);
    s_live[r] = live;
    scores[(size_t)n * stride] = live ? cn - logf(1.0f - pdv) : BIG;
  }
  __syncthreads();

  // ---- all-pairs NIS, gate and score: threads on the measurement axis --
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float zx = z[2 * m], zy = z[2 * m + 1];
    const bool zok = zmask[m];
    float* out = scores + (size_t)n0 * stride + 1 + m;
    for (int r = 0; r < rows; ++r) {
      const float dx = zx - s_px[r];
      const float dy = zy - s_py[r];
      const float nis = s_i11[r] * dx * dx + 2.0f * s_ioff[r] * dx * dy
                        + s_i22[r] * dy * dy;
      const bool ok = (nis <= eta2) && zok && s_live[r];
      out[(size_t)r * stride] = ok ? s_cn[r] + 0.5f * nis + s_log[r] : BIG;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  The caller allocates every output.
extern "C" int gate_score_launch(const void* params, const void* x,
                                 const void* P, const void* cnllr,
                                 const void* pd, const void* mask,
                                 const void* z, const void* zmask,
                                 void* scores, void* xbar, void* pbar,
                                 int N, int M, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + TILE_N - 1) / TILE_N;
  gate_score_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)params, (const float*)x, (const float*)P,
      (const float*)cnllr, (const float*)pd, (const bool*)mask,
      (const float*)z, (const bool*)zmask, (float*)scores, (float*)xbar,
      (float*)pbar, N, M);
  return (int)cudaGetLastError();
}
