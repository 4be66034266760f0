// Everything but the gather for one sample group of the brick integrate:
// kernels K2 (brick_group_rows) and K3 (brick_group_merged).
//
// Replaces: scripts/kernel_profile.py, make_pallas2_fn -> group_kernel (K2:
// a transposed (width, N) brick, rays on lanes, and six row inputs: the
// boundary rows y, x, z, the d2 and ray-length rows, and aux = [ay, ax,
// Re]) and make_merged_fn -> group_kernel (K3: the (N, width) brick and
// the same rows merged into one (3 nb + 2 nl + 3, N) array). Pallas, TPU.
//
// Per ray (one thread) and per sample of the group (one launch per group, as
// on the TPU): the segment lerp, the chord sagitta, the z clip, the locate
// as (p - lo) * inv with inv = float32((n - 1) / (hi - lo)), the exact
// window test dy <= wy - 2 against the anchor cells computed outside (with
// _locate's division: at a cell boundary the two can disagree by one cell
// and NaN the ray, as in the JAX package), the trapezoid weight (a skipped
// term when the sample has no second weight: 0 * NaN would be NaN), and
// 4 wy wx multiply-adds of static brick rows. The per-sample math is one
// device function for both kernels. All arithmetic is float32 with
// round-to-nearest intrinsics in the Pallas order and NaN-propagating
// min/max (jnp.minimum/maximum), so each kernel matches its twin
// (scripts/kernel_profile.py, group_rows_ref, group_merged_ref) bit for
// bit. The plan of the group (level offsets relative to the group's first
// row, fractions, weights, z cell, plane offset) sits in shared memory.
//
// Bound on this card: the brick (504 bytes a ray at (7,3,3,6)) and the
// sliced level rows, read once; the arithmetic is ~60 + 8 wy wx flops per
// sample. K2 reads its transposed brick coalesced (a warp's rays are
// neighbours in each brick row); K3 reads each ray's row through L1.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanI = 4;  // lv, wal, wbl (relative to the group's first row), dzo
constexpr int kPlanF = 6;  // f, f (1 - f), wav, wbv, zlo, zinv
constexpr int kMaxSamples = 64;

struct Consts {
  float y_lo, y_hi, x_lo, x_hi, z_lo, z_hi;
  float inv_sy, inv_sx;    // float32((n - 1) / (hi - lo))
  float y_cell, x_cell;    // n - 2 on each axis
  int wy, wx;
};

__device__ __forceinline__ float max_nan(float a, float b) { return isnan(a) ? a : fmaxf(a, b); }
__device__ __forceinline__ float min_nan(float a, float b) { return isnan(a) ? a : fminf(a, b); }

__device__ __forceinline__ float lerp_rn(float lo, float hi, float f) {
  return __fadd_rn(lo, __fmul_rn(f, __fsub_rn(hi, lo)));
}

// One sample of group_kernel for ray r. Rows are [row][ray] with stride N;
// ``brick(i)`` reads row element i of this ray's brick.
template <typename Brick>
__device__ __forceinline__ void group_sample(const float* by, const float* bx, const float* bz,
                                             const float* d2, const float* rl, float ay,
                                             float ax, float re, size_t N, long long r,
                                             const int* pi, const float* pf, const Consts& k,
                                             Brick brick, float* acc_w, float* acc_h) {
  const size_t lo = static_cast<size_t>(pi[0]) * N + r;
  const size_t hi = lo + N;
  const float f = pf[0];
  const float py = lerp_rn(by[lo], by[hi], f);
  const float px = lerp_rn(bx[lo], bx[hi], f);
  const float zlo_r = bz[lo], zhi_r = bz[hi];
  float pz = lerp_rn(zlo_r, zhi_r, f);
  const float hbar = __fmul_rn(0.5f, __fadd_rn(zlo_r, zhi_r));
  pz = __fsub_rn(pz, __fdiv_rn(__fmul_rn(pf[1], d2[lo]), __fmul_rn(2.0f, __fadd_rn(re, hbar))));
  const bool bndy = (py >= k.y_lo) && (py <= k.y_hi);
  const bool bndx = (px >= k.x_lo) && (px <= k.x_hi);
  pz = min_nan(max_nan(pz, k.z_lo), k.z_hi);
  const bool bndz = (pz >= k.z_lo) && (pz <= k.z_hi);
  const float posy = __fmul_rn(__fsub_rn(py, k.y_lo), k.inv_sy);
  const float iyf = min_nan(max_nan(floorf(posy), 0.0f), k.y_cell);
  const float fy = __fsub_rn(posy, iyf);
  const float posx = __fmul_rn(__fsub_rn(px, k.x_lo), k.inv_sx);
  const float ixf = min_nan(max_nan(floorf(posx), 0.0f), k.x_cell);
  const float fx = __fsub_rn(posx, ixf);
  const float fz = __fmul_rn(__fsub_rn(pz, pf[4]), pf[5]);
  const float dyi = __fsub_rn(iyf, ay);
  const float dxi = __fsub_rn(ixf, ax);
  const bool ok = bndy && bndx && bndz && dyi <= static_cast<float>(k.wy - 2) &&
                  dxi <= static_cast<float>(k.wx - 2);
  float w = __fmul_rn(pf[2], rl[static_cast<size_t>(pi[1]) * N + r]);
  if (pf[3] != 0.0f) w = __fadd_rn(w, __fmul_rn(pf[3], rl[static_cast<size_t>(pi[2]) * N + r]));
  const float wte = ok ? __fmul_rn(1.0e-6f, w) : NAN;
  const float gy = __fadd_rn(dyi, fy);
  const float gx = __fadd_rn(dxi, fx);
  const float a0 = __fmul_rn(wte, __fsub_rn(1.0f, fz));
  const float a1 = __fmul_rn(wte, fz);
  const int dzo = pi[3];
  for (int ky = 0; ky < k.wy; ++ky) {
    const float hy = max_nan(__fsub_rn(1.0f, fabsf(__fsub_rn(gy, static_cast<float>(ky)))), 0.0f);
    const float q0 = __fmul_rn(a0, hy);
    const float q1 = __fmul_rn(a1, hy);
    for (int kx = 0; kx < k.wx; ++kx) {
      const float hx =
          max_nan(__fsub_rn(1.0f, fabsf(__fsub_rn(gx, static_cast<float>(kx)))), 0.0f);
      const float w0 = __fmul_rn(q0, hx);
      const float w1 = __fmul_rn(q1, hx);
      const int r0 = ((dzo * k.wy + ky) * k.wx + kx) * 2;
      const int r1 = (((dzo + 1) * k.wy + ky) * k.wx + kx) * 2;
      *acc_w = __fadd_rn(*acc_w, __fmul_rn(brick(r0), w0));
      *acc_h = __fadd_rn(*acc_h, __fmul_rn(brick(r0 + 1), w0));
      *acc_w = __fadd_rn(*acc_w, __fmul_rn(brick(r1), w1));
      *acc_h = __fadd_rn(*acc_h, __fmul_rn(brick(r1 + 1), w1));
    }
  }
}

__device__ __forceinline__ void stage_plan(const int* plan_i, const float* plan_f, int S,
                                           int* s_pi, float* s_pf) {
  for (int i = threadIdx.x; i < S * kPlanI; i += blockDim.x) s_pi[i] = plan_i[i];
  for (int i = threadIdx.x; i < S * kPlanF; i += blockDim.x) s_pf[i] = plan_f[i];
  __syncthreads();
}

// K2: brickT (width, N); by/bx/bz (nb, N), d2/rl (nl, N), aux (3, N); out (2, N)
__global__ void brick_group_rows_kernel(const float* __restrict__ brickT,
                                        const float* __restrict__ by,
                                        const float* __restrict__ bx,
                                        const float* __restrict__ bz,
                                        const float* __restrict__ d2,
                                        const float* __restrict__ rl,
                                        const float* __restrict__ aux, const int* plan_i,
                                        const float* plan_f, float* __restrict__ out,
                                        long long n, int S, const Consts k) {
  __shared__ int s_pi[kMaxSamples * kPlanI];
  __shared__ float s_pf[kMaxSamples * kPlanF];
  stage_plan(plan_i, plan_f, S, s_pi, s_pf);
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  const float ay = aux[r], ax = aux[N + r], re = aux[2 * N + r];
  auto brick = [&](int i) { return __ldg(brickT + static_cast<size_t>(i) * N + r); };
  float acc_w = 0.0f, acc_h = 0.0f;
  for (int s = 0; s < S; ++s) {
    group_sample(by, bx, bz, d2, rl, ay, ax, re, N, r, s_pi + s * kPlanI, s_pf + s * kPlanF, k,
                 brick, &acc_w, &acc_h);
  }
  out[r] = acc_w;
  out[N + r] = acc_h;
}

// K3: brick (N, width); merged (3 nb + 2 nl + 3, N) = [y, x, z rows (nb
// each), d2, ray-length rows (nl each), ay, ax, Re]; out (2, N)
__global__ void brick_group_merged_kernel(const float* __restrict__ brick_nw,
                                          const float* __restrict__ merged, const int* plan_i,
                                          const float* plan_f, float* __restrict__ out,
                                          long long n, int S, int width, int nb, int nl,
                                          const Consts k) {
  __shared__ int s_pi[kMaxSamples * kPlanI];
  __shared__ float s_pf[kMaxSamples * kPlanF];
  stage_plan(plan_i, plan_f, S, s_pi, s_pf);
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  const float* by = merged;
  const float* bx = merged + static_cast<size_t>(nb) * N;
  const float* bz = merged + static_cast<size_t>(2 * nb) * N;
  const float* d2 = merged + static_cast<size_t>(3 * nb) * N;
  const float* rl = merged + static_cast<size_t>(3 * nb + nl) * N;
  const float* aux = merged + static_cast<size_t>(3 * nb + 2 * nl) * N;
  const float ay = aux[r], ax = aux[N + r], re = aux[2 * N + r];
  const float* row = brick_nw + static_cast<size_t>(r) * width;
  auto brick = [&](int i) { return __ldg(row + i); };
  float acc_w = 0.0f, acc_h = 0.0f;
  for (int s = 0; s < S; ++s) {
    group_sample(by, bx, bz, d2, rl, ay, ax, re, N, r, s_pi + s * kPlanI, s_pf + s * kPlanF, k,
                 brick, &acc_w, &acc_h);
  }
  out[r] = acc_w;
  out[N + r] = acc_h;
}

Consts make_consts(float y_lo, float y_hi, float x_lo, float x_hi, float z_lo, float z_hi,
                   float inv_sy, float inv_sx, int ny, int nx, int wy, int wx) {
  return Consts{y_lo, y_hi, x_lo, x_hi, z_lo, z_hi, inv_sy, inv_sx,
                static_cast<float>(ny - 2), static_cast<float>(nx - 2), wy, wx};
}

}  // namespace

extern "C" int brick_group_rows_launch(const float* brickT, const float* by, const float* bx,
                                       const float* bz, const float* d2, const float* rl,
                                       const float* aux, const int* plan_i, const float* plan_f,
                                       float* out, long long n, int S, float y_lo, float y_hi,
                                       float x_lo, float x_hi, float z_lo, float z_hi,
                                       float inv_sy, float inv_sx, int ny, int nx, int wy, int wx,
                                       void* stream) {
  if (S < 1 || S > kMaxSamples || ny < 2 || nx < 2 || wy < 2 || wx < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Consts k = make_consts(y_lo, y_hi, x_lo, x_hi, z_lo, z_hi, inv_sy, inv_sx, ny, nx, wy, wx);
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  brick_group_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(brickT, by, bx, bz, d2, rl, aux,
                                                                 plan_i, plan_f, out, n, S, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brick_group_merged_launch(const float* brick, const float* merged,
                                         const int* plan_i, const float* plan_f, float* out,
                                         long long n, int S, int width, int nb, int nl,
                                         float y_lo, float y_hi, float x_lo, float x_hi,
                                         float z_lo, float z_hi, float inv_sy, float inv_sx,
                                         int ny, int nx, int wy, int wx, void* stream) {
  if (S < 1 || S > kMaxSamples || ny < 2 || nx < 2 || wy < 2 || wx < 2 || nb < 2 || nl < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Consts k = make_consts(y_lo, y_hi, x_lo, x_hi, z_lo, z_hi, inv_sy, inv_sx, ny, nx, wy, wx);
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  brick_group_merged_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(brick, merged, plan_i, plan_f,
                                                                   out, n, S, width, nb, nl, k);
  return static_cast<int>(cudaGetLastError());
}
