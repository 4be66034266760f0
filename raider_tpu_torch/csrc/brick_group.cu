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
// 4 wy wx multiply-adds of static brick rows. All arithmetic is float32 with
// round-to-nearest intrinsics in the Pallas order and NaN-propagating
// min/max (jnp.minimum/maximum), so each kernel matches its twin
// (scripts/kernel_profile.py, group_rows_ref, group_merged_ref) bit for
// bit. The per-sample math is two device functions, sample_weights (the
// position math) and sample_sums, which K2 calls back to back.
//
// Bound on this card: the planes of the brick that the group's samples
// read (up to 504 bytes a ray at (7,3,3,6)) and the sliced level rows, read
// once; the arithmetic is ~60 + 8 wy wx flops per sample. K2 reads its transposed brick coalesced (a warp's rays are
// neighbours in each brick row) and stages the group's plan from device
// memory.
//
// K3's design against that bound:
//   * A block owns R consecutive rays, one thread a ray. Their brick rows
//     are one contiguous span of R x width floats: all threads copy it in
//     memory order by cp.async (stage.cuh: 16-byte copies when the tile is
//     the span itself and the brick 16-byte aligned, else 8- or 4-byte), into
//     a tile whose row pitch is an odd number of (wet, hydro) pairs (width
//     126 as it is, 256 padded to 258), so a thread's 8-byte pair reads are
//     free of bank conflicts. Only the planes the group's samples read are
//     copied: they are a prefix of each row (planes 0 to the highest
//     dzo + 1), and with 16-byte copies stage_rows skips the chunks wholly
//     past it (61 of 77 planes at (7,3,3,6)).
//   * Of each of the M = 3 nb + 2 nl + 3 merged rows, the block's rays are
//     one contiguous span of R floats. The block copies this slab into
//     shared memory, each row at a pitch congruent to N modulo 4 floats and
//     offset by the rows' alignment, so every row's copy and its span in
//     global memory are equally aligned modulo 16 bytes whatever N and the
//     base: 16-byte copies within each row, 4-byte ones at its ragged head
//     and tail. A thread then reads its ray's 9 row values a sample from
//     shared memory, consecutive threads on consecutive words.
//   * Two copy groups: the slab first, then the brick tile. The block waits
//     for the slab only, does every sample's position math into shared
//     memory (gy, gx, a0, a1 a sample, at an odd pitch of float4s), then
//     waits for the tile and does the sums in sample order: the tile's copy
//     lands under the position math.
//   * The group's plan goes by value with the launch (no copy to the device
//     before it) and is staged once a block.
//   * The window is a template argument (3x3, 4x4, any other up to 8x8 with
//     runtime bounds), so the ky/kx loops unroll and the hat weights sit in
//     registers. The loads are the old kernel's, from another memory, in
//     the same order of operations: K3 stays bit-identical to its twin.
//   * R = 32: many small blocks an SM, so while one block computes, the
//     SM's others have their copies in flight (blocks of 64 or 128 rays were
//     no faster, scripts/group_ablation.py). The launcher refuses more than
//     kMaxSamples samples, a window past kMaxWin, or a block above a
//     block's shared memory.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kPlanI = 4;  // lv, wal, wbl (relative to the group's first row), dzo
constexpr int kPlanF = 6;  // f, f (1 - f), wav, wbv, zlo, zinv
constexpr int kMaxSamples = 64;
constexpr int kMaxWin = 8;                       // wy, wx at most (K3's generic instance)
constexpr int kRays = 32;                        // K3's rays a block, one ray a thread

struct Consts {
  float y_lo, y_hi, x_lo, x_hi, z_lo, z_hi;
  float inv_sy, inv_sx;    // float32((n - 1) / (hi - lo))
  float y_cell, x_cell;    // n - 2 on each axis
  int wy, wx;
};

// K3's plan of one group, passed by value with the launch.
struct GroupPlan {
  int pi[kMaxSamples * kPlanI];
  float pf[kMaxSamples * kPlanF];
};

__device__ __forceinline__ float max_nan(float a, float b) { return isnan(a) ? a : fmaxf(a, b); }
__device__ __forceinline__ float min_nan(float a, float b) { return isnan(a) ? a : fminf(a, b); }

__device__ __forceinline__ float lerp_rn(float lo, float hi, float f) {
  return __fadd_rn(lo, __fmul_rn(f, __fsub_rn(hi, lo)));
}

// One sample of group_kernel for one ray, in two parts. sample_weights:
// the position math, from the ray's level rows (``row(b, i)`` reads its row i,
// relative to the group's first row, of block b: 0, 1, 2 the y, x, z
// boundaries, 3 d2, 4 ray length), to (gy, gx, a0, a1): the window
// coordinates and the two z planes' trapezoid weights.
template <typename Row>
__device__ __forceinline__ float4 sample_weights(Row row, float ay, float ax, float re,
                                                 const int* pi, const float* pf,
                                                 const Consts& k) {
  const int lv = pi[0];
  const float f = pf[0];
  const float py = lerp_rn(row(0, lv), row(0, lv + 1), f);
  const float px = lerp_rn(row(1, lv), row(1, lv + 1), f);
  const float zlo_r = row(2, lv), zhi_r = row(2, lv + 1);
  float pz = lerp_rn(zlo_r, zhi_r, f);
  const float hbar = __fmul_rn(0.5f, __fadd_rn(zlo_r, zhi_r));
  pz = __fsub_rn(pz, __fdiv_rn(__fmul_rn(pf[1], row(3, lv)), __fmul_rn(2.0f, __fadd_rn(re, hbar))));
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
  float w = __fmul_rn(pf[2], row(4, pi[1]));
  if (pf[3] != 0.0f) w = __fadd_rn(w, __fmul_rn(pf[3], row(4, pi[2])));
  const float wte = ok ? __fmul_rn(1.0e-6f, w) : NAN;
  return make_float4(__fadd_rn(dyi, fy), __fadd_rn(dxi, fx), __fmul_rn(wte, __fsub_rn(1.0f, fz)),
                     __fmul_rn(wte, fz));
}

// sample_sums: the 4 wy wx multiply-adds of the sample's (gy, gx, a0, a1)
// on its planes dzo and dzo + 1; ``pair(i)`` reads brick elements i and
// i + 1 of the ray's row (i even: a (wet, hydro) pair). WY, WX: the window,
// fixed at compile time; 0 for k.wy, k.wx.
template <int WY, int WX, typename Pair>
__device__ __forceinline__ void sample_sums(float4 g, int dzo, Pair pair, const Consts& k,
                                            float* acc_w, float* acc_h) {
  const int wy = WY > 0 ? WY : k.wy;
  const int wx = WX > 0 ? WX : k.wx;
  for (int ky = 0; ky < wy; ++ky) {
    const float hy = max_nan(__fsub_rn(1.0f, fabsf(__fsub_rn(g.x, static_cast<float>(ky)))), 0.0f);
    const float q0 = __fmul_rn(g.z, hy);
    const float q1 = __fmul_rn(g.w, hy);
    for (int kx = 0; kx < wx; ++kx) {
      const float hx =
          max_nan(__fsub_rn(1.0f, fabsf(__fsub_rn(g.y, static_cast<float>(kx)))), 0.0f);
      const float w0 = __fmul_rn(q0, hx);
      const float w1 = __fmul_rn(q1, hx);
      const float2 b0 = pair(((dzo * wy + ky) * wx + kx) * 2);
      const float2 b1 = pair((((dzo + 1) * wy + ky) * wx + kx) * 2);
      *acc_w = __fadd_rn(*acc_w, __fmul_rn(b0.x, w0));
      *acc_h = __fadd_rn(*acc_h, __fmul_rn(b0.y, w0));
      *acc_w = __fadd_rn(*acc_w, __fmul_rn(b1.x, w1));
      *acc_h = __fadd_rn(*acc_h, __fmul_rn(b1.y, w1));
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
  const float* rows[5] = {by, bx, bz, d2, rl};
  auto row = [&](int b, int i) { return rows[b][static_cast<size_t>(i) * N + r]; };
  auto pair = [&](int i) {
    return make_float2(__ldg(brickT + static_cast<size_t>(i) * N + r),
                       __ldg(brickT + static_cast<size_t>(i + 1) * N + r));
  };
  float acc_w = 0.0f, acc_h = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int* pi = s_pi + s * kPlanI;
    sample_sums<0, 0>(sample_weights(row, ay, ax, re, pi, s_pf + s * kPlanF, k), pi[3], pair, k,
                      &acc_w, &acc_h);
  }
  out[r] = acc_w;
  out[N + r] = acc_h;
}

// The row pitch (floats) of K3's merged slab: the least >= R + 3 that is
// congruent to n modulo 4, so that a row's copy starts as aligned as its
// span in global memory, with room for an offset of up to 3 floats.
inline int slab_pitch(int R, long long n) {
  return R + 3 + static_cast<int>(((n - R - 3) % 4 + 4) % 4);
}

// Floats rounded up to a multiple of 4 (16 bytes).
__host__ __device__ __forceinline__ long long up4(long long v) { return (v + 3) / 4 * 4; }

// Shared bytes of a K3 block of R rays: the brick tile, the merged slab (M
// rows at a pitch of at most R + 6), the plan and each ray's (gy, gx, a0,
// a1) for its S samples (at an odd pitch of float4s: no bank conflicts).
long long merged_smem_bytes(int R, int width, int S, int M) {
  const long long floats = static_cast<long long>(R) * brick_pitch(width) +
                           up4(static_cast<long long>(M) * (R + 6)) + up4(S * (kPlanI + kPlanF)) +
                           4LL * R * (S | 1);
  return floats * 4;
}

// Copy the block's span of each of the M merged rows (nr floats at
// src + m n) to dst + m pitch. With pitch = n (mod 4) and dst as aligned as
// src modulo 16 bytes, every row's copy is as aligned as its span: 16-byte
// chunks within a row, 4-byte copies at its ragged head and tail;
// consecutive threads on consecutive chunks.
__device__ __forceinline__ void stage_slab(float* dst, const float* __restrict__ src,
                                           long long n, int M, int nr, int pitch) {
  const int head = static_cast<int>((reinterpret_cast<std::uintptr_t>(src) >> 2) & 3);
  const int chunks = (nr + 6) / 4;   // the 16-byte chunks a row's span can touch
  for (int i = threadIdx.x; i < M * chunks; i += blockDim.x) {
    const int m = i / chunks;
    const int j0 = 4 * (i - m * chunks) - ((head + m * pitch) & 3);  // chunk start in the span
    const float* s = src + m * n;
    float* d = dst + m * pitch;
    if (j0 >= 0 && j0 + 4 <= nr) {
      cp_async16(d + j0, s + j0);
    } else {
      for (int j = j0 < 0 ? 0 : j0; j < j0 + 4 && j < nr; ++j) cp_async4(d + j, s + j);
    }
  }
}

// K3: brick (N, width); merged (M = 3 nb + 2 nl + 3, N) = [y, x, z rows (nb
// each), d2, ray-length rows (nl each), ay, ax, Re]; out (2, N). `keep`:
// the floats of a brick row that the group's planes span. WY, WX: the
// window at compile time, 0 for any window up to kMaxWin.
template <int WY, int WX>
__global__ void brick_group_merged_kernel(const float* __restrict__ brick,
                                          const float* __restrict__ merged, const GroupPlan plan,
                                          float* __restrict__ out, long long n, int S, int width,
                                          int nb, int nl, int pitch, int brick_unit, int keep,
                                          const Consts k) {
  extern __shared__ __align__(16) float smem[];
  const int R = static_cast<int>(blockDim.x);
  const int P = brick_pitch(width);
  const int M = 3 * nb + 2 * nl + 3;
  float* s_brick = smem;                                              // [R][P]
  float* s_slab = s_brick + R * P;             // [M][pitch], offset by the rows' alignment
  int* s_pi = reinterpret_cast<int*>(s_slab + up4(M * (R + 6)));     // [S][kPlanI]
  float* s_pf = reinterpret_cast<float*>(s_pi + S * kPlanI);          // [S][kPlanF]
  float4* s_g = reinterpret_cast<float4*>(s_pi + up4(S * (kPlanI + kPlanF)));  // [R][S | 1]

  // two copy groups: the slab first, then the brick tile, which lands while
  // the block does the samples' position math
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(n - r0 < R ? n - r0 : R);
  const int head = static_cast<int>((reinterpret_cast<std::uintptr_t>(merged) >> 2) & 3);
  stage_slab(s_slab + head, merged + r0, n, M, nr, pitch);
  const float* slab = s_slab + head;
  cp_async_commit();
  stage_rows(s_brick, brick + r0 * width, nr, width, P, brick_unit, keep);
  cp_async_commit();
  for (int i = threadIdx.x; i < S * kPlanI; i += R) s_pi[i] = plan.pi[i];
  for (int i = threadIdx.x; i < S * kPlanF; i += R) s_pf[i] = plan.pf[i];
  cp_async_wait<1>();
  __syncthreads();

  const int t = static_cast<int>(threadIdx.x);
  float4* g = s_g + t * (S | 1);
  if (t < nr) {
    const float* mine = slab + t;
    const int off[5] = {0, nb, 2 * nb, 3 * nb, 3 * nb + nl};
    auto row = [&](int b, int i) { return mine[(off[b] + i) * pitch]; };
    const int aux = 3 * nb + 2 * nl;
    const float ay = mine[aux * pitch], ax = mine[(aux + 1) * pitch], re = mine[(aux + 2) * pitch];
    for (int s = 0; s < S; ++s) {
      g[s] = sample_weights(row, ay, ax, re, s_pi + s * kPlanI, s_pf + s * kPlanF, k);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (t >= nr) return;

  const float2* pairs = reinterpret_cast<const float2*>(s_brick + t * P);
  auto pair = [&](int i) { return pairs[i >> 1]; };
  float acc_w = 0.0f, acc_h = 0.0f;
  for (int s = 0; s < S; ++s) {
    sample_sums<WY, WX>(g[s], s_pi[s * kPlanI + 3], pair, k, &acc_w, &acc_h);
  }
  out[r0 + t] = acc_w;
  out[n + r0 + t] = acc_h;
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

// K3's launch shape for a group of S samples, a brick of `width` floats a
// ray and nb, nl merged rows: kRays threads and their shared bytes.
extern "C" int brick_group_merged_shape(int S, int width, int nb, int nl, int wy, int wx,
                                        int* threads, long long* smem) {
  if (S < 1 || S > kMaxSamples || wy < 2 || wx < 2 || wy > kMaxWin || wx > kMaxWin ||
      nb < 2 || nl < 1 || width < 2 || width % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bytes = merged_smem_bytes(kRays, width, S, 3 * nb + 2 * nl + 3);
  if (bytes > kSmemBlockMax) return static_cast<int>(cudaErrorInvalidValue);
  *threads = kRays;
  *smem = bytes;
  return 0;
}

// plan_i (S, 4) and plan_f (S, 6): the group's plan in host memory.
extern "C" int brick_group_merged_launch(const float* brick, const float* merged,
                                         const int* plan_i, const float* plan_f, float* out,
                                         long long n, int S, int width, int nb, int nl,
                                         float y_lo, float y_hi, float x_lo, float x_hi,
                                         float z_lo, float z_hi, float inv_sy, float inv_sx,
                                         int ny, int nx, int wy, int wx, void* stream) {
  int threads = 0;
  long long smem = 0;
  const int code = brick_group_merged_shape(S, width, nb, nl, wy, wx, &threads, &smem);
  if (code != 0) return code;
  if (ny < 2 || nx < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k = make_consts(y_lo, y_hi, x_lo, x_hi, z_lo, z_hi, inv_sy, inv_sx, ny, nx, wy, wx);
  GroupPlan plan{};
  int top = 0;   // the highest plane a sample reads is top + 1
  for (int i = 0; i < S * kPlanI; ++i) plan.pi[i] = plan_i[i];
  for (int i = 0; i < S * kPlanF; ++i) plan.pf[i] = plan_f[i];
  for (int s = 0; s < S; ++s) top = plan_i[s * kPlanI + 3] > top ? plan_i[s * kPlanI + 3] : top;
  const int keep = (top + 2) * wy * wx * 2;
  auto kernel = wy == 3 && wx == 3   ? brick_group_merged_kernel<3, 3>
                : wy == 4 && wx == 4 ? brick_group_merged_kernel<4, 4>
                                     : brick_group_merged_kernel<0, 0>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(brick, merged, plan, out, n, S, width, nb, nl,
                                                 slab_pitch(threads, n),
                                                 copy_unit(brick, width), keep, k);
  return static_cast<int>(cudaGetLastError());
}
