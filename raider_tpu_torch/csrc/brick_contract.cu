// Brick contraction of one sample group over a gathered brick (kernel K1).
//
// Replaces: scripts/kernel_profile.py, make_pallas_fn -> contract_kernel
// (Pallas, TPU): the U-build plus contraction over the lanes of a gathered
// (N, width) brick, given each sample's four per-ray scalars (gy, gx, fz,
// wte) and its static z-plane offset.
//
// What it computes, per ray and per lane c of its brick row (width = planes
// x wy x wx x 2 lanes): the lane's (dz, dy, dx, fhyd) decoded in float with
// float floors, exactly as contract_kernel does; U(c) = sum over samples s
// of ((wte * wz) * wyl) * wxl with wz = m0 (1 - fz) + m1 fz (m0, m1 the 0/1
// masks of planes dzo and dzo + 1) and the hat weights
// wyl = max(0, 1 - |gy - dy|), wxl = max(0, 1 - |gx - dx|); then
// wet = sum_c brick(c) U(c) (1 - fhyd), hydro = sum_c brick(c) U(c) fhyd,
// in lane order. Round-to-nearest intrinsics in the twin's order of
// operations (scripts/kernel_profile.py, contract_ref) keep nvcc from
// contracting into FMAs, so the kernel and its twin agree bit for bit.
//
// Bound on this card: the bytes of the gathered brick (504 bytes a ray at
// the (7,3,3,6) spec) and the 4S scalars a ray, read once, and the two
// outputs. The arithmetic that can matter (a sample's terms on its two
// planes only) is ~1,500 instructions a ray at that spec, below it.
//
// The design against that bound:
//   * A block owns R consecutive rays, one thread a ray. Their brick rows
//     are one contiguous span of R x width floats, and their scalars one of
//     R x 4S: all threads copy both in memory order with cp.async, so every
//     warp reads whole 128-byte lines. The brick copies are 16 bytes when
//     the tile keeps the span's layout and the brick is 16-byte aligned (the
//     production spec; a tail of fewer than 4 floats goes by 4 bytes), else
//     8-byte (wet, hydro) pairs, or 4 bytes for a brick that is only 4-byte
//     aligned. The scalar copies are 4 bytes (the tile's pitch is odd).
//   * The brick tile's row pitch P has P / 2 odd: a thread reads its row as
//     (wet, hydro) pairs, 8 bytes, and 16 threads (one shared-memory phase)
//     at a pitch of an odd number of pairs fall on 16 distinct bank pairs.
//     Width 126 (63 pairs) is its own pitch, so the copy is a plain
//     memcpy; width 256 is padded to 258 and copied pair by pair. The
//     scalar tile's pitch 4S + 1 is odd for the same reason (4-byte reads).
//   * The lane decode is the same for every ray: the block computes it once
//     into shared memory with the twin's float operations (with each cell's
//     two lane weights 1 - fhyd, fhyd), and from the group's z offsets,
//     passed by value with the launch, for each plane the list of the
//     samples that can touch it (dzo = plane: role 0, wz = 1 - fz; dzo + 1 =
//     plane: role 1, wz = fz), in sample order.
//   * Each thread reads its ray's 4S scalars once: it checks them, and
//     replaces (fz, wte) in place by the two products wte * wz of its roles.
//   * U is built only where it can be non-zero, one plane at a time, the
//     plane's wy x wx cells in registers (the window is a template argument:
//     3x3 and 4x4, the kernel profile's specs, and any other up to 8x8 with
//     runtime bounds). Each of the plane's entries reads gy, gx and wte wz
//     once and adds its ((wte wz) wyl) wxl to every cell, in sample order.
//     With wte and fz finite and gy, gx not NaN, a sample's term on a lane
//     of another plane is exactly +-0, and dropping +-0 terms from a sum
//     changes at most the sign of a zero U, which brick * U * {0, 1} then
//     adds to an accumulator that starts at +0 (so it never holds -0)
//     without changing it. If some sample breaks that condition, its term
//     is NaN or inf on every lane, so U is not finite anywhere and the
//     twin's two sums are NaN: the thread writes NaN for both. A brick NaN
//     or inf still reaches the sums, since every lane is multiplied by its
//     U (+0 where no sample touches it). fmaxf for the hat weights
//     (NaN -> 0) is exact for the same reason: a NaN gy or gx already makes
//     the ray NaN.
//   * The lane sum runs in lane order in one thread, over the plane's cells
//     after its U, two lanes (one cell: the same dz, dy, dx, so the same U)
//     a step.
//   * Overlap: the launcher picks R of 32, 64 or 128 for the most resident
//     rays an SM by shared memory (ties to the larger block), so while one
//     block computes, the SM's other blocks have their copies in flight. At
//     (7,3,3,6): R = 64, 41,760 bytes a block, 5 blocks an SM; on the H100
//     that beat R = 32 and 128 and a persistent block double-buffering its
//     tiles (two tiles a block: fewer rays resident), PERF.md.
//   * No TMA: the (8,4,4,24) tile is padded pair by pair and the scalar
//     tile row by row, so neither is a copy of the span; and the tail
//     block's span need not be a multiple of 16 bytes. One cp.async path
//     covers them all, at ~32 copy instructions a ray at the production
//     spec against ~1,500 arithmetic ones.
//   * The launcher derives the launch shape from (width, S, planes) and
//     refuses what does not fit: more than kMaxSamples samples, a window
//     wider than kMaxWin, or a block of kRays[0] rays above a block's
//     shared memory.

#include <cmath>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kMaxSamples = 64;
constexpr int kMaxWin = 8;                       // wy, wx at most (the generic instance)

// The group's z-plane offsets, passed by value with the launch (no copy to
// the device before it).
struct DzoList {
  int v[kMaxSamples];
};
constexpr int kRays[] = {32, 64, 128};           // block sizes tried, one ray a thread

// Shared bytes of a block of R rays: the brick tile, the scalar tile, the
// lane decode (float4 a lane), the lane weights (float4 a cell) and the
// plane lists (planes + 1 starts, then up to 2S entries).
__host__ __device__ __forceinline__ long long smem_bytes(int R, int width, int S, int planes) {
  const long long tiles = static_cast<long long>(R) * (brick_pitch(width) + 4 * S + 1);
  const long long lists = ((planes + 1 + 2 * S) + 3) / 4 * 4;
  return (tiles + 6LL * width + lists) * 4LL;
}

// WY, WX: the window, fixed at compile time so that a plane's U lives in
// registers; 0 for any window up to kMaxWin (runtime wy, wx, guarded loops).
template <int WY, int WX>
__global__ void brick_contract_kernel(const float* __restrict__ brick,
                                      const float* __restrict__ scal, DzoList dzos,
                                      float* __restrict__ out_w, float* __restrict__ out_h,
                                      long long n, int S, int planes, int wy_rt, int wx_rt,
                                      int brick_unit) {
  constexpr int MY = WY > 0 ? WY : kMaxWin;
  constexpr int MX = WX > 0 ? WX : kMaxWin;
  const int wy = WY > 0 ? WY : wy_rt;
  const int wx = WX > 0 ? WX : wx_rt;
  extern __shared__ __align__(16) float smem[];
  const int R = static_cast<int>(blockDim.x);
  const int width = planes * wy * wx * 2;
  const int P = brick_pitch(width);
  const int SP = 4 * S + 1;
  float* s_brick = smem;                                        // [R][P]
  float* s_scal = s_brick + R * P;                              // [R][SP]
  float4* s_dec = reinterpret_cast<float4*>(s_scal + R * SP);   // [width] (dz, dy, dx, fhyd)
  float4* s_fw = s_dec + width;                                 // [width / 2] lane weights
  int* s_start = reinterpret_cast<int*>(s_fw + width / 2);      // [planes + 1]
  int* s_list = s_start + planes + 1;                           // [2S] 2 s + role

  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(n - r0 < R ? n - r0 : R);
  stage_rows(s_brick, brick + r0 * width, nr, width, P, brick_unit, width);
  stage_rows(s_scal, scal + r0 * 4 * S, nr, 4 * S, SP, 1, 4 * S);  // odd pitch: 4-byte copies

  // the lane decode, with the twin's float operations; a cell's two lanes
  // (wet, hydro) share (dz, dy, dx), and s_fw holds their sum weights
  // (1 - fhyd, fhyd) side by side
  const float plane_w = static_cast<float>(wy * wx * 2);
  const float row_w = static_cast<float>(wx * 2);
  for (int k = threadIdx.x; k < width / 2; k += R) {
    float fh[2];
    for (int h = 0; h < 2; ++h) {
      const float lane = static_cast<float>(2 * k + h);
      const float dzc = floorf(__fdiv_rn(lane, plane_w));
      const float r1 = __fsub_rn(lane, __fmul_rn(dzc, plane_w));
      const float dyc = floorf(__fdiv_rn(r1, row_w));
      const float r2 = __fsub_rn(r1, __fmul_rn(dyc, row_w));
      const float dxc = floorf(__fdiv_rn(r2, 2.0f));
      fh[h] = __fsub_rn(r2, __fmul_rn(2.0f, dxc));
      s_dec[2 * k + h] = make_float4(dzc, dyc, dxc, fh[h]);
    }
    s_fw[k] = make_float4(__fsub_rn(1.0f, fh[0]), fh[0], __fsub_rn(1.0f, fh[1]), fh[1]);
  }
  // per plane, the samples that can touch it, in sample order
  if (threadIdx.x == 0) {
    int k = 0;
    for (int p = 0; p < planes; ++p) {
      s_start[p] = k;
      for (int s = 0; s < S; ++s) {
        const int dzo = dzos.v[s];
        if (dzo == p) s_list[k++] = 2 * s;
        if (dzo + 1 == p) s_list[k++] = 2 * s + 1;
      }
    }
    s_start[planes] = k;
  }
  cp_async_wait_all();
  __syncthreads();
  const int t = static_cast<int>(threadIdx.x);
  if (t >= nr) return;

  // the ray's scalars, read once: (gy, gx, fz, wte) -> (gy, gx, wte wz0, wte wz1)
  float* sc = s_scal + t * SP;
  bool poison = false;
  for (int s = 0; s < S; ++s) {
    const float gy = sc[4 * s], gx = sc[4 * s + 1], fz = sc[4 * s + 2], wte = sc[4 * s + 3];
    poison = poison || !isfinite(wte) || !isfinite(fz) || isnan(gy) || isnan(gx);
    const float omf = __fsub_rn(1.0f, fz);
    const float wz0 = __fadd_rn(__fmul_rn(1.0f, omf), __fmul_rn(0.0f, fz));
    const float wz1 = __fadd_rn(__fmul_rn(0.0f, omf), __fmul_rn(1.0f, fz));
    sc[4 * s + 2] = __fmul_rn(wte, wz0);
    sc[4 * s + 3] = __fmul_rn(wte, wz1);
  }
  const long long ray = r0 + t;
  if (poison) {
    out_w[ray] = __int_as_float(0x7fc00000);
    out_h[ray] = __int_as_float(0x7fc00000);
    return;
  }

  const float2* row = reinterpret_cast<const float2*>(s_brick + t * P);
  float acc_w = 0.0f, acc_h = 0.0f;
  for (int p = 0; p < planes; ++p) {
    // the plane's decoded dy (per window row) and dx (per window column)
    float dyv[MY], dxv[MX];
#pragma unroll
    for (int i = 0; i < MY; ++i) dyv[i] = i < wy ? s_dec[(p * wy + i) * wx * 2].y : 0.0f;
#pragma unroll
    for (int j = 0; j < MX; ++j) dxv[j] = j < wx ? s_dec[(p * wy * wx + j) * 2].z : 0.0f;
    // U of the plane's cells: the touching samples' terms in sample order
    float U[MY][MX];
#pragma unroll
    for (int i = 0; i < MY; ++i) {
#pragma unroll
      for (int j = 0; j < MX; ++j) U[i][j] = 0.0f;
    }
    const int e0 = s_start[p], e1 = s_start[p + 1];
    for (int e = e0; e < e1; ++e) {
      const int ent = s_list[e];
      const float* ss = sc + 4 * (ent >> 1);
      const float gy = ss[0], gx = ss[1], a = ss[2 + (ent & 1)];
      float hx[MX];
#pragma unroll
      for (int j = 0; j < MX; ++j) {
        hx[j] = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(gx, dxv[j]))), 0.0f);
      }
#pragma unroll
      for (int i = 0; i < MY; ++i) {
        if (i < wy) {
          const float q = __fmul_rn(a, fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(gy, dyv[i]))), 0.0f));
#pragma unroll
          for (int j = 0; j < MX; ++j) {
            if (j < wx) {
              const float w = __fmul_rn(q, hx[j]);
              U[i][j] = e == e0 ? w : __fadd_rn(U[i][j], w);
            }
          }
        }
      }
    }
    // the plane's lanes, in lane order
#pragma unroll
    for (int i = 0; i < MY; ++i) {
#pragma unroll
      for (int j = 0; j < MX; ++j) {
        if (i < wy && j < wx) {
          const int k = (p * wy + i) * wx + j;
          const float2 b = row[k];
          const float4 f = s_fw[k];
          const float pw = __fmul_rn(b.x, U[i][j]), ph = __fmul_rn(b.y, U[i][j]);
          acc_w = __fadd_rn(acc_w, __fmul_rn(pw, f.x));
          acc_h = __fadd_rn(acc_h, __fmul_rn(pw, f.y));
          acc_w = __fadd_rn(acc_w, __fmul_rn(ph, f.z));
          acc_h = __fadd_rn(acc_h, __fmul_rn(ph, f.w));
        }
      }
    }
  }
  out_w[ray] = acc_w;
  out_h[ray] = acc_h;
}

// The launch shape of (width, S, planes): of kRays, the block size with the
// most resident rays an SM by shared memory (the larger on a tie).
int launch_shape(int width, int S, int planes, int* threads, long long* smem) {
  if (S < 1 || S > kMaxSamples || planes < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto bytes = [&](int R) { return smem_bytes(R, width, S, planes); };
  return pick_block(kRays, bytes, threads, smem) ? 0
                                                 : static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

extern "C" int brick_contract_shape(int S, int planes, int wy, int wx, int* threads,
                                    long long* smem) {
  if (wy < 1 || wx < 1 || wy > kMaxWin || wx > kMaxWin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_shape(planes * wy * wx * 2, S, planes, threads, smem);
}

// dzos: the S offsets in host memory.
extern "C" int brick_contract_launch(const float* brick, const float* scal, const int* dzos,
                                     float* out_w, float* out_h, long long n, int S, int planes,
                                     int wy, int wx, void* stream) {
  int threads = 0;
  long long smem = 0;
  const int code = brick_contract_shape(S, planes, wy, wx, &threads, &smem);
  if (code != 0) return code;
  if (n == 0) return 0;
  const int width = planes * wy * wx * 2;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wy == 3 && wx == 3   ? brick_contract_kernel<3, 3>
                : wy == 4 && wx == 4 ? brick_contract_kernel<4, 4>
                                     : brick_contract_kernel<0, 0>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int brick_unit = copy_unit(brick, width);
  DzoList dz{};
  for (int s = 0; s < S; ++s) dz.v[s] = dzos[s];
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(brick, scal, dz, out_w, out_h, n, S, planes,
                                                 wy, wx, brick_unit);
  return static_cast<int>(cudaGetLastError());
}
