// Windowed integrate along raytraced slant paths (kernel B3).
//
// Replaces: raider_tpu/delay/pallas_window.py:217, _run_windowed -> _kernel
// (Pallas, TPU). The rays are output pixels in tile order (tiles of 8 x 64
// pixels); a host pre-pass has fixed each tile's window anchors per plan
// group. Per ray (one thread) and per group of the grouped sampling plan:
//   1. each sample's position: lerp between the segment's ends, the chord
//      sagitta -f(1-f) d^2 / (2 (Re + h)), the optional z clip;
//   2. its cell by a multiply with the inverse step, posy = (py - ylo) * yinv,
//      the bounds test (py >= ylo, posy <= ny-1) and the window test
//      0 <= dy <= wy-2, 0 <= dx <= wx-2 against the tile's anchors;
//   3. the trilinear value from the 2 x 2 x 2 corners of the two
//      (nz, ny, nxp) weather cubes: the x-blend of each (plane, y) row, then
//      the (plane, y) mix;
//   4. the trapezoid weight 1e-6 (wa rl[wa_lvl] + wb rl[wb_lvl]), both terms
//      always. A sample that fails a test is NaN and poisons the ray; padded
//      plan slots add nothing. Each group sums its samples from zero, then
//      adds that sum to the ray's total.
//
// Bound on this card: bytes, the operand stream. Each ray reads 8 floats of
// segment operands a level (y, x, z at both ends, d^2, ray length), each
// once: 1,568 bytes a ray over 49 levels, 98% of the bytes the function
// moves; the cube cells a tile's samples read are few and shared by its
// rays; ~40 flops a sample. Design:
//   * A block owns kRays consecutive tile-order rays inside one 512-ray
//     tile, one ray a thread. It stages the schedule and its tile's anchors
//     once.
//   * Operand rings: the host (pallas_window.ring_schedule) walks the plan's
//     real samples in order and gives each operand row a sample reads a
//     ring slot: copied once, with the first sample that reads it, and kept
//     until the last (ray_len[lvl] serves the next sample's wa term). Each
//     warp keeps its own ring of slots of its 32 rays in shared memory
//     and copies each sample's new rows into it by 16-byte cp.async, kStages
//     - 1 samples ahead of the math, one commit group a sample; its threads
//     then wait for their copies and meet at a warp barrier, so warps run
//     apart, as threads of independent rays do (a block-wide ring and
//     barrier held the whole block to its slowest warp every sample).
//   * Corners: the two cubes come interleaved as (wet, hydro) pairs, so a
//     (plane, y) row's x-pair of both is two 8-byte __ldg; L1 and L2 serve
//     the tile's shared cells. (Staging each group's rectangle of the cubes
//     in shared memory, double-buffered, was slower on the H100: its copies
//     and shared memory cost more warps than the loads it saved.)
// With the corners taken out, the kernel runs at the speed of its copies
// alone (builds `no_corners`, `copy_only`): what remains above the copies is
// the corner gathers, not the operand stream.
//
// All arithmetic uses round-to-nearest intrinsics in the twin's order
// (raider_tpu_torch/delay/pallas_window.py, window_integrate_ref): no FMA
// contraction, so on NaN-free cubes it matches the twin bit for bit.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kRays = 128;           // rays a block, one a thread; divides a tile
constexpr int kStages = 4;           // samples whose rows are resident or in flight
constexpr int kDepth = kStages - 1;  // samples fetched ahead of the math
constexpr int kSampI = 8;            // schedule words a sample (two int4)
constexpr int kSampF = 8;            // schedule values a sample (two float4)

static_assert(kStages >= 2, "at least one sample fetched ahead");
static_assert(kRays % 32 == 0 && 512 % kRays == 0, "a block is whole warps inside a tile");

struct Params {
  const float* lo;       // (3, L, n): y, x, z at the segment's low end
  const float* hi;       // (3, L, n): at its high end
  const float* d2;       // (L, n)
  const float* ray_len;  // (L, n)
  const float* re;       // (n,)
  const float2* cube;    // (nz, ny, nxp) (wet, hydro) pairs
  const int* ay;         // (n_tiles, n_groups) window anchors, y
  const int* ax;         // (n_tiles, n_groups) window anchors, x
  const int* sched_i;    // [K][kSampI] samples, [n_fetch] fetches
  const float* sched_f;  // [K][kSampF]
  float* out;            // (2, n)
  long long n;
  int L, n_groups, K, n_fetch, n_slots;
  int wy, wx, tile, ny, nx, nxp;
  float y_lo, y_inv, x_lo, x_inv, z_lo, z_hi;
  int z_clip;
};

__host__ __device__ __forceinline__ long long up4(long long v) { return (v + 3) / 4 * 4; }

// Shared words of a block: the warps' rings, the schedule, the tile's
// anchors; each part a whole number of 16-byte units.
__host__ __device__ __forceinline__ long long smem_words(int n_slots, int K, int n_fetch,
                                                         int n_groups) {
  return static_cast<long long>(n_slots) * kRays +
         static_cast<long long>(K) * (kSampI + kSampF) + up4(n_fetch) + up4(2LL * n_groups);
}

__device__ __forceinline__ float lerp_rn(float lo, float hi, float f) {
  return __fadd_rn(lo, __fmul_rn(f, __fsub_rn(hi, lo)));
}

// ((s00 m00 + s01 m01) + s10 m10) + s11 m11 over each cube, each s the
// x-blend (1-fx) v[ix] + fx v[ix+1] of a (plane, y) row, read from (wet,
// hydro) pairs at strides `row` and `plane`. Returns (wet, hydro).
__device__ __forceinline__ float2 mix4(const float2* c, size_t row, size_t plane, float wx0,
                                       float fx, const float* m) {
  float v_w = 0.0f, v_h = 0.0f;
  const size_t off[4] = {0, row, plane, plane + row};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = __ldg(c + off[k]), b = __ldg(c + off[k] + 1);
    const float s_w = __fadd_rn(__fmul_rn(wx0, a.x), __fmul_rn(fx, b.x));
    const float s_h = __fadd_rn(__fmul_rn(wx0, a.y), __fmul_rn(fx, b.y));
    v_w = k == 0 ? __fmul_rn(s_w, m[0]) : __fadd_rn(v_w, __fmul_rn(s_w, m[k]));
    v_h = k == 0 ? __fmul_rn(s_h, m[0]) : __fadd_rn(v_h, __fmul_rn(s_h, m[k]));
  }
  return make_float2(v_w, v_h);
}

// A sample's schedule words: 0-1 the ring slots of ly, lx, lz, hy | hx, hz,
// d2, rl[wa] (a byte each); 2 the slot of rl[wb] | end of group << 16;
// 3 group | level << 16; 4 cube plane; 5 fetch start | count << 16; 6 unused;
// 7 wa_lvl | wb_lvl << 16. Its values: frac, wa, wb, zlo, zinv. A fetch is
// slot | array << 8 | row << 10 (array 0 lo, 1 hi, 2 d2, 3 rl).
__global__ void __launch_bounds__(kRays) window_integrate_kernel(const Params prm) {
  extern __shared__ __align__(16) float smem[];
  const int t = static_cast<int>(threadIdx.x);
  const int K = prm.K, ng = prm.n_groups;
  float* ring = smem;                                                  // [warps][n_slots][32]
  int* s_si = reinterpret_cast<int*>(ring + prm.n_slots * kRays);      // [K][kSampI]
  float* s_sf = reinterpret_cast<float*>(s_si + K * kSampI);           // [K][kSampF]
  int* s_fe = reinterpret_cast<int*>(s_sf + K * kSampF);              // [n_fetch]
  int2* s_a = reinterpret_cast<int2*>(s_fe + up4(prm.n_fetch));        // [n_groups] anchors

  const long long r0 = static_cast<long long>(blockIdx.x) * kRays;
  const long long tile = r0 / prm.tile;
  const int n_words = K * kSampI, n_vals = K * kSampF;
  for (int i = t; i < n_words; i += kRays) s_si[i] = prm.sched_i[i];
  for (int i = t; i < n_vals; i += kRays) s_sf[i] = prm.sched_f[i];
  for (int i = t; i < prm.n_fetch; i += kRays) s_fe[i] = prm.sched_i[n_words + i];
  for (int i = t; i < ng; i += kRays) {
    s_a[i] = make_int2(prm.ay[tile * ng + i], prm.ax[tile * ng + i]);
  }
  __syncthreads();

  const size_t N = static_cast<size_t>(prm.n);
  const size_t nxp = static_cast<size_t>(prm.nxp);
  const size_t plane = static_cast<size_t>(prm.ny) * nxp;

  // each warp runs its own ring over its 32 rays: wring[slot][lane]
  const int lane = t & 31;
  const long long rw = r0 + (t - lane);                      // the warp's first ray
  float* wring = ring + (t - lane) * prm.n_slots;
  // copy the rows sample k reads first into the warp's slots: 8 lanes a row
  auto fetch = [&](int k) {
    const int w = s_si[k * kSampI + 5];
    const int* fe = s_fe + (w & 0xffff);
    for (int e = lane; e < (w >> 16) * 8; e += 32) {
      const int f = fe[e >> 3], c = 4 * (e & 7), a = (f >> 8) & 3;
      const float* src = a == 0 ? prm.lo : a == 1 ? prm.hi : a == 2 ? prm.d2 : prm.ray_len;
      cp_async16(wring + (f & 0xff) * 32 + c, src + static_cast<size_t>(f >> 10) * N + rw + c);
    }
  };
  for (int c = 0; c < kDepth; ++c) {
    if (c < K) fetch(c);
    cp_async_commit();
  }

  const float re = prm.re[rw + lane];
  // one sample: (wt v_w, wt v_h)
  auto sample = [&](float ly, float hy, float lx, float hx, float lz, float hz, float d2,
                    float rla, float rlb, int g, int pl, const float4& f0, float zinv) {
    const float f = f0.x;
    const float py = lerp_rn(ly, hy, f);
    const float px = lerp_rn(lx, hx, f);
    float pz = lerp_rn(lz, hz, f);
    const float hbar = __fmul_rn(0.5f, __fadd_rn(lz, hz));
    const float sag = __fdiv_rn(__fmul_rn(__fmul_rn(f, __fsub_rn(1.0f, f)), d2),
                                __fmul_rn(2.0f, __fadd_rn(re, hbar)));
    pz = __fsub_rn(pz, sag);
    if (prm.z_clip && !isnan(pz)) pz = fminf(fmaxf(pz, prm.z_lo), prm.z_hi);
    const bool bz = (pz >= prm.z_lo) && (pz <= prm.z_hi);

    const float posy = __fmul_rn(__fsub_rn(py, prm.y_lo), prm.y_inv);
    // clamp in float: NaN goes to cell 0 instead of an undefined integer
    const float iyf = fminf(fmaxf(floorf(posy), 0.0f), static_cast<float>(prm.ny - 2));
    const float fy = __fsub_rn(posy, iyf);
    const bool by = (py >= prm.y_lo) && (posy <= static_cast<float>(prm.ny - 1));
    const float posx = __fmul_rn(__fsub_rn(px, prm.x_lo), prm.x_inv);
    const float ixf = fminf(fmaxf(floorf(posx), 0.0f), static_cast<float>(prm.nx - 2));
    const float fx = __fsub_rn(posx, ixf);
    const bool bx = (px >= prm.x_lo) && (posx <= static_cast<float>(prm.nx - 1));
    const int iy = static_cast<int>(iyf), ix = static_cast<int>(ixf);
    const int2 an = s_a[g];
    const int dy = iy - an.x, dx = ix - an.y;
    const float fz = __fmul_rn(__fsub_rn(pz, f0.w), zinv);
    const bool ok = by && bx && bz && dy >= 0 && dy <= prm.wy - 2 && dx >= 0 &&
                    dx <= prm.wx - 2;

    float v_w = NAN, v_h = NAN;
    if (ok) {
      const float wz0 = __fsub_rn(1.0f, fz), wy0 = __fsub_rn(1.0f, fy);
      const float m[4] = {__fmul_rn(wz0, wy0), __fmul_rn(wz0, fy), __fmul_rn(fz, wy0),
                          __fmul_rn(fz, fy)};
      const float wx0 = __fsub_rn(1.0f, fx);
      const size_t base = static_cast<size_t>(pl) * plane + static_cast<size_t>(iy) * nxp + ix;
      const float2 v = mix4(prm.cube + base, nxp, plane, wx0, fx, m);
      v_w = v.x, v_h = v.y;
    }
    const float wt = __fmul_rn(1.0e-6f, __fadd_rn(__fmul_rn(f0.y, rla), __fmul_rn(f0.z, rlb)));
    return make_float2(__fmul_rn(wt, v_w), __fmul_rn(wt, v_h));
  };

  float out_w = 0.0f, out_h = 0.0f, acc_w = 0.0f, acc_h = 0.0f;
  for (int i = 0; i < K; ++i) {
    const int4 w0 = reinterpret_cast<const int4*>(s_si)[2 * i];
    const int4 w1 = reinterpret_cast<const int4*>(s_si)[2 * i + 1];
    const float4 f0 = reinterpret_cast<const float4*>(s_sf)[2 * i];
    const float zinv = s_sf[i * kSampF + 4];
    // sample i's rows landed and the warp is done with i - 1
    cp_async_wait<kDepth - 1>();
    __syncwarp();
    if (i + kDepth < K) fetch(i + kDepth);
    cp_async_commit();
    // the sample's operands: rows in the warp's ring slots
    auto opnd = [&](int word, int byte) { return wring[((word >> 8 * byte) & 0xff) * 32 + lane]; };
    const float ly = opnd(w0.x, 0), lx = opnd(w0.x, 1), lz = opnd(w0.x, 2), hy = opnd(w0.x, 3);
    const float hx = opnd(w0.y, 0), hz = opnd(w0.y, 1), d2 = opnd(w0.y, 2);
    const float rla = opnd(w0.y, 3), rlb = opnd(w0.z, 0);
    const float2 v = sample(ly, hy, lx, hx, lz, hz, d2, rla, rlb, w0.w & 0xffff, w1.x, f0, zinv);
    acc_w = __fadd_rn(acc_w, v.x);
    acc_h = __fadd_rn(acc_h, v.y);
    if (w0.z & 0x10000) {   // the group's last sample
      out_w = __fadd_rn(out_w, acc_w);
      out_h = __fadd_rn(out_h, acc_h);
      acc_w = acc_h = 0.0f;
    }
  }
  cp_async_wait<0>();
  prm.out[rw + lane] = out_w;
  prm.out[N + rw + lane] = out_h;
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// Kernel B3 as built: rays a block and stage count. The host plans the ring
// with them.
extern "C" int window_integrate_config(int* rays, int* stages) {
  *rays = kRays;
  *stages = kStages;
  return 0;
}

// The launch shape for a ring of n_slots slots a warp and a schedule of K
// samples and n_fetch fetches over n_groups groups: kRays threads and the
// shared bytes, which must fit a block.
extern "C" int window_integrate_shape(int n_slots, int K, int n_fetch, int n_groups,
                                      int* threads, long long* smem) {
  if (n_slots < 1 || n_slots > 0xff || K < 1 || n_fetch < 1 || n_fetch > 0xffff ||
      n_groups < 1 || n_groups > 0xffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bytes = 4 * smem_words(n_slots, K, n_fetch, n_groups);
  if (bytes > kSmemBlockMax) return static_cast<int>(cudaErrorInvalidValue);
  *threads = kRays;
  *smem = bytes;
  return 0;
}

extern "C" int window_integrate_launch(
    const float* lo, const float* hi, const float* d2, const float* ray_len, const float* re,
    const float2* cube, const int* ay, const int* ax, const int* sched_i, const float* sched_f,
    float* out, long long n, int L, int n_groups, int K, int n_fetch, int n_slots, int wy,
    int wx, int tile, int ny, int nx, int nxp, float y_lo, float y_inv, float x_lo, float x_inv,
    float z_lo, float z_hi, int z_clip, void* stream) {
  int threads = 0;
  long long smem = 0;
  const int code = window_integrate_shape(n_slots, K, n_fetch, n_groups, &threads, &smem);
  if (code != 0) return code;
  // levels that fit the schedule's 16-bit fields; whole blocks inside whole
  // tiles; operand rows (at multiples of n floats) as 16-byte aligned as
  // their bases
  if (L < 1 || L > 0x7fff || tile < kRays || tile % kRays != 0 || n % tile != 0 ||
      ny < 2 || nx < 2 || nxp < nx || !aligned16(lo) || !aligned16(hi) ||
      !aligned16(d2) || !aligned16(ray_len) || !aligned16(cube) || !aligned16(sched_i) ||
      !aligned16(sched_f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long blocks = n / kRays;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  Params prm{lo, hi, d2, ray_len, re, cube, ay, ax, sched_i, sched_f, out, n,
             L, n_groups, K, n_fetch, n_slots,
             wy, wx, tile, ny, nx, nxp, y_lo, y_inv, x_lo, x_inv, z_lo, z_hi, z_clip};
  const cudaError_t err = cudaFuncSetAttribute(
      window_integrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_integrate_kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
