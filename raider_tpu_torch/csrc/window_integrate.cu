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
//   3. the trilinear value from the 2 x 2 x 2 corners, read straight from the
//      two (nz, ny, nxp) weather cubes: the x-blend of each (plane, y) row,
//      then the (plane, y) mix;
//   4. the trapezoid weight 1e-6 (wa rl[wa_lvl] + wb rl[wb_lvl]), both terms
//      always. A sample that fails a test is NaN and poisons the ray; padded
//      plan slots add nothing. Each group sums its samples from zero, then
//      adds that sum to the ray's total.
//
// Bound on this card: bytes. Per ray 8 L floats of segment operands (y, x,
// z at both ends, d^2, ray length) plus Re, and the cube cells its samples
// touch; about 40 flops per sample. The TPU kernel staged a (planes, WY,
// 256) window of both cubes in VMEM per tile and group: at 7 planes in f32
// that is 114 KB at WY = 8 and 573 KB at WY = 40, past a block's 227 KB of
// shared memory. Design: one thread per ray in tile order, so a block holds
// neighbouring pixels whose samples fall in the same few cells and its
// corner reads hit L1/L2 (both padded cubes of the 50x400x400 scene, 82 MB,
// are about L2's 50 MB); segment operands are indexed [level][ray], so a
// warp's loads coalesce; the plan is staged once per block in shared memory.
// Staging the tile's true window with cp.async/TMA is later work.
//
// All arithmetic uses round-to-nearest intrinsics in the twin's order
// (raider_tpu_torch/delay/pallas_window.py, window_integrate_ref): no FMA
// contraction, so on NaN-free cubes it matches the twin bit for bit.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanI = 5;  // lvl, wa_lvl, wb_lvl, dzo, pad
constexpr int kPlanF = 5;  // frac, wa, wb, zlo, zinv

struct Params {
  const float* lo;       // (3, L, n): y, x, z at the segment's low end
  const float* hi;       // (3, L, n): at its high end
  const float* d2;       // (L, n)
  const float* ray_len;  // (L, n)
  const float* re;       // (n,)
  const float* cube_w;   // (nz, ny, nxp)
  const float* cube_h;
  const int* ay;         // (n_tiles, n_groups) window anchors, y
  const int* ax;         // (n_tiles, n_groups) window anchors, x
  const int* plan_i;     // (n_groups, G, kPlanI)
  const float* plan_f;   // (n_groups, G, kPlanF)
  const int* za;         // (n_groups,) shifted z anchors
  float* out;            // (2, n)
  long long n;
  int L, n_groups, G, wy, wx, tile, ny, nx, nxp;
  float y_lo, y_inv, x_lo, x_inv, z_lo, z_hi;
  int z_clip;
};

__device__ __forceinline__ float lerp_rn(float lo, float hi, float f) {
  return __fadd_rn(lo, __fmul_rn(f, __fsub_rn(hi, lo)));
}

// the x-blend of one (plane, y) row: (1-fx) v[ix] + fx v[ix+1]
__device__ __forceinline__ float xblend(const float* row, float wx0, float fx) {
  return __fadd_rn(__fmul_rn(wx0, __ldg(row)), __fmul_rn(fx, __ldg(row + 1)));
}

// ((s00 m00 + s01 m01) + s10 m10) + s11 m11 over one cube
__device__ __forceinline__ float mix4(const float* c, size_t nxp, size_t plane, float wx0,
                                      float fx, const float* m) {
  float v = __fmul_rn(xblend(c, wx0, fx), m[0]);
  v = __fadd_rn(v, __fmul_rn(xblend(c + nxp, wx0, fx), m[1]));
  v = __fadd_rn(v, __fmul_rn(xblend(c + plane, wx0, fx), m[2]));
  return __fadd_rn(v, __fmul_rn(xblend(c + plane + nxp, wx0, fx), m[3]));
}

__global__ void window_integrate_kernel(const Params prm) {
  extern __shared__ int smem[];
  const int n_slots = prm.n_groups * prm.G;
  int* s_pi = smem;
  float* s_pf = reinterpret_cast<float*>(s_pi + n_slots * kPlanI);
  int* s_za = reinterpret_cast<int*>(s_pf + n_slots * kPlanF);
  for (int i = threadIdx.x; i < n_slots * kPlanI; i += blockDim.x) s_pi[i] = prm.plan_i[i];
  for (int i = threadIdx.x; i < n_slots * kPlanF; i += blockDim.x) s_pf[i] = prm.plan_f[i];
  for (int i = threadIdx.x; i < prm.n_groups; i += blockDim.x) s_za[i] = prm.za[i];
  __syncthreads();

  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= prm.n) return;
  const size_t N = static_cast<size_t>(prm.n);
  const size_t LN = static_cast<size_t>(prm.L) * N;
  const size_t nxp = static_cast<size_t>(prm.nxp);
  const size_t plane = static_cast<size_t>(prm.ny) * nxp;
  const long long tile = r / prm.tile;
  const float re = prm.re[r];
  float out_w = 0.0f, out_h = 0.0f;

  for (int g = 0; g < prm.n_groups; ++g) {
    const int* pi = s_pi + g * prm.G * kPlanI;
    const float* pf = s_pf + g * prm.G * kPlanF;
    const int ay = prm.ay[tile * prm.n_groups + g];
    const int ax = prm.ax[tile * prm.n_groups + g];
    float acc_w = 0.0f, acc_h = 0.0f;
    bool any_real = false;
    for (int s = 0; s < prm.G; ++s) {
      const int* si = pi + s * kPlanI;
      const float* sf = pf + s * kPlanF;
      if (si[4] != 0) continue;  // padding adds nothing
      any_real = true;
      const size_t o = static_cast<size_t>(si[0]) * N + r;
      const float f = sf[0];
      const float py = lerp_rn(prm.lo[o], prm.hi[o], f);
      const float px = lerp_rn(prm.lo[LN + o], prm.hi[LN + o], f);
      const float lz = prm.lo[2 * LN + o], hz = prm.hi[2 * LN + o];
      float pz = lerp_rn(lz, hz, f);
      const float hbar = __fmul_rn(0.5f, __fadd_rn(lz, hz));
      const float sag = __fdiv_rn(__fmul_rn(__fmul_rn(f, __fsub_rn(1.0f, f)), prm.d2[o]),
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
      const int dy = iy - ay, dx = ix - ax;
      const float fz = __fmul_rn(__fsub_rn(pz, sf[3]), sf[4]);
      const bool ok = by && bx && bz && dy >= 0 && dy <= prm.wy - 2 && dx >= 0 &&
                      dx <= prm.wx - 2;

      float v_w = NAN, v_h = NAN;
      if (ok) {
        const size_t base =
            static_cast<size_t>(s_za[g] + si[3]) * plane + static_cast<size_t>(iy) * nxp + ix;
        const float wz0 = __fsub_rn(1.0f, fz), wy0 = __fsub_rn(1.0f, fy);
        const float m[4] = {__fmul_rn(wz0, wy0), __fmul_rn(wz0, fy), __fmul_rn(fz, wy0),
                            __fmul_rn(fz, fy)};
        const float wx0 = __fsub_rn(1.0f, fx);
        v_w = mix4(prm.cube_w + base, nxp, plane, wx0, fx, m);
        v_h = mix4(prm.cube_h + base, nxp, plane, wx0, fx, m);
      }
      const float rl = __fadd_rn(__fmul_rn(sf[1], prm.ray_len[static_cast<size_t>(si[1]) * N + r]),
                                 __fmul_rn(sf[2], prm.ray_len[static_cast<size_t>(si[2]) * N + r]));
      const float wt = __fmul_rn(1.0e-6f, rl);
      acc_w = __fadd_rn(acc_w, __fmul_rn(wt, v_w));
      acc_h = __fadd_rn(acc_h, __fmul_rn(wt, v_h));
    }
    if (any_real) {
      out_w = __fadd_rn(out_w, acc_w);
      out_h = __fadd_rn(out_h, acc_h);
    }
  }
  prm.out[r] = out_w;
  prm.out[N + r] = out_h;
}

}  // namespace

extern "C" int window_integrate_launch(
    const float* lo, const float* hi, const float* d2, const float* ray_len, const float* re,
    const float* cube_w, const float* cube_h, const int* ay, const int* ax, const int* plan_i,
    const float* plan_f, const int* za, float* out, long long n, int L, int n_groups, int G,
    int wy, int wx, int tile, int ny, int nx, int nxp, float y_lo, float y_inv, float x_lo,
    float x_inv, float z_lo, float z_hi, int z_clip, void* stream) {
  if (G < 1 || n_groups < 1 || L < 1 || tile < 1 || ny < 2 || nx < 2 || nxp < nx) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Params prm;
  prm.lo = lo;
  prm.hi = hi;
  prm.d2 = d2;
  prm.ray_len = ray_len;
  prm.re = re;
  prm.cube_w = cube_w;
  prm.cube_h = cube_h;
  prm.ay = ay;
  prm.ax = ax;
  prm.plan_i = plan_i;
  prm.plan_f = plan_f;
  prm.za = za;
  prm.out = out;
  prm.n = n;
  prm.L = L;
  prm.n_groups = n_groups;
  prm.G = G;
  prm.wy = wy;
  prm.wx = wx;
  prm.tile = tile;
  prm.ny = ny;
  prm.nx = nx;
  prm.nxp = nxp;
  prm.y_lo = y_lo;
  prm.y_inv = y_inv;
  prm.x_lo = x_lo;
  prm.x_inv = x_inv;
  prm.z_lo = z_lo;
  prm.z_hi = z_hi;
  prm.z_clip = z_clip;

  const size_t smem = static_cast<size_t>(n_groups) * G * (kPlanI * sizeof(int) + kPlanF * sizeof(float))
                      + static_cast<size_t>(n_groups) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_integrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  window_integrate_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
