// Brick integrate along raytraced slant paths: kernel B2 (float32 table)
// and kernel K4 (its int16 branch, brick_i16).
//
// Replaces: raider_tpu/delay/raytrace.py, _static_brick_pallas_fn ->
// group_kernel / group_call / run (Pallas, TPU), with and without has_deq,
// and its XLA form _integrate_bricks (the plan as operands, deq).
//
// Per ray (one thread) and per brick group of the grouped sampling plan:
//   1. every sample's position: lerp between the level boundaries, the chord
//      sagitta -f(1-f) d^2 / (2 (Re + h)), the optional z clip;
//   2. its cell by the locate formula of raider_tpu_torch/ops/interp.py,
//      _locate ((p - lo) / step on a uniform axis, a binary search
//      otherwise), and the group anchor as the minimum cell;
//   3. one brick row (planes x wy x wx x {wet, hydro} floats) read straight
//      from the table at (anchor z, anchor y, anchor x): no (N, width)
//      gathered brick is ever written out;
//   4. per sample, the exact integer window test (dy <= wy-2, dx <= wx-2),
//      bounds, trapezoid weight 1e-6 * ray length, and the trilinear mix of
//      the two z planes it uses with hat weights in y and x (wy x wx x 2
//      corners per field) into wet and hydro.
// An out-of-bounds or out-of-window sample makes the whole ray NaN; padded
// plan slots contribute nothing; NaN in the two brick planes a sample uses
// poisons the ray, as in the Pallas kernel.
//
// Bound on this card: scattered reads of 504-byte table rows, ~11-16 per ray
// per slice at the (7,3,3,6) spec, plus 5 (L+1) coalesced level-boundary
// floats per ray; the arithmetic is small.
// Design against that bound: the gather happens inside the kernel, so each
// row is read once per ray and group (through L1, shared by the group's
// samples) and nothing intermediate reaches device memory; boundary rows are
// indexed [level][ray], so a warp's loads of one level coalesce; the plan,
// common to all rays, is staged once per block in shared memory.
//
// All arithmetic uses explicit round-to-nearest intrinsics in the twin's
// order of operations: no FMA contraction, so each sample's position, cell
// and contribution are bit-identical to the plain-torch twin
// (delay/raytrace.py, integrate_bricks_ref) on a NaN-free table, and the
// window test and NaN masks agree. Row offsets are 64-bit: row * width passes 2^31
// floats at a 51x400x400 cube.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kI16Nan = -32768;  // int16 sentinel of a non-finite cell
constexpr int kPlanI = 5;  // lvl, wa_lvl, wb_lvl, dzoff, pad
constexpr int kPlanF = 5;  // frac, wa, wb, zlo, zinv

struct Axis {
  const float* grid;  // (n,) ascending; read only when !uniform
  float lo, hi, step;
  int uniform, n;
};

template <typename Row>
struct Params {
  const Row* table;
  const float* deq;  // [sw, ow, sh, oh] for an int16 table, else null
  const float* bnd_y;
  const float* bnd_x;
  const float* bnd_z;
  const float* d2;
  const float* ray_len;
  const float* re;
  const int* plan_i;
  const float* plan_f;
  const int* anchor;
  float* out;
  long long n;
  int n_groups, G, planes, wy, wx, ny, nx;
  Axis y, x;
  float z_lo, z_hi;
  int z_clip;
};

// _locate: cell index in [0, n-2], fractional offset, in-bounds flag.
__device__ __forceinline__ int locate(const Axis& a, float p, float* frac, bool* inb) {
  *inb = (p >= a.lo) && (p <= a.hi);
  if (a.uniform) {
    const float pos = __fdiv_rn(__fsub_rn(p, a.lo), a.step);
    // clamp in float: NaN clamps to cell 0 instead of an undefined integer
    const float idx = fminf(fmaxf(floorf(pos), 0.0f), static_cast<float>(a.n - 2));
    *frac = __fsub_rn(pos, idx);
    return static_cast<int>(idx);
  }
  int lo = 0, hi = a.n;  // first node > p (searchsorted side='right')
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.grid[mid] <= p) lo = mid + 1; else hi = mid;
  }
  const int idx = max(0, min(lo - 1, a.n - 2));
  const float x0 = a.grid[idx];
  *frac = __fdiv_rn(__fsub_rn(p, x0), __fsub_rn(a.grid[idx + 1], x0));
  return idx;
}

__device__ __forceinline__ float lerp_rn(float lo, float hi, float f) {
  return __fadd_rn(lo, __fmul_rn(f, __fsub_rn(hi, lo)));
}

// one corner of the row as float: a float row as it is, an int16 row decoded
__device__ __forceinline__ float corner(const float* p, float, float) { return __ldg(p); }

__device__ __forceinline__ float corner(const short* p, float scale, float offset) {
  const short raw = __ldg(p);
  return raw == kI16Nan ? NAN : __fadd_rn(__fmul_rn(static_cast<float>(raw), scale), offset);
}

template <typename Row, int kMaxG>
__global__ void brick_integrate_kernel(const Params<Row> prm) {
  extern __shared__ int smem[];
  const int n_slots = prm.n_groups * prm.G;
  int* s_pi = smem;
  float* s_pf = reinterpret_cast<float*>(s_pi + n_slots * kPlanI);
  int* s_anchor = reinterpret_cast<int*>(s_pf + n_slots * kPlanF);
  for (int i = threadIdx.x; i < n_slots * kPlanI; i += blockDim.x) s_pi[i] = prm.plan_i[i];
  for (int i = threadIdx.x; i < n_slots * kPlanF; i += blockDim.x) s_pf[i] = prm.plan_f[i];
  for (int i = threadIdx.x; i < prm.n_groups; i += blockDim.x) s_anchor[i] = prm.anchor[i];
  __syncthreads();

  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= prm.n) return;
  const size_t N = static_cast<size_t>(prm.n);
  const float re = prm.re[r];
  const int width = prm.planes * prm.wy * prm.wx * 2;
  float sw = 0.0f, ow = 0.0f, sh = 0.0f, oh = 0.0f;
  if (prm.deq != nullptr) {
    sw = prm.deq[0];
    ow = prm.deq[1];
    sh = prm.deq[2];
    oh = prm.deq[3];
  }
  float acc_w = 0.0f, acc_h = 0.0f;

  for (int g = 0; g < prm.n_groups; ++g) {
    const int* pi = s_pi + g * prm.G * kPlanI;
    const float* pf = s_pf + g * prm.G * kPlanF;
    int iy[kMaxG], ix[kMaxG];
    float fy[kMaxG], fx[kMaxG], fz[kMaxG], wt[kMaxG];
    bool ok[kMaxG];
    int ay = INT_MAX, ax = INT_MAX;
    bool any_real = false;
#pragma unroll
    for (int s = 0; s < kMaxG; ++s) {
      if (s < prm.G) {
        const int lv = pi[s * kPlanI + 0];
        const size_t o0 = static_cast<size_t>(lv) * N + r;
        const size_t o1 = o0 + N;
        const float f = pf[s * kPlanF + 0];
        const float py = lerp_rn(prm.bnd_y[o0], prm.bnd_y[o1], f);
        const float px = lerp_rn(prm.bnd_x[o0], prm.bnd_x[o1], f);
        const float lz = prm.bnd_z[o0], hz = prm.bnd_z[o1];
        float pz = lerp_rn(lz, hz, f);
        const float hbar = __fmul_rn(0.5f, __fadd_rn(lz, hz));
        const float sag = __fdiv_rn(__fmul_rn(__fmul_rn(f, __fsub_rn(1.0f, f)), prm.d2[o0]),
                                    __fmul_rn(2.0f, __fadd_rn(re, hbar)));
        pz = __fsub_rn(pz, sag);
        if (prm.z_clip && !isnan(pz)) pz = fminf(fmaxf(pz, prm.z_lo), prm.z_hi);
        const bool bz = (pz >= prm.z_lo) && (pz <= prm.z_hi);
        bool by, bx;
        iy[s] = locate(prm.y, py, &fy[s], &by);
        ix[s] = locate(prm.x, px, &fx[s], &bx);
        fz[s] = __fmul_rn(__fsub_rn(pz, pf[s * kPlanF + 3]), pf[s * kPlanF + 4]);
        ok[s] = by && bx && bz;
        const float rl = __fadd_rn(
            __fmul_rn(pf[s * kPlanF + 1], prm.ray_len[static_cast<size_t>(pi[s * kPlanI + 1]) * N + r]),
            __fmul_rn(pf[s * kPlanF + 2], prm.ray_len[static_cast<size_t>(pi[s * kPlanI + 2]) * N + r]));
        wt[s] = __fmul_rn(1.0e-6f, rl);
        ay = min(ay, iy[s]);
        ax = min(ax, ix[s]);
        any_real = any_real || (pi[s * kPlanI + 4] == 0);
      }
    }
    if (!any_real) continue;  // an all-padding group contributes exactly 0

    const long long row_idx =
        (static_cast<long long>(s_anchor[g]) * prm.ny + ay) * prm.nx + ax;
    const Row* row = prm.table + static_cast<size_t>(row_idx) * static_cast<size_t>(width);

#pragma unroll
    for (int s = 0; s < kMaxG; ++s) {
      if (s < prm.G && pi[s * kPlanI + 4] == 0) {
        const int dy = iy[s] - ay, dx = ix[s] - ax;
        const bool in_window = ok[s] && dy <= prm.wy - 2 && dx <= prm.wx - 2;
        const float wte = in_window ? wt[s] : NAN;
        const float gy = __fadd_rn(static_cast<float>(dy), fy[s]);
        const float gx = __fadd_rn(static_cast<float>(dx), fx[s]);
        const float w0 = __fsub_rn(1.0f, fz[s]);
        const float w1 = fz[s];
        const int dzo = pi[s * kPlanI + 3];
        // the twin's order: z mix per corner, then the hat sum over y, then
        // over x, then the trapezoid weight; a hat weight is nonzero for at
        // most two corners, so each sum rounds exactly as the twin's does
        float v_w = 0.0f, v_h = 0.0f;
        for (int l = 0; l < prm.wx; ++l) {
          float vy_w = 0.0f, vy_h = 0.0f;
          for (int k = 0; k < prm.wy; ++k) {
            const float hk =
                fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(gy, static_cast<float>(k)))), 0.0f);
            const Row* c0 = row + ((dzo * prm.wy + k) * prm.wx + l) * 2;
            const Row* c1 = c0 + prm.wy * prm.wx * 2;
            const float vz_w = __fadd_rn(__fmul_rn(corner(c0, sw, ow), w0),
                                         __fmul_rn(corner(c1, sw, ow), w1));
            const float vz_h = __fadd_rn(__fmul_rn(corner(c0 + 1, sh, oh), w0),
                                         __fmul_rn(corner(c1 + 1, sh, oh), w1));
            vy_w = __fadd_rn(vy_w, __fmul_rn(vz_w, hk));
            vy_h = __fadd_rn(vy_h, __fmul_rn(vz_h, hk));
          }
          const float hl =
              fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(gx, static_cast<float>(l)))), 0.0f);
          v_w = __fadd_rn(v_w, __fmul_rn(vy_w, hl));
          v_h = __fadd_rn(v_h, __fmul_rn(vy_h, hl));
        }
        acc_w = __fadd_rn(acc_w, __fmul_rn(wte, v_w));
        acc_h = __fadd_rn(acc_h, __fmul_rn(wte, v_h));
      }
    }
  }
  prm.out[r] = acc_w;
  prm.out[N + r] = acc_h;
}

template <typename Row, int kMaxG>
int launch_instance(const Params<Row>& prm, void* stream) {
  const size_t smem = static_cast<size_t>(prm.n_groups) * prm.G * (kPlanI * sizeof(int) + kPlanF * sizeof(float))
                      + static_cast<size_t>(prm.n_groups) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        brick_integrate_kernel<Row, kMaxG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 128;
  const long long blocks = (prm.n + threads - 1) / threads;
  brick_integrate_kernel<Row, kMaxG><<<static_cast<unsigned>(blocks), threads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename Row>
int launch(const Row* table, const float* deq, const float* bnd_y, const float* bnd_x,
           const float* bnd_z, const float* d2, const float* ray_len, const float* re,
           const int* plan_i, const float* plan_f, const int* anchor, const float* y_axis,
           const float* x_axis, float* out, long long n, int n_groups, int G, int planes,
           int wy, int wx, int ny, int nx, float y_lo, float y_hi, float y_step, int y_uniform,
           float x_lo, float x_hi, float x_step, int x_uniform, float z_lo, float z_hi,
           int z_clip, void* stream) {
  if (G < 1 || G > 24 || n_groups < 1 || ny < 2 || nx < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Params<Row> prm;
  prm.table = table;
  prm.deq = deq;
  prm.bnd_y = bnd_y;
  prm.bnd_x = bnd_x;
  prm.bnd_z = bnd_z;
  prm.d2 = d2;
  prm.ray_len = ray_len;
  prm.re = re;
  prm.plan_i = plan_i;
  prm.plan_f = plan_f;
  prm.anchor = anchor;
  prm.out = out;
  prm.n = n;
  prm.n_groups = n_groups;
  prm.G = G;
  prm.planes = planes;
  prm.wy = wy;
  prm.wx = wx;
  prm.ny = ny;
  prm.nx = nx;
  prm.y = Axis{y_axis, y_lo, y_hi, y_step, y_uniform, ny};
  prm.x = Axis{x_axis, x_lo, x_hi, x_step, x_uniform, nx};
  prm.z_lo = z_lo;
  prm.z_hi = z_hi;
  prm.z_clip = z_clip;
  return G <= 8 ? launch_instance<Row, 8>(prm, stream) : launch_instance<Row, 24>(prm, stream);
}

}  // namespace

extern "C" int brick_integrate_launch(
    const float* table, const float* bnd_y, const float* bnd_x, const float* bnd_z,
    const float* d2, const float* ray_len, const float* re, const int* plan_i,
    const float* plan_f, const int* anchor, const float* y_axis, const float* x_axis,
    float* out, long long n, int n_groups, int G, int planes, int wy, int wx, int ny,
    int nx, float y_lo, float y_hi, float y_step, int y_uniform, float x_lo, float x_hi,
    float x_step, int x_uniform, float z_lo, float z_hi, int z_clip, void* stream) {
  return launch<float>(table, nullptr, bnd_y, bnd_x, bnd_z, d2, ray_len, re, plan_i, plan_f,
                       anchor, y_axis, x_axis, out, n, n_groups, G, planes, wy, wx, ny, nx,
                       y_lo, y_hi, y_step, y_uniform, x_lo, x_hi, x_step, x_uniform, z_lo,
                       z_hi, z_clip, stream);
}

extern "C" int brick_integrate_i16_launch(
    const short* table, const float* bnd_y, const float* bnd_x, const float* bnd_z,
    const float* d2, const float* ray_len, const float* re, const int* plan_i,
    const float* plan_f, const int* anchor, const float* y_axis, const float* x_axis,
    float* out, const float* deq, long long n, int n_groups, int G, int planes, int wy,
    int wx, int ny, int nx, float y_lo, float y_hi, float y_step, int y_uniform, float x_lo,
    float x_hi, float x_step, int x_uniform, float z_lo, float z_hi, int z_clip,
    void* stream) {
  if (deq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<short>(table, deq, bnd_y, bnd_x, bnd_z, d2, ray_len, re, plan_i, plan_f,
                       anchor, y_axis, x_axis, out, n, n_groups, G, planes, wy, wx, ny, nx,
                       y_lo, y_hi, y_step, y_uniform, x_lo, x_hi, x_step, x_uniform, z_lo,
                       z_hi, z_clip, stream);
}
