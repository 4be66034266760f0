// Fused refractivity + top-down zenith-delay scan (kernel B1).
//
// Replaces: raider_tpu/ops/pallas_ztd.py, ztd_totals -> _kernel (Pallas, TPU).
// Per (y, x) column of (nz, ny, nx) float32 cubes t, p, e:
//   N_w = k2 e / T + k3 e / T^2,   N_h = k1 p / T
//   tot[k] = sum_{j >= k} (N_j + N_{j+1}) * (dz_j * 0.5e-6),   tot[nz-1] = 0
//
// Bound on this card: device-memory bandwidth. Each call reads t, p, e once
// and writes wet and hydro once: 5 x 4 B per cell, ~163 MB at 51x400x400,
// against ~1 flop per byte.
// Design against that bound: one thread per column, threads laid along x, so
// every z-level load and store of a warp is one contiguous 128-byte run; the
// scan runs serially in registers (the upper level's refractivity and both
// accumulators are carried), so no intermediate ever reaches device memory.
// dz lives in shared memory (one copy per block).
//
// Numerics follow the Pallas kernel's order of operations (pallas_ztd.py:41,
// 54-56): (k2 e)/t + (k3 e)/(t t), dz * 0.5e-6 applied to (N + N_up). The
// accumulation uses explicit round-to-nearest intrinsics so that nvcc's FMA
// contraction cannot move it away from the plain-torch twin
// (raider_tpu_torch/ops/ztd.py, ztd_totals_ref).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void refractivity(float t, float p, float e, float k1, float k2,
                                             float k3, float* nw, float* nh) {
  *nw = __fadd_rn(__fdiv_rn(__fmul_rn(k2, e), t),
                  __fdiv_rn(__fmul_rn(k3, e), __fmul_rn(t, t)));
  *nh = __fdiv_rn(__fmul_rn(k1, p), t);
}

__global__ void ztd_totals_kernel(const float* __restrict__ t, const float* __restrict__ p,
                                  const float* __restrict__ e, const float* __restrict__ dz,
                                  float* __restrict__ wet, float* __restrict__ hyd, int nz,
                                  long long ncol, float k1, float k2, float k3) {
  extern __shared__ float s_dz[];
  for (int k = threadIdx.x; k < nz - 1; k += blockDim.x) s_dz[k] = dz[k];
  __syncthreads();

  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= ncol) return;

  size_t idx = static_cast<size_t>(nz - 1) * static_cast<size_t>(ncol) + c;
  float nw_up, nh_up;
  refractivity(t[idx], p[idx], e[idx], k1, k2, k3, &nw_up, &nh_up);
  wet[idx] = 0.0f;
  hyd[idx] = 0.0f;
  float acc_w = 0.0f, acc_h = 0.0f;
  for (int k = nz - 2; k >= 0; --k) {
    idx -= static_cast<size_t>(ncol);
    float nw, nh;
    refractivity(t[idx], p[idx], e[idx], k1, k2, k3, &nw, &nh);
    const float d = __fmul_rn(s_dz[k], 0.5e-6f);
    acc_w = __fadd_rn(acc_w, __fmul_rn(__fadd_rn(nw, nw_up), d));
    acc_h = __fadd_rn(acc_h, __fmul_rn(__fadd_rn(nh, nh_up), d));
    wet[idx] = acc_w;
    hyd[idx] = acc_h;
    nw_up = nw;
    nh_up = nh;
  }
}

}  // namespace

extern "C" int ztd_totals_launch(const float* t, const float* p, const float* e,
                                 const float* dz, float* wet, float* hyd, int nz,
                                 long long ncol, float k1, float k2, float k3,
                                 void* stream) {
  const int threads = 256;
  const long long blocks = (ncol + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(nz > 1 ? nz - 1 : 1) * sizeof(float);
  ztd_totals_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(t, p, e, dz, wet, hyd, nz, ncol,
                                                           k1, k2, k3);
  return static_cast<int>(cudaGetLastError());
}
