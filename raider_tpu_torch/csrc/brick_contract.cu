// Brick contraction of one sample group over a gathered brick (kernel K1).
//
// Replaces: scripts/kernel_profile.py, make_pallas_fn -> contract_kernel
// (Pallas, TPU): the U-build plus contraction over the lanes of a gathered
// (N, width) brick, given each sample's four per-ray scalars (gy, gx, fz,
// wte) and its static z-plane offset.
//
// Per ray (one thread) and per lane c of its brick row (width = planes x wy
// x wx x 2 lanes): the lane's (dz, dy, dx, field) decoded in float with
// float floors, exactly as contract_kernel does; U(c) = sum over samples s
// of wte * wz * wyl * wxl with wz = m0 (1 - fz) + m1 fz (m0, m1 the 0/1
// plane masks of planes dzo and dzo + 1) and the hat weights
// wyl = max(0, 1 - |gy - dy|), wxl = max(0, 1 - |gx - dx|); then
// wet = sum_c brick(c) U(c) (1 - fhyd), hydro = sum_c brick(c) U(c) fhyd.
// The lane sums run in lane order, as the twin sums them
// (scripts/kernel_profile.py, contract_ref), with round-to-nearest
// intrinsics in the twin's order of operations and NaN-propagating max, so
// the kernel and its twin agree bit for bit.
//
// Bound on this card: the bytes of the gathered brick (504 bytes a ray at
// the (7,3,3,6) spec) and the 4S scalars a ray, read once; the arithmetic
// (~10 flops per lane and sample) is a few times below that at S = 6.
// Design against that bound: one thread streams its own row and scalars
// through L1 (simple first; a warp-cooperative, coalesced row load is the
// next step); the group's z offsets sit in shared memory.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSamples = 64;

// jnp.maximum(0, x): NaN stays NaN (fmaxf would return 0)
__device__ __forceinline__ float relu_nan(float x) { return isnan(x) ? x : fmaxf(x, 0.0f); }

__global__ void brick_contract_kernel(const float* __restrict__ brick,
                                      const float* __restrict__ scal,
                                      const int* __restrict__ dzos, float* __restrict__ out_w,
                                      float* __restrict__ out_h, long long n, int S, int planes,
                                      int wy, int wx) {
  __shared__ float s_dzo[kMaxSamples];
  for (int i = threadIdx.x; i < S; i += blockDim.x) s_dzo[i] = static_cast<float>(dzos[i]);
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int width = planes * wy * wx * 2;
  const float* row = brick + static_cast<size_t>(r) * width;
  const float* sc = scal + static_cast<size_t>(r) * 4 * S;
  const float plane_w = static_cast<float>(wy * wx * 2);
  const float row_w = static_cast<float>(wx * 2);
  float acc_w = 0.0f, acc_h = 0.0f;
  for (int c = 0; c < width; ++c) {
    const float lane = static_cast<float>(c);
    const float dzc = floorf(__fdiv_rn(lane, plane_w));
    const float r1 = __fsub_rn(lane, __fmul_rn(dzc, plane_w));
    const float dyc = floorf(__fdiv_rn(r1, row_w));
    const float r2 = __fsub_rn(r1, __fmul_rn(dyc, row_w));
    const float dxc = floorf(__fdiv_rn(r2, 2.0f));
    const float fhyd = __fsub_rn(r2, __fmul_rn(2.0f, dxc));
    float u = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float gy = __ldg(sc + 4 * s);
      const float gx = __ldg(sc + 4 * s + 1);
      const float fz = __ldg(sc + 4 * s + 2);
      const float wte = __ldg(sc + 4 * s + 3);
      const float m0 = dzc == s_dzo[s] ? 1.0f : 0.0f;
      const float m1 = dzc == __fadd_rn(s_dzo[s], 1.0f) ? 1.0f : 0.0f;
      const float wz = __fadd_rn(__fmul_rn(m0, __fsub_rn(1.0f, fz)), __fmul_rn(m1, fz));
      const float wyl = relu_nan(__fsub_rn(1.0f, fabsf(__fsub_rn(gy, dyc))));
      const float wxl = relu_nan(__fsub_rn(1.0f, fabsf(__fsub_rn(gx, dxc))));
      const float w = __fmul_rn(__fmul_rn(__fmul_rn(wte, wz), wyl), wxl);
      u = s == 0 ? w : __fadd_rn(u, w);
    }
    const float prod = __fmul_rn(__ldg(row + c), u);
    acc_w = __fadd_rn(acc_w, __fmul_rn(prod, __fsub_rn(1.0f, fhyd)));
    acc_h = __fadd_rn(acc_h, __fmul_rn(prod, fhyd));
  }
  out_w[r] = acc_w;
  out_h[r] = acc_h;
}

}  // namespace

extern "C" int brick_contract_launch(const float* brick, const float* scal, const int* dzos,
                                     float* out_w, float* out_h, long long n, int S, int planes,
                                     int wy, int wx, void* stream) {
  if (S < 1 || S > kMaxSamples || planes < 2 || wy < 1 || wx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  brick_contract_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(brick, scal, dzos, out_w, out_h,
                                                               n, S, planes, wy, wx);
  return static_cast<int>(cudaGetLastError());
}
