// 16-bit table-row probes (kernels S4 and S5).
//
// Replaces: scripts/probe_f16.py:53, probe_kernel (S4) and
// scripts/probe_f16.py:88, probe_bitcast_i16_bf16 (S5) (Pallas, TPU). They
// ask whether 16-bit 128-wide table rows load and convert as cheaply as f32
// ones on this card, before the int16 table modes are ported.
//
// S4 probe_load: x (n, 128) in bf16, f16 or int16 -> out (n,) f32,
//   out[i] = sum over r = 0, 16, ..., 112 of float(x[i, r]) * 0.5,
//   summed in that order from 0 (the Pallas kernel's loop).
// S5 probe_bitcast_i16_bf16: x (n, 128) int16 bit patterns -> the same bits
//   read as bf16, converted to f32.
//
// Bound on this card: bytes. S4 reads one value in every 32-byte sector of
// each 256-byte row, so every sector of the block comes from memory (n x 256
// bytes in, n x 4 out) for 8 adds per row; S5 reads 2 and writes 4 bytes per
// element. Design: S4 runs one thread per row with the 8 loads in flight
// together; S5 moves 16 bytes a thread (8 elements) in and two float4 out,
// neighbouring threads on neighbouring addresses, in a grid-stride loop.
// S4's sum uses round-to-nearest intrinsics in the twin's order; both
// conversions are exact, so both kernels match their twins bit for bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 128;
constexpr int kStride = 16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <>
__device__ __forceinline__ float to_f32<int16_t>(int16_t v) {
  return static_cast<float>(v);
}

template <typename T>
__global__ void probe_load_kernel(const T* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* row = x + static_cast<size_t>(i) * kWidth;
  float v[kWidth / kStride];
#pragma unroll
  for (int k = 0; k < kWidth / kStride; ++k) v[k] = to_f32(row[k * kStride]);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kWidth / kStride; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], 0.5f));
  out[i] = acc;
}

__device__ __forceinline__ float bf16_bits(unsigned int bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits & 0xffffu)));
}

// 8 int16 (one uint4, little-endian: element 2k in the low half of word k)
// -> 8 floats (two float4)
__global__ void bitcast_i16_bf16_kernel(const uint4* __restrict__ x, float4* __restrict__ out,
                                        long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const uint4 w = x[i];
    out[2 * i] = make_float4(bf16_bits(w.x), bf16_bits(w.x >> 16), bf16_bits(w.y),
                             bf16_bits(w.y >> 16));
    out[2 * i + 1] = make_float4(bf16_bits(w.z), bf16_bits(w.z >> 16), bf16_bits(w.w),
                                 bf16_bits(w.w >> 16));
  }
}

template <typename T>
int launch_probe_load(const void* x, float* out, long long n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  probe_load_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(x), out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_load_bf16_launch(const void* x, float* out, long long n, void* stream) {
  return launch_probe_load<__nv_bfloat16>(x, out, n, stream);
}

extern "C" int probe_load_f16_launch(const void* x, float* out, long long n, void* stream) {
  return launch_probe_load<__half>(x, out, n, stream);
}

extern "C" int probe_load_i16_launch(const void* x, float* out, long long n, void* stream) {
  return launch_probe_load<int16_t>(x, out, n, stream);
}

// n_elem must be a multiple of 8, x and out 16-byte aligned (the wrapper checks)
extern "C" int probe_bitcast_i16_bf16_launch(const void* x, float* out, long long n_elem,
                                             void* stream) {
  const long long n_vec = n_elem / 8;
  if (n_vec == 0) return 0;
  const int threads = 256;
  const long long want = (n_vec + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 132LL * 64 ? want : 132LL * 64);
  bitcast_i16_bf16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), reinterpret_cast<float4*>(out), n_vec);
  return static_cast<int>(cudaGetLastError());
}
