// Fused refractivity + top-down zenith-delay scan (kernel B1).
//
// Replaces: raider_tpu/ops/pallas_ztd.py, ztd_totals -> _kernel (Pallas, TPU).
// Per (y, x) column of (nz, ny, nx) float32 cubes t, p, e:
//   N_w = k2 e / T + k3 e / T^2,   N_h = k1 p / T
//   tot[k] = sum_{j >= k} (N_j + N_{j+1}) * (dz_j * 0.5e-6),   tot[nz-1] = 0
//
// Two input layouts, told apart by the strides (stride_z, stride_col) of the
// flattened (nz, ny * nx) view, which the wrapper passes:
//   * rows:    contiguous (z, y, x) cubes, stride_z = ny * nx, stride_col = 1;
//   * columns: the (z, y, x) view of contiguous (y, x, z) cubes, the weather
//              model's own layout, stride_z = 1, stride_col = nz.
// wet and hydro are always written as contiguous (z, y, x) cubes.
//
// Bound on this card: device-memory bandwidth. Each call reads t, p, e once
// and writes wet and hydro once: 5 x 4 B per cell, ~163 MB at 51x400x400,
// against ~1 flop per byte.
//
// The design against that bound:
//   * A block owns kCols consecutive columns and walks z from the top in
//     chunks of the levels split evenly, at most kMaxDepth levels a chunk.
//     Up to kMaxDepth levels (the HRRR ladder's 51) a block stages all its
//     columns' levels at once, and blocks overlap one another; deeper
//     ladders (ERA5's 137) run in chunks, chunk i + 1's t, p and e in
//     flight (cp.async) while the block works on chunk i in the other of
//     two buffers.
//   * All kThreads threads copy a chunk in memory order, consecutive
//     threads on consecutive addresses in either layout: in the rows layout
//     a chunk is its levels' rows of kCols contiguous floats, in the columns
//     layout kCols runs of its levels, one contiguous span when the chunk
//     holds every level. So each warp's copy fills whole 128-byte lines: a
//     column's run of a few levels would fill part of its sectors.
//   * The shared tile is [field][level][column], level rows padded to the
//     odd pitch kCols + 1. The columns layout's fill writes one column's
//     levels a warp, a stride of the odd pitch: distinct banks, but for the
//     lanes where a run ends and the next column's begins. Both passes below
//     read level rows: consecutive words.
//   * Pass 1: all threads turn each staged (t, p, e) into (N_w, N_h) in
//     place, independent cells, so the three divisions a cell run with every
//     thread of the block. Pass 2: one thread a column scans its column
//     serially in registers (the upper level's refractivity and both
//     accumulators are carried) and writes each level's two outputs as a
//     coalesced row of kCols floats. dz stays in shared memory. No
//     intermediate reaches device memory.
//   * The shape (64 columns, 256 threads, 64 levels: 39,980 bytes of shared
//     memory a block at 51 levels, 5 blocks an SM) did best on the H100, for
//     the columns layout at the headline cube and the HRRR CONUS grid, among
//     32-128 columns a block with 1-8 threads a column, with and without the
//     parallel pass, and persistent double-buffered blocks (PERF.md).
//   * The copies are 4 bytes. Why not 16-byte copies or TMA: the tile
//     transposes the columns layout and pads the level rows, so its words
//     are not 16-byte runs of the source; TMA also needs 16-byte-aligned
//     global strides: the (nz, ncol) view of the HRRR CONUS grid has a row
//     stride of 1059 * 1799 * 4 bytes and the columns view one of
//     51 * 4 = 204 bytes; neither is a multiple of 16.
//   * The launcher derives the launch shape (kThreads threads, the dynamic
//     shared bytes for nz) and refuses a level count whose tiles and steps
//     do not fit a block's shared memory.
//
// Numerics follow the Pallas kernel's order of operations (pallas_ztd.py:41,
// 54-56): (k2 e)/t + (k3 e)/(t t), dz * 0.5e-6 applied to (N + N_up). The
// accumulation uses explicit round-to-nearest intrinsics so that nvcc's FMA
// contraction cannot move it away from the plain-torch twin
// (raider_tpu_torch/ops/ztd.py, ztd_totals_ref): the kernel is bit-identical
// to it, NaN and inf included, on either layout.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;        // columns a block
constexpr int kThreads = 256;    // threads a block: all copy, all compute pass 1
constexpr int kMaxDepth = 64;    // levels a chunk at most
constexpr int kPitch = kCols + 1;  // words a staged level row
constexpr long long kSmemBlockMax = 232448;  // dynamic shared bytes a block may take

// The chunks split the levels evenly, top down: chunk i of nchunk holds
// levels [chunk_lo(i), chunk_lo(i - 1)), at most depth(nz) of them.
__host__ __device__ __forceinline__ int chunks(int nz) { return (nz + kMaxDepth - 1) / kMaxDepth; }
__host__ __device__ __forceinline__ int depth(int nz) {
  return (nz + chunks(nz) - 1) / chunks(nz);
}
__device__ __forceinline__ int chunk_lo(int i, int nz, int nchunk) {
  return nz - ((i + 1) * nz) / nchunk;
}

__device__ __forceinline__ void refractivity(float t, float p, float e, float k1, float k2,
                                             float k3, float* nw, float* nh) {
  *nw = __fadd_rn(__fdiv_rn(__fmul_rn(k2, e), t),
                  __fdiv_rn(__fmul_rn(k3, e), __fmul_rn(t, t)));
  *nh = __fdiv_rn(__fmul_rn(k1, p), t);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copies of levels [lo, lo + d) of the block's nc live columns
// (from c0) of t, p and e into buf, whose fields are field_words apart.
// Element i of the chunk in memory order is (column a, level b) with
// (a, b) = divmod(i, d) in the columns layout (levels fastest) and
// (level a, column b) = divmod(i, nc) in the rows layout; a thread steps i
// by kThreads, carrying (a, b) without a division.
__device__ __forceinline__ void stage_chunk(float* buf, int field_words,
                                            const float* __restrict__ t,
                                            const float* __restrict__ p,
                                            const float* __restrict__ e, long long c0, int nc,
                                            int lo, int d, long long stride_z,
                                            long long stride_col) {
  const bool levels_fast = stride_z == 1;
  const int inner = levels_fast ? d : nc;
  const int q = kThreads / inner, r = kThreads % inner;
  const int n = nc * d;
  int a = static_cast<int>(threadIdx.x) / inner, b = static_cast<int>(threadIdx.x) % inner;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int l = levels_fast ? b : a;
    const int c = levels_fast ? a : b;
    const long long g = (c0 + c) * stride_col + static_cast<long long>(lo + l) * stride_z;
    const int s = l * kPitch + c;
    cp_async4(buf + s, t + g);
    cp_async4(buf + field_words + s, p + g);
    cp_async4(buf + 2 * field_words + s, e + g);
    a += q;
    b += r;
    if (b >= inner) {
      b -= inner;
      ++a;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ztd_totals_kernel(const float* __restrict__ t, const float* __restrict__ p,
                      const float* __restrict__ e, const float* __restrict__ dz,
                      float* __restrict__ wet, float* __restrict__ hyd, int nz, long long ncol,
                      long long stride_z, long long stride_col, float k1, float k2, float k3) {
  extern __shared__ __align__(16) float smem[];
  const int nchunk = chunks(nz);
  const int field_words = depth(nz) * kPitch;
  const int buf_words = 3 * field_words;
  float* tiles = smem;                                       // [nbuf][3][depth][kPitch]
  float* s_dz = smem + (nchunk > 1 ? 2 : 1) * buf_words;     // nz - 1

  const long long c0 = static_cast<long long>(blockIdx.x) * kCols;
  const int nc = static_cast<int>(ncol - c0 < kCols ? ncol - c0 : kCols);
  const bool live = static_cast<int>(threadIdx.x) < nc;  // scans a column in pass 2
  const long long c = c0 + threadIdx.x;

  int lo = chunk_lo(0, nz, nchunk);
  stage_chunk(tiles, field_words, t, p, e, c0, nc, lo, nz - lo, stride_z, stride_col);
  cp_async_commit();
  for (int k = threadIdx.x; k < nz - 1; k += kThreads) s_dz[k] = dz[k];

  float nw_up = 0.0f, nh_up = 0.0f, acc_w = 0.0f, acc_h = 0.0f;
  for (int i = 0; i < nchunk; ++i) {
    const int hi = i == 0 ? nz - 1 : lo - 1;
    lo = chunk_lo(i, nz, nchunk);
    if (i + 1 < nchunk) {
      const int lo_next = chunk_lo(i + 1, nz, nchunk);
      stage_chunk(tiles + ((i + 1) & 1) * buf_words, field_words, t, p, e, c0, nc, lo_next,
                  lo - lo_next, stride_z, stride_col);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk i (and dz) visible to every thread
    float* buf = tiles + (i & 1) * buf_words;
    // pass 1: (t, p, e) -> (N_w, N_h) in place, every staged cell
    for (int j = threadIdx.x; j < (hi - lo + 1) * kCols; j += kThreads) {
      if (j % kCols >= nc) continue;
      const int s = (j / kCols) * kPitch + j % kCols;
      float nw, nh;
      refractivity(buf[s], buf[field_words + s], buf[2 * field_words + s], k1, k2, k3, &nw, &nh);
      buf[s] = nw;
      buf[field_words + s] = nh;
    }
    __syncthreads();
    // pass 2: the scan, one thread a column
    if (live) {
#pragma unroll 4
      for (int k = hi; k >= lo; --k) {
        const int s = (k - lo) * kPitch + threadIdx.x;
        const float nw = buf[s], nh = buf[field_words + s];
        const size_t o = static_cast<size_t>(k) * static_cast<size_t>(ncol) + c;
        if (k < nz - 1) {
          const float d = __fmul_rn(s_dz[k], 0.5e-6f);
          acc_w = __fadd_rn(acc_w, __fmul_rn(__fadd_rn(nw, nw_up), d));
          acc_h = __fadd_rn(acc_h, __fmul_rn(__fadd_rn(nh, nh_up), d));
        }
        wet[o] = acc_w;
        hyd[o] = acc_h;
        nw_up = nw;
        nh_up = nh;
      }
    }
    __syncthreads();  // buffer i & 1 read by all before chunk i + 2 overwrites it
  }
}

}  // namespace

extern "C" int ztd_totals_launch(const float* t, const float* p, const float* e,
                                 const float* dz, float* wet, float* hyd, int nz,
                                 long long ncol, long long stride_z, long long stride_col,
                                 float k1, float k2, float k3, void* stream) {
  if (nz < 2 || ncol < 1 || (ncol + kCols - 1) / kCols > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool rows = stride_col == 1 && stride_z == ncol;
  const bool columns = stride_z == 1 && stride_col == nz;
  if (!rows && !columns) return static_cast<int>(cudaErrorInvalidValue);
  // the launch shape: kCols columns a block; one chunk buffer (two when the
  // levels take more than one chunk) of t, p and e, then the nz - 1 steps
  const long long bufs = chunks(nz) > 1 ? 2 : 1;
  const long long smem = (bufs * 3 * depth(nz) * kPitch + (nz - 1)) * 4LL;
  if (smem > kSmemBlockMax) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      ztd_totals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (ncol + kCols - 1) / kCols;
  ztd_totals_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(t, p, e, dz, wet, hyd, nz, ncol,
                                                           stride_z, stride_col, k1, k2, k3);
  return static_cast<int>(cudaGetLastError());
}
