// Staging of contiguous row spans into shared memory by cp.async for the
// kernels that give each thread one ray's row, K1 (brick_contract.cu) and
// K3 (brick_group.cu), and K1's choice of a block size by shared memory.
//
// A block of R consecutive rays reads one contiguous span of R x width
// floats of the gathered brick: all threads copy it in memory order, so
// every warp reads whole 128-byte lines. The tile's row pitch has an odd
// number of (wet, hydro) pairs: a thread reads its row as 8-byte pairs, and
// the 16 threads of one shared-memory phase at a pitch of an odd number of
// pairs fall on 16 distinct bank pairs.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kSmemBlockMax = 232448;      // dynamic shared bytes a block may take
constexpr long long kSmemSM = 233472;            // shared bytes of one SM
constexpr long long kSmemBlockReserved = 1024;   // kept by the runtime per resident block
constexpr int kMaxBlocksSM = 32;

// The brick tile's row pitch in floats: an odd number of (wet, hydro) pairs.
__host__ __device__ __forceinline__ int brick_pitch(int width) {
  return (width / 2) % 2 == 1 ? width : width + 2;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Close the thread's open copies into a group; wait until at most N of its
// groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, nr) of `cols` floats from src (contiguous) into dst at a
// row pitch of `pitch` floats, in units of `unit` floats (4 only when
// pitch == cols; else 1, or 2 dividing cols and pitch), consecutive threads
// on consecutive units. In a padded tile the (row, col) of a thread's unit
// is carried from step to step. Only the first `keep` floats of each row
// are needed (cols: all); with 16-byte units the units wholly past column
// `keep` of their row are not copied (a unit that straddles two rows is).
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int nr,
                                           int cols, int pitch, int unit, int keep) {
  const int threads = static_cast<int>(blockDim.x);
  const long long total = static_cast<long long>(nr) * cols;
  const int tid = static_cast<int>(threadIdx.x);
  if (pitch == cols && unit == 4 && keep < cols) {  // the row's column carried from step to step
    const long long head = total - total % 4;
    const int carry = threads * 4 % cols;
    int col = tid * 4 % cols;
    for (long long i = static_cast<long long>(tid) * 4; i < head;
         i += static_cast<long long>(threads) * 4) {
      if (col < keep || col + 4 > cols) cp_async16(dst + i, src + i);
      col += carry;
      if (col >= cols) col -= cols;
    }
    for (long long i = head + tid; i < total; i += threads) cp_async4(dst + i, src + i);
    return;
  }
  if (pitch == cols) {  // the tile is the span itself; a tail of < unit floats by 4 bytes
    const long long head = total - total % unit;
    for (long long i = static_cast<long long>(tid) * unit; i < head;
         i += static_cast<long long>(threads) * unit) {
      if (unit == 4) {
        cp_async16(dst + i, src + i);
      } else if (unit == 2) {
        cp_async8(dst + i, src + i);
      } else {
        cp_async4(dst + i, src + i);
      }
    }
    for (long long i = head + tid; i < total; i += threads) cp_async4(dst + i, src + i);
    return;
  }
  const int step = threads * unit;
  const int q = step / cols, r = step % cols;
  int row = tid * unit / cols, col = tid * unit % cols;
  for (long long i = static_cast<long long>(tid) * unit; i < total; i += step) {
    float* d = dst + static_cast<long long>(row) * pitch + col;
    if (unit == 2) {
      cp_async8(d, src + i);
    } else {
      cp_async4(d, src + i);
    }
    col += r;
    row += q;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
}

// Copy unit (floats) of a brick tile: every block's span starts at a
// multiple of R x width floats from `brick`, R a multiple of 4 and width
// even, so it is as aligned as `brick`; 16-byte units need the tile to be
// the span itself, 8-byte ones only an even width and pitch.
inline int copy_unit(const float* brick, int width) {
  const auto a = reinterpret_cast<std::uintptr_t>(brick);
  if (brick_pitch(width) == width && a % 16 == 0) return 4;
  return a % 8 == 0 ? 2 : 1;
}

// Of the block sizes `rays` (ascending), the one with the most resident
// rays an SM by shared memory, the larger on a tie; `bytes(R)` is a block's
// dynamic shared memory. False when not even the first fits a block.
template <int N, typename Bytes>
bool pick_block(const int (&rays)[N], Bytes bytes, int* threads, long long* smem) {
  long long best = -1;
  for (int R : rays) {
    const long long b = bytes(R);
    if (b > kSmemBlockMax) break;
    long long blocks = kSmemSM / (b + kSmemBlockReserved);
    if (blocks > kMaxBlocksSM) blocks = kMaxBlocksSM;
    if (blocks * R >= best) {
      best = blocks * R;
      *threads = R;
      *smem = b;
    }
  }
  return best >= 0;
}

}  // namespace
