// Brick integrate along raytraced slant paths: kernel B2 (float32 table)
// and kernel K4 (its int16 branch, brick_i16).
//
// Replaces: raider_tpu/delay/raytrace.py, _static_brick_pallas_fn ->
// group_kernel / group_call / run (Pallas, TPU), with and without has_deq,
// and its XLA form _integrate_bricks (the plan as operands, deq).
//
// Per ray (one lane) and per brick group of the grouped sampling plan:
//   1. every sample's position: lerp between the level boundaries, the chord
//      sagitta -f(1-f) d^2 / (2 (Re + h)), the optional z clip;
//   2. its cell by the locate formula of raider_tpu_torch/ops/interp.py,
//      _locate ((p - lo) / step on a uniform axis, a binary search
//      otherwise), and the group anchor as the minimum cell;
//   3. per sample, the two z planes it uses (dzo, dzo+1) of the brick row at
//      (anchor z, anchor y, anchor x), staged in shared memory: no (N, width)
//      gathered brick is ever written out;
//   4. per sample, the exact integer window test (dy <= wy-2, dx <= wx-2),
//      bounds, trapezoid weight 1e-6 * ray length, and the trilinear mix of
//      the two planes with hat weights in y and x (wy x wx x 2 corners per
//      field) into wet and hydro.
// An out-of-bounds or out-of-window sample makes the whole ray NaN; padded
// plan slots contribute nothing; NaN in the two brick planes a sample uses
// poisons the ray, as in the Pallas kernel, and NaN elsewhere in the row
// does not.
//
// What bounds it on this card. Per ray and group the kernel needs a few
// hundred bytes of one 504-byte (f32) or 252-byte (int16) row at the
// (7,3,3,6) spec, and the rows of a warp's 32 rays lie anywhere in a table
// of gigabytes. Read one scalar at a time by one thread per ray (the first
// form of this kernel), each warp-wide load touched up to 32 sectors to use
// 4 or 2 bytes of each: ~2,100 such loads per ray and slice, with the L1 too
// small to keep a group's rows; that was its bound. Staged as below, what
// remains is (a) the planes each (ray, group) needs, fetched from device
// memory when the rays are incoherent, since the table is far larger than
// the L2 (the distinct-row bound counts each row once); (b) the loads of the
// level boundaries and the position math of every sample, three correctly
// rounded divisions among it; (c) one copy instruction per (wet, hydro)
// pair and ray. scripts/brick_ablation.py times the kernel without its
// copies and without its mix; PERF.md has the numbers.
//
// The design against that bound:
//   * Stage, do not scatter. The warp copies the brick planes its 32 rays
//     need (wy wx (wet, hydro) pairs each, 72 B f32 / 36 B int16 at 3x3)
//     into warp-owned rings in shared memory with cp.async. The copy unit
//     is one pair (8 B f32, 4 B int16): rows (504 B, 252 B) and plane
//     offsets (72 B, 36 B) are only pair-aligned at the 3x3 specs. Chunk i
//     of the warp's 32 planes goes to lane i % 32, so consecutive lanes
//     copy consecutive pairs of one plane and each plane arrives as whole
//     sectors. With the window fixed at compile time (3x3, 4x4) the copy
//     loop unrolls and its divisions by the pair count become multiplies.
//   * Copy each plane once per group. A ray's ring holds four planes; a
//     sample reads planes dzo and dzo+1, and the next sample of a group
//     mostly reuses one of them (dzo never falls within a group). A small
//     map, the same for every lane, records which slot holds which plane of
//     the current rows, so only planes the ring lacks are copied: about
//     half the copies and bytes of staging both planes per sample.
//   * Double-buffer across samples. While sample s's planes fly, the warp
//     finds the next real sample (and, on entering a group, that group's
//     anchor from its samples' y/x cells), copies the planes it lacks into
//     slots sample s does not read, and computes sample s's weights; then
//     cp.async.wait_group and __syncwarp, and sample s is mixed from shared
//     memory. The rings belong to one warp, so the loop needs no
//     __syncthreads.
//   * No bank conflicts. A ray's ring is padded to an odd number of pairs
//     (37 at 3x3, 65 at 4x4): the lanes' reads of one corner (a float2 for
//     f32, read in two half-warp phases; one 32-bit word for int16) then
//     fall on distinct banks.
//   * No per-sample register arrays. The group anchor needs every sample's
//     cell before the first plane can be addressed; the first pass computes
//     only the y/x cells, and each sample's full state is recomputed (the
//     same operations, so the same bits) when it is mixed. G bounds only
//     the plan's shared memory.
//   * The launch shape (threads, dynamic shared bytes) comes from
//     raider_tpu_torch/kernels/__init__.py, brick_launch_shape; this file
//     checks that the shared memory covers the plan and the rings. The
//     launch bound keeps a thread at 64 registers, so shared memory, not
//     registers, sets the resident warps up to 32 an SM.
// Why not TMA: a bulk copy needs a 16-byte-aligned address and a size that
// is a multiple of 16, and issues one request per plane (72 bytes at 8-byte
// alignment, a different row per lane); the planes of this gather are
// neither aligned nor large enough for it to pay, while cp.async takes 4- and
// 8-byte pairs from 32 lanes at once.
//
// All arithmetic uses explicit round-to-nearest intrinsics in the twin's
// order of operations: no FMA contraction, so each sample's position, cell
// and contribution are bit-identical to the plain-torch twin
// (delay/raytrace.py, integrate_bricks_ref) on a NaN-free table, and the
// window test and NaN masks agree. The int16 decode stays per corner, after
// the load (the sentinel to NaN, a multiply, then an add). Row indices are
// 32-bit (the wrapper checks the table's row count); element offsets are
// 64-bit: row * width passes 2^31 elements at a 51x400x400 cube.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kI16Nan = -32768;  // int16 sentinel of a non-finite cell
constexpr int kPlanI = 5;  // lvl, wa_lvl, wb_lvl, dzoff, pad
constexpr int kPlanF = 5;  // frac, wa, wb, zlo, zinv
// the launch bound: blocks of up to 512 threads, two of them resident, so at
// most 64 registers a thread and 32 resident warps an SM
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRing = 4;      // plane slots in a ray's ring
constexpr int kMaxPlanes = 16;  // planes a row may have: 2 bits a plane in the slot map

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

// one corner's (wet, hydro) pair: the unit of a copy and of a read
template <typename Row>
struct PairOf;
template <>
struct PairOf<float> {
  using T = float2;
};
template <>
struct PairOf<short> {
  using T = int;  // wet in the low half, hydro in the high half
};

// the plan's bytes at the head of the dynamic shared memory (16-aligned)
__host__ __device__ inline size_t plan_bytes(int n_groups, int G) {
  const size_t b = static_cast<size_t>(n_groups) * G * (kPlanI + kPlanF) * 4 +
                   static_cast<size_t>(n_groups) * 4;
  return (b + 15) / 16 * 16;
}

// pairs a ray's ring holds: kRing planes of wy x wx pairs, padded to an odd count
__host__ __device__ inline int slot_pairs(int wy, int wx) { return kRing * wy * wx + 1; }

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

// a corner pair as (wet, hydro) floats: a float pair as it is, an int16 pair
// decoded field by field
__device__ __forceinline__ void decode(float2 p, const float*, float* w, float* h) {
  *w = p.x;
  *h = p.y;
}

__device__ __forceinline__ float decode_i16(short raw, float scale, float offset) {
  return raw == kI16Nan ? NAN : __fadd_rn(__fmul_rn(static_cast<float>(raw), scale), offset);
}

__device__ __forceinline__ void decode(int p, const float* dq, float* w, float* h) {
  *w = decode_i16(static_cast<short>(p & 0xffff), dq[0], dq[1]);
  *h = decode_i16(static_cast<short>(p >> 16), dq[2], dq[3]);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// advance (g, s) to the next real (non-padding) slot of the plan, in plan
// order; false past the end. The plan is the same for every ray, so the
// whole warp takes the same path.
__device__ __forceinline__ bool next_slot(const int* s_pi, int n_groups, int G, int* g, int* s) {
  for (;;) {
    if (++*s >= G) {
      *s = 0;
      ++*g;
    }
    if (*g >= n_groups) return false;
    if (s_pi[(*g * G + *s) * kPlanI + 4] == 0) return true;
  }
}

// the group anchor's y/x cells: the minimum over every slot of the group
// (padding slots repeat the last real sample, as in the twin)
template <typename Row>
__device__ __forceinline__ void group_anchor(const Params<Row>& prm, const int* pi,
                                             const float* pf, size_t r, size_t N, int* ay,
                                             int* ax) {
  int my = INT_MAX, mx = INT_MAX;
  for (int s = 0; s < prm.G; ++s) {
    const size_t o0 = static_cast<size_t>(pi[s * kPlanI]) * N + r;
    const float f = pf[s * kPlanF];
    const float py = lerp_rn(prm.bnd_y[o0], prm.bnd_y[o0 + N], f);
    const float px = lerp_rn(prm.bnd_x[o0], prm.bnd_x[o0 + N], f);
    float frac;
    bool inb;
    my = min(my, locate(prm.y, py, &frac, &inb));
    mx = min(mx, locate(prm.x, px, &frac, &inb));
  }
  *ay = my;
  *ax = mx;
}

struct Weights {
  float gy, gx, w0, w1, wte;
};

// one sample's hat coordinates, z weights and trapezoid weight (NaN when the
// sample is out of bounds or out of the group's window)
template <typename Row>
__device__ __forceinline__ Weights sample_weights(const Params<Row>& prm, const int* pi,
                                                  const float* pf, float re, size_t r,
                                                  size_t N, int ay, int ax, int wy, int wx) {
  const size_t o0 = static_cast<size_t>(pi[0]) * N + r;
  const size_t o1 = o0 + N;
  const float f = pf[0];
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
  float fy, fx;
  bool by, bx;
  const int iy = locate(prm.y, py, &fy, &by);
  const int ix = locate(prm.x, px, &fx, &bx);
  const float fz = __fmul_rn(__fsub_rn(pz, pf[3]), pf[4]);
  const float rl = __fadd_rn(
      __fmul_rn(pf[1], prm.ray_len[static_cast<size_t>(pi[1]) * N + r]),
      __fmul_rn(pf[2], prm.ray_len[static_cast<size_t>(pi[2]) * N + r]));
  const int dy = iy - ay, dx = ix - ax;
  const bool in_window = by && bx && bz && dy <= wy - 2 && dx <= wx - 2;
  Weights w;
  w.wte = in_window ? __fmul_rn(1.0e-6f, rl) : NAN;
  w.gy = __fadd_rn(static_cast<float>(dy), fy);
  w.gx = __fadd_rn(static_cast<float>(dx), fx);
  w.w0 = __fsub_rn(1.0f, fz);
  w.w1 = fz;
  return w;
}

// The warp copies one plane of its 32 rays' rows into ring slot ``dst_off``
// (pairs) of each ray's ring ([32][slot] pairs): the pairs [src_off, src_off
// + plane_pairs) of row ``row`` of each lane (row < 0: an idle lane, nothing
// copied). Chunk i of the 32 x plane_pairs goes to lane i % 32, so
// consecutive lanes copy consecutive pairs of one plane. kPlanePairs > 0
// fixes ``plane_pairs`` at compile time: the loop unrolls and its divisions
// become multiplies.
template <int kPlanePairs, typename Pair>
__device__ __forceinline__ void stage_plane(const Pair* table, Pair* ring, int row,
                                            size_t row_pairs, size_t src_off, int dst_off,
                                            int plane_pairs, int slot, int lane) {
  if (kPlanePairs > 0) plane_pairs = kPlanePairs;
#pragma unroll
  for (int it = 0; it < plane_pairs; ++it) {
    const int i = it * 32 + lane;
    const int ray = i / plane_pairs, off = i - ray * plane_pairs;
    const int src_row = __shfl_sync(kFullMask, row, ray);
    if (src_row >= 0) {
      cp_async<sizeof(Pair)>(ring + ray * slot + dst_off + off,
                             table + static_cast<size_t>(src_row) * row_pairs + src_off + off);
    }
  }
}

// Which ring slot holds which plane of the current rows: the same for every
// lane of the warp (it follows the plan). ``map`` gives each plane its slot
// (2 bits a plane), ``held`` each slot its plane + 1 (8 bits a slot, 0:
// none). A plane is resident when the slot the map names still holds it.
struct Ring {
  uint32_t map, held;
  __device__ int slot(int p) const { return static_cast<int>((map >> (2 * p)) & 3u); }
  __device__ bool has(int p) const {
    return static_cast<int>((held >> (8 * slot(p))) & 0xffu) == p + 1;
  }
  __device__ void put(int p, int f) {
    map = (map & ~(3u << (2 * p))) | (static_cast<uint32_t>(f) << (2 * p));
    held = (held & ~(0xffu << (8 * f))) | (static_cast<uint32_t>(p + 1) << (8 * f));
  }
};

// Stages planes q and q+1 of each lane's row ``row`` for the next sample,
// copying only those the ring lacks, into slots the current sample
// (``busy``, a bit a slot) does not read; then commits one cp.async group
// (empty when both were resident). Returns the two slots.
template <int kPlanePairs, typename Pair>
__device__ __forceinline__ int2 stage_sample(const Pair* table, Pair* ring, Ring* rg,
                                             unsigned busy, int row, size_t row_pairs, int q,
                                             int plane_pairs, int slot, int lane) {
  int f[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = q + j;
    if (rg->has(p)) {
      f[j] = rg->slot(p);
    } else {
      f[j] = __ffs(~busy & ((1u << kRing) - 1u)) - 1;
      rg->put(p, f[j]);
      stage_plane<kPlanePairs>(table, ring, row, row_pairs, static_cast<size_t>(p) * plane_pairs,
                               f[j] * plane_pairs, plane_pairs, slot, lane);
    }
    busy |= 1u << f[j];
  }
  cp_async_commit();
  return make_int2(f[0], f[1]);
}

// the twin's order: z mix per corner, then the hat sum over y, then over x,
// then the trapezoid weight; a hat weight is nonzero for at most two
// corners, so each sum rounds exactly as the twin's does
template <typename Pair>
__device__ __forceinline__ void mix(const Pair* plane0, const Pair* plane1, const float* dq,
                                    const Weights& w, int wy, int wx, float* acc_w,
                                    float* acc_h) {
  float v_w = 0.0f, v_h = 0.0f;
#pragma unroll
  for (int l = 0; l < wx; ++l) {
    float vy_w = 0.0f, vy_h = 0.0f;
#pragma unroll
    for (int k = 0; k < wy; ++k) {
      const float hk = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(w.gy, static_cast<float>(k)))), 0.0f);
      float c0w, c0h, c1w, c1h;
      decode(plane0[k * wx + l], dq, &c0w, &c0h);
      decode(plane1[k * wx + l], dq, &c1w, &c1h);
      const float vz_w = __fadd_rn(__fmul_rn(c0w, w.w0), __fmul_rn(c1w, w.w1));
      const float vz_h = __fadd_rn(__fmul_rn(c0h, w.w0), __fmul_rn(c1h, w.w1));
      vy_w = __fadd_rn(vy_w, __fmul_rn(vz_w, hk));
      vy_h = __fadd_rn(vy_h, __fmul_rn(vz_h, hk));
    }
    const float hl = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(w.gx, static_cast<float>(l)))), 0.0f);
    v_w = __fadd_rn(v_w, __fmul_rn(vy_w, hl));
    v_h = __fadd_rn(v_h, __fmul_rn(vy_h, hl));
  }
  *acc_w = __fadd_rn(*acc_w, __fmul_rn(w.wte, v_w));
  *acc_h = __fadd_rn(*acc_h, __fmul_rn(w.wte, v_h));
}

// kWY, kWX: the window at compile time (0: read from the parameters)
template <typename Row, int kWY, int kWX>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    brick_integrate_kernel(const Params<Row> prm) {
  using Pair = typename PairOf<Row>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = prm.G;
  const int n_slots = prm.n_groups * G;
  int* s_pi = reinterpret_cast<int*>(smem);
  float* s_pf = reinterpret_cast<float*>(s_pi + n_slots * kPlanI);
  int* s_anchor = reinterpret_cast<int*>(s_pf + n_slots * kPlanF);
  for (int i = threadIdx.x; i < n_slots * kPlanI; i += blockDim.x) s_pi[i] = prm.plan_i[i];
  for (int i = threadIdx.x; i < n_slots * kPlanF; i += blockDim.x) s_pf[i] = prm.plan_f[i];
  for (int i = threadIdx.x; i < prm.n_groups; i += blockDim.x) s_anchor[i] = prm.anchor[i];
  __syncthreads();
  float dq[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // [sw, ow, sh, oh] of an int16 table
  if (prm.deq != nullptr) {
    for (int i = 0; i < 4; ++i) dq[i] = prm.deq[i];
  }

  const int wy = kWY > 0 ? kWY : prm.wy;
  const int wx = kWX > 0 ? kWX : prm.wx;
  const int slot = slot_pairs(wy, wx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pair* ring = reinterpret_cast<Pair*>(smem + plan_bytes(prm.n_groups, G)) +
               static_cast<size_t>(warp) * 32 * slot;

  const long long r0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r0 - lane >= prm.n) return;  // the whole warp is past the end
  const bool active = r0 < prm.n;
  // an idle lane of a live warp follows the warp's first ray, copies nothing
  // and stores nothing
  const size_t r = static_cast<size_t>(active ? r0 : r0 - lane);
  const size_t N = static_cast<size_t>(prm.n);
  const float re = prm.re[r];
  const Pair* table = reinterpret_cast<const Pair*>(prm.table);
  const int plane_pairs = wy * wx;
  const size_t row_pairs = static_cast<size_t>(prm.planes) * plane_pairs;
  auto anchor_row = [&](int g, int ay, int ax) {
    return active ? (s_anchor[g] * prm.ny + ay) * prm.nx + ax : -1;
  };

  float acc_w = 0.0f, acc_h = 0.0f;
  int g = 0, s = -1, ay = 0, ax = 0;
  Ring rg{0u, 0u};
  int2 cur = make_int2(0, 1);
  bool have = next_slot(s_pi, prm.n_groups, G, &g, &s);
  if (have) {
    group_anchor(prm, s_pi + g * G * kPlanI, s_pf + g * G * kPlanF, r, N, &ay, &ax);
    cur = stage_sample<kWY * kWX>(table, ring, &rg, 0u, anchor_row(g, ay, ax), row_pairs,
                                  s_pi[(g * G + s) * kPlanI + 3], plane_pairs, slot, lane);
  }
  while (have) {
    int ng = g, ns = s, nay = ay, nax = ax;
    int2 nxt = cur;
    const bool next = next_slot(s_pi, prm.n_groups, G, &ng, &ns);
    if (next) {
      if (ng != g) {  // a new row for every lane: nothing in the ring is resident
        group_anchor(prm, s_pi + ng * G * kPlanI, s_pf + ng * G * kPlanF, r, N, &nay, &nax);
        rg.held = 0u;
      }
      nxt = stage_sample<kWY * kWX>(table, ring, &rg, (1u << cur.x) | (1u << cur.y),
                                    anchor_row(ng, nay, nax), row_pairs,
                                    s_pi[(ng * G + ns) * kPlanI + 3], plane_pairs, slot, lane);
    }
    const int k = g * G + s;
    const Weights w = sample_weights(prm, s_pi + k * kPlanI, s_pf + k * kPlanF, re, r, N, ay, ax,
                                     wy, wx);
    if (next) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();
    const Pair* mine = ring + lane * slot;
    mix(mine + cur.x * plane_pairs, mine + cur.y * plane_pairs, dq, w, wy, wx, &acc_w, &acc_h);
    __syncwarp();  // every lane has read the current slots before they are refilled
    g = ng;
    s = ns;
    ay = nay;
    ax = nax;
    cur = nxt;
    have = next;
  }
  if (active) {
    prm.out[r] = acc_w;
    prm.out[N + r] = acc_h;
  }
}

template <typename Row, int kWY, int kWX>
int launch_instance(const Params<Row>& prm, int threads, size_t smem, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(brick_integrate_kernel<Row, kWY, kWX>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (prm.n + threads - 1) / threads;
  brick_integrate_kernel<Row, kWY, kWX><<<static_cast<unsigned>(blocks), threads, smem,
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
           int z_clip, int threads, long long smem_bytes, void* stream) {
  if (G < 1 || n_groups < 1 || ny < 2 || nx < 2 || wy < 2 || wx < 2 || planes < 2 ||
      planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the launch shape: whole warps within the launch bound, and shared memory
  // for the plan and two slot buffers of 32 rays per warp
  const size_t need = plan_bytes(n_groups, G) + static_cast<size_t>(threads / 32) * 32 *
                                                    slot_pairs(wy, wx) * 2 * sizeof(Row);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < need) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
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
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (wy == 3 && wx == 3) return launch_instance<Row, 3, 3>(prm, threads, smem, stream);
  if (wy == 4 && wx == 4) return launch_instance<Row, 4, 4>(prm, threads, smem, stream);
  return launch_instance<Row, 0, 0>(prm, threads, smem, stream);
}

}  // namespace

extern "C" int brick_integrate_launch(
    const float* table, const float* bnd_y, const float* bnd_x, const float* bnd_z,
    const float* d2, const float* ray_len, const float* re, const int* plan_i,
    const float* plan_f, const int* anchor, const float* y_axis, const float* x_axis,
    float* out, long long n, int n_groups, int G, int planes, int wy, int wx, int ny,
    int nx, float y_lo, float y_hi, float y_step, int y_uniform, float x_lo, float x_hi,
    float x_step, int x_uniform, float z_lo, float z_hi, int z_clip, int threads,
    long long smem_bytes, void* stream) {
  return launch<float>(table, nullptr, bnd_y, bnd_x, bnd_z, d2, ray_len, re, plan_i, plan_f,
                       anchor, y_axis, x_axis, out, n, n_groups, G, planes, wy, wx, ny, nx,
                       y_lo, y_hi, y_step, y_uniform, x_lo, x_hi, x_step, x_uniform, z_lo,
                       z_hi, z_clip, threads, smem_bytes, stream);
}

extern "C" int brick_integrate_i16_launch(
    const short* table, const float* bnd_y, const float* bnd_x, const float* bnd_z,
    const float* d2, const float* ray_len, const float* re, const int* plan_i,
    const float* plan_f, const int* anchor, const float* y_axis, const float* x_axis,
    float* out, const float* deq, long long n, int n_groups, int G, int planes, int wy,
    int wx, int ny, int nx, float y_lo, float y_hi, float y_step, int y_uniform, float x_lo,
    float x_hi, float x_step, int x_uniform, float z_lo, float z_hi, int z_clip, int threads,
    long long smem_bytes, void* stream) {
  if (deq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<short>(table, deq, bnd_y, bnd_x, bnd_z, d2, ray_len, re, plan_i, plan_f,
                       anchor, y_axis, x_axis, out, n, n_groups, G, planes, wy, wx, ny, nx,
                       y_lo, y_hi, y_step, y_uniform, x_lo, x_hi, x_step, x_uniform, z_lo,
                       z_hi, z_clip, threads, smem_bytes, stream);
}
