// Pipelined bf16 weight-cotangent product of kernels 2 and 5 (outer_flat.cu,
// outer_padded.cu) for sm_90a, and the host launch both kernels share.
//
// Both kernels compute, per job (a table entry or slot),
//   out[job.out] = x[job.x] (BSx, R) . g[job.g] (BSg, R)^T      fp32 sums
// and differ only in how a job is found (the Jobs functor each passes).
//
// What bounds it: 2 x BSx x BSg x R operations per live job on 2 x 128 x R
// bf16 operands; at R = 1,536 the tensor cores' bound is 0.124 ms for the
// 2,442 entries of the 40,960-node mask, but each entry's x and g tiles
// must reach its SM from L2 (786 KB an entry, 1.92 GB a launch), so moving
// operands binds. The product before this one gave every entry two 128 x 64
// tiles (x read twice), walked R in 32-column chunks through registers with
// two barriers a chunk and no copy in flight during mma.sync: ~0.98 ms, 12%
// of the bound. This one: 0.25 ms in storage order (0.28 per entry; ~7 TB/s
// from L2, 50% of the bound), against 0.86 ms for torch.bmm on operands
// gathered beforehand; at R = 128, where the writes bind, 0.06 ms (H100
// 80GB HBM3, 700 W; PERF.md).
//
// Design, against that:
// - One thread block per (job, 128 x NT output tile), NT = 128 (64 where
//   BSg % 128 != 0): a 128-square block is one tile, so x and g are read
//   once per entry. The tile index is the fastest grid axis and jobs run in
//   table order, so neighbouring blocks share g[row] in L2.
// - Copies by TMA: x is one 2-D tensor (nbx * BSx, R) and g one (nbg * BSg,
//   R), so a gathered tile is a box coordinate; a producer warp streams
//   64-column (128-byte) R chunks of both into a ring of STAGES stages,
//   one mbarrier per stage, and TMA's zero fill masks the ragged R edge.
//   Where TMA cannot address an operand (R % 8 != 0, or a base not 16-byte
//   aligned) the producer warp copies it by element loads into the same
//   swizzled layout and fences the async proxy.
// - Two consumer warpgroups, 64 output rows each, fp32 accumulators in
//   registers, one wgmma m64nNTk16 per 16 R columns with both operands
//   K-major in the 128-byte swizzle (no transpose bit). A stage goes back
//   to the producer once the wgmmas that read it have completed; the next
//   stage's wgmmas are issued before that wait.
// - Occupancy instead of persistence: three 32 KB stages let two blocks
//   share an SM, so one block's epilogue overlaps the other's loads.
// - No atomics and no split of R: a repeat is bit-identical. A job whose x
//   is a sentinel stores exact zeros without a ring step; every job runs
//   tile_product on the same tiles in the same R order, so kernel 5 equals
//   kernel 2 on as_flat_pallas's tables bit for bit.
//
// fp32 inputs take outer_tile.cuh's FMA product.

#pragma once

#include <limits.h>

#include "hopper_tile.cuh"
#include "outer_tile.cuh"

namespace gwt {
namespace outer {

using bf16 = __nv_bfloat16;

constexpr int KR = 64;                   // R columns a ring step: 128 bytes
constexpr int ROW_BYTES = KR * 2;
constexpr int X_BYTES = MT * ROW_BYTES;  // 16 KB
constexpr int STAGES = 3;
constexpr int CONSUMER_WARPS = wide::CONSUMER_WARPS;
constexpr int THREADS = wide::THREADS;

template <int NT>
struct Tile {
  static_assert(NT == 64 || NT == 128, "NT: 64 or 128");
  static constexpr int G_BYTES = NT * ROW_BYTES;
  static constexpr int STAGE_BYTES = X_BYTES + G_BYTES;
  // 1 KB to align the ring to the swizzle's 1 KB period, the ring, then a
  // full and an empty barrier per stage
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
};

// A consumer thread's share of its warpgroup's 64 x NT fp32 tile, in
// wgmma's accumulator layout (hopper_tile.cuh's wgmma).
template <int NT>
using Acc = float[NT / 2];

struct Operands {
  const CUtensorMap* x;           // (nbx * bs_x, r), 128-row boxes; null:
  const CUtensorMap* g;           // (nbg * bs_g, r), NT-row boxes; element
  const bf16* xp;                 // loads from xp / gp
  const bf16* gp;
  int bs_x, bs_g, r;
};

struct Ring {
  uint8_t* base;                  // 1 KB aligned
  int stage_bytes;
  uint64_t* full;                 // a step has landed in the stage
  uint64_t* empty;                // the consumers are done with the stage
  __device__ uint8_t* x(int s) const { return base + s * stage_bytes; }
  __device__ uint8_t* g(int s) const { return x(s) + X_BYTES; }
};

// Rows [0, n) of `rows` (row pitch r), columns k0 .. k0 + 63 (zero from r
// on), into a box of 128-byte rows in TMA's 128-byte swizzle, by the
// producer warp's element loads.
__device__ __forceinline__ void load_box(uint8_t* dst, const bf16* rows,
                                         int n, int k0, int r) {
  for (int u = threadIdx.x % 32; u < n * 8; u += 32) {
    const int row = u / 8, cu = u % 8;
    const int col = k0 + 8 * cu;
    union {
      uint4 v;
      bf16 h[8];
    } t;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      t.h[e] = col + e < r ? rows[(size_t)row * r + col + e]
                           : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(dst + wide::swz(row, cu)) = t.v;
  }
}

// The producer warp: `steps` ring steps of x rows xr0 .. +127 and g rows
// gr0 .. +NT-1, 64 R columns each.
template <int NT>
__device__ void produce(const Ring& ring, const Operands& op, int xr0,
                        int gr0, int steps) {
  const int lane = threadIdx.x % 32;
  wide::Cursor cur;
  for (int s = 0; s < steps; ++s) {
    const int k0 = s * KR;
    uint64_t* full = ring.full + cur.stage;
    uint8_t* xs = ring.x(cur.stage);
    uint8_t* gs = ring.g(cur.stage);
    wide::bar_wait(ring.empty + cur.stage, cur.parity ^ 1);
    if (op.x == nullptr)
      load_box(xs, op.xp + (size_t)xr0 * op.r, MT, k0, op.r);
    if (op.g == nullptr)
      load_box(gs, op.gp + (size_t)gr0 * op.r, NT, k0, op.r);
    if (op.x == nullptr || op.g == nullptr) {
      // generic writes that wgmma reads through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
    }
    if (lane == 0) {
      wide::bar_arrive_tx(full, (op.x ? X_BYTES : 0) +
                                    (op.g ? Tile<NT>::G_BYTES : 0));
      if (op.x != nullptr) wide::tma_load(xs, op.x, k0, xr0, full);
      if (op.g != nullptr) wide::tma_load(gs, op.g, k0, gr0, full);
    }
    __syncwarp();
    cur.next<STAGES>();
  }
}

// A consumer warpgroup: `steps` ring steps into its 64 x rows by NT, one
// wgmma m64nNTk16 per 16 R columns, both operands K-major.
template <int NT>
__device__ void consume(const Ring& ring, int steps, Acc<NT>& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  wide::Cursor cur;
  int held = -1;                  // the stage the last wgmmas read
  for (int s = 0; s < steps; ++s) {
    wide::bar_wait(ring.full + cur.stage, cur.parity);
    // this warpgroup's 64 x rows: 64 rows of 128 bytes into the x box
    const uint32_t xa = smem_addr(ring.x(cur.stage)) + wg * 64 * ROW_BYTES;
    const uint32_t ga = smem_addr(ring.g(cur.stage));
    wide::fence_regs(acc);
    wide::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk)   // 32 bytes along K-major rows
      wide::wgmma<0, 0>(acc, wide::gmma_desc(xa + kk * 32, 16, 1024),
                        wide::gmma_desc(ga + kk * 32, 16, 1024));
    wide::wgmma_commit();
    wide::wgmma_wait<1>();        // the previous step's wgmmas are done
    wide::fence_regs(acc);
    if (held >= 0 && lane == 0) wide::bar_arrive(ring.empty + held);
    held = cur.stage;
    cur.next<STAGES>();
  }
  wide::wgmma_wait<0>();
  wide::fence_regs(acc);
}

// The tile (m0, n0) of one job's output block into acc: zeros where job.x
// < 0, else the ring's product over R. Returns false on the producer warp,
// which holds no part of the tile. Every thread of the block must call it.
template <int NT>
__device__ bool tile_product(Acc<NT>& acc, const Operands& op, const Job& job,
                             int m0, int n0) {
  const bool producer = threadIdx.x >= 32 * CONSUMER_WARPS;
  if (!producer) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  }
  if (job.x < 0) return !producer;   // the same for every thread
  Ring ring;
  ring.stage_bytes = Tile<NT>::STAGE_BYTES;
  ring.base = wide::setup_ring(STAGES, ring.stage_bytes, ring.full,
                               ring.empty);
  const int steps = (op.r + KR - 1) / KR;
  if (producer) {
    produce<NT>(ring, op, job.x * op.bs_x + m0, job.g * op.bs_g + n0, steps);
    return false;
  }
  consume<NT>(ring, steps, acc);
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The consumers' tile into out (row pitch ld) from (m0, n0), cast once to
// O. In the accumulator layout the four lanes of a quad hold a row's 8
// columns of an 8-column group, two each: 32 bytes in fp32, a whole sector,
// stored as is. In bf16 that is 16 bytes, so the quad first trades the
// halves of two neighbouring groups: each lane then stores 4 columns (8
// bytes) and every warp store still writes whole 32-byte sectors, half as
// many stores as pairs would take. ld and n0 are multiples of 64.
template <int NT>
__device__ __forceinline__ void store_block(const Acc<NT>& acc,
                                            float* __restrict__ out, int ld,
                                            int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < NT / 8; ++nt) {
    const int col = n0 + 8 * nt + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * h;
      *reinterpret_cast<float2*>(out + (size_t)row * ld + col) =
          make_float2(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void store_block(const Acc<NT>& acc,
                                            bf16* __restrict__ out, int ld,
                                            int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % 4;
  // lane q takes columns 4q .. 4q + 3 of the groups' 16: lanes 2q and
  // 2q + 1 (mod 4) of its quad hold them, in group nt for q < 2, else nt + 1
  const int s0 = (lane & ~3) | ((2 * q) & 3);
#pragma unroll
  for (int nt = 0; nt < NT / 8; nt += 2) {
    const int col = n0 + 8 * nt + 4 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * h;
      const uint32_t e = pack_bf16(acc[4 * nt + 2 * h],
                                   acc[4 * nt + 2 * h + 1]);
      const uint32_t o = pack_bf16(acc[4 * nt + 4 + 2 * h],
                                   acc[4 * nt + 4 + 2 * h + 1]);
      const uint32_t e0 = __shfl_sync(0xffffffffu, e, s0);
      const uint32_t e1 = __shfl_sync(0xffffffffu, e, s0 + 1);
      const uint32_t o0 = __shfl_sync(0xffffffffu, o, s0);
      const uint32_t o1 = __shfl_sync(0xffffffffu, o, s0 + 1);
      *reinterpret_cast<uint2*>(out + (size_t)row * ld + col) =
          q < 2 ? make_uint2(e0, e1) : make_uint2(o0, o1);
    }
  }
}

// One block per (job, 128 x NT output tile), the tile index fastest.
template <int NT, typename O, class Jobs>
__global__ void __launch_bounds__(THREADS, 2)
outer_bf16(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_g, int x_tma, int g_tma,
           const bf16* __restrict__ xp, const bf16* __restrict__ gp,
           O* __restrict__ out, Jobs jobs, int bs_x, int bs_g, int r) {
  const int tiles_n = bs_g / NT;
  const int tiles = tiles_n * (bs_x / MT);
  const int t = blockIdx.x % tiles;
  const Job job = jobs(blockIdx.x / tiles);
  if (job.out < 0) return;        // the same for every thread
  const int m0 = (t / tiles_n) * MT, n0 = (t % tiles_n) * NT;
  const Operands op{x_tma ? &tm_x : nullptr, g_tma ? &tm_g : nullptr, xp, gp,
                    bs_x, bs_g, r};
  Acc<NT> acc;
  if (!tile_product<NT>(acc, op, job, m0, n0)) return;
  store_block<NT>(acc, out + (size_t)job.out * bs_x * bs_g, bs_g, m0, n0);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int NT, typename O, class Jobs>
int launch_bf16(const void* x, const void* g, void* out, Jobs jobs,
                long long blocks, int nbx, int nbg, int bs_x, int bs_g, int r,
                cudaStream_t stream) {
  CUtensorMap tm_x, tm_g;
  const bool x_tma = wide::encode_rows(&tm_x, x, (uint64_t)nbx * bs_x, r, MT);
  const bool g_tma = wide::encode_rows(&tm_g, g, (uint64_t)nbg * bs_g, r, NT);
  if (cudaError_t e = cudaFuncSetAttribute(
          outer_bf16<NT, O, Jobs>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<NT>::SMEM))
    return static_cast<int>(e);
  outer_bf16<NT, O, Jobs>
      <<<static_cast<unsigned>(blocks), THREADS, Tile<NT>::SMEM, stream>>>(
          tm_x, tm_g, x_tma, g_tma, static_cast<const bf16*>(x),
          static_cast<const bf16*>(g), static_cast<O*>(out), jobs, bs_x,
          bs_g, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename O, class Jobs>
int launch_as(int dtype, const void* x, const void* g, void* out, Jobs jobs,
              int n_jobs, int nbx, int nbg, int bs_x, int bs_g, int r,
              cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid(n_jobs, bs_g / NT, bs_x / MT);
    outer_f32<O, Jobs><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<O*>(out), jobs, bs_x, bs_g, r);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = bs_g % 128 == 0 ? 128 : 64;
  const long long blocks = (long long)n_jobs * (bs_x / MT) * (bs_g / nt);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (nt == 128)
    return launch_bf16<128, O>(x, g, out, jobs, blocks, nbx, nbg, bs_x, bs_g,
                               r, stream);
  return launch_bf16<64, O>(x, g, out, jobs, blocks, nbx, nbg, bs_x, bs_g, r,
                            stream);
}

// Kernel 2's or 5's launch over n_jobs jobs: dtype 0 = float32 x and g (the
// FMA product), 1 = bfloat16 (this product); out_dtype likewise for out.
// x (nbx * bs_x, r) and g (nbg * bs_g, r) row-major; bs_x % 128 == 0,
// bs_g % 64 == 0, n_jobs >= 1, r >= 1. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
template <class Jobs>
int launch(int dtype, int out_dtype, const void* x, const void* g, void* out,
           Jobs jobs, int n_jobs, int nbx, int nbg, int bs_x, int bs_g, int r,
           cudaStream_t stream) {
  if (bs_x % MT || bs_g % 64 || n_jobs < 1 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 0)
    return launch_as<float>(dtype, x, g, out, jobs, n_jobs, nbx, nbg, bs_x,
                            bs_g, r, stream);
  if (out_dtype == 1)
    return launch_as<bf16>(dtype, x, g, out, jobs, n_jobs, nbx, nbg, bs_x,
                           bs_g, r, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace outer
}  // namespace gwt
