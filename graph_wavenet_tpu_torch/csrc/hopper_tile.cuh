// Pipelined wide-tile bf16 block product of the mix kernels 1, 3 and 4
// (mix_flat.cu, mix_flat2.cu, mix_padded.cu) for sm_90a.
//
// One thread block owns an output tile of OT = 128 destination rows by CT
// columns of R (CT = 64, 128 or 256: ops/cuda/block_diffusion.py's
// tile_cols picks it from R, by one rule for all three kernels) and walks
// the live entries of its destination row in list order as one stream of
// (entry, KC = 64 contracted rows) steps.
//
// What bounds it: a step is 2 x 128 x 64 x CT operations on 16 KB of block
// and 128 x CT bytes of x, so at the city shapes the tensor cores bind
// (kernel 1 at R = 3,072: 0.24 TFLOP, a 0.247 ms bound). The product before
// this one staged 32-row chunks of a 64-column tile through registers, two
// barriers a chunk and no copy in flight during compute, and read each
// block 48 times at R = 3,072: it waited on memory latency, at 10% of the
// bound (2.486 ms). This one takes 0.504 ms, 49% (H100 80GB HBM3, 700 W;
// PERF.md). At 256 columns one block fills an SM, so every wave pays its
// ring's fill and its epilogue with nothing to overlap them.
//
// Design, against that:
// - Copies by TMA into a ring of STAGES stages in dynamic shared memory,
//   each signalled by an mbarrier. One producer warp issues them: the blocks
//   are one 2-D tensor (n_blocks * bs_a, bs_b) and x one (nbx * bs_c, R), so
//   a gathered chunk is a box coordinate, and TMA's zero fill masks the
//   ragged R edge. The next steps are in flight while one computes, across
//   entry boundaries. Where TMA cannot address x (R % 8 != 0, or x not
//   16-byte aligned) the producer warp copies it with element loads into
//   the same layout.
// - Wide tiles: CT = 256 reads each block 12 times at R = 3,072; small R
//   takes a narrow tile, since there reading the blocks binds. The kernels
//   put the R tile on the fastest grid axis, so the tiles of one row run
//   together and share its blocks in L2.
// - Tensor cores by wgmma: two consumer warpgroups, 64 output rows each,
//   fp32 accumulators in registers, one m64nCTk16 per 16-row slice. Both
//   operands are read from shared memory in TMA's 128-byte swizzle: the
//   block chunk M-major in the forward (blk[k][o]) and K-major for dx
//   (blk[o][k]), x N-major. A stage goes back to the producer once the
//   wgmmas that read it have completed; the next stage's wgmmas are issued
//   before that wait. Its outputs have measured bit for bit equal to those
//   of the mma.sync product before it (PERF.md).
//
// Kernels 1, 3 and 4 all run tile_product on tiles of the same shape for
// the same R, so each output element sees the same chain of operations in
// all three: kernel 3 equals two kernel-1 launches and kernel 4 equals
// kernel 1 on as_flat_pallas's tables, bit for bit. The barrier, TMA,
// swizzle and wgmma pieces below also build hopper_outer.cuh's product
// (kernels 2 and 5).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "block_tile.cuh"

namespace gwt {
namespace wide {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;                 // contracted rows per step
constexpr int BOX = 64;                // columns of one 128-byte swizzled box
constexpr int BOX_BYTES = 64 * 128;    // a box of 64 such rows
constexpr int A_BYTES = OT * KC * 2;   // one block chunk: 16 KB
constexpr int CONSUMER_WARPS = 8;      // two warpgroups of 64 output rows
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;   // and a producer warp

template <int CT>
struct Tile {
  static_assert(CT == 64 || CT == 128 || CT == 256, "CT: 64, 128 or 256");
  static constexpr int NB = CT / BOX;                 // x boxes per step
  static constexpr int X_BYTES = NB * BOX_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + X_BYTES;
  static constexpr int STAGES = CT == 128 ? 3 : 4;
  static constexpr int MIN_BLOCKS = CT == 256 ? 1 : 2;
  // 1 KB to align the ring to the swizzle's 1 KB period, the ring, then a
  // full and an empty barrier per stage
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
};

// A consumer thread's share of its warpgroup's 64 x CT fp32 tile, in
// wgmma's accumulator layout (see wgmma below).
template <int CT>
using WideAcc = float[CT / 2];

// ---------------------------------------------------------------------------
// barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(b)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait of ~17 s is a
// fault (a copy that never lands), not a wait: it traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_addr(b);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// Box (c, r) of the 2-D tensor map into shared memory at dst; completion
// counts its bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c),
         "r"(r), "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of 16-byte unit `chunk` of row `row` in a box of 128-byte
// rows written by TMA's 128-byte swizzle (from a 1 KB-aligned base).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// A wgmma shared-memory descriptor in the 128-byte swizzle. MN-major
// operands: lbo is the stride between 64-element swizzle atoms along M or N
// (one box), sbo the stride between 8-row groups along K (1 KB). K-major:
// lbo is unused (16), sbo the stride between 8-row groups along M.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x N, fp32) += A (64 x 16) B (16 x N), N = 2 x the floats in d: one
// wgmma m64nNk16. A is M-major when kTransA, else K-major; B N-major when
// kTransB, else K-major. d[i] is row 16 w + lane / 4 + 8 ((i % 4) / 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2 of the 64 x N tile (w: the warp
// in the warpgroup).
template <int kTransA, int kTransB = 1>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA),
        "n"(kTransB));
}

template <int kTransA, int kTransB = 1>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA),
        "n"(kTransB));
}

template <int kTransA, int kTransB = 1>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p, 1, 1, %131, %132;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA),
        "n"(kTransB));
}

// Keeps the compiler from moving accumulator accesses across wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the ring and its two roles
// ---------------------------------------------------------------------------

// A ring of `stages` stages of `stage_bytes` in dynamic shared memory from
// its first 1 KB boundary (the swizzle's period), then a full and an empty
// barrier per stage, set up by thread 0: full takes the producer's one
// arrival (with its bytes), empty one arrival per consumer warp. Returns the
// ring's base. Ends in a block barrier: every thread must call it.
__device__ __forceinline__ uint8_t* setup_ring(int stages, int stage_bytes,
                                               uint64_t*& full,
                                               uint64_t*& empty) {
  extern __shared__ uint8_t ring_smem[];
  uint8_t* base = ring_smem + ((1024 - (smem_addr(ring_smem) & 1023)) & 1023);
  full = reinterpret_cast<uint64_t*>(base + stages * stage_bytes);
  empty = full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return base;
}

template <int CT>
struct Ring {
  uint8_t* base;                  // 1 KB aligned
  uint64_t* full;                 // a step has landed in the stage
  uint64_t* empty;                // the consumers are done with the stage
  __device__ uint8_t* a(int s) const {
    return base + s * Tile<CT>::STAGE_BYTES;
  }
  __device__ uint8_t* x(int s) const { return a(s) + A_BYTES; }
};

struct Cursor {                   // a stage index and its phase parity
  int stage = 0;
  uint32_t parity = 0;
  template <int S>
  __device__ void next() {
    if (++stage == S) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// Where one stream's operands come from.
struct Operands {
  const CUtensorMap* a;           // the blocks, (n_blocks * bs_a, bs_b)
  const CUtensorMap* x;           // x, (nbx * bs_c, r); null: element loads
  const bf16* xp;                 // x, for element loads
  int bs_a, bs_c, r;
  int o0, c0;                     // the output tile's first row and column
  bool fwd;                       // A[o][k] = blk[k][o] (transpose_lhs)
};

struct AnyEntry {                 // kernels 1 and 3: every entry is live
  __device__ bool operator()(int, int) const { return true; }
};

struct NoWait {
  __device__ void operator()(int) const {}
};

// x rows [0, KC) of `rows` (row pitch r), columns c0 .. c0 + CT - 1 (zero
// from r on), into the stage's swizzled boxes by the producer warp's
// element loads. kL2: through L2 only (ld.global.cg).
template <int CT, bool kL2>
__device__ __forceinline__ void load_x_chunk(uint8_t* xs, const bf16* rows,
                                             int c0, int r) {
  constexpr int UNITS = CT / 8;   // 16-byte units a row
  for (int u = threadIdx.x % 32; u < KC * UNITS; u += 32) {
    const int k = u / UNITS, cu = u % UNITS;
    const int col = c0 + 8 * cu;
    union {
      uint4 v;
      bf16 h[8];
    } t;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      t.h[e] = col + e < r ? load1<kL2>(rows + (size_t)k * r + col + e)
                           : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(xs + (cu / 8) * BOX_BYTES + swz(k, cu % 8)) =
        t.v;
  }
}

// The producer warp: for each live entry in [begin, end), wait(src) on lane
// 0 (kernel 3's hop 2 waits for the source row there), then one ring step
// per KC contracted rows.
template <int CT, bool kL2, class Live, class Wait>
__device__ void produce(const Ring<CT>& ring, const Operands& op,
                        const int* slot, const int* src, int begin, int end,
                        Live live, Wait wait) {
  const int lane = threadIdx.x % 32;
  Cursor cur;
  for (int l = begin; l < end; ++l) {
    const int k = slot[l], s = src[l];
    if (!live(k, s)) continue;
    if (lane == 0) wait(s);
    __syncwarp();
    for (int k0 = 0; k0 < op.bs_c; k0 += KC) {
      uint64_t* full = ring.full + cur.stage;
      uint8_t* as = ring.a(cur.stage);
      uint8_t* xs = ring.x(cur.stage);
      bar_wait(ring.empty + cur.stage, cur.parity ^ 1);
      if (op.x == nullptr) {
        load_x_chunk<CT, kL2>(xs, op.xp + ((size_t)s * op.bs_c + k0) * op.r,
                              op.c0, op.r);
        // generic writes that wgmma reads through the async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
      }
      if (lane == 0) {
        bar_arrive_tx(full, A_BYTES + (op.x ? Tile<CT>::X_BYTES : 0));
        if (op.fwd) {             // two 64 x 64 boxes: k rows, o columns
          tma_load(as, op.a, op.o0, k * op.bs_a + k0, full);
          tma_load(as + BOX_BYTES, op.a, op.o0 + BOX, k * op.bs_a + k0, full);
        } else {                  // one 128 x 64 box: o rows, k columns
          tma_load(as, op.a, k0, k * op.bs_a + op.o0, full);
        }
        if (op.x != nullptr)
#pragma unroll
          for (int b = 0; b < Tile<CT>::NB; ++b)
            tma_load(xs + b * BOX_BYTES, op.x, op.c0 + b * BOX,
                     s * op.bs_c + k0, full);
      }
      __syncwarp();
      cur.next<Tile<CT>::STAGES>();
    }
  }
}

// A consumer warpgroup: `steps` ring steps into its 64 rows x CT, one
// wgmma m64nCTk16 per 16 contracted rows.
template <int CT, bool kFwd>
__device__ void consume(const Ring<CT>& ring, int steps, WideAcc<CT>& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;
  Cursor cur;
  int held = -1;                  // the stage the last wgmmas read
  for (int s = 0; s < steps; ++s) {
    bar_wait(ring.full + cur.stage, cur.parity);
    // this warpgroup's 64 block rows: box g (forward) or rows 64 g .. (dx)
    const uint32_t a = smem_addr(ring.a(cur.stage)) + g * BOX_BYTES;
    const uint32_t x = smem_addr(ring.x(cur.stage));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // 16 contracted rows: two 8-row groups (2 KB) of an MN-major box, or
      // 32 bytes along a K-major row
      const uint64_t da = kFwd ? gmma_desc(a + kk * 2048, BOX_BYTES, 1024)
                               : gmma_desc(a + kk * 32, 16, 1024);
      wgmma<kFwd ? 1 : 0>(acc, da,
                          gmma_desc(x + kk * 2048, BOX_BYTES, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();              // the previous step's wgmmas are done
    fence_regs(acc);
    if (held >= 0 && lane == 0) bar_arrive(ring.empty + held);
    held = cur.stage;
    cur.next<Tile<CT>::STAGES>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// The output tile of one destination row: sets up the ring, runs the
// producer warp on the live entries of [begin, end) and the consumer warps
// on as many steps. Returns false on the producer warp, which holds no part
// of the tile. Every thread of the block must call it.
template <int CT, bool kL2, class Live, class Wait>
__device__ bool tile_product(WideAcc<CT>& acc, const Operands& op,
                             const int* slot, const int* src, int begin,
                             int end, Live live, Wait wait) {
  Ring<CT> ring;
  ring.base = setup_ring(Tile<CT>::STAGES, Tile<CT>::STAGE_BYTES, ring.full,
                         ring.empty);
  if (threadIdx.x >= 32 * CONSUMER_WARPS) {
    produce<CT, kL2>(ring, op, slot, src, begin, end, live, wait);
    return false;
  }
#pragma unroll
  for (int i = 0; i < CT / 2; ++i) acc[i] = 0.f;
  int n = 0;
  for (int l = begin; l < end; ++l) n += live(slot[l], src[l]) ? 1 : 0;
  const int steps = n * (op.bs_c / KC);
  if (op.fwd)
    consume<CT, true>(ring, steps, acc);
  else
    consume<CT, false>(ring, steps, acc);
  return true;
}

// Barrier of the 256 consumer threads only (the producer warp may be gone).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(32 * CONSUMER_WARPS) : "memory");
}

// Casts the consumers' tile once and stores it at out (bs_o, r) row-major
// from (o0, c0), columns < r only. add (optional, same layout, never out)
// is added after the cast, in bf16: the cast value and add summed in fp32
// and rounded once, as block_tile.cuh's store_tile. Without __restrict__
// every load of add would wait for the stores before it. Pairs of columns
// move as one 4-byte access where r is even and the base is 4-byte aligned
// (add may be a view at an odd element offset).
template <int CT>
__device__ __forceinline__ void store_wide(const WideAcc<CT>& acc,
                                           bf16* __restrict__ out,
                                           const bf16* __restrict__ add,
                                           int o0, int c0, int r) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool pairs = r % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const bool add_pairs =
      r % 2 == 0 && reinterpret_cast<uintptr_t>(add) % 4 == 0;
#pragma unroll
  for (int nt = 0; nt < CT / 8; ++nt) {
    const int c = c0 + 8 * nt + 2 * (lane % 4);
    if (c >= r) continue;
    const bool both = c + 1 < r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = o0 + 16 * warp + lane / 4 + 8 * h;
      const size_t at = (size_t)row * r + c;
      bf16 v0 = __float2bfloat16_rn(acc[4 * nt + 2 * h]);
      bf16 v1 = __float2bfloat16_rn(acc[4 * nt + 2 * h + 1]);
      if (add != nullptr) {
        __nv_bfloat162 a;
        if (both && add_pairs) {
          a = *reinterpret_cast<const __nv_bfloat162*>(add + at);
        } else {
          a.x = add[at];
          a.y = both ? add[at + 1] : a.x;
        }
        v0 = __float2bfloat16_rn(__bfloat162float(v0) +
                                 __bfloat162float(a.x));
        v1 = __float2bfloat16_rn(__bfloat162float(v1) +
                                 __bfloat162float(a.y));
      }
      if (both && pairs) {
        __nv_bfloat162 v;
        v.x = v0;
        v.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(out + at) = v;
      } else {
        out[at] = v0;
        if (both) out[at + 1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// the library needs no -lcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A tensor map of a (rows, cols) row-major bf16 tensor in boxes of 64
// columns x box_rows rows, 128-byte swizzle, zero fill outside. False where
// TMA cannot address it (row pitch or base not a multiple of 16 bytes) or
// the driver refuses; the map is then zeroed.
inline bool encode_rows(CUtensorMap* map, const void* base, uint64_t rows,
                        uint64_t cols, uint32_t box_rows) {
  memset(map, 0, sizeof(*map));
  const EncodeTiled fn = encoder();
  if (fn == nullptr || cols % 8 || reinterpret_cast<uintptr_t>(base) % 16)
    return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {BOX, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The blocks' map for one orientation: forward chunks are two 64-row boxes
// (k rows, o columns), dx chunks one 128-row box (o rows, k columns).
inline bool encode_blocks(CUtensorMap* map, const void* blocks, int n_blocks,
                          int bs_a, int bs_b, bool fwd) {
  return encode_rows(map, blocks, (uint64_t)n_blocks * bs_a, bs_b,
                     fwd ? KC : OT);
}

// f(std::integral_constant<int, ct>{}) for a tile width the product
// builds; cudaErrorInvalidValue for any other.
template <class F>
inline int with_ct(int ct, F f) {
  switch (ct) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Lets `kernel` take CT's dynamic shared memory; 0 or a cudaError_t.
template <int CT, class Kernel>
inline int allow_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<CT>::SMEM));
}

}  // namespace wide
}  // namespace gwt
