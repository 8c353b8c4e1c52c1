// Shared tile product of the block-sparse weight cotangents
// (outer_flat.cu, outer_padded.cu).
//
// One thread block of 256 threads owns an output tile of MT = 128 x rows by
// NT = 64 g rows and accumulates x_tile (MT, R) . g_tile (NT, R)^T over R
// in fp32 registers, 32 values a thread, in block_tile.cuh's accumulator
// layout. R is walked in chunks of KR = 32 in a fixed order, so a repeat is
// bit-identical; ragged R is masked (no pad-to-128 copy). Two products,
// chosen by the element type:
//
// - float: plain fp32 FMAs (the fp32 result is held to 1e-5). Both chunks
//   are stored k-major in shared memory, as entry_product's block chunk.
// - bfloat16: mma.sync m16n8k16 with fp32 accumulation. Both operands are
//   R-contiguous rows (K-major), which is what mma.sync wants: x is the
//   row-major M x K operand, g the column-major K x N one, so plain
//   (non-transposed) ldmatrix builds both fragments.

#pragma once

#include "block_tile.cuh"

namespace gwt {

constexpr int MT = OT;            // x rows (output rows) per tile: 128
constexpr int NT = CT;            // g rows (output columns) per tile: 64
constexpr int KR = 32;            // R columns per staged chunk

struct SmemOuterF32 {             // k-major, as entry_product's sm.a; +4
  float x[KR][MT + 4];            // keeps rows 16-byte aligned and spreads
  float g[KR][NT + 4];            // the transposing stores over banks
};

struct SmemOuterBf16 {
  __nv_bfloat16 x[MT][KR + PAD16];   // rows m, k contiguous
  __nv_bfloat16 g[NT][KR + PAD16];   // rows n, k contiguous
};

// fp32: thread (ty, tx) of a 16 x 16 grid owns output rows 8 ty + i and
// columns 4 tx + j (block_tile.cuh's float tile_coord). xs and gs point at
// the tiles' first rows, each row r elements long.
__device__ __forceinline__ void outer_tile(Acc& acc, SmemOuterF32& sm,
                                           const float* xs, const float* gs,
                                           int r) {
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  constexpr int NX = KR * MT / NTHREADS;   // 16 x elements a thread
  constexpr int NG = KR * NT / NTHREADS;   // 8 g elements a thread
  // element i = tid + u * NTHREADS of a chunk: row i / KR, column i % KR,
  // so a warp reads 32 consecutive R values of one row
  const int col = tid % KR;
  for (int k0 = 0; k0 < r; k0 += KR) {
    const bool in = k0 + col < r;
    float xv[NX], gv[NG];
#pragma unroll
    for (int u = 0; u < NX; ++u) {
      const int m = (tid + u * NTHREADS) / KR;
      xv[u] = in ? xs[(size_t)m * r + k0 + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int n = (tid + u * NTHREADS) / KR;
      gv[u] = in ? gs[(size_t)n * r + k0 + col] : 0.f;
    }
    __syncthreads();              // the previous chunk has been consumed
#pragma unroll
    for (int u = 0; u < NX; ++u)
      sm.x[col][(tid + u * NTHREADS) / KR] = xv[u];
#pragma unroll
    for (int u = 0; u < NG; ++u)
      sm.g[col][(tid + u * NTHREADS) / KR] = gv[u];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KR; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.x[k][RPT * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.x[k][RPT * ty + 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&sm.g[k][CPT * tx]);
      const float ar[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[CPT] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
    }
  }
}

// Eight bf16 values of one row from column c on, zero past r.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int c, int r,
                                       bool vec) {
  union {
    uint4 v;
    __nv_bfloat16 h[8];
  } u;
  if (vec && c + 8 <= r) {
    u.v = *reinterpret_cast<const uint4*>(p + c);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      u.h[e] = c + e < r ? p[c + e] : __float2bfloat16_rn(0.f);
  }
  return u.v;
}

// bf16: warp w owns output rows 32 (w % 4) .. +31 and columns 32 (w / 4) ..
// +31 (block_tile.cuh's bf16 tile_coord).
__device__ __forceinline__ void outer_tile(Acc& acc, SmemOuterBf16& sm,
                                           const __nv_bfloat16* xs,
                                           const __nv_bfloat16* gs, int r) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = 32 * (warp % 4), wn = 32 * (warp / 4);
  const int q = lane / 8, l8 = lane % 8;
  // 16 bytes a load: row tid / 4 (+64 for the second x load), columns
  // 8 (tid % 4) .. +7 of the chunk
  const int lr = tid / 4, lc = 8 * (tid % 4);
  const bool vec = (r % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(xs) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(gs) % 16 == 0);
  for (int k0 = 0; k0 < r; k0 += KR) {
    const uint4 x0 = load8(xs + (size_t)lr * r, k0 + lc, r, vec);
    const uint4 x1 = load8(xs + (size_t)(lr + 64) * r, k0 + lc, r, vec);
    const uint4 g0 = load8(gs + (size_t)lr * r, k0 + lc, r, vec);
    __syncthreads();              // the previous chunk has been consumed
    *reinterpret_cast<uint4*>(&sm.x[lr][lc]) = x0;
    *reinterpret_cast<uint4*>(&sm.x[lr + 64][lc]) = x1;
    *reinterpret_cast<uint4*>(&sm.g[lr][lc]) = g0;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KR; kk += 16) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)  // (m +0/+8, k +0/+8)
        ldsm_x4(a[mt], &sm.x[wm + 16 * mt + 8 * (q % 2) + l8]
                            [kk + 8 * (q / 2)]);
#pragma unroll
      for (int np = 0; np < 2; ++np)  // n tiles 2np, 2np+1: (k +0/+8, n +0/+8)
        ldsm_x4(b[np], &sm.g[wn + 16 * np + 8 * (q / 2) + l8]
                            [kk + 8 * (q % 2)]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[4 * mt + nt], a[mt], b[nt / 2][2 * (nt % 2)],
                   b[nt / 2][2 * (nt % 2) + 1]);
    }
  }
}

template <typename T> struct SmemOuterOf;
template <> struct SmemOuterOf<float> { using type = SmemOuterF32; };
template <> struct SmemOuterOf<__nv_bfloat16> { using type = SmemOuterBf16; };

// Stores the tile at o (row stride ld) from (m0, n0), cast once to O. T is
// the input type: it decides the accumulator layout.
template <typename T, typename O>
__device__ __forceinline__ void store_outer(const Acc& acc, O* o, int ld,
                                            int m0, int n0) {
#pragma unroll
  for (int i = 0; i < ACC_I; ++i) {
#pragma unroll
    for (int j = 0; j < ACC_J; ++j) {
      int m, n;
      tile_coord(static_cast<T*>(nullptr), i, j, m, n);
      o[(size_t)(m0 + m) * ld + n0 + n] = from_f<O>(acc[i][j]);
    }
  }
}

}  // namespace gwt
