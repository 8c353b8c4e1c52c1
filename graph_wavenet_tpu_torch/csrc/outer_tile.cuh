// fp32 tile product of the block-sparse weight cotangents (kernels 2 and 5,
// outer_flat.cu and outer_padded.cu), and the job each thread block of
// either product takes. The bf16 product is hopper_outer.cuh's.
//
// One thread block of 256 threads owns an output tile of MT = 128 x rows by
// NT = 64 g rows and accumulates x_tile (MT, R) . g_tile (NT, R)^T over R
// in fp32 registers, 32 values a thread, with plain FMAs (the fp32 result
// is held to 1e-5). R is walked in chunks of KR = 32 in a fixed order, so a
// repeat is bit-identical; ragged R is masked (no pad-to-128 copy). Both
// chunks are stored k-major in shared memory, as entry_product's block
// chunk.

#pragma once

#include "block_tile.cuh"

namespace gwt {

constexpr int MT = OT;            // x rows (output rows) per tile: 128
constexpr int NT = CT;            // g rows (output columns) per fp32 tile: 64
constexpr int KR = 32;            // R columns per staged chunk

// What one thread block of a weight-cotangent kernel computes: the x and g
// block-rows it contracts and the output block its tile goes to. x < 0:
// the tile is exact zeros and reads nothing; out < 0: the block does
// nothing.
struct Job {
  int x, g, out;
};

struct SmemOuterF32 {             // k-major, as entry_product's sm.a; +4
  float x[KR][MT + 4];            // keeps rows 16-byte aligned and spreads
  float g[KR][NT + 4];            // the transposing stores over banks
};

// Thread (ty, tx) of a 16 x 16 grid owns output rows 8 ty + i and columns
// 4 tx + j (block_tile.cuh's tile_coord). xs and gs point at the tiles'
// first rows, each row r elements long.
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

// grid (job, bs_g / 64, bs_x / 128): fp32 x (nbx * bs_x, r) and g (nbg *
// bs_g, r) row-major, out (.., bs_x, bs_g) cast once to O. The product
// needs ~126 of the 128 registers that two blocks an SM leave a thread, so
// the three pointers are formed before it and the tile's origin is read
// from blockIdx again after it.
template <typename O, class Jobs>
__global__ void __launch_bounds__(NTHREADS, 2)
outer_f32(const float* __restrict__ x, const float* __restrict__ g,
          O* __restrict__ out, Jobs jobs, int bs_x, int bs_g, int r) {
  __shared__ __align__(16) SmemOuterF32 sm;
  const Job job = jobs(blockIdx.x);
  if (job.out < 0) return;        // the same for every thread
  const float* xs =
      x + ((size_t)(job.x < 0 ? 0 : job.x) * bs_x + blockIdx.z * MT) * r;
  const float* gs = g + ((size_t)job.g * bs_g + blockIdx.y * NT) * r;
  O* o = out + (size_t)job.out * bs_x * bs_g;
  Acc acc;
  zero_acc(acc);
  if (job.x >= 0) outer_tile(acc, sm, xs, gs, r);
  const int m0 = blockIdx.z * MT, n0 = blockIdx.y * NT;
#pragma unroll
  for (int i = 0; i < ACC_I; ++i) {
#pragma unroll
    for (int j = 0; j < ACC_J; ++j) {
      int m, n;
      tile_coord(static_cast<float*>(nullptr), i, j, m, n);
      o[(size_t)(m0 + m) * bs_g + n0 + n] = from_f<O>(acc[i][j]);
    }
  }
}

}  // namespace gwt
