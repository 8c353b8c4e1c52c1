// Shared tiles of the block-sparse diffusion kernels: the fp32 product of
// the mix kernels 1, 3 and 4 (mix_flat.cu, mix_flat2.cu, mix_padded.cu),
// and the pieces the weight-cotangent tile (outer_tile.cuh) builds on. The
// bf16 products are hopper_tile.cuh's (mix) and hopper_outer.cuh's
// (weight cotangents).
//
// fp32: one thread block of 256 threads owns an output tile of OT = 128
// destination rows by CT = 64 columns of R and accumulates it in fp32
// registers, 32 values a thread, with plain FMAs (__fmaf_rn), the only way
// to hold the plain fp32 result to 1e-5. One live entry contracts the
// entry's block with one (BSc, R) source tile; the contraction axis is
// staged through shared memory in chunks of KC = 32 rows. All global loads
// of a chunk are issued before any of them is stored, so their latencies
// overlap. Thread (ty, tx) of a 16 x 16 grid owns rows 8*ty + i and columns
// 4*tx + j, read from shared memory as 16-byte vectors. What bounds it: the
// 67 TFLOP/s FMA rate; kernel 4 in fp32 ran at 48% of it at R = 3,072 on an
// H100 80GB HBM3 at 700 W (PERF.md).
//
// Every mix kernel runs entry_product for every entry of a destination row,
// in list order, on tiles of the same shape. So each output element sees
// the same chain of operations in the same order, which is what makes the
// fused order-2 kernel bitwise equal to two launches of the single-hop
// kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace gwt {

constexpr int OT = 128;           // output rows per tile
constexpr int KC = 32;            // contraction rows per staged chunk
constexpr int CT = 64;            // R columns per fp32 tile
constexpr int NTHREADS = 256;
constexpr int ACC_I = 8;          // acc[ACC_I][ACC_J]: 32 fp32 a thread
constexpr int ACC_J = 4;
using Acc = float[ACC_I][ACC_J];

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Global loads of source elements. kL2 reads through L2 only
// (ld.global.cg): the fused kernel reads rows of its own first output,
// written by other thread blocks during the launch, and must not hit a
// stale L1 line.
template <bool kL2>
__device__ __forceinline__ float load1(const float* p) {
  return kL2 ? __ldcg(p) : *p;
}
template <bool kL2>
__device__ __forceinline__ __nv_bfloat16 load1(const __nv_bfloat16* p) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  return __ushort_as_bfloat16(kL2 ? __ldcg(q) : *q);
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < ACC_I; ++i)
#pragma unroll
    for (int j = 0; j < ACC_J; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// float: fp32 FMAs
// ---------------------------------------------------------------------------

constexpr int TX = 16, TY = 16;   // thread grid
constexpr int RPT = OT / TY;      // rows a thread (8)
constexpr int CPT = CT / TX;      // columns a thread (4)

struct SmemF32 {
  float a[KC][OT + 4];            // +4 keeps rows 16-byte aligned
  float x[KC][CT];
};

// acc[i][j] += sum_k A[k][o0 + 8 ty + i] * xs[k][c0 + 4 tx + j]
//   transpose_lhs: blk is (bs_c, bs_o), A[k][o] = blk[k][o]  (forward)
//   otherwise:     blk is (bs_o, bs_c), A[k][o] = blk[o][k]  (transpose)
// xs points at a (bs_c, r) row-major source tile. Columns >= r read as 0.
template <bool kL2>
__device__ __forceinline__ void entry_product(
    Acc& acc, SmemF32& sm, const float* blk, const float* xs, int bs_c,
    int bs_o, int o0, int c0, int r, bool transpose_lhs) {
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  constexpr int NA = KC * OT / NTHREADS;     // 16 block elements a thread
  constexpr int NX = KC * CT / NTHREADS;     // 8 source elements a thread
  for (int k0 = 0; k0 < bs_c; k0 += KC) {
    float av[NA], xv[NX];
    // element i = tid + u * NTHREADS of the chunk: a fixed pointer and a
    // fixed stride per thread
    if (transpose_lhs) {          // chunk rows k = i / OT, columns o = i % OT
      const float* p = blk + (size_t)(k0 + tid / OT) * bs_o + o0 + tid % OT;
      const size_t step = (size_t)(NTHREADS / OT) * bs_o;
#pragma unroll
      for (int u = 0; u < NA; ++u) av[u] = p[u * step];
    } else {                      // k = i % KC, o = i / KC
      const float* p = blk + (size_t)(o0 + tid / KC) * bs_c + k0 + tid % KC;
      const size_t step = (size_t)(NTHREADS / KC) * bs_c;
#pragma unroll
      for (int u = 0; u < NA; ++u) av[u] = p[u * step];
    }
    {                             // k = i / CT, column c0 + i % CT
      const int col = c0 + tid % CT;
      const float* p = xs + (size_t)(k0 + tid / CT) * r + col;
      const size_t step = (size_t)(NTHREADS / CT) * r;
#pragma unroll
      for (int u = 0; u < NX; ++u)
        xv[u] = col < r ? load1<kL2>(p + u * step) : 0.f;
    }
    __syncthreads();              // the previous chunk has been consumed
    if (transpose_lhs) {
#pragma unroll
      for (int u = 0; u < NA; ++u) {
        const int i = tid + u * NTHREADS;
        sm.a[i / OT][i % OT] = av[u];
      }
    } else {
#pragma unroll
      for (int u = 0; u < NA; ++u) {
        const int i = tid + u * NTHREADS;
        sm.a[i % KC][i / KC] = av[u];
      }
    }
#pragma unroll
    for (int u = 0; u < NX; ++u) {
      const int i = tid + u * NTHREADS;
      sm.x[i / CT][i % CT] = xv[u];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[k][RPT * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.a[k][RPT * ty + 4]);
      const float4 xq = *reinterpret_cast<const float4*>(&sm.x[k][CPT * tx]);
      const float ar[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float xr[CPT] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[i][j] = __fmaf_rn(ar[i], xr[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void tile_coord(float*, int i, int j, int& row,
                                           int& col) {
  row = RPT * (threadIdx.x / TX) + i;
  col = CPT * (threadIdx.x % TX) + j;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------

// Casts the tile once and stores it at out (bs_o, r) row-major, columns
// < r only. add (optional, same layout) is added after the cast, in T's
// precision: the cast value and add are summed in fp32 and rounded once,
// as PyTorch adds two tensors of T.
template <typename T>
__device__ __forceinline__ void store_tile(const Acc& acc, T* out,
                                           const T* add, int o0, int c0,
                                           int r) {
#pragma unroll
  for (int i = 0; i < ACC_I; ++i) {
#pragma unroll
    for (int j = 0; j < ACC_J; ++j) {
      int row, col;
      tile_coord(static_cast<T*>(nullptr), i, j, row, col);
      const int c = c0 + col;
      if (c < r) {
        const size_t at = (size_t)(o0 + row) * r + c;
        T v = from_f<T>(acc[i][j]);
        if (add != nullptr) v = from_f<T>(to_f(v) + to_f(add[at]));
        out[at] = v;
      }
    }
  }
}

}  // namespace gwt
