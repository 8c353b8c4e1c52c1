// Flat block-sparse weight cotangent (kernel 2) for sm_90a.
//
// Replaces: graph_wavenet_tpu/ops/pallas/block_diffusion.py,
//   gathered_block_outer_flat (body _dblocks_flat_kernel).
//
// Computes, for every entry l of a flat support's forward table (dummy
// entries included),
//   out[l] = x[src[l]] (BSx, R) . g[row[l]] (BSg, R)^T      (BSx, BSg) fp32
// contracted over R, the per-entry weight cotangent of one hop. Both
// operands are R-contiguous rows (K-major), which is what mma.sync wants:
// x is the row-major M x K operand, g the column-major K x N one.
// Rectangular blocks (128 x 512) are taken by tiling the output.
//
// What bounds it: the fp32 output, 64 KB per 128x128 entry, is written once
// (160 MB per launch for the 2,442 entries of the 40,960-node city mask),
// and the product is 2 * Lt * BSx * BSg * R operations. At the last layer's
// R = 128 the writes bind (bytes); at the first layer's R = 1,536 the
// operations do, on the bf16 tensor cores for bf16 inputs and on the
// 67 TFLOP/s FMA rate for fp32 inputs (plain FMAs: the fp32 result is held
// to 1e-5).
//
// Design: the TPU grid walks R sequentially into a VMEM accumulator, one
// entry at a time. Here every (entry, 128 x 64 output tile) is its own
// thread block: entries alone number in the thousands, enough to fill the
// 132 SMs, so R is not split. A block walks R in chunks of 32 in a fixed
// order, accumulates in registers and writes its tile once: no atomics, and
// the result is the same from run to run. Ragged R is masked in the kernel
// (no pad-to-128 copy). The accumulator layout and the tensor-core helpers
// are block_tile.cuh's, shared with the mix kernels.

#include "block_tile.cuh"

namespace {

constexpr int MT = gwt::OT;       // x rows (output rows) per tile: 128
constexpr int NT = gwt::CT;       // g rows (output columns) per tile: 64
constexpr int KR = 32;            // R columns per staged chunk

struct SmemOuterF32 {             // k-major, as entry_product's sm.a; +4
  float x[KR][MT + 4];            // keeps rows 16-byte aligned and spreads
  float g[KR][NT + 4];            // the transposing stores over banks
};

struct SmemOuterBf16 {
  __nv_bfloat16 x[MT][KR + gwt::PAD16];   // rows m, k contiguous
  __nv_bfloat16 g[NT][KR + gwt::PAD16];   // rows n, k contiguous
};

// fp32: thread (ty, tx) of a 16 x 16 grid owns output rows 8 ty + i and
// columns 4 tx + j (block_tile.cuh's float tile_coord).
__device__ __forceinline__ void outer_tile(gwt::Acc& acc, SmemOuterF32& sm,
                                           const float* xs, const float* gs,
                                           int r) {
  const int tid = threadIdx.x;
  const int ty = tid / gwt::TX, tx = tid % gwt::TX;
  constexpr int NX = KR * MT / gwt::NTHREADS;   // 16 x elements a thread
  constexpr int NG = KR * NT / gwt::NTHREADS;   // 8 g elements a thread
  // element i = tid + u * NTHREADS of a chunk: row i / KR, column i % KR,
  // so a warp reads 32 consecutive R values of one row
  const int col = tid % KR;
  for (int k0 = 0; k0 < r; k0 += KR) {
    const bool in = k0 + col < r;
    float xv[NX], gv[NG];
#pragma unroll
    for (int u = 0; u < NX; ++u) {
      const int m = (tid + u * gwt::NTHREADS) / KR;
      xv[u] = in ? xs[(size_t)m * r + k0 + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int n = (tid + u * gwt::NTHREADS) / KR;
      gv[u] = in ? gs[(size_t)n * r + k0 + col] : 0.f;
    }
    __syncthreads();              // the previous chunk has been consumed
#pragma unroll
    for (int u = 0; u < NX; ++u)
      sm.x[col][(tid + u * gwt::NTHREADS) / KR] = xv[u];
#pragma unroll
    for (int u = 0; u < NG; ++u)
      sm.g[col][(tid + u * gwt::NTHREADS) / KR] = gv[u];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KR; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.x[k][gwt::RPT * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.x[k][gwt::RPT * ty + 4]);
      const float4 bq =
          *reinterpret_cast<const float4*>(&sm.g[k][gwt::CPT * tx]);
      const float ar[gwt::RPT] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
      const float br[gwt::CPT] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < gwt::RPT; ++i)
#pragma unroll
        for (int j = 0; j < gwt::CPT; ++j)
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

// bf16: mma.sync m16n8k16 with fp32 accumulation. Warp w owns output rows
// 32 (w % 4) .. +31 and columns 32 (w / 4) .. +31 (block_tile.cuh's bf16
// tile_coord). Both operands sit in shared memory with k contiguous, so
// plain (non-transposed) ldmatrix builds both fragments.
__device__ __forceinline__ void outer_tile(gwt::Acc& acc, SmemOuterBf16& sm,
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
        gwt::ldsm_x4(a[mt], &sm.x[wm + 16 * mt + 8 * (q % 2) + l8]
                                 [kk + 8 * (q / 2)]);
#pragma unroll
      for (int np = 0; np < 2; ++np)  // n tiles 2np, 2np+1: (k +0/+8, n +0/+8)
        gwt::ldsm_x4(b[np], &sm.g[wn + 16 * np + 8 * (q / 2) + l8]
                                 [kk + 8 * (q % 2)]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          gwt::mma_bf16(acc[4 * mt + nt], a[mt], b[nt / 2][2 * (nt % 2)],
                        b[nt / 2][2 * (nt % 2) + 1]);
    }
  }
}

template <typename T> struct SmemOuterOf;
template <> struct SmemOuterOf<float> { using type = SmemOuterF32; };
template <> struct SmemOuterOf<__nv_bfloat16> { using type = SmemOuterBf16; };

// grid (entry, BSg / 64, BSx / 128)
template <typename T>
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
outer_flat_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const int* __restrict__ src, const int* __restrict__ row,
                  float* __restrict__ out, int bs_x, int bs_g, int r) {
  __shared__ __align__(16) typename SmemOuterOf<T>::type sm;
  const int l = blockIdx.x;
  const int n0 = blockIdx.y * NT;
  const int m0 = blockIdx.z * MT;
  gwt::Acc acc;
  gwt::zero_acc(acc);
  outer_tile(acc, sm, x + ((size_t)src[l] * bs_x + m0) * r,
             g + ((size_t)row[l] * bs_g + n0) * r, r);
  float* o = out + (size_t)l * bs_x * bs_g;
#pragma unroll
  for (int i = 0; i < gwt::ACC_I; ++i) {
#pragma unroll
    for (int j = 0; j < gwt::ACC_J; ++j) {
      int m, n;
      gwt::tile_coord(static_cast<T*>(nullptr), i, j, m, n);
      o[(size_t)(m0 + m) * bs_g + n0 + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* src, const void* row,
           void* out, int lt, int bs_x, int bs_g, int r,
           cudaStream_t stream) {
  dim3 grid(lt, bs_g / NT, bs_x / MT);
  dim3 block(gwt::NTHREADS);
  outer_flat_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const int*>(src), static_cast<const int*>(row),
      static_cast<float*>(out), bs_x, bs_g, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and g); out is float32 (lt, bs_x,
// bs_g). x (nbx, bs_x, r) and g (nbg, bs_g, r) row-major; src/row (lt,)
// int32. bs_x % 128 == 0, bs_g % 64 == 0, lt >= 1, r >= 1. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int gwt_outer_flat(int dtype, const void* x, const void* g,
                              const void* src, const void* row, void* out,
                              int lt, int bs_x, int bs_g, int r,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs_x % MT || bs_g % NT || lt < 1 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, g, src, row, out, lt, bs_x, bs_g, r, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, src, row, out, lt, bs_x, bs_g, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
