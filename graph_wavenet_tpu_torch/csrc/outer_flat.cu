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
// (no pad-to-128 copy). The tile product is outer_tile.cuh's, shared with
// the padded cotangent (kernel 5, outer_padded.cu).

#include "outer_tile.cuh"

namespace {

using gwt::MT;
using gwt::NT;

// grid (entry, BSg / 64, BSx / 128)
template <typename T>
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
outer_flat_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const int* __restrict__ src, const int* __restrict__ row,
                  float* __restrict__ out, int bs_x, int bs_g, int r) {
  __shared__ __align__(16) typename gwt::SmemOuterOf<T>::type sm;
  const int l = blockIdx.x;
  const int n0 = blockIdx.y * NT;
  const int m0 = blockIdx.z * MT;
  gwt::Acc acc;
  gwt::zero_acc(acc);
  gwt::outer_tile(acc, sm, x + ((size_t)src[l] * bs_x + m0) * r,
                  g + ((size_t)row[l] * bs_g + n0) * r, r);
  gwt::store_outer<T>(acc, out + (size_t)l * bs_x * bs_g, bs_g, m0, n0);
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
