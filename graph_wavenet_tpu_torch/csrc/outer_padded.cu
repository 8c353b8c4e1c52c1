// Padded block-sparse weight cotangent (kernel 5) for sm_90a.
//
// Replaces: graph_wavenet_tpu/ops/pallas/block_diffusion.py,
//   gathered_block_outer (body _dblocks_kernel).
//
// Computes, for every slot (i, m) of a padded (NB, MB) forward table,
//   out[i, m] = x[src[i, m]] (BS, R) . g[i] (BS, R)^T          (BS, BS)
// contracted over R, in fp32, cast once to the output type (the blocks'
// storage type, fp32 or bf16): the padded hop's gradient with respect to
// its blocks. A sentinel slot (src >= nbx: the reference's zero block-row)
// reads nothing and stores exact zeros, so x is passed unpadded and the
// output, allocated uninitialised, is written everywhere.
//
// What bounds it: the output, NB * MB blocks of BS x BS written once (231 MB
// in fp32, 115 MB in bf16 at the 40,960-node city layout, sentinels
// included), and 2 * n_live * BS * BS * R operations for the live slots. At
// the last layer's R = 128 the writes bind; at the first layer's R = 1,536
// the operations do (tensor cores for bf16 inputs, the FMA rate for fp32).
//
// Design: kernel 2 with row = l / MB. Every (slot, 128 x 64 output tile) is
// its own thread block (thousands, enough to fill the 132 SMs without
// splitting R); it walks R in chunks of 32 in a fixed order through
// outer_tile.cuh's product, accumulates in registers and writes its tile
// once: no atomics, and a repeat is bit-identical. Ragged R is masked in
// the kernel (no pad-to-128 copy).

#include "outer_tile.cuh"

namespace {

using gwt::MT;
using gwt::NT;

// grid (slot, BS / 64, BS / 128)
template <typename T, typename O>
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
outer_padded_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const int* __restrict__ src, O* __restrict__ out, int mb,
                    int nbx, int bs, int r) {
  __shared__ __align__(16) typename gwt::SmemOuterOf<T>::type sm;
  const size_t l = blockIdx.x;
  const int n0 = blockIdx.y * NT;
  const int m0 = blockIdx.z * MT;
  const int s = src[l];
  gwt::Acc acc;
  gwt::zero_acc(acc);
  if (s >= 0 && s < nbx)          // the same test for every thread
    gwt::outer_tile(acc, sm, x + ((size_t)s * bs + m0) * r,
                    g + ((l / mb) * bs + n0) * r, r);
  gwt::store_outer<T>(acc, out + l * bs * bs, bs, m0, n0);
}

template <typename T, typename O>
int launch(const void* x, const void* g, const void* src, void* out,
           int n_slots, int mb, int nbx, int bs, int r, cudaStream_t stream) {
  dim3 grid(n_slots, bs / NT, bs / MT);
  dim3 block(gwt::NTHREADS);
  outer_padded_kernel<T, O><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const int*>(src), static_cast<O*>(out), mb, nbx, bs, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_as(int out_dtype, const void* x, const void* g, const void* src,
              void* out, int n_slots, int mb, int nbx, int bs, int r,
              cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<T, float>(x, g, src, out, n_slots, mb, nbx, bs, r, stream);
  if (out_dtype == 1)
    return launch<T, __nv_bfloat16>(x, g, src, out, n_slots, mb, nbx, bs, r,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and g); out_dtype likewise for out.
// x (nbx, bs, r), g (n_slots / mb, bs, r), out (n_slots, bs, bs) row-major;
// src (n_slots,) int32, slot l in row l / mb. bs % 128 == 0, n_slots >= 1,
// mb >= 1, r >= 1. Returns cudaGetLastError() after the launch (0 =
// cudaSuccess).
extern "C" int gwt_outer_padded(int dtype, const void* x, const void* g,
                                const void* src, void* out, int out_dtype,
                                int n_slots, int mb, int nbx, int bs, int r,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs % MT || n_slots < 1 || mb < 1 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_as<float>(out_dtype, x, g, src, out, n_slots, mb, nbx, bs,
                            r, s);
  if (dtype == 1)
    return launch_as<__nv_bfloat16>(out_dtype, x, g, src, out, n_slots, mb,
                                    nbx, bs, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
