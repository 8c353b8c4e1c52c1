// Flat block-sparse diffusion hop (kernel 1) for sm_90a.
//
// Replaces: graph_wavenet_tpu/ops/pallas/block_diffusion.py,
//   gathered_block_mix_flat (body _mix_flat_kernel).
//
// Computes, for every live entry l of a list sorted by destination row,
//   out[row[l]] += blocks[slot[l]] (contract) x[src[l]]
// with fp32 accumulation and one cast per output tile. transpose_lhs
// contracts the block's first axis (the forward, nconv orientation);
// otherwise its second (the backward dx over the transpose tables).
// Blocks may be rectangular (128 x 512 "flat-rect").
//
// What bounds it: at the city shapes (~2,400 live 128x128 blocks per
// support, R = B*T*32 up to 3,072) one hop is ~0.24 TFLOP against ~0.6 GB
// read once and written once (bf16), and blocks that are ~99% zeros still
// do dense work. So operations bind: in fp32 the 67 TFLOP/s FMA rate (the
// kernel uses plain FMAs, as the 1e-5 tolerance against fp32 demands), in
// bf16 the tensor cores' 989 TFLOP/s (the kernel uses mma.sync). At small
// R (batch 1, late layers) reading the blocks binds instead.
//
// Design: the TPU grid walks the entry list in order and revisits one
// output tile across consecutive steps. On the card the mix is independent
// per destination row and per column of R, so one thread block owns one
// (destination row, 128-row output tile, 64-column R tile). It finds its
// entries through a CSR row pointer built on the host once per support,
// walks them in list order accumulating in registers, and writes once.
// Ragged R is masked in the kernel (no pad-to-128 copy). Rows without
// entries come out zero. The product itself is block_tile.cuh's
// entry_product, shared with the fused order-2 kernel.

#include "block_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
mix_flat_kernel(const T* __restrict__ blocks, const int* __restrict__ slot,
                const T* __restrict__ x, const int* __restrict__ src,
                const int* __restrict__ row_ptr, T* __restrict__ out,
                int bs_c, int bs_o, int r, int transpose_lhs) {
  __shared__ __align__(16) typename gwt::SmemOf<T>::type sm;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * gwt::CT;
  const int o0 = blockIdx.z * gwt::OT;
  const size_t blk_elems = (size_t)bs_c * bs_o;
  gwt::Acc acc;
  gwt::zero_acc(acc);
  const int end = row_ptr[row + 1];
  for (int l = row_ptr[row]; l < end; ++l) {
    gwt::entry_product<false>(acc, sm, blocks + slot[l] * blk_elems,
                                 x + (size_t)src[l] * bs_c * r, bs_c, bs_o,
                                 o0, c0, r, transpose_lhs != 0);
  }
  gwt::store_tile<T>(acc, out + (size_t)row * bs_o * r,
                     static_cast<const T*>(nullptr), o0, c0, r);
}

template <typename T>
int launch(const void* blocks, const void* slot, const void* x,
           const void* src, const void* row_ptr, void* out, int nb,
           int bs_c, int bs_o, int r, int transpose_lhs,
           cudaStream_t stream) {
  dim3 grid(nb, (r + gwt::CT - 1) / gwt::CT, bs_o / gwt::OT);
  dim3 block(gwt::NTHREADS);
  mix_flat_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(slot),
      static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr), static_cast<T*>(out), bs_c, bs_o, r,
      transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int gwt_mix_flat(int dtype, const void* blocks, const void* slot,
                            const void* x, const void* src,
                            const void* row_ptr, void* out, int nb, int bs_c,
                            int bs_o, int r, int transpose_lhs,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs_o % gwt::OT || bs_c % gwt::KC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(blocks, slot, x, src, row_ptr, out, nb, bs_c, bs_o,
                         r, transpose_lhs, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(blocks, slot, x, src, row_ptr, out, nb,
                                 bs_c, bs_o, r, transpose_lhs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
