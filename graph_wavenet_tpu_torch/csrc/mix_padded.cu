// Padded block-sparse diffusion hop (kernel 4) for sm_90a.
//
// Replaces: graph_wavenet_tpu/ops/pallas/block_diffusion.py,
//   gathered_block_mix (body _mix_kernel).
//
// Computes, for every block-row i of a padded (NB, MB) table,
//   out[i] = sum_m blocks[slot[i, m]] (contract) x[src[i, m]]
// with fp32 accumulation and one cast per output tile. transpose_lhs
// contracts the block's first axis (the forward, nconv orientation);
// otherwise its second (dx over the transpose tables). Blocks are square.
//
// Sentinels: the reference pads every row to MB slots with a zero block-row
// of x (forward, src == NB) or a zero block (dx, slot == NB * MB) appended
// to the operands on every hop. Here an entry whose slot is outside the
// blocks (slot >= n_blocks) or whose source is outside x (src >= nbx) is
// skipped: it would contribute exact zeros. So the callers pass x and the
// blocks unpadded (no copy), and the 31% of slots that are sentinels at the
// 40,960-node city layout cost a table read, not a product.
//
// What bounds it: as kernel 1, the live blocks' products (operations: the
// 67 TFLOP/s FMA rate in fp32, the tensor cores in bf16) at large R, the
// blocks read once at small R.
//
// Design: kernel 1 over an implicit row pointer: row i's entries are
// i * MB .. i * MB + MB - 1. One thread block owns one (row, 128-row output
// tile, 64-column R tile), walks the row's slots in order, accumulates in
// registers through block_tile.cuh's entry_product and writes once. Live
// slots come first in each row and in the order of the flat form's entries,
// so the output is bitwise equal to kernel 1 on as_flat_pallas's tables in
// both orientations. Rows with no live slot come out zero.

#include "block_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
mix_padded_kernel(const T* __restrict__ blocks, const int* __restrict__ slot,
                  const T* __restrict__ x, const int* __restrict__ src,
                  T* __restrict__ out, int mb, int n_blocks, int nbx, int bs,
                  int r, int transpose_lhs) {
  __shared__ __align__(16) typename gwt::SmemOf<T>::type sm;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * gwt::CT;
  const int o0 = blockIdx.z * gwt::OT;
  const size_t blk_elems = (size_t)bs * bs;
  gwt::Acc acc;
  gwt::zero_acc(acc);
  const size_t end = (size_t)(row + 1) * mb;
  for (size_t l = (size_t)row * mb; l < end; ++l) {
    const int k = slot[l], s = src[l];
    // a sentinel: the same test for every thread, so the block stays
    // together through entry_product's barriers
    if (k < 0 || k >= n_blocks || s < 0 || s >= nbx) continue;
    gwt::entry_product<false>(acc, sm, blocks + k * blk_elems,
                              x + (size_t)s * bs * r, bs, bs, o0, c0, r,
                              transpose_lhs != 0);
  }
  gwt::store_tile<T>(acc, out + (size_t)row * bs * r,
                     static_cast<const T*>(nullptr), o0, c0, r);
}

template <typename T>
int launch(const void* blocks, const void* slot, const void* x,
           const void* src, void* out, int nb, int mb, int n_blocks, int nbx,
           int bs, int r, int transpose_lhs, cudaStream_t stream) {
  dim3 grid(nb, (r + gwt::CT - 1) / gwt::CT, bs / gwt::OT);
  dim3 block(gwt::NTHREADS);
  mix_padded_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(slot),
      static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<T*>(out), mb, n_blocks, nbx, bs, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (blocks, x and out). blocks (n_blocks,
// bs, bs), x (nbx, bs, r), out (nb, bs, r) row-major; slot/src (nb * mb,)
// int32. bs % 128 == 0, nb >= 1, r >= 1. Returns cudaGetLastError() after
// the launch (0 = cudaSuccess).
extern "C" int gwt_mix_padded(int dtype, const void* blocks, const void* slot,
                              const void* x, const void* src, void* out,
                              int nb, int mb, int n_blocks, int nbx, int bs,
                              int r, int transpose_lhs, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs % gwt::OT || nb < 1 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(blocks, slot, x, src, out, nb, mb, n_blocks, nbx,
                         bs, r, transpose_lhs, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(blocks, slot, x, src, out, nb, mb, n_blocks,
                                 nbx, bs, r, transpose_lhs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
