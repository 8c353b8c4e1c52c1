// Fused order-2 flat block-sparse diffusion (kernel 3) for sm_90a.
//
// Replaces: graph_wavenet_tpu/ops/pallas/block_diffusion.py,
//   gathered_block_mix_flat2 (body _mix_flat2_kernel, schedule
//   fused2_schedule).
//
// Computes both hops of one support in one launch over the row-sorted
// entry list: out1 = mix(x), cast to the activation dtype, plus the
// optional add (after the cast); out2 = mix(out1). Square 128-row blocks.
// Bitwise equal to two launches of kernel 1 (mix_flat.cu) with the add
// between them: both run block_tile.cuh's entry_product over the entries
// of a row in list order, on tiles of the same shape.
//
// What bounds it: the same dense block work as two hops of kernel 1
// (~0.5 TFLOP for both hops at R = 3,072 and ~2,400 live blocks), on fp32
// FMAs or bf16 tensor cores by element type; operations bind before
// memory except at small R. What it saves over two launches is hop 2's
// read of out1 from device memory: hop 2 of a row runs shortly after hop 1
// of the rows it reads, so those rows are still in the 50 MB L2.
//
// Design: hop 2 of a row needs out1 rows finished by other rows' entries,
// a dependency across destination rows; columns stay independent. The TPU
// kernel walks the whole list in one sequential grid per R tile and keeps
// finished out1 rows in a VMEM ring. Walked by one persistent thread block
// per R tile, that schedule leaves the card nearly idle at small R (R / 64
// blocks: one block at R = 32). So here every (hop, destination row,
// 64-column R tile) is its own thread block, as in kernel 1, and the
// cross-row dependency is kept with per-(row, tile) completion flags in
// device memory:
//   - A block takes a ticket from a global counter when it starts. Tickets
//     map to work in steps: step s holds hop 1 of row s, then hop 2 of row
//     s - lag, for every R tile. lag = max(0, max over entries of
//     src - row) is computed on the host once per support, so every out1
//     row that hop 2 of a row reads is produced under a smaller ticket.
//     A block waits only for smaller tickets, taken by blocks that are
//     already running, so the launch cannot deadlock whatever order the
//     hardware starts blocks in.
//   - Hop 1 stores its out1 tile, fences, and publishes its flag with a
//     release store. Hop 2 waits for each source row's flag with acquire
//     loads before reading that tile, and reads out1 through L2 only
//     (ld.global.cg), never through a stale L1 line.
//   - The finished out1 rows stay in device memory (and in practice L2),
//     not in a shared-memory ring, so ring_w does not limit the tile.
//   - A wait that lasts seconds traps, so a fault in the tables becomes a
//     launch error instead of a hung card.

#include "block_tile.cuh"

namespace {

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ void wait_flag(const int* flag) {
  long long spins = 0;
  while (load_acquire(flag) == 0) {
    __nanosleep(100);
    if (++spins > (1ll << 25)) __trap();
  }
}

// flags: nb * ntiles completion flags, then the ticket counter; all zero at
// launch.
template <typename T>
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
mix_flat2_kernel(const T* __restrict__ blocks, const int* __restrict__ slot,
                 const T* __restrict__ x, const int* __restrict__ src,
                 const int* __restrict__ row_ptr, const T* __restrict__ add,
                 T* out1, T* __restrict__ out2, int* flags, int nb, int lag,
                 int r, int transpose_lhs) {
  constexpr int bs = gwt::OT;
  __shared__ __align__(16) typename gwt::SmemOf<T>::type sm;
  __shared__ int item;
  const int ntiles = (r + gwt::CT - 1) / gwt::CT;
  const int tid = threadIdx.x;
  if (tid == 0) item = atomicAdd(flags + (size_t)nb * ntiles, 1);
  __syncthreads();
  const int step = item / (2 * ntiles);
  const int hop = (item / ntiles) % 2;
  const int tile = item % ntiles;
  const int rw = hop == 0 ? step : step - lag;
  if (rw < 0 || rw >= nb) return;            // the same for the whole block
  const int c0 = tile * gwt::CT;
  const size_t blk_elems = (size_t)bs * bs;
  const size_t row_elems = (size_t)bs * r;
  gwt::Acc acc;
  gwt::zero_acc(acc);
  const int end = row_ptr[rw + 1];
  if (hop == 0) {
    for (int l = row_ptr[rw]; l < end; ++l)
      gwt::entry_product<false>(acc, sm, blocks + slot[l] * blk_elems,
                                   x + src[l] * row_elems, bs, bs, 0, c0, r,
                                   transpose_lhs != 0);
    const size_t at = rw * row_elems;
    gwt::store_tile<T>(acc, out1 + at, add != nullptr ? add + at : nullptr,
                       0, c0, r);
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(flags + (size_t)rw * ntiles + tile, 1);
  } else {
    for (int l = row_ptr[rw]; l < end; ++l) {
      const int s = src[l];
      // thread 0 acquires the flag; the barrier passes it on to the other
      // threads before any of them loads the tile
      if (tid == 0) wait_flag(flags + (size_t)s * ntiles + tile);
      __syncthreads();
      gwt::entry_product<true>(acc, sm, blocks + slot[l] * blk_elems,
                                  out1 + s * row_elems, bs, bs, 0, c0, r,
                                  transpose_lhs != 0);
    }
    gwt::store_tile<T>(acc, out2 + rw * row_elems,
                       static_cast<const T*>(nullptr), 0, c0, r);
  }
}

template <typename T>
int launch(const void* blocks, const void* slot, const void* x,
           const void* src, const void* row_ptr, const void* add, void* out1,
           void* out2, void* flags, int nb, int lag, int r,
           int transpose_lhs, cudaStream_t stream) {
  const long long ntiles = (r + gwt::CT - 1) / gwt::CT;
  const long long n_items = 2 * ntiles * (nb + (long long)lag);
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(gwt::NTHREADS);
  mix_flat2_kernel<T><<<static_cast<unsigned>(n_items), block, 0, stream>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(slot),
      static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr), static_cast<const T*>(add),
      static_cast<T*>(out1), static_cast<T*>(out2), static_cast<int*>(flags),
      nb, lag, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; add may be null. Square blocks of
// bs = 128 rows. flags: nb * ceil(r / 64) + 1 zeroed int32. Returns
// cudaGetLastError() after the launch.
extern "C" int gwt_mix_flat2(int dtype, const void* blocks, const void* slot,
                             const void* x, const void* src,
                             const void* row_ptr, const void* add,
                             void* out1, void* out2, void* flags, int nb,
                             int lag, int bs, int r, int transpose_lhs,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs != gwt::OT || lag < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(blocks, slot, x, src, row_ptr, add, out1, out2,
                         flags, nb, lag, r, transpose_lhs, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(blocks, slot, x, src, row_ptr, add, out1,
                                 out2, flags, nb, lag, r, transpose_lhs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int gwt_mix_flat2_tiles(int r) {
  return (r + gwt::CT - 1) / gwt::CT;
}

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
