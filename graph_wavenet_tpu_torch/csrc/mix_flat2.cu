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
// between them: both run the same product (hopper_tile.cuh in bf16,
// block_tile.cuh's in fp32) over the entries of a row in list order, on
// tiles of the same shape.
//
// What bounds it: the same dense block work as two hops of kernel 1
// (~0.5 TFLOP for both hops at R = 3,072 and ~2,400 live blocks), on fp32
// FMAs or bf16 tensor cores by element type; operations bind before
// memory except at small R. What it saves over two launches is hop 2's
// read of out1 from device memory: hop 2 of a row runs shortly after hop 1
// of the rows it reads, so those rows are still in the 50 MB L2. On an H100
// 80GB HBM3 at 700 W (PERF.md) bf16 R = 3,072 takes 1.097 ms, slower than
// two kernel-1 launches on the same inputs (0.990 ms), and 1.785 ms with
// add (1.236); likely (not yet measured) because hop-2 blocks hold SMs
// while they wait on flags. This schedule is the next thing to redesign.
//
// Design: hop 2 of a row needs out1 rows finished by other rows' entries,
// a dependency across destination rows; columns stay independent. The TPU
// kernel walks the whole list in one sequential grid per R tile and keeps
// finished out1 rows in a VMEM ring. Walked by one persistent thread block
// per R tile, that schedule leaves the card nearly idle at small R. So here
// every (hop, destination row, R tile) is its own thread block, as in
// kernel 1, and the cross-row dependency is kept with per-(row, tile)
// completion flags in device memory:
//   - A block takes a ticket from a global counter when it starts. Tickets
//     map to work in steps: step s holds hop 1 of row s, then hop 2 of row
//     s - lag, for every R tile. lag = max(0, max over entries of
//     src - row) is computed on the host once per support, so every out1
//     row that hop 2 of a row reads is produced under a smaller ticket.
//     A block waits only for smaller tickets, taken by blocks that are
//     already running, so the launch cannot deadlock whatever order the
//     hardware starts blocks in.
//   - Hop 1 stores its out1 tile, fences, and publishes its flag with a
//     release store. Hop 2 waits for each source row's flag with an acquire
//     load before reading that tile: in bf16 the producer warp waits, then
//     fences the async proxy (fence.proxy.async.global) before its TMA reads
//     the tile, or reads it through L2 only (ld.global.cg) where R rules TMA
//     out; in fp32 every load goes through L2 only, never a stale L1 line.
//   - The finished out1 rows stay in device memory (and in practice L2),
//     not in a shared-memory ring, so ring_w does not limit the tile.
//   - A wait that lasts seconds traps, so a fault in the tables becomes a
//     launch error instead of a hung card.
// The tile width is the one kernel 1 takes for the same R and dtype; the
// flags buffer holds one flag per (row, tile) of that width.

#include "block_tile.cuh"
#include "hopper_tile.cuh"

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

// The ticket's work item: (hop, destination row, R tile), or rw outside
// [0, nb) for a step without work.
struct Item {
  int hop, rw, tile;
};

__device__ __forceinline__ Item take_ticket(int* counter, int ntiles,
                                            int lag) {
  __shared__ int item;
  if (threadIdx.x == 0) item = atomicAdd(counter, 1);
  __syncthreads();
  const int step = item / (2 * ntiles);
  const int hop = (item / ntiles) % 2;
  return Item{hop, hop == 0 ? step : step - lag, item % ntiles};
}

// flags: nb * ntiles completion flags, then the ticket counter; all zero at
// launch.
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
mix_flat2_f32(const float* __restrict__ blocks, const int* __restrict__ slot,
              const float* __restrict__ x, const int* __restrict__ src,
              const int* __restrict__ row_ptr, const float* __restrict__ add,
              float* out1, float* __restrict__ out2, int* flags, int nb,
              int lag, int r, int transpose_lhs) {
  constexpr int bs = gwt::OT;
  __shared__ __align__(16) gwt::SmemF32 sm;
  const int ntiles = (r + gwt::CT - 1) / gwt::CT;
  const Item it = take_ticket(flags + (size_t)nb * ntiles, ntiles, lag);
  if (it.rw < 0 || it.rw >= nb) return;     // the same for the whole block
  const int rw = it.rw, tile = it.tile, tid = threadIdx.x;
  const int c0 = tile * gwt::CT;
  const size_t blk_elems = (size_t)bs * bs;
  const size_t row_elems = (size_t)bs * r;
  gwt::Acc acc;
  gwt::zero_acc(acc);
  const int end = row_ptr[rw + 1];
  if (it.hop == 0) {
    for (int l = row_ptr[rw]; l < end; ++l)
      gwt::entry_product<false>(acc, sm, blocks + slot[l] * blk_elems,
                                x + src[l] * row_elems, bs, bs, 0, c0, r,
                                transpose_lhs != 0);
    const size_t at = rw * row_elems;
    gwt::store_tile<float>(acc, out1 + at, add != nullptr ? add + at : nullptr,
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
    gwt::store_tile<float>(acc, out2 + rw * row_elems,
                           static_cast<const float*>(nullptr), 0, c0, r);
  }
}

// Hop 2's wait, on the producer warp's lane 0 before it loads a source row.
struct FlagWait {
  const int* flags;
  int ntiles, tile;
  __device__ void operator()(int s) const {
    wait_flag(flags + (size_t)s * ntiles + tile);
    // out1 was written through the generic proxy; TMA reads it through the
    // async proxy
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
};

template <int CT>
__global__ void __launch_bounds__(gwt::wide::THREADS,
                                  gwt::wide::Tile<CT>::MIN_BLOCKS)
mix_flat2_bf16(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_o1, int x_tma,
               const __nv_bfloat16* __restrict__ x,
               const int* __restrict__ slot, const int* __restrict__ src,
               const int* __restrict__ row_ptr,
               const __nv_bfloat16* __restrict__ add, __nv_bfloat16* out1,
               __nv_bfloat16* __restrict__ out2, int* flags, int nb, int lag,
               int r, int transpose_lhs) {
  using namespace gwt::wide;
  constexpr int bs = gwt::OT;
  const int ntiles = (r + CT - 1) / CT;
  const Item it = take_ticket(flags + (size_t)nb * ntiles, ntiles, lag);
  if (it.rw < 0 || it.rw >= nb) return;     // the same for the whole block
  const int rw = it.rw, tile = it.tile;
  const size_t at = (size_t)rw * bs * r;
  const int begin = row_ptr[rw], end = row_ptr[rw + 1];
  const bool fwd = transpose_lhs != 0;
  WideAcc<CT> acc;
  if (it.hop == 0) {
    const Operands op{&tm_a, x_tma ? &tm_x : nullptr, x, bs, bs, r, 0,
                      tile * CT, fwd};
    if (!tile_product<CT, false>(acc, op, slot, src, begin, end, AnyEntry{},
                                 NoWait{}))
      return;
    store_wide<CT>(acc, out1 + at, add != nullptr ? add + at : nullptr, 0,
                   op.c0, r);
    __threadfence();
    asm volatile("fence.proxy.async.global;" ::: "memory");
    consumer_sync();
    if (threadIdx.x == 0) store_release(flags + (size_t)rw * ntiles + tile, 1);
  } else {
    const Operands op{&tm_a, x_tma ? &tm_o1 : nullptr, out1, bs, bs, r, 0,
                      tile * CT, fwd};
    if (!tile_product<CT, true>(acc, op, slot, src, begin, end, AnyEntry{},
                                FlagWait{flags, ntiles, tile}))
      return;
    store_wide<CT>(acc, out2 + at, nullptr, 0, op.c0, r);
  }
}

int launch_f32(const void* blocks, const void* slot, const void* x,
               const void* src, const void* row_ptr, const void* add,
               void* out1, void* out2, void* flags, int nb, int lag, int r,
               int transpose_lhs, long long n_items, cudaStream_t stream) {
  mix_flat2_f32<<<static_cast<unsigned>(n_items), gwt::NTHREADS, 0, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(slot),
      static_cast<const float*>(x), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr), static_cast<const float*>(add),
      static_cast<float*>(out1), static_cast<float*>(out2),
      static_cast<int*>(flags), nb, lag, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

template <int CT>
int launch_bf16(const void* blocks, const void* slot, const void* x,
                const void* src, const void* row_ptr, const void* add,
                void* out1, void* out2, void* flags, int nb, int n_blocks,
                int lag, int r, int transpose_lhs, long long n_items,
                cudaStream_t stream) {
  using namespace gwt::wide;
  constexpr int bs = gwt::OT;
  CUtensorMap tm_a, tm_x, tm_o1;
  if (!encode_blocks(&tm_a, blocks, n_blocks, bs, bs, transpose_lhs != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t rows = (uint64_t)nb * bs;
  const bool x_tma = encode_rows(&tm_x, x, rows, r, KC) &&
                     encode_rows(&tm_o1, out1, rows, r, KC);
  if (int rc = allow_smem<CT>(mix_flat2_bf16<CT>)) return rc;
  mix_flat2_bf16<CT><<<static_cast<unsigned>(n_items), THREADS,
                       Tile<CT>::SMEM, stream>>>(
      tm_a, tm_x, tm_o1, x_tma, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(slot), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr),
      static_cast<const __nv_bfloat16*>(add),
      static_cast<__nv_bfloat16*>(out1), static_cast<__nv_bfloat16*>(out2),
      static_cast<int*>(flags), nb, lag, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (ct must be 64), 1 = bfloat16 (ct 64, 128 or 256);
// add may be null. Square blocks of bs = 128 rows, n_blocks of them.
// flags: nb * ceil(r / ct) + 1 zeroed int32. Returns cudaGetLastError()
// after the launch.
extern "C" int gwt_mix_flat2(int dtype, const void* blocks, const void* slot,
                             const void* x, const void* src,
                             const void* row_ptr, const void* add,
                             void* out1, void* out2, void* flags, int nb,
                             int n_blocks, int lag, int bs, int r,
                             int transpose_lhs, int ct, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bs != gwt::OT || lag < 0 || ct <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_items = 2LL * ((r + ct - 1) / ct) * (nb + (long long)lag);
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && ct == gwt::CT)
    return launch_f32(blocks, slot, x, src, row_ptr, add, out1, out2, flags,
                      nb, lag, r, transpose_lhs, n_items, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return gwt::wide::with_ct(ct, [&](auto c) {
    return launch_bf16<decltype(c)::value>(blocks, slot, x, src, row_ptr, add,
                                           out1, out2, flags, nb, n_blocks,
                                           lag, r, transpose_lhs, n_items, s);
  });
}

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
