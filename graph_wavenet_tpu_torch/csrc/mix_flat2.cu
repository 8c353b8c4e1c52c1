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
// tiles of the same shape. Only the schedule and the epilogue differ.
//
// What bounds it: the same dense block work as two hops of kernel 1
// (~0.5 TFLOP for both hops at R = 3,072 and ~2,400 live blocks), on fp32
// FMAs or bf16 tensor cores by element type; operations bind before
// memory except at small R. What it saves over two launches is hop 2's
// read of out1 from device memory (hop 2 of a row runs shortly after hop 1
// of the rows it reads, so those rows are still in the 50 MB L2), the add's
// own pass, and the second launch's fill and tail. On an H100 80GB HBM3 at
// 700 W (PERF.md) bf16 takes, against two kernel-1 launches in the same
// run: forward R = 1,536 0.515 ms against 0.529, R = 3,072 0.984 against
// 0.985 (0.494 ms bound); over the transpose tables with add R = 1,536
// 0.585 against 0.651 (0.249 ms bound). The schedule before this one took
// 0.583, 1.078 and 0.962 ms there. fp32 wins at every R (R = 3,072: 14.25
// against 16.09 ms). Its persistent loop runs kernel 1's own work ~2.6%
// slower a tile (garage/k3_variants.py), which the fusion only just pays
// back at R = 3,072 forward.
//
// Design: hop 2 of a row needs out1 rows finished by other rows' entries,
// a dependency across destination rows; columns stay independent. The TPU
// kernel walks the whole list in one sequential grid per R tile and keeps
// finished out1 rows in a VMEM ring. Here every (hop, destination row, R
// tile) is a work item, and the cross-row dependency is kept with
// per-(row, tile) completion flags in device memory:
//   - Items are handed out by tickets (see the grid below), in steps:
//     step s holds hop 1 of row s, then hop 2 of row s - span, for every R
//     tile; the first span steps hold only hop 1, the last only hop 2.
//     span = lag + slack (ops/cuda/block_diffusion.py: fused2_launch), where
//     lag = max(0, max over entries of src - row) makes every out1 row
//     that hop 2 of a row reads come from a smaller ticket, and the slack
//     is the steps the tickets held at once span, so those rows were
//     published about a wave before hop 2 asks for them. Without the slack
//     (the design before this one) hop 2 waited on the hop-1 items issued
//     just before it, which were still running, and its SM stood idle.
//   - The grid is persistent: no larger than the blocks the card holds at
//     once (the occupancy, read at launch), each block pulling tickets in a
//     loop. Block b's first ticket is b; the later ones come from the
//     counter. A block waits only for smaller tickets, each held by a block
//     that runs (a first ticket's block is resident, since the whole grid
//     fits the card; a later ticket was taken by a running block) and whose
//     own waits are on smaller tickets still, so the launch cannot deadlock
//     whatever order the hardware starts blocks in.
//   - bf16: one producer warp takes the tickets and hands each item to the
//     two consumer warpgroups through a two-slot queue in shared memory.
//     Its ring cursor carries over from item to item, so it loads the next
//     tile's first stages while the consumers store the last one: the
//     ring's fill and the epilogue are paid once per block, not per tile.
//     Before a hop-1 item with add it prefetches the add tile into L2;
//     the epilogue (store_wide_sum) then issues its loads in batches.
//   - Hop 1 stores its out1 tile, and one thread fences and publishes
//     the flag with a release store once every thread has stored its part.
//     fp32: the block meets at a barrier, then thread 0 publishes. bf16:
//     each consumer thread fences the async proxy, each warp arrives on an
//     mbarrier and goes on to the next item; a publisher warp waits on it
//     and publishes. A release waits for the stores to reach L2: done by
//     a consumer, it held both warpgroups (through the ring) for ~7% of a
//     hop-1 tile's time at 256 columns. Hop 2 waits for each
//     source row's flag with an acquire load before reading that tile: in
//     bf16 the producer warp's lanes wait for all the row's sources side
//     by side, then fence the async proxy (fence.proxy.async.global)
//     before TMA reads the tiles, or read them through L2 only
//     (ld.global.cg) where R rules TMA out; in fp32 thread 0 waits before
//     each entry and every load goes through L2 only, never a stale L1
//     line.
//   - A wait that lasts seconds traps, so a fault in the tables becomes a
//     launch error instead of a hung card.
// The tile width is the one kernel 1 takes for the same R and dtype; the
// flags buffer holds one flag per (row, tile) of that width, then the
// ticket counter. Times: PERF.md (chip_smoke.py's dispatch phase).

#include "block_tile.cuh"
#include "entry.cuh"
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

// Publishes a finished out1 tile: after a barrier (fp32) or an mbarrier
// wait (bf16) on the threads that stored it, one thread makes the tile's
// stores visible at gpu scope (cumulative over the stores the barrier
// ordered before it) and releases the flag.
__device__ __forceinline__ void publish(int* flag) {
  __threadfence();
  store_release(flag, 1);
}

// A work item: (hop, destination row, R tile); rw = -1 past the last one.
// n: the row's entries (set by the bf16 producer for its consumers).
struct Item {
  int hop, rw, tile, n;
};

// The item of ticket t among 2 * nb * nt (nt R tiles a row): see the
// header. span is at most nb.
__device__ __forceinline__ Item item_of(int t, int nb, int nt, int span) {
  const int a = span * nt;                  // hop 1 of rows [0, span)
  const int b = 2 * nt * (nb - span);       // the steps with both hops
  if (t < a) return Item{0, t / nt, t % nt, 0};
  t -= a;
  if (t < b) {
    const int step = span + t / (2 * nt), w = t % (2 * nt);
    const int hop = w / nt;
    return Item{hop, hop == 0 ? step : step - span, w % nt, 0};
  }
  t -= b;
  if (t < a) return Item{1, nb - span + t / nt, t % nt, 0};
  return Item{0, -1, 0, 0};
}

// A block's next ticket: its first is its own index (no block waits on the
// counter at launch, when all would at once), the later ones come from the
// counter past the grid's first tickets.
__device__ __forceinline__ int next_ticket(int* counter, bool first) {
  return first ? static_cast<int>(blockIdx.x)
               : static_cast<int>(gridDim.x) + atomicAdd(counter, 1);
}

// flags: nb * ntiles completion flags, then the ticket counter; all zero at
// launch.
__global__ void __launch_bounds__(gwt::NTHREADS, 2)
mix_flat2_f32(const float* __restrict__ blocks, const int* __restrict__ slot,
              const float* __restrict__ x, const int* __restrict__ src,
              const int* __restrict__ row_ptr, const float* __restrict__ add,
              float* out1, float* __restrict__ out2, int* flags, int nb,
              int span, int r, int transpose_lhs) {
  constexpr int bs = gwt::OT;
  __shared__ __align__(16) gwt::SmemF32 sm;
  __shared__ int ticket;
  const int ntiles = (r + gwt::CT - 1) / gwt::CT;
  const int tid = threadIdx.x;
  const size_t blk_elems = (size_t)bs * bs;
  const size_t row_elems = (size_t)bs * r;
  for (bool first = true;; first = false) {
    if (tid == 0) ticket = next_ticket(flags + (size_t)nb * ntiles, first);
    __syncthreads();
    const Item it = item_of(ticket, nb, ntiles, span);
    __syncthreads();              // every thread has read the ticket
    if (it.rw < 0) return;        // the same for the whole block
    const int rw = it.rw, tile = it.tile;
    const int c0 = tile * gwt::CT;
    gwt::Acc acc;
    gwt::zero_acc(acc);
    const int end = row_ptr[rw + 1];
    if (it.hop == 0) {
      for (int l = row_ptr[rw]; l < end; ++l)
        gwt::entry_product<false>(acc, sm, blocks + slot[l] * blk_elems,
                                  x + src[l] * row_elems, bs, bs, 0, c0, r,
                                  transpose_lhs != 0);
      const size_t at = rw * row_elems;
      gwt::store_tile<float>(acc, out1 + at,
                             add != nullptr ? add + at : nullptr, 0, c0, r);
      __syncthreads();
      if (tid == 0) publish(flags + (size_t)rw * ntiles + tile);
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
}

// Hop 2's wait, on the producer warp before it loads any source row of
// entries [begin, end): the lanes acquire the rows' flags side by side,
// so a row pays one round trip to L2, not one per entry.
__device__ __forceinline__ void wait_sources(const int* flags,
                                             const int* src, int begin,
                                             int end, int ntiles, int tile) {
  for (int l = begin + threadIdx.x % 32; l < end; l += 32)
    wait_flag(flags + (size_t)src[l] * ntiles + tile);
  __syncwarp();
  // out1 was written through the generic proxy; TMA reads it through the
  // async proxy
  asm volatile("fence.proxy.async.global;" ::: "memory");
  __syncwarp();
}

// Asks L2 for the 128-byte lines of a tile's OT rows (pitch r) over
// columns [c0, min(c0 + CT, r)), on the producer warp's 32 lanes.
template <int CT>
__device__ __forceinline__ void prefetch_tile(const __nv_bfloat16* rows,
                                              int c0, int r) {
  constexpr int LINES = CT * 2 / 128 + 1;   // lines a row can touch
  const int last = min(c0 + CT, r) - 1;
  for (int u = threadIdx.x % 32; u < gwt::OT * LINES; u += 32) {
    const int c = min(c0 + (u % LINES) * 64, last);
    asm volatile("prefetch.global.L2 [%0];"
                 :: "l"(rows + (size_t)(u / LINES) * r + c));
  }
}

// The bf16 kernel's warps: the two consumer warpgroups, the producer warp,
// and a publisher warp that releases each finished out1 tile's flag.
constexpr int K3_THREADS = gwt::wide::THREADS + 32;

template <int CT>
__global__ void __launch_bounds__(K3_THREADS, gwt::wide::Tile<CT>::MIN_BLOCKS)
mix_flat2_bf16(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_o1, int x_tma,
               const __nv_bfloat16* __restrict__ x,
               const int* __restrict__ slot, const int* __restrict__ src,
               const int* __restrict__ row_ptr,
               const __nv_bfloat16* __restrict__ add, __nv_bfloat16* out1,
               __nv_bfloat16* __restrict__ out2, int* flags, int nb,
               int span, int r, int transpose_lhs) {
  using namespace gwt::wide;
  constexpr int bs = gwt::OT;
  constexpr int PRODUCER = CONSUMER_WARPS, PUBLISHER = CONSUMER_WARPS + 1;
  const int ntiles = (r + CT - 1) / CT;
  const bool fwd = transpose_lhs != 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The producer's queue of items to the consumer and publisher warps: two
  // slots, each with a full barrier (the producer's arrival) and an empty
  // one (every consumer warp's, and the publisher's once it has published
  // the slot's out1 tile; so the consumers run at most one hop-1 item
  // ahead of the publisher). stored: a consumer warp's arrival once its
  // part of a hop-1 tile is stored, two slots by the hop-1 items' order.
  __shared__ Item items[2];
  __shared__ uint64_t queued[2], taken[2], stored[2];
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) {
      bar_init(queued + q, 1);
      bar_init(taken + q, CONSUMER_WARPS + 1);
      bar_init(stored + q, CONSUMER_WARPS);
    }
  }
  Ring<CT> ring;                  // fences the barriers' init, syncs
  ring.base = setup_ring(Tile<CT>::STAGES, Tile<CT>::STAGE_BYTES, ring.full,
                         ring.empty);
  Cursor cur, queue, out;         // per role: the ring's, the queue's, stored's
  if (warp == PRODUCER) {
    for (bool first = true;; first = false) {
      int t = 0;
      if (lane == 0) t = next_ticket(flags + (size_t)nb * ntiles, first);
      Item it = item_of(__shfl_sync(0xffffffffu, t, 0), nb, ntiles, span);
      const int begin = it.rw < 0 ? 0 : row_ptr[it.rw];
      const int end = it.rw < 0 ? 0 : row_ptr[it.rw + 1];
      it.n = end - begin;
      if (lane == 0) {
        bar_wait(taken + queue.stage, queue.parity ^ 1);
        items[queue.stage] = it;
        bar_arrive(queued + queue.stage);
      }
      __syncwarp();
      queue.next<2>();
      if (it.rw < 0) return;
      const int c0 = it.tile * CT;
      if (it.hop == 0) {
        if (add != nullptr)
          prefetch_tile<CT>(add + (size_t)it.rw * bs * r, c0, r);
        const Operands op{&tm_a, x_tma ? &tm_x : nullptr, x, bs, bs, r, 0, c0,
                          fwd};
        produce<CT, false>(ring, op, slot, src, begin, end, AnyEntry{}, cur);
      } else {
        const Operands op{&tm_a, x_tma ? &tm_o1 : nullptr, out1, bs, bs, r, 0,
                          c0, fwd};
        wait_sources(flags, src, begin, end, ntiles, it.tile);
        produce<CT, true>(ring, op, slot, src, begin, end, AnyEntry{}, cur);
      }
    }
  }
  if (warp == PUBLISHER) {
    // a release waits for the tile's stores to reach L2; here it holds up
    // no consumer
    for (;;) {
      bar_wait(queued + queue.stage, queue.parity);
      const Item it = items[queue.stage];
      if (it.rw >= 0 && it.hop == 0) {
        bar_wait(stored + out.stage, out.parity);
        out.next<2>();
        if (lane == 0) publish(flags + (size_t)it.rw * ntiles + it.tile);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(taken + queue.stage);
      queue.next<2>();
      if (it.rw < 0) return;
    }
  }
  WideAcc<CT> acc;
  for (;;) {
    bar_wait(queued + queue.stage, queue.parity);
    const Item it = items[queue.stage];
    __syncwarp();
    if (lane == 0) bar_arrive(taken + queue.stage);
    queue.next<2>();
    if (it.rw < 0) return;
#pragma unroll
    for (int i = 0; i < CT / 2; ++i) acc[i] = 0.f;
    const int steps = it.n * (bs / KC);
    if (fwd)
      consume<CT, true>(ring, steps, acc, cur);
    else
      consume<CT, false>(ring, steps, acc, cur);
    const size_t at = (size_t)it.rw * bs * r;
    const int c0 = it.tile * CT;
    if (it.hop == 0) {
      if (add != nullptr)
        store_wide_sum<CT>(acc, out1 + at, add + at, 0, c0, r);
      else
        store_wide<CT>(acc, out1 + at, 0, c0, r);
      // other blocks' TMA reads the tile through the async proxy
      asm volatile("fence.proxy.async.global;" ::: "memory");
      __syncwarp();
      if (lane == 0) bar_arrive(stored + out.stage);
      out.next<2>();
    } else {
      store_wide<CT>(acc, out2 + at, 0, c0, r);
    }
  }
}

int launch_f32(const void* blocks, const void* slot, const void* x,
               const void* src, const void* row_ptr, const void* add,
               void* out1, void* out2, void* flags, int nb, int span, int r,
               int transpose_lhs, int grid, cudaStream_t stream) {
  mix_flat2_f32<<<grid, gwt::NTHREADS, 0, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(slot),
      static_cast<const float*>(x), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr), static_cast<const float*>(add),
      static_cast<float*>(out1), static_cast<float*>(out2),
      static_cast<int*>(flags), nb, span, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

template <int CT>
int launch_bf16(const void* blocks, const void* slot, const void* x,
                const void* src, const void* row_ptr, const void* add,
                void* out1, void* out2, void* flags, int nb, int n_blocks,
                int span, int r, int transpose_lhs, int grid,
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
  mix_flat2_bf16<CT><<<grid, K3_THREADS, Tile<CT>::SMEM, stream>>>(
      tm_a, tm_x, tm_o1, x_tma, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(slot), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr),
      static_cast<const __nv_bfloat16*>(add),
      static_cast<__nv_bfloat16*>(out1), static_cast<__nv_bfloat16*>(out2),
      static_cast<int*>(flags), nb, span, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d: dtype (0 = float32, ct must be 64; 1 = bfloat16, ct 64, 128 or 256),
// blocks, slot, x, src, row_ptr, add (0: none), out1, out2, flags, nb,
// n_blocks, span, bs, r, transpose_lhs, ct, grid. Square blocks of bs = 128
// rows, n_blocks of them. span: hop 2 of row i runs in the step of hop 1 of
// row i + span (lag <= span <= nb). grid: the persistent blocks, at least 1
// and at most the items and the blocks the card holds at once. flags:
// nb * ceil(r / ct) + 1 zeroed int32. Returns cudaGetLastError() after the
// launch.
extern "C" int gwt_mix_flat2(const long long* d, void* stream) {
  gwt::Desc a(d);
  const int dtype = a.i32();
  const void *blocks = a.ptr<const void>(), *slot = a.ptr<const void>(),
             *x = a.ptr<const void>(), *src = a.ptr<const void>(),
             *row_ptr = a.ptr<const void>(), *add = a.ptr<const void>();
  void *out1 = a.ptr<void>(), *out2 = a.ptr<void>(), *flags = a.ptr<void>();
  const int nb = a.i32(), n_blocks = a.i32(), span = a.i32(), bs = a.i32(),
            r = a.i32(), transpose_lhs = a.i32(), ct = a.i32(),
            grid = a.i32();
  auto s = static_cast<cudaStream_t>(stream);
  if (!a.ok() || bs != gwt::OT || span < 0 || span > nb || ct <= 0 ||
      grid <= 0)
    return gwt::BAD;
  // every block takes one ticket past the last item
  const long long tickets = 2LL * ((r + ct - 1) / ct) * nb + grid;
  if (grid > tickets - grid) return gwt::BAD;
  if (tickets > 0x7fffffffLL) return gwt::BAD;
  if (dtype == 0 && ct == gwt::CT)
    return launch_f32(blocks, slot, x, src, row_ptr, add, out1, out2, flags,
                      nb, span, r, transpose_lhs, grid, s);
  if (dtype != 1) return gwt::BAD;
  return gwt::wide::with_ct(ct, [&](auto c) {
    return launch_bf16<decltype(c)::value>(blocks, slot, x, src, row_ptr, add,
                                           out1, out2, flags, nb, n_blocks,
                                           span, r, transpose_lhs, grid, s);
  });
}

// d: dtype, ct, n (int*). Blocks of kernel 3 one SM holds at once for dtype
// and ct (the card's occupancy for the launch's threads and shared memory)
// into *n; stream unused.
extern "C" int gwt_mix_flat2_per_sm(const long long* d, void*) {
  gwt::Desc a(d);
  const int dtype = a.i32(), ct = a.i32();
  int* n = a.ptr<int>();
  if (!a.ok()) return gwt::BAD;
  if (dtype == 0 && ct == gwt::CT)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, mix_flat2_f32, gwt::NTHREADS, 0));
  if (dtype != 1) return gwt::BAD;
  return gwt::wide::with_ct(ct, [&](auto c) {
    constexpr int CT = decltype(c)::value;
    using gwt::wide::Tile;
    if (int rc = gwt::wide::allow_smem<CT>(mix_flat2_bf16<CT>)) return rc;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, mix_flat2_bf16<CT>, K3_THREADS, Tile<CT>::SMEM));
  });
}
