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
// blocks read once at small R. On an H100 80GB HBM3 at 700 W (PERF.md) bf16
// R = 3,072 takes 0.505 ms (bound 0.247 ms, BSR on the same live blocks
// 1.330 ms), dx at R = 1,536 0.281 ms, R = 32 0.051 ms.
//
// Design: kernel 1 over an implicit row pointer: row i's entries are
// i * MB .. i * MB + MB - 1. One thread block owns one (row, 128-row output
// tile, R tile), walks the row's slots in order, accumulates in registers
// and writes once. In bf16 the sentinels are filtered out of the producer's
// stream before they take a ring step (hopper_tile.cuh); in fp32 they are
// skipped around block_tile.cuh's FMA product. Live slots come first in
// each row and in the order of the flat form's entries, and the product is
// kernel 1's on tiles of the same shape, so the output is bitwise equal to
// kernel 1 on as_flat_pallas's tables in both orientations. Rows with no
// live slot come out zero.

#include "block_tile.cuh"
#include "entry.cuh"
#include "hopper_tile.cuh"

namespace {

struct LiveSlot {                 // a slot inside the blocks, a source in x
  int n_blocks, nbx;
  __device__ bool operator()(int k, int s) const {
    return k >= 0 && k < n_blocks && s >= 0 && s < nbx;
  }
};

__global__ void __launch_bounds__(gwt::NTHREADS, 2)
mix_padded_f32(const float* __restrict__ blocks, const int* __restrict__ slot,
               const float* __restrict__ x, const int* __restrict__ src,
               float* __restrict__ out, int mb, int n_blocks, int nbx, int bs,
               int r, int transpose_lhs) {
  __shared__ __align__(16) gwt::SmemF32 sm;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * gwt::CT;
  const int o0 = blockIdx.z * gwt::OT;
  const size_t blk_elems = (size_t)bs * bs;
  const LiveSlot live{n_blocks, nbx};
  gwt::Acc acc;
  gwt::zero_acc(acc);
  const size_t end = (size_t)(row + 1) * mb;
  for (size_t l = (size_t)row * mb; l < end; ++l) {
    const int k = slot[l], s = src[l];
    // a sentinel: the same test for every thread, so the block stays
    // together through entry_product's barriers
    if (!live(k, s)) continue;
    gwt::entry_product<false>(acc, sm, blocks + k * blk_elems,
                              x + (size_t)s * bs * r, bs, bs, o0, c0, r,
                              transpose_lhs != 0);
  }
  gwt::store_tile<float>(acc, out + (size_t)row * bs * r,
                         static_cast<const float*>(nullptr), o0, c0, r);
}

template <int CT>
__global__ void __launch_bounds__(gwt::wide::THREADS,
                                  gwt::wide::Tile<CT>::MIN_BLOCKS)
mix_padded_bf16(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_x, int x_tma,
                const __nv_bfloat16* __restrict__ x,
                const int* __restrict__ slot, const int* __restrict__ src,
                __nv_bfloat16* __restrict__ out, int mb, int n_blocks,
                int nbx, int bs, int r, int transpose_lhs) {
  using namespace gwt::wide;
  const int row = blockIdx.y;     // R tiles fastest: a row's tiles share
                                  // its blocks through L2
  const Operands op{&tm_a, x_tma ? &tm_x : nullptr, x, bs, bs, r,
                    static_cast<int>(blockIdx.z) * gwt::OT,
                    static_cast<int>(blockIdx.x) * CT, transpose_lhs != 0};
  WideAcc<CT> acc;
  if (!tile_product<CT, false>(acc, op, slot, src, row * mb, (row + 1) * mb,
                               LiveSlot{n_blocks, nbx}))
    return;
  store_wide<CT>(acc, out + (size_t)row * bs * r, op.o0, op.c0, r);
}

int launch_f32(const void* blocks, const void* slot, const void* x,
               const void* src, void* out, int nb, int mb, int n_blocks,
               int nbx, int bs, int r, int transpose_lhs,
               cudaStream_t stream) {
  dim3 grid(nb, (r + gwt::CT - 1) / gwt::CT, bs / gwt::OT);
  mix_padded_f32<<<grid, gwt::NTHREADS, 0, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(slot),
      static_cast<const float*>(x), static_cast<const int*>(src),
      static_cast<float*>(out), mb, n_blocks, nbx, bs, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

template <int CT>
int launch_bf16(const void* blocks, const void* slot, const void* x,
                const void* src, void* out, int nb, int mb, int n_blocks,
                int nbx, int bs, int r, int transpose_lhs,
                cudaStream_t stream) {
  using namespace gwt::wide;
  CUtensorMap tm_a, tm_x;
  if (!encode_blocks(&tm_a, blocks, n_blocks, bs, bs, transpose_lhs != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool x_tma = encode_rows(&tm_x, x, (uint64_t)nbx * bs, r, KC);
  if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid y
  if (int rc = allow_smem<CT>(mix_padded_bf16<CT>)) return rc;
  dim3 grid((r + CT - 1) / CT, nb, bs / gwt::OT);
  mix_padded_bf16<CT><<<grid, THREADS, Tile<CT>::SMEM, stream>>>(
      tm_a, tm_x, x_tma, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(slot), static_cast<const int*>(src),
      static_cast<__nv_bfloat16*>(out), mb, n_blocks, nbx, bs, r,
      transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d: dtype (0 = float32, ct must be 64; 1 = bfloat16, ct 64, 128 or 256;
// blocks, x and out), blocks, slot, x, src, out, nb, mb, n_blocks, nbx, bs,
// r, transpose_lhs, ct. blocks (n_blocks, bs, bs), x (nbx, bs, r), out (nb,
// bs, r) row-major; slot/src (nb * mb,) int32. bs % 128 == 0, nb >= 1,
// r >= 1. Returns cudaGetLastError() after the launch.
extern "C" int gwt_mix_padded(const long long* d, void* stream) {
  gwt::Desc a(d);
  const int dtype = a.i32();
  const void *blocks = a.ptr<const void>(), *slot = a.ptr<const void>(),
             *x = a.ptr<const void>(), *src = a.ptr<const void>();
  void* out = a.ptr<void>();
  const int nb = a.i32(), mb = a.i32(), n_blocks = a.i32(), nbx = a.i32(),
            bs = a.i32(), r = a.i32(), transpose_lhs = a.i32(), ct = a.i32();
  auto s = static_cast<cudaStream_t>(stream);
  if (!a.ok() || bs % gwt::OT || nb < 1 || r < 1) return gwt::BAD;
  if (dtype == 0 && ct == gwt::CT)
    return launch_f32(blocks, slot, x, src, out, nb, mb, n_blocks, nbx, bs,
                      r, transpose_lhs, s);
  if (dtype != 1) return gwt::BAD;
  return gwt::wide::with_ct(ct, [&](auto c) {
    return launch_bf16<decltype(c)::value>(blocks, slot, x, src, out, nb, mb,
                                           n_blocks, nbx, bs, r,
                                           transpose_lhs, s);
  });
}
