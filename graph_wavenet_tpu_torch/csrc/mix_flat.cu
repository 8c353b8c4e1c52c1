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
// bf16 the tensor cores' 989 TFLOP/s. At small R (batch 1, late layers)
// reading the blocks binds instead. On an H100 80GB HBM3 at 700 W (PERF.md)
// bf16 R = 3,072 takes 0.504 ms against a 0.247 ms bound and 1.564 ms for
// PyTorch's BSR product; dx at R = 1,536 0.283 ms; R = 32 0.040 ms.
//
// Design: the TPU grid walks the entry list in order and revisits one
// output tile across consecutive steps. On the card the mix is independent
// per destination row and per column of R, so one thread block owns one
// (destination row, 128-row output tile, R tile). It finds its entries
// through a CSR row pointer built on the host once per support, walks them
// in list order accumulating in registers, and writes once. Ragged R is
// masked in the kernel (no pad-to-128 copy). Rows without entries come out
// zero.
// - bf16: hopper_tile.cuh's pipelined product (TMA ring, wgmma, CT = 64,
//   128 or 256 columns by R), shared with kernels 3 and 4.
// - fp32: block_tile.cuh's FMA product on 64-column tiles.

#include "block_tile.cuh"
#include "entry.cuh"
#include "hopper_tile.cuh"

namespace {

__global__ void __launch_bounds__(gwt::NTHREADS, 2)
mix_flat_f32(const float* __restrict__ blocks, const int* __restrict__ slot,
             const float* __restrict__ x, const int* __restrict__ src,
             const int* __restrict__ row_ptr, float* __restrict__ out,
             int bs_c, int bs_o, int r, int transpose_lhs) {
  __shared__ __align__(16) gwt::SmemF32 sm;
  const int row = blockIdx.x;
  const int c0 = blockIdx.y * gwt::CT;
  const int o0 = blockIdx.z * gwt::OT;
  const size_t blk_elems = (size_t)bs_c * bs_o;
  gwt::Acc acc;
  gwt::zero_acc(acc);
  const int end = row_ptr[row + 1];
  for (int l = row_ptr[row]; l < end; ++l) {
    gwt::entry_product<false>(acc, sm, blocks + slot[l] * blk_elems,
                              x + (size_t)src[l] * bs_c * r, bs_c, bs_o, o0,
                              c0, r, transpose_lhs != 0);
  }
  gwt::store_tile<float>(acc, out + (size_t)row * bs_o * r,
                         static_cast<const float*>(nullptr), o0, c0, r);
}

template <int CT>
__global__ void __launch_bounds__(gwt::wide::THREADS,
                                  gwt::wide::Tile<CT>::MIN_BLOCKS)
mix_flat_bf16(const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_x, int x_tma,
              const __nv_bfloat16* __restrict__ x,
              const int* __restrict__ slot, const int* __restrict__ src,
              const int* __restrict__ row_ptr,
              __nv_bfloat16* __restrict__ out, int bs_a, int bs_c, int bs_o,
              int r, int transpose_lhs) {
  using namespace gwt::wide;
  const int row = blockIdx.y;     // R tiles fastest: a row's tiles share
                                  // its blocks through L2
  const Operands op{&tm_a, x_tma ? &tm_x : nullptr, x, bs_a, bs_c, r,
                    static_cast<int>(blockIdx.z) * gwt::OT,
                    static_cast<int>(blockIdx.x) * CT, transpose_lhs != 0};
  WideAcc<CT> acc;
  if (!tile_product<CT, false>(acc, op, slot, src, row_ptr[row],
                               row_ptr[row + 1], AnyEntry{}))
    return;
  store_wide<CT>(acc, out + (size_t)row * bs_o * r, op.o0, op.c0, r);
}

int launch_f32(const void* blocks, const void* slot, const void* x,
               const void* src, const void* row_ptr, void* out, int nb,
               int bs_c, int bs_o, int r, int transpose_lhs,
               cudaStream_t stream) {
  dim3 grid(nb, (r + gwt::CT - 1) / gwt::CT, bs_o / gwt::OT);
  mix_flat_f32<<<grid, gwt::NTHREADS, 0, stream>>>(
      static_cast<const float*>(blocks), static_cast<const int*>(slot),
      static_cast<const float*>(x), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr), static_cast<float*>(out), bs_c, bs_o,
      r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

template <int CT>
int launch_bf16(const void* blocks, const void* slot, const void* x,
                const void* src, const void* row_ptr, void* out, int nb,
                int n_blocks, int nbx, int bs_c, int bs_o, int r,
                int transpose_lhs, cudaStream_t stream) {
  using namespace gwt::wide;
  const bool fwd = transpose_lhs != 0;
  const int bs_a = fwd ? bs_c : bs_o, bs_b = fwd ? bs_o : bs_c;
  CUtensorMap tm_a, tm_x;
  if (!encode_blocks(&tm_a, blocks, n_blocks, bs_a, bs_b, fwd))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool x_tma = encode_rows(&tm_x, x, (uint64_t)nbx * bs_c, r, KC);
  if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid y
  if (int rc = allow_smem<CT>(mix_flat_bf16<CT>)) return rc;
  dim3 grid((r + CT - 1) / CT, nb, bs_o / gwt::OT);
  mix_flat_bf16<CT><<<grid, THREADS, Tile<CT>::SMEM, stream>>>(
      tm_a, tm_x, x_tma, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(slot), static_cast<const int*>(src),
      static_cast<const int*>(row_ptr), static_cast<__nv_bfloat16*>(out),
      bs_a, bs_c, bs_o, r, transpose_lhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d: dtype (0 = float32, ct must be 64; 1 = bfloat16, ct 64, 128 or 256),
// blocks, slot, x, src, row_ptr, out, nb, n_blocks, nbx, bs_c, bs_o, r,
// transpose_lhs, ct. blocks (n_blocks, bs_a, bs_b), x (nbx, bs_c, r), out
// (nb, bs_o, r). Returns cudaGetLastError() after the launch.
extern "C" int gwt_mix_flat(const long long* d, void* stream) {
  gwt::Desc a(d);
  const int dtype = a.i32();
  const void *blocks = a.ptr<const void>(), *slot = a.ptr<const void>(),
             *x = a.ptr<const void>(), *src = a.ptr<const void>(),
             *row_ptr = a.ptr<const void>();
  void* out = a.ptr<void>();
  const int nb = a.i32(), n_blocks = a.i32(), nbx = a.i32(), bs_c = a.i32(),
            bs_o = a.i32(), r = a.i32(), transpose_lhs = a.i32(),
            ct = a.i32();
  auto s = static_cast<cudaStream_t>(stream);
  if (!a.ok() || bs_o % gwt::OT) return gwt::BAD;
  if (dtype == 0 && ct == gwt::CT && bs_c % gwt::KC == 0)
    return launch_f32(blocks, slot, x, src, row_ptr, out, nb, bs_c, bs_o, r,
                      transpose_lhs, s);
  if (dtype != 1 || bs_c % gwt::wide::KC) return gwt::BAD;
  return gwt::wide::with_ct(ct, [&](auto c) {
    return launch_bf16<decltype(c)::value>(blocks, slot, x, src, row_ptr, out,
                                           nb, n_blocks, nbx, bs_c, bs_o, r,
                                           transpose_lhs, s);
  });
}
