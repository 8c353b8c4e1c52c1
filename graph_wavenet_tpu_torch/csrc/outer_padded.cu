// Padded block-sparse weight cotangent (kernel 5) for sm_90a.
//
// Replaces: graph_wavenet_tpu/ops/pallas/block_diffusion.py,
//   gathered_block_outer (body _dblocks_kernel).
//
// Computes, for every slot (i, m) of a padded (NB, MB) forward table,
//   out[i, m] = x[src[i, m]] (BS, R) . g[i] (BS, R)^T          (BS, BS)
// contracted over R, in fp32, cast once to the output type (the blocks'
// storage type, fp32 or bf16): the padded hop's gradient with respect to
// its blocks. A sentinel slot (src outside x: the reference's zero
// block-row) reads nothing and stores exact zeros, so x is passed unpadded
// and the output, allocated uninitialised, is written everywhere.
//
// What bounds it: the output, NB * MB blocks of BS x BS written once (231 MB
// in fp32, 115 MB in bf16 at the 40,960-node city layout, sentinels
// included), and 2 * n_live * BS * BS * R operations for the live slots. At
// the last layer's R = 128 the writes bind; at the first layer's R = 1,536
// the operations do on paper (bf16: 0.123 ms), and moving each live slot's
// x and g tiles from L2 to its SM is this design's floor, as for kernel 2.
// On an H100 80GB HBM3 at 700 W (PERF.md), bf16: 0.26-0.35 ms at R = 1,536
// across runs (the product before, 1.02; torch.bmm on the live slots'
// gathered operands 0.81), 0.07-0.09 ms at R = 128 (bound 0.04).
//
// Design: kernel 2 with row = l / MB, on the same products (outer_flat.cu,
// hopper_outer.cuh): a thread block per (slot, output tile), the tile
// index fastest, R in a fixed order, no atomics, a repeat bit-identical.
// Sentinels leave the producer's stream: their consumers store zeros.
// Every live slot runs the tile product kernel 2 runs for its entry, so on
// as_flat_pallas's tables kernel 5 equals kernel 2 bit for bit.

#include "entry.cuh"
#include "hopper_outer.cuh"

namespace {

// Slot l: x block-row src[l] (a sentinel outside [0, nbx) gives zeros), g
// block-row l / mb, output block l.
struct PaddedJobs {
  const int* src;
  int mb, nbx;
  __device__ gwt::Job operator()(int l) const {
    const int s = src[l];
    return {s >= 0 && s < nbx ? s : -1, l / mb, l};
  }
};

}  // namespace

// d: dtype (0 = float32, 1 = bfloat16; x and g), x, g, src, out, out_dtype
// (likewise, for out), n_slots, mb, nbx, bs, r. x (nbx, bs, r), g (n_slots /
// mb, bs, r), out (n_slots, bs, bs) row-major; src (n_slots,) int32, slot l
// in row l / mb. bs % 128 == 0, n_slots >= 1, mb >= 1, r >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int gwt_outer_padded(const long long* d, void* stream) {
  gwt::Desc a(d);
  const int dtype = a.i32();
  const void *x = a.ptr<const void>(), *g = a.ptr<const void>(),
             *src = a.ptr<const void>();
  void* out = a.ptr<void>();
  const int out_dtype = a.i32(), n_slots = a.i32(), mb = a.i32(),
            nbx = a.i32(), bs = a.i32(), r = a.i32();
  if (!a.ok() || mb < 1 || n_slots % mb) return gwt::BAD;
  const PaddedJobs jobs{static_cast<const int*>(src), mb, nbx};
  return gwt::outer::launch(dtype, out_dtype, x, g, out, jobs, n_slots, nbx,
                            n_slots / mb, bs, bs, r,
                            static_cast<cudaStream_t>(stream));
}
