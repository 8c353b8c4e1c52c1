// Flat block-sparse weight cotangent (kernel 2) for sm_90a.
//
// Replaces: graph_wavenet_tpu/ops/pallas/block_diffusion.py,
//   gathered_block_outer_flat (body _dblocks_flat_kernel).
//
// Computes, for every entry l of a flat support's forward table,
//   out[l] = x[src[l]] (BSx, R) . g[row[l]] (BSg, R)^T      (BSx, BSg) fp32
// contracted over R, the per-entry weight cotangent of one hop (dummy
// entries included: the TPU kernel's contract). Given the table's storage
// slots, it writes in storage order instead: entry l's tile, cast once to
// the blocks' dtype, goes to out[slot[l]]; dummy entries (slot[l] ==
// zero_slot) are skipped without a load, and the zero slot's block is
// written as exact zeros. That is the TPU caller's gather by inv_slot and
// cast, bit for bit, with no per-entry fp32 buffer. Rectangular blocks
// (128 x 512) take four 128-column output tiles.
//
// What bounds it: 2 * Lt * BSx * BSg * R operations against x and g read
// once and the output written once. At the first layer's R = 1,536 the
// tensor cores bind on paper (0.124 ms for the 2,442 entries of the
// 40,960-node mask in bf16), but every entry moves its x and g tiles from
// L2 to its SM (1.92 GB a launch), which is the floor of this design; at
// the last layer's R = 128 the output writes bind. fp32 inputs run plain
// FMAs (held to 1e-5) on the 67 TFLOP/s rate. On an H100 80GB HBM3 at 700
// W (PERF.md), bf16 in storage order: 0.25 ms at R = 1,536 (per entry
// 0.28; the product before, 0.98; torch.bmm on gathered operands 0.86) and
// 0.06 ms at R = 128 (bound 0.03). The per-entry launch with the gather
// and cast after it took 0.59 ms.
//
// Design: the TPU grid walks R sequentially into a VMEM accumulator, one
// entry at a time. Here every (entry, output tile) is its own thread block;
// entries number in the thousands, enough to fill the 132 SMs, so R is not
// split. R is walked in a fixed order into registers and each tile is
// written once: no atomics, and the result is the same from run to run.
// bf16 runs hopper_outer.cuh's pipelined TMA + wgmma product (the tile
// index fastest, so a row's entries share g[row] in L2), fp32
// outer_tile.cuh's FMA product, both shared with the padded cotangent
// (kernel 5, outer_padded.cu).

#include "hopper_outer.cuh"

namespace {

// Per entry (slot null): job l writes block l. In storage order: job l <
// lt writes block slot[l] unless it is the zero slot (a dummy entry), and
// job lt writes the zero slot's zeros.
struct FlatJobs {
  const int* src;
  const int* row;
  const int* slot;
  int lt, zero_slot;
  __device__ gwt::Job operator()(int l) const {
    if (slot == nullptr) return {src[l], row[l], l};
    if (l == lt) return {-1, 0, zero_slot};
    const int k = slot[l];
    if (k == zero_slot) return {-1, 0, -1};
    return {src[l], row[l], k};
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and g); out_dtype likewise for out.
// x (nbx, bs_x, r) and g (nbg, bs_g, r) row-major; src/row (lt,) int32.
// slot null: out is (lt, bs_x, bs_g), per entry (out_dtype must be 0).
// Else slot (lt,) int32 and out (n_slots, bs_x, bs_g) in storage order, the
// zero slot n_slots - 1. bs_x % 128 == 0, bs_g % 64 == 0, lt >= 1, r >= 1.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int gwt_outer_flat(int dtype, const void* x, const void* g,
                              const void* src, const void* row,
                              const void* slot, void* out, int out_dtype,
                              int lt, int n_slots, int nbx, int nbg,
                              int bs_x, int bs_g, int r, void* stream) {
  if (lt < 1 || (slot == nullptr ? out_dtype != 0 : n_slots < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const FlatJobs jobs{static_cast<const int*>(src),
                      static_cast<const int*>(row),
                      static_cast<const int*>(slot), lt, n_slots - 1};
  return gwt::outer::launch(dtype, out_dtype, x, g, out, jobs,
                            lt + (slot != nullptr), nbx, nbg, bs_x, bs_g, r,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* gwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
