// Channel projection (the model's 1x1 convs) for sm_90a: a dense-ops
// kernel with no Pallas counterpart.
//
// Replaces: no TPU kernel. The JAX package leaves its channel matmuls to
// XLA, which fuses the bias and the casts around them. Before this kernel
// the port ran each bf16 projection as five PyTorch passes (an fp32 copy of
// the input, an FFMA GEMM with fp32 output, the bias add, the cast back,
// and one fp32 add per further operand), and autograd saved the fp32
// copies and ran the same GEMMs backward.
//
// Computes, over rows m shared by K bf16 operands x_k (width C_k),
//   forward  y[m, :]   = bf16(sum_k x_k[m, :] @ W[:, cols_k]^T + b)
//   dgrad    dx_k[m, :] = bf16(g[m, :] @ W[:, cols_k])
//   wgrad    dW = bf16(sum_m g[m, :]^T x[m, :]),  db = sum_m g[m, :] (fp32)
// W is (F, sum C_k) bf16 (the conv weight's layout), b fp32. Products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators held
// in registers across every operand and every column chunk); the bias is
// added and the result cast once, in the epilogue. A bf16 x bf16 product
// is exact in fp32, so only the order of the fp32 sums differs from the
// fp32 GEMM chain. The forward and the dgrad are one kernel
// (chan_proj_kernel): J inputs summed into H outputs that split the output
// columns, forward J = K, H = 1, dgrad J = 1 (g), H = K (over W^T).
//
// Addressing: a row m is (o, i) = (m / I, m % I), and every operand and
// output has its own two element strides (so, si) for those levels with a
// unit channel stride. That reads the temporal conv's taps x[:, i*d :
// i*d + T_out] and the skip conv's last steps as views, and the sparse
// diffusion's node-leading hops (N, B*T, C) as (B*T, N, C) views (so = C,
// si = B*T*C), so its output comes out in (B, T, N, F). The dgrad writes
// each operand's gradient with the operand's own strides.
// Widths that are not a multiple of 8 (the start conv's 2 input channels,
// end_conv_2's 12 outputs) or unaligned views take element loads and
// stores; everything else moves 16 bytes a thread (cp.async, zero-filled
// past the edges). Column widths are padded to the tile in shared memory,
// never in device memory.
//
// What bounds it: at most 2 * F * C operations a row against 2 * (C + F)
// bytes, 16 to 170 operations a byte at the model's widths, below the
// card's ~295: memory binds every projection. The city step's diffusion
// projection (7 x 32 -> 32 over 1.97 M rows at the first layer) moves
// ~1 GB forward at 3.35 TB/s. So the design streams: a 128-row x 64-column
// output tile per 256-thread block, a 3-stage cp.async ring of 32-column
// chunks (one chunk per operand and 32 channels), three blocks an SM, and
// every byte read and written once per column tile (the skip and end
// convs' wider outputs re-read their inputs from L2). On an H100 80GB HBM3
// at 700 W (PERF.md) that diffusion projection takes 0.40 ms forward on
// row-major operands and 0.55 on the sparse path's (B*T, N, C) views
// against a 0.30 ms byte bound; the dgrad 0.69 / 0.81, the weight
// gradient 0.54; the fp32 chain took 5.0 ms forward.
//
// The weight gradient reduces over all rows: each block of
// chan_proj_wgrad owns a (WF f x 8192/WF c) tile of dW over one row range
// ("split") and writes fp32 partials; chan_proj_reduce sums the splits in
// a fixed order, casts dW once and writes db in fp32. No atomics, so the
// result is the same on every run. The bias's sum rides along as a column
// of ones after the last channel. A thread's x segments keep one column
// for the whole row range, so their operand and address are worked out
// once, not per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "entry.cuh"

namespace {

constexpr int MAXOP = 16;
constexpr int THREADS = 256;

// forward / dgrad tile
constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES;
constexpr int OUT_LD = BN * 2 + 16;  // staged output row, bytes (padded)
static_assert(BM * OUT_LD <= SMEM, "output staging fits the ring");

// weight-gradient tiles: WF f x (8192 / WF) c, WF = 32, 64 or 128 (the
// host picks the one that reads the fewest bytes), 32 rows a stage
constexpr int WK = 32, WSTAGES = 4;

template <int WF_>
struct WTile {
  static constexpr int F = WF_, C = 8192 / WF_;
  static constexpr int G_BYTES = WK * F * 2, X_BYTES = WK * C * 2;
  static constexpr int STAGE = G_BYTES + X_BYTES;
  static constexpr int SMEM = WSTAGES * STAGE;
  static constexpr int WARPS_F = F / 32;
};

// division by the rows' inner count without a divide: the quotient is
// umulhi(n, mul) >> shr for 0 <= n < 2^31 (round-up reciprocal)
struct Div {
  int d;
  unsigned mul, shr;
};

Div make_div(int d) {
  Div r{d, 0u, 0u};
  if (d != 1) {
    int l = 31 - __builtin_clz(static_cast<unsigned>(d));
    if (d & (d - 1)) ++l;
    const unsigned p = 31 + l;
    r.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    r.shr = p - 32;
  }
  return r;
}

__device__ __forceinline__ int div_rows(int n, const Div& v) {
  return v.d == 1 ? n : static_cast<int>(__umulhi(n, v.mul) >> v.shr);
}

struct In {
  const __nv_bfloat16* ptr;
  long long so, si;  // element strides of the (o, i) row levels
  int c;             // channels
  int koff;          // first column of W (forward) or of dW
  int q0;            // first chunk of this operand in the chunk list
  int vec;           // 16-byte loads of x
  int wvec;          // 16-byte loads of W's columns
};

struct Out {
  __nv_bfloat16* ptr;
  long long so, si;
  int n0;  // first output column
  int f;   // columns
  int vec;
};

struct Proj {
  In in[MAXOP];
  Out out[MAXOP];
  const __nv_bfloat16* w;  // (n, ktot) row-major
  const float* bias;       // (n,) or null
  Div inner;
  int n_in, n_out, m, n, ktot, n_chunks, n_tiles;
};

struct Grad {
  In in[MAXOP];
  const __nv_bfloat16* g;
  long long gso, gsi;
  float* part;  // (n_split, f, cext)
  Div inner;
  int n_in, m, f, ctot, cext, tiles_c, rows_per_split, gvec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t& r0,
                                      uint32_t& r1, uint32_t& r2,
                                      uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 from global by element loads, zero where !ok(e), into one
// 16-byte shared-memory slot
template <class Ok>
__device__ __forceinline__ void load8(char* dst,
                                      const unsigned short* src, Ok ok) {
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = ok(2 * e) ? src[2 * e] : 0u;
    const uint32_t hi = ok(2 * e + 1) ? src[2 * e + 1] : 0u;
    v[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// 64-byte rows of 4 chunks, chunk XOR (row / 2) % 4: ldmatrix's 8 rows
// hit 8 different bank groups
__device__ __forceinline__ int swz64(int row, int ch) {
  return row * 64 + ((ch ^ ((row >> 1) & 3)) << 4);
}

// rows of 64 bytes as swz64; wider rows, the chunk's low 3 bits XOR
// row % 8
template <int ROW_BYTES>
__device__ __forceinline__ int swz(int row, int ch) {
  if constexpr (ROW_BYTES == 64) return swz64(row, ch);
  return row * ROW_BYTES + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ int operand_of_chunk(const Proj& p, int q) {
  int j = 0;
  while (j + 1 < p.n_in && p.in[j + 1].q0 <= q) ++j;
  return j;
}

// chunk q of the row tile into one ring stage: x rows [m0, m0 + BM) and
// W rows [n0, n0 + BN), 32 columns of one operand
__device__ __forceinline__ void load_chunk(const Proj& p, int q, char* stage,
                                           const long long (&ro)[2],
                                           const long long (&ri)[2],
                                           const bool (&rok)[2], int n0) {
  const In& in = p.in[operand_of_chunk(p, q)];
  const int seg = threadIdx.x & 3;
  const int col = (q - in.q0) * BK + seg * 8;
  const uint32_t base = smem_u32(stage);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = (threadIdx.x >> 2) + s * 64;
    const int off = swz64(r, seg);
    const __nv_bfloat16* src = in.ptr + ro[s] * in.so + ri[s] * in.si + col;
    if (in.vec) {
      const bool ok = rok[s] && col < in.c;
      cp16(base + off, ok ? src : in.ptr, ok);
    } else {
      const bool row_ok = rok[s];
      const int left = in.c - col;
      load8(stage + off, reinterpret_cast<const unsigned short*>(src),
            [&](int e) { return row_ok && e < left; });
    }
  }
  const int rn = threadIdx.x >> 2;
  const int nn = n0 + rn;
  const int off = A_BYTES + swz64(rn, seg);
  const __nv_bfloat16* wsrc =
      p.w + (long long)(nn < p.n ? nn : 0) * p.ktot + in.koff + col;
  if (in.wvec) {
    const bool ok = nn < p.n && col < in.c;
    cp16(base + off, ok ? wsrc : p.w, ok);
  } else {
    const bool row_ok = nn < p.n;
    const int left = in.c - col;
    load8(stage + off, reinterpret_cast<const unsigned short*>(wsrc),
          [&](int e) { return row_ok && e < left; });
  }
}

// the warp's 32 x 32 slice of the tile over one 32-column chunk
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4],
                                          uint32_t sa, uint32_t sb, int wm,
                                          int wn, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + (lane & 15);
      ldsm4(sa + swz64(r, ks * 2 + (lane >> 4)), a[mi][0], a[mi][1],
            a[mi][2], a[mi][3]);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const int r = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldsm4(sb + swz64(r, ks * 2 + ((lane >> 3) & 1)), b[2 * nj][0],
            b[2 * nj][1], b[2 * nj + 1][0], b[2 * nj + 1][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

__device__ __forceinline__ int output_of_column(const Proj& p, int c) {
  int h = 0;
  while (h + 1 < p.n_out && p.out[h + 1].n0 <= c) ++h;
  return h;
}

__global__ void __launch_bounds__(THREADS, 3)
chan_proj_kernel(const __grid_constant__ Proj p) {
  __shared__ __align__(128) char smem[SMEM];
  const int m0 = (blockIdx.x / p.n_tiles) * BM;
  const int n0 = (blockIdx.x % p.n_tiles) * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;

  long long ro[2], ri[2];
  bool rok[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int m = m0 + (threadIdx.x >> 2) + s * 64;
    rok[s] = m < p.m;
    const int mm = rok[s] ? m : 0;
    ro[s] = div_rows(mm, p.inner);
    ri[s] = mm - ro[s] * p.inner.d;
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < p.n_chunks)
      load_chunk(p, s, smem + s * STAGE_BYTES, ro, ri, rok, n0);
    commit();
  }
  const uint32_t base = smem_u32(smem);
  for (int q = 0; q < p.n_chunks; ++q) {
    wait_groups<STAGES - 2>();
    __syncthreads();
    const int qn = q + STAGES - 1;
    if (qn < p.n_chunks)
      load_chunk(p, qn, smem + (qn % STAGES) * STAGE_BYTES, ro, ri, rok, n0);
    commit();
    const uint32_t st = base + (q % STAGES) * STAGE_BYTES;
    mma_chunk(acc, st, st + A_BYTES, wm, wn, lane);
  }
  wait_groups<0>();
  __syncthreads();

  // epilogue: + bias, one cast, staged in shared memory, then 16-byte
  // stores along each output row
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = wn * 32 + ni * 8 + 2 * t;
    const int n = n0 + col;
    const float b0 = (p.bias && n < p.n) ? p.bias[n] : 0.f;
    const float b1 = (p.bias && n + 1 < p.n) ? p.bias[n + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wm * 32 + mi * 16 + g + hh * 8;
        *reinterpret_cast<__nv_bfloat162*>(smem + row * OUT_LD + col * 2) =
            __floats2bfloat162_rn(acc[mi][ni][2 * hh] + b0,
                                  acc[mi][ni][2 * hh + 1] + b1);
      }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < BM * (BN / 8) / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int row = idx >> 3, seg = idx & 7;
    const int m = m0 + row;
    const int c0 = n0 + seg * 8;
    if (m >= p.m || c0 >= p.n) continue;
    const long long o = div_rows(m, p.inner), i = m - o * p.inner.d;
    const uint4 v =
        *reinterpret_cast<const uint4*>(smem + row * OUT_LD + seg * 16);
    const Out& out = p.out[output_of_column(p, c0)];
    const int local = c0 - out.n0;
    if (out.vec && local + 8 <= out.f) {
      *reinterpret_cast<uint4*>(out.ptr + o * out.so + i * out.si + local) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int k = 0; k < 8 && c0 + k < p.n; ++k) {
        const Out& ok = p.out[output_of_column(p, c0 + k)];
        ok.ptr[o * ok.so + i * ok.si + (c0 + k - ok.n0)] = e[k];
      }
    }
  }
}

__device__ __forceinline__ int operand_of_column(const Grad& p, int c) {
  int j = 0;
  while (j + 1 < p.n_in && p.in[j + 1].koff <= c) ++j;
  return j;
}

// A thread's x segments of the c-tile, fixed for the whole row range: the
// operand's address at the segment's column and its row strides, or null
// where the segment takes element loads (ragged or unaligned channels, an
// operand's edge, the bias's column of ones, past the channels).
template <class T>
struct XSlots {
  static constexpr int N = WK * T::C / 8 / THREADS;
  const __nv_bfloat16* ptr[N];
  long long so[N], si[N];
};

template <class T>
__device__ __forceinline__ void x_slots(const Grad& p, int c0,
                                        XSlots<T>& xs) {
#pragma unroll
  for (int k = 0; k < XSlots<T>::N; ++k) {
    const int c = c0 + ((threadIdx.x + k * THREADS) % (T::C / 8)) * 8;
    xs.ptr[k] = nullptr;
    xs.so[k] = xs.si[k] = 0;
    if (c < p.ctot) {
      const In& in = p.in[operand_of_column(p, c)];
      const int local = c - in.koff;
      if (in.vec && local % 8 == 0 && local + 8 <= in.c) {
        xs.ptr[k] = in.ptr + local;
        xs.so[k] = in.so;
        xs.si[k] = in.si;
      }
    }
  }
}

// rows [r0, r0 + WK) of g's f-tile and of x's c-tile into one stage; rows
// at or past r_end read zeros
template <class T>
__device__ __forceinline__ void load_rows(const Grad& p, const XSlots<T>& xs,
                                          char* stage, int r0, int r_end,
                                          int f0, int c0) {
  const uint32_t base = smem_u32(stage);
#pragma unroll
  for (int idx = threadIdx.x; idx < WK * T::F / 8; idx += THREADS) {
    const int r = idx / (T::F / 8), seg = idx % (T::F / 8);
    const int m = r0 + r;
    const bool row_ok = m < r_end;
    const int mm = row_ok ? m : 0;
    const long long o = div_rows(mm, p.inner), i = mm - o * p.inner.d;
    const int f = f0 + seg * 8;
    const __nv_bfloat16* src = p.g + o * p.gso + i * p.gsi + f;
    const int off = swz<T::F * 2>(r, seg);
    if (p.gvec) {
      const bool ok = row_ok && f < p.f;
      cp16(base + off, ok ? src : p.g, ok);
    } else {
      const int left = p.f - f;
      load8(stage + off, reinterpret_cast<const unsigned short*>(src),
            [&](int e) { return row_ok && e < left; });
    }
  }
#pragma unroll
  for (int k = 0; k < XSlots<T>::N; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int r = idx / (T::C / 8), seg = idx % (T::C / 8);
    const int m = r0 + r;
    const bool row_ok = m < r_end;
    const int mm = row_ok ? m : 0;
    const long long o = div_rows(mm, p.inner), i = mm - o * p.inner.d;
    const int c = c0 + seg * 8;
    const int off = T::G_BYTES + swz<T::C * 2>(r, seg);
    if (xs.ptr[k]) {
      cp16(base + off, xs.ptr[k] + o * xs.so[k] + i * xs.si[k], row_ok);
    } else if (c > p.ctot) {
      *reinterpret_cast<uint4*>(stage + off) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t pair = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ce = c + 2 * e + h;
          uint32_t bits = 0;
          if (row_ok && ce < p.ctot) {
            const In& ie = p.in[operand_of_column(p, ce)];
            bits = reinterpret_cast<const unsigned short*>(
                ie.ptr + o * ie.so + i * ie.si)[ce - ie.koff];
          } else if (row_ok && ce == p.ctot) {
            bits = 0x3F80u;  // bf16 1.0
          }
          pair |= bits << (16 * h);
        }
        v[e] = pair;
      }
      *reinterpret_cast<uint4*>(stage + off) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
chan_proj_wgrad(const __grid_constant__ Grad p) {
  extern __shared__ __align__(128) char smem[];
  const int tile = blockIdx.x, split = blockIdx.y;
  const int f0 = (tile / p.tiles_c) * T::F;
  const int c0 = (tile % p.tiles_c) * T::C;
  const int r_begin = split * p.rows_per_split;
  const int r_end = min(p.m, r_begin + p.rows_per_split);
  const int n_steps = r_end > r_begin ? (r_end - r_begin + WK - 1) / WK : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wf = warp % T::WARPS_F, wc = warp / T::WARPS_F;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  XSlots<T> xs;
  x_slots<T>(p, c0, xs);
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < n_steps)
      load_rows<T>(p, xs, smem + s * T::STAGE, r_begin + s * WK, r_end, f0,
                   c0);
    commit();
  }
  const uint32_t base = smem_u32(smem);
  for (int q = 0; q < n_steps; ++q) {
    wait_groups<WSTAGES - 2>();
    __syncthreads();
    const int qn = q + WSTAGES - 1;
    if (qn < n_steps)
      load_rows<T>(p, xs, smem + (qn % WSTAGES) * T::STAGE,
                   r_begin + qn * WK, r_end, f0, c0);
    commit();
    const uint32_t sg = base + (q % WSTAGES) * T::STAGE;
    const uint32_t sx = sg + T::G_BYTES;
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      uint32_t a[2][4], b[4][2];
      // A = g^T (f x rows): stored rows m, columns f, read transposed
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ch = (wf * 32 + mi * 16) / 8 + ((lane >> 3) & 1);
        ldsm4_t(sg + swz<T::F * 2>(r, ch), a[mi][0], a[mi][1], a[mi][2],
                a[mi][3]);
      }
      // B = x (rows x c): stored rows m, columns c, read transposed
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int r = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int ch = (wc * 32 + nj * 16) / 8 + (lane >> 4);
        ldsm4_t(sx + swz<T::C * 2>(r, ch), b[2 * nj][0], b[2 * nj][1],
                b[2 * nj + 1][0], b[2 * nj + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  wait_groups<0>();

  const int g = lane >> 2, t = lane & 3;
  float* part = p.part + (long long)split * p.f * p.cext;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + wf * 32 + mi * 16 + g + (e >> 1) * 8;
        const int c = c0 + wc * 32 + ni * 8 + 2 * t + (e & 1);
        if (f < p.f && c < p.cext)
          part[(long long)f * p.cext + c] = acc[mi][ni][e];
      }
}

// dW and db from the splits' partials, summed in split order
__global__ void __launch_bounds__(THREADS)
chan_proj_reduce(const float* __restrict__ part, int n_split, int f,
                 int ctot, int cext, __nv_bfloat16* __restrict__ dw,
                 float* __restrict__ db) {
  __shared__ float red[THREADS / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long total = (long long)f * cext;
  const long long e = (long long)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < total)
    for (int k = warp; k < n_split; k += THREADS / 32) s += part[k * total + e];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < total) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) sum += red[w][lane];
    const int fr = static_cast<int>(e / cext), c = static_cast<int>(e % cext);
    if (c < ctot)
      dw[(long long)fr * ctot + c] = __float2bfloat16_rn(sum);
    else
      db[fr] = sum;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool strides8(long long so, long long si) { return so % 8 == 0 && si % 8 == 0; }

// one operand from the descriptor: ptr, so, si, c, koff
In read_in(gwt::Desc& a, const void* w, int ktot) {
  In in;
  in.ptr = a.ptr<const __nv_bfloat16>();
  in.so = a.i64();
  in.si = a.i64();
  in.c = a.i32();
  in.koff = a.i32();
  in.q0 = 0;
  in.vec = in.c % 8 == 0 && strides8(in.so, in.si) && aligned16(in.ptr);
  in.wvec = w != nullptr && in.c % 8 == 0 && in.koff % 8 == 0 &&
            ktot % 8 == 0 && aligned16(w);
  return in;
}

template <class T>
int launch_wgrad(Grad& p, int n_split, cudaStream_t s) {
  // the 32-row tile's ring takes more than the default 48 KB
  if (cudaError_t rc = cudaFuncSetAttribute(
          chan_proj_wgrad<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          T::SMEM))
    return static_cast<int>(rc);
  p.tiles_c = (p.cext + T::C - 1) / T::C;
  const int tiles = ((p.f + T::F - 1) / T::F) * p.tiles_c;
  chan_proj_wgrad<T><<<dim3(tiles, n_split), THREADS, T::SMEM, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward or dgrad. d: n_in, n_out, m, inner, n, ktot, w, bias, then per
// input (ptr, so, si, c, koff), then per output (ptr, so, si, n0, f). W is
// (n, ktot) bf16 row-major; input j contracts with its columns [koff, koff +
// c); output h takes columns [n0, n0 + f) of the n. Returns
// cudaGetLastError() after the launch.
extern "C" int gwt_chan_proj(const long long* d, void* stream) {
  gwt::Desc a(d);
  Proj p;
  p.n_in = a.i32();
  p.n_out = a.i32();
  const long long m = a.i64();
  const int inner = a.i32();
  p.n = a.i32();
  p.ktot = a.i32();
  p.w = a.ptr<const __nv_bfloat16>();
  p.bias = a.ptr<const float>();
  if (!a.ok() || p.n_in < 1 || p.n_in > MAXOP || p.n_out < 1 ||
      p.n_out > MAXOP || m < 1 || m > 0x7fffffffLL || inner < 1 || p.n < 1)
    return gwt::BAD;
  p.m = static_cast<int>(m);
  p.inner = make_div(inner);
  int q = 0;
  for (int j = 0; j < p.n_in; ++j) {
    p.in[j] = read_in(a, p.w, p.ktot);
    p.in[j].q0 = q;
    q += (p.in[j].c + BK - 1) / BK;
  }
  p.n_chunks = q;
  for (int h = 0; h < p.n_out; ++h) {
    Out& o = p.out[h];
    o.ptr = a.ptr<__nv_bfloat16>();
    o.so = a.i64();
    o.si = a.i64();
    o.n0 = a.i32();
    o.f = a.i32();
    o.vec = o.f % 8 == 0 && o.n0 % 8 == 0 && strides8(o.so, o.si) &&
            aligned16(o.ptr);
  }
  if (!a.ok()) return gwt::BAD;
  p.n_tiles = (p.n + BN - 1) / BN;
  const long long blocks = ((m + BM - 1) / BM) * p.n_tiles;
  if (blocks > 0x7fffffffLL) return gwt::BAD;
  chan_proj_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Weight gradient. d: n_in, m, inner, f, ctot, n_split, wf (the tile's f
// rows: 32, 64 or 128), g, gso, gsi, part, dw, db, then per input (ptr, so,
// si, c, koff). part holds n_split * f * (ctot + 1) fp32; dw is (f, ctot)
// bf16, db (f,) fp32. Returns cudaGetLastError() after the two launches.
extern "C" int gwt_chan_proj_wgrad(const long long* d, void* stream) {
  gwt::Desc a(d);
  Grad p;
  p.n_in = a.i32();
  const long long m = a.i64();
  const int inner = a.i32();
  p.f = a.i32();
  p.ctot = a.i32();
  const int n_split = a.i32(), wf = a.i32();
  p.g = a.ptr<const __nv_bfloat16>();
  p.gso = a.i64();
  p.gsi = a.i64();
  p.part = a.ptr<float>();
  auto* dw = a.ptr<__nv_bfloat16>();
  auto* db = a.ptr<float>();
  if (!a.ok() || p.n_in < 1 || p.n_in > MAXOP || m < 1 || m > 0x7fffffffLL ||
      inner < 1 || p.f < 1 || p.ctot < 1 || n_split < 1 || n_split > 65535)
    return gwt::BAD;
  p.m = static_cast<int>(m);
  p.inner = make_div(inner);
  p.cext = p.ctot + 1;
  p.gvec = p.f % 8 == 0 && strides8(p.gso, p.gsi) && aligned16(p.g);
  for (int j = 0; j < p.n_in; ++j) p.in[j] = read_in(a, nullptr, 0);
  if (!a.ok()) return gwt::BAD;
  p.rows_per_split = static_cast<int>((m + n_split - 1) / n_split);
  auto s = static_cast<cudaStream_t>(stream);
  int rc = gwt::BAD;
  if (wf == 32) rc = launch_wgrad<WTile<32>>(p, n_split, s);
  if (wf == 64) rc = launch_wgrad<WTile<64>>(p, n_split, s);
  if (wf == 128) rc = launch_wgrad<WTile<128>>(p, n_split, s);
  if (rc) return rc;
  const long long total = (long long)p.f * p.cext;
  chan_proj_reduce<<<static_cast<unsigned>((total + 31) / 32), THREADS, 0,
                     s>>>(p.part, n_split, p.f, p.ctot, p.cext, dw, db);
  return static_cast<int>(cudaGetLastError());
}
