// The tail of a Graph WaveNet layer for sm_90a: the dropout multiply, the
// residual add and BatchNorm over channels-last (B, T, N, C) bf16
// activations, forward and backward. A dense-ops kernel with no Pallas
// counterpart.
//
// Replaces: no TPU kernel. The JAX package leaves BatchNorm to XLA, which
// fuses it with the dropout multiply and the residual add around it. Before
// this kernel the port ran the tail as PyTorch passes: the multiply and the
// add in bf16, an fp32 copy, a mean pass, a squared-deviation pass, a
// four-op normalize and a cast, and autograd ran about 19 more passes
// backward over the fp32 copies it saved; some 230 bytes moved per (B, T,
// N, C) element.
//
// Computes, per channel c, over the n = B * T * N positions (times the
// ranks of a process group, whose sums the host all-reduces between the
// launches):
//   stats       x = bf16(bf16(h * drop) + res),  sum_x[c]
//   var         sum_sq[c] = sum (x - mean)^2      (two-pass, biased)
//   apply       y = bf16((x - mean) * inv * w + b),  inv = rsqrt(var + eps)
//   eval        y from h, drop and res in one pass (running statistics)
//   grad_reduce sum_g[c] = sum g,  sum_gx[c] = sum g * xhat
//   grad_apply  dx = bf16(w * inv * (g - sum_g / n - xhat * sum_gx / n)),
//               dres = dx,  dh = bf16(dx * drop)
// with xhat = (x - mean) * inv, every elementwise step in fp32 rounded as
// PyTorch's separate ops round it (no contraction into fused
// multiply-adds), so x is bit for bit the chain's and y and the gradients
// differ from it only in the order of the fp32 sums. drop and res may be
// absent; res and dres are views of the layer input's last T steps.
//
// What bounds it: bytes. Training moves ~33 bytes per element (forward: h,
// drop and res read and x written, x read twice more and y written;
// backward: g and x read to reduce, then g, x and drop read and dx and dh
// written) against the chain's ~230; an eval pass reads h and res and
// writes y, 6 bytes. A thread owns V consecutive channels of a row (16-byte
// loads where every view allows them, else V = 1); a block's rows stream
// through one (b, t) plane of nodes.
//
// Sums: each block reduces its threads' fp32 partials in shared memory in
// a fixed order and writes one partial per channel; bn_tail_finish sums
// the blocks' partials in a fixed order. No atomics: the shapes and the
// card's SM count fix the grid, so a step's sums, and a graphed step's
// replays, repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "entry.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int RED = 2048;  // shared floats per accumulator

// 16-byte lanes run at most 256 threads a block (the host's plan), which
// leaves the register allocator room for a thread's per-channel constants
template <int V>
constexpr int bound_threads() { return V == 8 ? 256 : MAX_THREADS; }

// a (B, T, N, C) view with a unit channel stride; p null: absent
struct View {
  __nv_bfloat16* p;
  long long s0, s1, s2;
};

struct Geo {
  int t, n, c;        // steps, nodes, channels
  int lanes, rows;    // threads across a row, rows a block covers at once
};

__device__ __forceinline__ long long at(const View& v, int b, int t, int n,
                                        int c) {
  return b * v.s0 + t * v.s1 + n * v.s2 + c;
}

__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const auto* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h2[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    f[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    auto* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h2[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(f[0]);
  }
}

template <int V>
__device__ __forceinline__ void load_channels(const float* src, int c0,
                                              float (&f)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = src[c0 + v];
}

// x = bf16(bf16(h * drop) + res), each step rounded as the chain rounds it
template <int V>
__device__ __forceinline__ void make_x(const View& h, const View& drop,
                                       const View& res, int b, int t, int n,
                                       int c0, float (&x)[V]) {
  load<V>(h.p + at(h, b, t, n, c0), x);
  if (drop.p) {
    float d[V];
    load<V>(drop.p + at(drop, b, t, n, c0), d);
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = round_bf(__fmul_rn(x[v], d[v]));
  }
  if (res.p) {
    float r[V];
    load<V>(res.p + at(res, b, t, n, c0), r);
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = round_bf(__fadd_rn(x[v], r[v]));
  }
}

// The block's K per-channel sums into part[block][K][C]: every thread's
// partials through shared memory, each channel's summed over the block's
// row slots in order.
template <int V, int K>
__device__ __forceinline__ void block_partials(const float (&acc)[K][V],
                                               const Geo& g, float* part) {
  __shared__ float red[K * RED];
  const int lane = threadIdx.x % g.lanes, r = threadIdx.x / g.lanes;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v)
      red[(k * g.rows + r) * g.c + lane * V + v] = acc[k][v];
  __syncthreads();
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  for (int j = threadIdx.x; j < K * g.c; j += blockDim.x) {
    const int k = j / g.c, c = j % g.c;
    float s = 0.f;
    for (int i = 0; i < g.rows; ++i) s += red[(k * g.rows + i) * g.c + c];
    part[blk * K * g.c + j] = s;
  }
}

// A block's plane (b, t) and its thread's first row and channel.
struct Slot {
  int b, t, n0, step, c0;
};

__device__ __forceinline__ Slot slot(const Geo& g, int V) {
  Slot s;
  s.b = blockIdx.y / g.t;
  s.t = blockIdx.y % g.t;
  s.n0 = blockIdx.x * g.rows + threadIdx.x / g.lanes;
  s.step = gridDim.x * g.rows;
  s.c0 = (threadIdx.x % g.lanes) * V;
  return s;
}

template <int V>
__global__ void __launch_bounds__(bound_threads<V>())
    bn_tail_stats(View h, View drop, View res, View x, Geo g, float* part) {
  const Slot s = slot(g, V);
  float acc[1][V] = {};
#pragma unroll 2
  for (int n = s.n0; n < g.n; n += s.step) {
    float v[V];
    make_x<V>(h, drop, res, s.b, s.t, n, s.c0, v);
    store<V>(x.p + at(x, s.b, s.t, n, s.c0), v);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[0][i] += v[i];
  }
  block_partials<V, 1>(acc, g, part);
}

template <int V>
__global__ void __launch_bounds__(bound_threads<V>())
    bn_tail_var(View x, const float* mean, Geo g, float* part) {
  const Slot s = slot(g, V);
  float m[V], acc[1][V] = {};
  load_channels<V>(mean, s.c0, m);
#pragma unroll 2
  for (int n = s.n0; n < g.n; n += s.step) {
    float v[V];
    load<V>(x.p + at(x, s.b, s.t, n, s.c0), v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = __fsub_rn(v[i], m[i]);
      acc[0][i] += __fmul_rn(d, d);
    }
  }
  block_partials<V, 1>(acc, g, part);
}

// y = bf16((x - mean) * inv * w + b); PARTS: x made from h, drop and res
template <int V, bool PARTS>
__global__ void __launch_bounds__(bound_threads<V>())
    bn_tail_apply(View h, View drop, View res, View x, View y,
                  const float* mean, const float* inv, const float* w,
                  const float* bias, Geo g) {
  const Slot s = slot(g, V);
  float m[V], k[V], wv[V], bv[V];
  load_channels<V>(mean, s.c0, m);
  load_channels<V>(inv, s.c0, k);
  load_channels<V>(w, s.c0, wv);
  load_channels<V>(bias, s.c0, bv);
#pragma unroll 2
  for (int n = s.n0; n < g.n; n += s.step) {
    float v[V];
    if constexpr (PARTS)
      make_x<V>(h, drop, res, s.b, s.t, n, s.c0, v);
    else
      load<V>(x.p + at(x, s.b, s.t, n, s.c0), v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[i], m[i]), k[i]), wv[i]), bv[i]);
    store<V>(y.p + at(y, s.b, s.t, n, s.c0), v);
  }
}

template <int V>
__global__ void __launch_bounds__(bound_threads<V>())
    bn_tail_grad_reduce(View gy, View x, const float* mean, const float* inv,
                        Geo g, float* part) {
  const Slot s = slot(g, V);
  float m[V], k[V], acc[2][V] = {};
  load_channels<V>(mean, s.c0, m);
  load_channels<V>(inv, s.c0, k);
#pragma unroll 2
  for (int n = s.n0; n < g.n; n += s.step) {
    float gv[V], xv[V];
    load<V>(gy.p + at(gy, s.b, s.t, n, s.c0), gv);
    load<V>(x.p + at(x, s.b, s.t, n, s.c0), xv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = __fmul_rn(__fsub_rn(xv[i], m[i]), k[i]);
      acc[0][i] += gv[i];
      acc[1][i] += __fmul_rn(gv[i], xh);
    }
  }
  block_partials<V, 2>(acc, g, part);
}

// dx = bf16(w * inv * (g - sums[0] / n - xhat * (sums[1] / n))) into dres
// (if present), dh = bf16(dx * drop) (dx without drop)
template <int V>
__global__ void __launch_bounds__(bound_threads<V>())
    bn_tail_grad_apply(View gy, View x, View drop, View dh, View dres,
                       const float* mean, const float* inv, const float* w,
                       const float* sums, float count, Geo g) {
  const Slot s = slot(g, V);
  float m[V], k[V], a[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = s.c0 + i;
    m[i] = mean[c];
    k[i] = inv[c];
    a[i] = __fdiv_rn(sums[c], count);
    q[i] = __fdiv_rn(sums[g.c + c], count);
  }
  float wk[V];
#pragma unroll
  for (int i = 0; i < V; ++i) wk[i] = __fmul_rn(w[s.c0 + i], k[i]);
#pragma unroll 2
  for (int n = s.n0; n < g.n; n += s.step) {
    float gv[V], xv[V];
    load<V>(gy.p + at(gy, s.b, s.t, n, s.c0), gv);
    load<V>(x.p + at(x, s.b, s.t, n, s.c0), xv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = __fmul_rn(__fsub_rn(xv[i], m[i]), k[i]);
      const float d = __fsub_rn(__fsub_rn(gv[i], a[i]), __fmul_rn(xh, q[i]));
      gv[i] = round_bf(__fmul_rn(wk[i], d));
    }
    if (dres.p) store<V>(dres.p + at(dres, s.b, s.t, n, s.c0), gv);
    if (drop.p) {
      float d[V];
      load<V>(drop.p + at(drop, s.b, s.t, n, s.c0), d);
#pragma unroll
      for (int i = 0; i < V; ++i) gv[i] = __fmul_rn(gv[i], d[i]);
    }
    store<V>(dh.p + at(dh, s.b, s.t, n, s.c0), gv);
  }
}

// out[j] = sum over the p blocks' partials part[i][j], in a fixed order
__global__ void bn_tail_finish(const float* part, int p, int k, float* out) {
  __shared__ float red[256];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < p; i += blockDim.x)
    s += part[(long long)i * k + j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = red[0];
}

// The shared head of every descriptor: b, t, n, c, vec, lanes, rows, gx.
struct Head {
  int b, vec, gx;
  Geo g;
  bool ok;
};

Head read_head(gwt::Desc& a) {
  Head h;
  h.b = a.i32();
  h.g.t = a.i32();
  h.g.n = a.i32();
  h.g.c = a.i32();
  h.vec = a.i32();
  h.g.lanes = a.i32();
  h.g.rows = a.i32();
  h.gx = a.i32();
  const long long planes = (long long)h.b * h.g.t;
  const long long threads = (long long)h.g.lanes * h.g.rows;
  h.ok = a.ok() && h.b > 0 && h.g.t > 0 && h.g.n > 0 &&
         (h.vec == 1 || h.vec == 8) &&
         (long long)h.g.lanes * h.vec == h.g.c && threads <= MAX_THREADS &&
         threads * h.vec <= RED && h.gx > 0 && planes <= 65535;
  return h;
}

View read_view(gwt::Desc& a) {
  View v;
  v.p = a.ptr<__nv_bfloat16>();
  v.s0 = a.i64();
  v.s1 = a.i64();
  v.s2 = a.i64();
  return v;
}

dim3 grid(const Head& h) { return dim3(h.gx, h.b * h.g.t); }

unsigned threads(const Head& h) { return h.g.lanes * h.g.rows; }

int finish(const float* part, const Head& h, int k, float* out,
           cudaStream_t s) {
  bn_tail_finish<<<k * h.g.c, 256, 0, s>>>(part, h.gx * h.b * h.g.t,
                                           k * h.g.c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry takes a descriptor (int64) that starts with the head b, t, n,
// c, vec (1 or 8 channels a thread), lanes (c / vec), rows, gx (blocks
// along the nodes of a (b, t) plane), then views as (ptr, s0, s1, s2) with
// ptr 0 for an absent one, then pointers to fp32 per-channel vectors. The
// host picks vec = 8 only where every view is 16-byte aligned with strides
// that are multiples of 8. part holds gx * b * t * K * c fp32 (K = 1, or 2
// for grad_reduce). Each returns cudaGetLastError() after its launches.

// head, h, drop, res, x, part, sum
extern "C" int gwt_bn_tail_stats(const long long* d, void* stream) {
  gwt::Desc a(d);
  const Head h = read_head(a);
  if (!h.ok) return gwt::BAD;
  const View hv = read_view(a), dv = read_view(a), rv = read_view(a),
             xv = read_view(a);
  float *part = a.ptr<float>(), *sum = a.ptr<float>();
  auto s = static_cast<cudaStream_t>(stream);
  if (h.vec == 8)
    bn_tail_stats<8><<<grid(h), threads(h), 0, s>>>(hv, dv, rv, xv, h.g,
                                                     part);
  else
    bn_tail_stats<1><<<grid(h), threads(h), 0, s>>>(hv, dv, rv, xv, h.g,
                                                     part);
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  return finish(part, h, 1, sum, s);
}

// head, x, mean, part, sum_sq
extern "C" int gwt_bn_tail_var(const long long* d, void* stream) {
  gwt::Desc a(d);
  const Head h = read_head(a);
  if (!h.ok) return gwt::BAD;
  const View xv = read_view(a);
  const float* mean = a.ptr<const float>();
  float *part = a.ptr<float>(), *out = a.ptr<float>();
  auto s = static_cast<cudaStream_t>(stream);
  if (h.vec == 8)
    bn_tail_var<8><<<grid(h), threads(h), 0, s>>>(xv, mean, h.g, part);
  else
    bn_tail_var<1><<<grid(h), threads(h), 0, s>>>(xv, mean, h.g, part);
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  return finish(part, h, 1, out, s);
}

// head, parts (1: x from h, drop and res; 0: x given), h, drop, res, x, y,
// mean, inv, w, bias
extern "C" int gwt_bn_tail_apply(const long long* d, void* stream) {
  gwt::Desc a(d);
  const Head h = read_head(a);
  if (!h.ok) return gwt::BAD;
  const bool parts = a.i64() != 0;
  const View hv = read_view(a), dv = read_view(a), rv = read_view(a),
             xv = read_view(a), yv = read_view(a);
  const float *mean = a.ptr<const float>(), *inv = a.ptr<const float>(),
              *w = a.ptr<const float>(), *bias = a.ptr<const float>();
  auto s = static_cast<cudaStream_t>(stream);
  if (h.vec == 8 && parts)
    bn_tail_apply<8, true><<<grid(h), threads(h), 0, s>>>(
        hv, dv, rv, xv, yv, mean, inv, w, bias, h.g);
  else if (h.vec == 8)
    bn_tail_apply<8, false><<<grid(h), threads(h), 0, s>>>(
        hv, dv, rv, xv, yv, mean, inv, w, bias, h.g);
  else if (parts)
    bn_tail_apply<1, true><<<grid(h), threads(h), 0, s>>>(
        hv, dv, rv, xv, yv, mean, inv, w, bias, h.g);
  else
    bn_tail_apply<1, false><<<grid(h), threads(h), 0, s>>>(
        hv, dv, rv, xv, yv, mean, inv, w, bias, h.g);
  return static_cast<int>(cudaGetLastError());
}

// head, g, x, mean, inv, part, sums (2, c)
extern "C" int gwt_bn_tail_grad_reduce(const long long* d, void* stream) {
  gwt::Desc a(d);
  const Head h = read_head(a);
  if (!h.ok) return gwt::BAD;
  const View gv = read_view(a), xv = read_view(a);
  const float *mean = a.ptr<const float>(), *inv = a.ptr<const float>();
  float *part = a.ptr<float>(), *sums = a.ptr<float>();
  auto s = static_cast<cudaStream_t>(stream);
  if (h.vec == 8)
    bn_tail_grad_reduce<8><<<grid(h), threads(h), 0, s>>>(gv, xv, mean, inv,
                                                          h.g, part);
  else
    bn_tail_grad_reduce<1><<<grid(h), threads(h), 0, s>>>(gv, xv, mean, inv,
                                                          h.g, part);
  if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  return finish(part, h, 2, sums, s);
}

// head, g, x, drop, dh, dres, mean, inv, w, sums (2, c), count
extern "C" int gwt_bn_tail_grad_apply(const long long* d, void* stream) {
  gwt::Desc a(d);
  const Head h = read_head(a);
  if (!h.ok) return gwt::BAD;
  const View gv = read_view(a), xv = read_view(a), dv = read_view(a),
             dhv = read_view(a), drv = read_view(a);
  const float *mean = a.ptr<const float>(), *inv = a.ptr<const float>(),
              *w = a.ptr<const float>(), *sums = a.ptr<const float>();
  const long long n = a.i64();
  if (n < 1) return gwt::BAD;
  const float count = static_cast<float>(n);
  auto s = static_cast<cudaStream_t>(stream);
  if (h.vec == 8)
    bn_tail_grad_apply<8><<<grid(h), threads(h), 0, s>>>(
        gv, xv, dv, dhv, drv, mean, inv, w, sums, count, h.g);
  else
    bn_tail_grad_apply<1><<<grid(h), threads(h), 0, s>>>(
        gv, xv, dv, dhv, drv, mean, inv, w, sums, count, h.g);
  return static_cast<int>(cudaGetLastError());
}
