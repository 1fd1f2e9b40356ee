// Multi-level separable 3D lifting wavelet transform of (B, n, n, n) float32
// blocks, forward and inverse, for Hopper (sm_90a), for every power-of-two
// block side n >= 8.
//
// Replaces the Pallas kernels repro/kernels/wavelet3d.py::wavelet3d_forward
// and ::wavelet3d_inverse (_call/_kernel).  Those write each 1D predict step
// as a dense banded matmul s @ P^T for the TPU's matrix unit; here each step
// is what it is, a 3-tap (w3ai) or 4-tap (w4i, w4l) stencil whose boundary
// rows use the one-sided weights of wavelets._predict_table.
//
// Bound: device-memory bytes.  A block reads and writes 4 n^3 bytes and does
// about 14 flops per element over all levels, below the card's float32 rate
// per byte.  Every intermediate level stays on chip, so the block crosses
// HBM once each way.
//
// Dispatch by n (explicit; a failed launch raises on every n, nothing falls
// back):
//
// * n <= 64: the cluster kernel.  A block is held by a thread-block cluster
//   of K CTAs, each owning a slab of S = n / K planes along the block's
//   axis -3, loaded with 16-byte cp.async copies and stored with 16-byte
//   vectors; while one CTA lifts, the copies of the others on its SM are in
//   flight.  K by n, as measured on the H100:
//     n = 8, 16: K = 1 (3 and 20 KiB of shared memory): no line crosses a
//       CTA, and a 16^3 block in one CTA beat two slabs of 8 planes.
//     n = 32: K = 4, slabs of 8 planes, 36 KiB, six CTAs per SM.  A read
//       chunk of 32 blocks becomes 128 CTAs on 132 SMs.  Two slabs of 16
//       planes made the forward over a whole field faster and the inverse
//       over a chunk slower; the read path launches the inverse 128 times
//       for each forward, so K = 4 costs the main path less device time.
//     n = 64: K = 16, slabs of 4 planes, 69 KiB, three CTAs per SM (above
//       the portable 8, which Hopper grants on request).  Slabs of 8
//       planes, 137 KiB, leave one CTA per SM and nothing to overlap with;
//       they were slower.
//   Lines along the axes -2 and -1 lie inside a slab and are lifted by the
//   CTA that owns it.  Lines along axis -3 cross the slabs: the cluster's
//   threads share them out and read and write the sibling slabs through
//   distributed shared memory (map_shared_rank).  cluster.sync() separates
//   the axis steps that cross slabs; __syncthreads() the others.
//   Layout: rows of n floats at a pitch of n + 4 floats.  Every row starts
//   16-byte aligned, so cp.async lands 16-byte copies straight into it, and
//   lines along axis -1 are read and written as float4: the 8 threads of a
//   quarter-warp phase take 8 consecutive rows, whose starts fall in 8
//   distinct 16-byte bank groups.  Lines along the axes -2 and -3 are taken
//   column by column, consecutive threads on consecutive addresses: free of
//   conflicts while a warp spans one row (c >= 32), 2-way at c = 16, 4-way
//   at c = 8.  The pitch n + 1 would keep scalar row reads conflict-free
//   but rows would lose their 16-byte alignment, and the copies with it.
// * n >= 128: a 128^3 block is 8 MiB, far above a cluster's 16 x 227 KiB.
//   The staged kernel lifts one axis of one level per launch, through
//   global memory: one thread per line, the line staged in the thread's
//   own stretch of shared memory (3 c / 2 + 1 floats, an odd stride, so
//   threads never share a bank), outputs written back in place.  The host
//   launches it levels x 3 times, after one copy of the input into the
//   output.
//
// Arithmetic, the same in both kernels and in the plain version
// (repro_torch/core/wavelets.py): every multiply and add is an _rn
// intrinsic in the reference's order, so nothing is contracted into an FMA;
// the taps are summed left to right from +0.0, as XLA's reduction sums
// them; and subnormals are flushed explicitly, not by a compiler flag, as
// XLA's CPU backend flushes them: every operand and every result of the
// arithmetic becomes a zero of the same sign below the smallest normal
// float (flush(), below), while copies (a w4i coarse value passed on as it
// is) keep their bits.  This source needs no -ftz.
//
// Each block is computed by its own CTAs in a fixed order, so the output
// bits of a block do not depend on the batch size or on its neighbours.
//
// The predict weights come from the host (float32, normal or zero, level
// after level, row after row, `taps` per row); the stencil start of row i is
// clip(i - 1, 0, m - taps), the formula _predict_table uses, which the Python
// wrapper checks against the table before it builds the weights.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

enum Kind { kW4i = 0, kW4l = 1, kW3ai = 2 };

__host__ __device__ constexpr int taps_of(int kind) { return kind == kW3ai ? 3 : 4; }

template <int KIND>
struct Taps {
  static constexpr int value = taps_of(KIND);
};

__host__ __device__ constexpr int tap_start(int i, int m, int taps) {
  return i - 1 < 0 ? 0 : (i - 1 > m - taps ? m - taps : i - 1);
}

// v itself for every normal v, a zero of v's sign for a subnormal one: an
// add of -0.0 that reads its operand flushed (.ftz), exact for every v, one
// instruction where a compare and select take three
__device__ __forceinline__ float flush(float v) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, 0f80000000;" : "=f"(r) : "f"(v));
  return r;
}

// XLA's CPU arithmetic on operands that are already flushed: the rounded
// result, flushed
__device__ __forceinline__ float add(float a, float b) { return flush(__fadd_rn(a, b)); }
__device__ __forceinline__ float sub(float a, float b) { return flush(__fsub_rn(a, b)); }
__device__ __forceinline__ float mul(float a, float b) { return flush(__fmul_rn(a, b)); }

// predicted odd value i = sum_j w[i, j] * fs[start(i) + j]: the flushed
// products summed left to right from +0.0, as the plain version does
template <int KIND, class F>
__device__ __forceinline__ float predict(const F& fs, const float* w, int i, int m) {
  constexpr int T = Taps<KIND>::value;
  const int st = tap_start(i, m, T);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < T; ++j) acc = add(acc, mul(fs[st + j], w[i * T + j]));
  return acc;
}

// Forward step on one line of 2m values, held as s[i] = x[2i] and d[i] =
// x[2i + 1] as read; on exit s holds the coarse and d the detail values.
// fs is scratch for the flushed coarse values (w4i, w4l).  Once inlined
// with a constant m the loops unroll and the arrays live in registers.
template <int KIND, class S, class D, class F>
__device__ __forceinline__ void fwd_lift(S& s, D& d, F& fs, int m, const float* w) {
#pragma unroll
  for (int i = 0; i < m; ++i) {
    const float fo = flush(d[i]);
    if (KIND == kW3ai) s[i] = mul(add(flush(s[i]), fo), 0.5f);
    d[i] = fo;
  }
  if (KIND == kW3ai) {  // s is flushed already
#pragma unroll
    for (int i = 0; i < m; ++i) d[i] = sub(d[i], predict<KIND>(s, w, i, m));
  } else {  // s keeps the even samples' bits; the arithmetic reads them flushed
#pragma unroll
    for (int i = 0; i < m; ++i) fs[i] = flush(s[i]);
#pragma unroll
    for (int i = 0; i < m; ++i) d[i] = sub(d[i], predict<KIND>(fs, w, i, m));
  }
  if (KIND == kW4l) {
#pragma unroll
    for (int i = 0; i < m; ++i) s[i] = add(fs[i], mul(add(d[i > 0 ? i - 1 : 0], d[i]), 0.25f));
  }
}

// Inverse step: on entry s[i], d[i] = the coarse and detail values as read;
// on exit s[i] = x[2i] and d[i] = x[2i + 1]
template <int KIND, class S, class D, class F>
__device__ __forceinline__ void inv_lift(S& s, D& d, F& fs, int m, const float* w) {
#pragma unroll
  for (int i = 0; i < m; ++i) {
    d[i] = flush(d[i]);
    fs[i] = flush(s[i]);
  }
  if (KIND == kW4l) {
#pragma unroll
    for (int i = 0; i < m; ++i) {
      fs[i] = sub(fs[i], mul(add(d[i > 0 ? i - 1 : 0], d[i]), 0.25f));
      s[i] = fs[i];
    }
  }
#pragma unroll
  for (int i = 0; i < m; ++i) d[i] = add(d[i], predict<KIND>(fs, w, i, m));
  if (KIND == kW3ai) {
#pragma unroll
    for (int i = 0; i < m; ++i) s[i] = sub(mul(2.0f, fs[i]), d[i]);
  }
  // w4i: the even samples are the coarse values as read (a copy)
}

// One step on a line of C values, element i at p(i), in registers
template <int KIND, bool INV, int C, class Ptr>
__device__ __forceinline__ void lift_line(const Ptr& p, const float* w) {
  constexpr int M = C / 2;
  float s[M], d[M], fs[M];
  if (!INV) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s[i] = *p(2 * i);
      d[i] = *p(2 * i + 1);
    }
    fwd_lift<KIND>(s, d, fs, M, w);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      *p(i) = s[i];
      *p(M + i) = d[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s[i] = *p(i);
      d[i] = *p(M + i);
    }
    inv_lift<KIND>(s, d, fs, M, w);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      *p(2 * i) = s[i];
      *p(2 * i + 1) = d[i];
    }
  }
}

// The same on a contiguous, 16-byte aligned row, in float4 vectors
template <int KIND, bool INV, int C>
__device__ __forceinline__ void lift_row(float* row, const float* w) {
  constexpr int M = C / 2;
  float4* v = reinterpret_cast<float4*>(row);
  float s[M], d[M], fs[M];
  if (!INV) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 a = v[q];
      s[2 * q] = a.x;
      d[2 * q] = a.y;
      s[2 * q + 1] = a.z;
      d[2 * q + 1] = a.w;
    }
    fwd_lift<KIND>(s, d, fs, M, w);
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      v[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      v[M / 4 + q] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 a = v[q];
      const float4 b = v[M / 4 + q];
      s[4 * q] = a.x;
      s[4 * q + 1] = a.y;
      s[4 * q + 2] = a.z;
      s[4 * q + 3] = a.w;
      d[4 * q] = b.x;
      d[4 * q + 1] = b.y;
      d[4 * q + 2] = b.z;
      d[4 * q + 3] = b.w;
    }
    inv_lift<KIND>(s, d, fs, M, w);
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      v[q] = make_float4(s[2 * q], d[2 * q], s[2 * q + 1], d[2 * q + 1]);
  }
}

// ---------------------------------------------------------------------------
// The cluster kernel, n <= 64
// ---------------------------------------------------------------------------

template <int N>
struct Cluster {
  static constexpr int K = N <= 16 ? 1 : (N == 32 ? 4 : 16);  // CTAs per block
  static constexpr int S = N / K;            // planes per CTA
  static constexpr int P = N + 4;            // row pitch, floats
  static constexpr int PLANE = N * P;        // plane pitch, floats
  static constexpr int MAXW = 4 * (N - 4);   // weights of every level, 4 taps
  static constexpr int THREADS = N == 8 ? 64 : 128;
  static constexpr int MIN_BLOCKS = N == 64 ? 3 : 6;
  static constexpr size_t SMEM = (static_cast<size_t>(S) * PLANE + MAXW) * sizeof(float);
};

// Axis -3 at corner c: c^2 lines across the slabs, shared out over the
// cluster's threads; plane i of a line lies in CTA i / S, plane i % S
template <int N, int KIND, bool INV, int C>
__device__ __forceinline__ void cross_step(float* sm, const float* w, const cg::cluster_group& cl,
                                           int rank) {
  using G = Cluster<N>;
  for (int l = rank * G::THREADS + threadIdx.x; l < C * C; l += G::K * G::THREADS) {
    float* loc = sm + (l / C) * G::P + l % C;
    auto p = [&](int i) { return cl.map_shared_rank(loc, i / G::S) + (i % G::S) * G::PLANE; };
    lift_line<KIND, INV, C>(p, w);
  }
}

// Axis -2 (AXIS 1) or -1 (AXIS 2) at corner c, on the planes of this CTA's
// slab that lie in the corner
template <int N, int KIND, bool INV, int C, int AXIS>
__device__ __forceinline__ void slab_step(float* sm, const float* w, int rank) {
  using G = Cluster<N>;
  const int first = rank * G::S;
  const int planes = C <= first ? 0 : (C - first < G::S ? C - first : G::S);
  for (int l = threadIdx.x; l < planes * C; l += G::THREADS) {
    float* base = sm + (l / C) * G::PLANE;
    if (AXIS == 2) {
      lift_row<KIND, INV, C>(base + (l % C) * G::P, w);
    } else {
      float* col = base + l % C;
      auto p = [&](int i) { return col + i * G::P; };
      lift_line<KIND, INV, C>(p, w);
    }
  }
}

template <int N, int KIND, bool INV, int C>
__device__ void level(float* sm, const float* w, const cg::cluster_group& cl, int rank) {
  if (!INV) {
    cross_step<N, KIND, INV, C>(sm, w, cl, rank);
    cl.sync();
    slab_step<N, KIND, INV, C, 1>(sm, w, rank);
    __syncthreads();
    slab_step<N, KIND, INV, C, 2>(sm, w, rank);
    cl.sync();
  } else {
    slab_step<N, KIND, INV, C, 2>(sm, w, rank);
    __syncthreads();
    slab_step<N, KIND, INV, C, 1>(sm, w, rank);
    cl.sync();
    cross_step<N, KIND, INV, C>(sm, w, cl, rank);
    cl.sync();
  }
}

// c is uniform over the cluster, so every thread reaches the same barriers
template <int N, int KIND, bool INV, int C = N>
__device__ void level_at(float* sm, const float* w, const cg::cluster_group& cl, int rank,
                         int c) {
  if (c == C) {
    level<N, KIND, INV, C>(sm, w, cl, rank);
  } else if constexpr (C > 8) {
    level_at<N, KIND, INV, C / 2>(sm, w, cl, rank, c);
  }
}

template <int N, int KIND, bool INV>
__global__ void __launch_bounds__(Cluster<N>::THREADS, Cluster<N>::MIN_BLOCKS)
wavelet3d_cluster_kernel(const float* __restrict__ in, float* __restrict__ out,
                         const float* __restrict__ wtab, int nw, int levels) {
  using G = Cluster<N>;
  constexpr int T = Taps<KIND>::value;
  constexpr int ROW4 = N / 4;                // float4 vectors per row
  constexpr int NV = G::S * N * ROW4;        // float4 vectors per slab
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* w = sm + G::S * G::PLANE;
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());

  // this CTA's slab: planes rank * S .. rank * S + S - 1 of block blockIdx.x / K
  const size_t base = (static_cast<size_t>(blockIdx.x / G::K) * N + rank * G::S) * N * N;
  const float4* src = reinterpret_cast<const float4*>(in + base);
  for (int v = threadIdx.x; v < NV; v += G::THREADS)
    __pipeline_memcpy_async(sm + (v / ROW4) * G::P + (v % ROW4) * 4, src + v, sizeof(float4));
  __pipeline_commit();
  for (int i = threadIdx.x; i < nw; i += G::THREADS) w[i] = wtab[i];
  __pipeline_wait_prior(0);
  cl.sync();  // every slab of the cluster is in place before any is read

  if (!INV) {
    int off = 0;  // first weight of level l
    for (int l = 0; l < levels; ++l) {
      level_at<N, KIND, INV>(sm, w + off, cl, rank, N >> l);
      off += ((N >> l) / 2) * T;
    }
  } else {
    int off = nw;
    for (int l = levels - 1; l >= 0; --l) {
      off -= ((N >> l) / 2) * T;
      level_at<N, KIND, INV>(sm, w + off, cl, rank, N >> l);
    }
  }

  // the last cluster.sync() above ends every access to other CTAs' slabs
  float4* dst = reinterpret_cast<float4*>(out + base);
  for (int v = threadIdx.x; v < NV; v += G::THREADS)
    dst[v] = *reinterpret_cast<const float4*>(sm + (v / ROW4) * G::P + (v % ROW4) * 4);
}

template <int N, int KIND, bool INV>
cudaError_t launch_cluster(const float* in, float* out, const float* w, int nw,
                           long long nblocks, int levels, cudaStream_t stream) {
  using G = Cluster<N>;
  if (nw > G::MAXW || nblocks > 0x7fffffffLL / G::K) return cudaErrorInvalidValue;
  auto* kernel = wavelet3d_cluster_kernel<N, KIND, INV>;
  // a function-local static is initialized exactly once, thread-safely
  static const cudaError_t attr = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::SMEM));
    // K = 16 at n = 64: above the portable 8, which Hopper allows on request
    if (e == cudaSuccess && G::K > 8)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = G::K;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nblocks * G::K));
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, in, out, w, nw, levels);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The staged kernel, n >= 128: one axis of one level per launch
// ---------------------------------------------------------------------------

constexpr size_t kStagedSmem = 200 * 1024;

template <int KIND, bool INV>
__global__ void __launch_bounds__(128)
wavelet3d_staged_kernel(float* __restrict__ x, const float* __restrict__ w, long long nlines,
                        int n, int c, int axis) {
  extern __shared__ float4 smem[];
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= nlines) return;
  const int m = c / 2;
  float* s = reinterpret_cast<float*>(smem) + threadIdx.x * (3 * m + 1);
  float* d = s + m;
  float* fs = d + m;
  const long long cc = static_cast<long long>(c) * c;
  const long long nn = static_cast<long long>(n) * n;
  const long long b = l / cc;
  const int a = static_cast<int>((l % cc) / c), e = static_cast<int>(l % c);
  float* p = x + b * n * nn;
  long long stride;
  if (axis == 0) {  // (i, a, e)
    p += a * static_cast<long long>(n) + e;
    stride = nn;
  } else if (axis == 1) {  // (a, j, e)
    p += a * nn + e;
    stride = n;
  } else {  // (a, e, k)
    p += (a * static_cast<long long>(n) + e) * n;
    stride = 1;
  }
  if (!INV) {
    for (int i = 0; i < m; ++i) {
      s[i] = p[2 * i * stride];
      d[i] = p[(2 * i + 1) * stride];
    }
    fwd_lift<KIND>(s, d, fs, m, w);
    for (int i = 0; i < m; ++i) {
      p[i * stride] = s[i];
      p[(m + i) * stride] = d[i];
    }
  } else {
    for (int i = 0; i < m; ++i) {
      s[i] = p[i * stride];
      d[i] = p[(m + i) * stride];
    }
    inv_lift<KIND>(s, d, fs, m, w);
    for (int i = 0; i < m; ++i) {
      p[2 * i * stride] = s[i];
      p[(2 * i + 1) * stride] = d[i];
    }
  }
}

template <int KIND, bool INV>
cudaError_t launch_staged(const float* in, float* out, const float* w, int nw,
                          long long nblocks, int n, int levels, cudaStream_t stream) {
  auto* kernel = wavelet3d_staged_kernel<KIND, INV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kStagedSmem));
  if (attr != cudaSuccess) return attr;
  const size_t bytes = static_cast<size_t>(nblocks) * n * n * n * sizeof(float);
  cudaError_t err = cudaMemcpyAsync(out, in, bytes, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  constexpr int T = Taps<KIND>::value;
  for (int k = 0; k < levels; ++k) {
    const int l = INV ? levels - 1 - k : k;
    const int c = n >> l;
    int off = 0;
    for (int j = 0; j < l; ++j) off += ((n >> j) / 2) * T;
    const size_t per_thread = (3 * static_cast<size_t>(c / 2) + 1) * sizeof(float);
    unsigned threads = 128;
    while (threads > 1 && threads * per_thread > kStagedSmem) threads /= 2;
    if (threads * per_thread > kStagedSmem) return cudaErrorInvalidValue;
    const long long nlines = nblocks * c * static_cast<long long>(c);
    const long long grid = (nlines + threads - 1) / threads;
    if (grid > 0x7fffffffLL || off + (c / 2) * T > nw) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = threads * per_thread;
    cfg.stream = stream;
    for (int a = 0; a < 3; ++a) {
      const int axis = INV ? 2 - a : a;
      err = cudaLaunchKernelEx(&cfg, kernel, out, w + off, nlines, n, c, axis);
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

int max_levels(int n) {
  int lv = 0;
  while (n >= 8) {
    n /= 2;
    ++lv;
  }
  return lv;
}

long long weight_count(int n, int kind, int levels) {
  long long nw = 0;
  for (int l = 0; l < levels; ++l) nw += static_cast<long long>((n >> l) / 2) * taps_of(kind);
  return nw;
}

template <int KIND, bool INV>
cudaError_t dispatch(const float* in, float* out, const float* w, int nw, long long nblocks,
                     int n, int levels, cudaStream_t st) {
  switch (n) {
    case 8: return launch_cluster<8, KIND, INV>(in, out, w, nw, nblocks, levels, st);
    case 16: return launch_cluster<16, KIND, INV>(in, out, w, nw, nblocks, levels, st);
    case 32: return launch_cluster<32, KIND, INV>(in, out, w, nw, nblocks, levels, st);
    case 64: return launch_cluster<64, KIND, INV>(in, out, w, nw, nblocks, levels, st);
    default: return launch_staged<KIND, INV>(in, out, w, nw, nblocks, n, levels, st);
  }
}

template <bool INV>
int run(const void* in, void* out, const void* w, int nw, long long nblocks, int n, int kind,
        int levels, void* stream) {
  if (nblocks < 1 || n < 8 || (n & (n - 1)) != 0 || levels < 1 || levels > max_levels(n) ||
      kind < kW4i || kind > kW3ai || nw != weight_count(n, kind, levels))
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(in);
  float* y = static_cast<float*>(out);
  const float* wt = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kW4i: return dispatch<kW4i, INV>(x, y, wt, nw, nblocks, n, levels, st);
    case kW4l: return dispatch<kW4l, INV>(x, y, wt, nw, nblocks, n, levels, st);
    default: return dispatch<kW3ai, INV>(x, y, wt, nw, nblocks, n, levels, st);
  }
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream`, does not
// synchronize, and returns the first CUDA error of its launches (0 =
// success).
extern "C" int wavelet3d_forward_launch(const void* in, void* out, const void* w, int nw,
                                        long long nblocks, int n, int kind, int levels,
                                        void* stream) {
  return run<false>(in, out, w, nw, nblocks, n, kind, levels, stream);
}

extern "C" int wavelet3d_inverse_launch(const void* in, void* out, const void* w, int nw,
                                        long long nblocks, int n, int kind, int levels,
                                        void* stream) {
  return run<true>(in, out, w, nw, nblocks, n, kind, levels, stream);
}

extern "C" const char* wavelet3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
