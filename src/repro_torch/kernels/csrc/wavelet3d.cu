// Multi-level separable 3D lifting wavelet transform of (B, n, n, n) float32
// blocks, forward and inverse, for Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/wavelet3d.py::wavelet3d_forward
// and ::wavelet3d_inverse (_call/_kernel).  Those write each 1D predict step
// as a dense banded matmul s @ P^T for the TPU's matrix unit; here each step
// is what it is, a 3-tap (w3ai) or 4-tap (w4i, w4l) stencil whose boundary
// rows use the one-sided weights of wavelets._predict_table.
//
// Design: one CTA per block.  The whole n^3 block lives in dynamic shared
// memory (132 KiB at n = 32 with the padded pitch below), loaded and stored
// with coalesced 16-byte vectors.  For each level and axis every thread takes
// whole lines of length c along that axis, reads the line into registers,
// lifts it, and writes [s | d] back in place; __syncthreads() separates the
// axis steps.  Rows are padded to a pitch of n + 1 floats so that lines along
// the contiguous axis, taken by neighbouring threads, fall in distinct banks.
//
// Each block is computed by one CTA alone, in a fixed order, so the output
// bits of a block do not depend on the batch size or on its neighbours.
//
// Bound: device-memory bytes.  A block reads and writes 4 n^3 bytes and does
// about 14 flops per element over all levels, far below the card's float32
// rate per byte.  The design keeps every intermediate level in shared memory,
// so the block crosses HBM exactly once each way.
//
// The predict weights come from the host (float32, level after level, row
// after row, `taps` per row); the stencil start of row i is
// clip(i - 1, 0, m - taps), the formula _predict_table uses, which the Python
// wrapper checks against the table before it builds the weights.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWeights = 128;  // (16 + 8 + 4) rows x 4 taps at n = 32

enum Kind { kW4i = 0, kW4l = 1, kW3ai = 2 };

template <int KIND>
struct Taps {
  static constexpr int value = KIND == kW3ai ? 3 : 4;
};

__host__ __device__ constexpr int tap_start(int i, int m, int taps) {
  return i - 1 < 0 ? 0 : (i - 1 > m - taps ? m - taps : i - 1);
}

// predicted odd value i = sum_j w[i, j] * s[start(i) + j], products rounded
// and summed left to right, as the plain version computes it
template <int KIND, int M>
__device__ __forceinline__ float predict(const float (&s)[M], const float* w,
                                         int i) {
  constexpr int T = Taps<KIND>::value;
  const int st = tap_start(i, M, T);
  float acc = __fmul_rn(w[i * T], s[st]);
#pragma unroll
  for (int j = 1; j < T; ++j) acc = __fadd_rn(acc, __fmul_rn(w[i * T + j], s[st + j]));
  return acc;
}

// forward step on one line of C values at p[0], p[stride], ...
template <int KIND, int C>
__device__ __forceinline__ void fwd_line(float* p, int stride, const float* w) {
  constexpr int M = C / 2;
  float s[M], d[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float e = p[(2 * i) * stride];
    const float o = p[(2 * i + 1) * stride];
    s[i] = KIND == kW3ai ? __fmul_rn(__fadd_rn(e, o), 0.5f) : e;
    d[i] = o;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = __fsub_rn(d[i], predict<KIND, M>(s, w, i));
  if (KIND == kW4l) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      s[i] = __fadd_rn(s[i], __fmul_rn(__fadd_rn(d[i > 0 ? i - 1 : 0], d[i]), 0.25f));
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    p[i * stride] = s[i];
    p[(M + i) * stride] = d[i];
  }
}

// inverse step on one line: [s | d] -> interleaved (e, o)
template <int KIND, int C>
__device__ __forceinline__ void inv_line(float* p, int stride, const float* w) {
  constexpr int M = C / 2;
  float s[M], d[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s[i] = p[i * stride];
    d[i] = p[(M + i) * stride];
  }
  if (KIND == kW4l) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      s[i] = __fsub_rn(s[i], __fmul_rn(__fadd_rn(d[i > 0 ? i - 1 : 0], d[i]), 0.25f));
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float o = __fadd_rn(d[i], predict<KIND, M>(s, w, i));
    d[i] = o;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float e = KIND == kW3ai ? __fsub_rn(__fmul_rn(2.0f, s[i]), d[i]) : s[i];
    p[(2 * i) * stride] = e;
    p[(2 * i + 1) * stride] = d[i];
  }
}

// one 1D step along `axis` (0, 1, 2 = the block's axes -3, -2, -1) over the
// c^3 corner; element (i, j, k) sits at (i * N + j) * P + k
template <int N, int KIND, bool INV, int C>
__device__ __forceinline__ void axis_step(float* sm, const float* w, int axis) {
  constexpr int P = N + 1;
  for (int l = threadIdx.x; l < C * C; l += blockDim.x) {
    const int a = l / C, b = l % C;
    float* p;
    int stride;
    if (axis == 0) {
      p = sm + a * P + b;
      stride = N * P;
    } else if (axis == 1) {
      p = sm + a * N * P + b;
      stride = P;
    } else {
      p = sm + (a * N + b) * P;
      stride = 1;
    }
    if (INV)
      inv_line<KIND, C>(p, stride, w);
    else
      fwd_line<KIND, C>(p, stride, w);
  }
}

template <int N, int KIND, bool INV, int C>
__device__ void level(float* sm, const float* w) {
  if (!INV) {
    axis_step<N, KIND, INV, C>(sm, w, 0);
    __syncthreads();
    axis_step<N, KIND, INV, C>(sm, w, 1);
    __syncthreads();
    axis_step<N, KIND, INV, C>(sm, w, 2);
    __syncthreads();
  } else {
    axis_step<N, KIND, INV, C>(sm, w, 2);
    __syncthreads();
    axis_step<N, KIND, INV, C>(sm, w, 1);
    __syncthreads();
    axis_step<N, KIND, INV, C>(sm, w, 0);
    __syncthreads();
  }
}

template <int N, int KIND, bool INV>
__device__ void level_at(float* sm, const float* w, int c) {
  // c is uniform over the CTA, so every thread reaches the same barriers
  if (c == 8) level<N, KIND, INV, 8>(sm, w);
  if constexpr (N >= 16) {
    if (c == 16) level<N, KIND, INV, 16>(sm, w);
  }
  if constexpr (N >= 32) {
    if (c == 32) level<N, KIND, INV, 32>(sm, w);
  }
}

template <int N, int KIND, bool INV>
__global__ void __launch_bounds__(kThreads)
wavelet3d_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float* __restrict__ wtab, int nw, int levels) {
  constexpr int P = N + 1;
  constexpr int T = Taps<KIND>::value;
  constexpr int NV = N * N * N / 4;  // float4 vectors per block
  extern __shared__ float smem[];
  float* sm = smem;
  float* w = smem + N * N * P;

  const size_t base = static_cast<size_t>(blockIdx.x) * N * N * N;
  const float4* src = reinterpret_cast<const float4*>(in + base);
  for (int v = threadIdx.x; v < NV; v += blockDim.x) {
    const float4 q = src[v];
    float* dst = sm + (v * 4 / N) * P + (v * 4) % N;
    dst[0] = q.x;
    dst[1] = q.y;
    dst[2] = q.z;
    dst[3] = q.w;
  }
  for (int i = threadIdx.x; i < nw; i += blockDim.x) w[i] = wtab[i];
  __syncthreads();

  int off[4] = {0, 0, 0, 0};  // first weight of each level
  for (int l = 1; l < levels; ++l) off[l] = off[l - 1] + ((N >> (l - 1)) / 2) * T;
  if (!INV) {
    for (int l = 0; l < levels; ++l) level_at<N, KIND, INV>(sm, w + off[l], N >> l);
  } else {
    for (int l = levels - 1; l >= 0; --l) level_at<N, KIND, INV>(sm, w + off[l], N >> l);
  }

  float4* dst = reinterpret_cast<float4*>(out + base);
  for (int v = threadIdx.x; v < NV; v += blockDim.x) {
    const float* q = sm + (v * 4 / N) * P + (v * 4) % N;
    dst[v] = make_float4(q[0], q[1], q[2], q[3]);
  }
}

template <int N, int KIND, bool INV>
cudaError_t launch(const float* in, float* out, const float* w, int nw,
                   long long nblocks, int levels, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(N) * N * (N + 1) + nw) * sizeof(float);
  // raise the instantiation's shared-memory limit to its largest launch, once
  // (a function-local static is initialized exactly once, thread-safely)
  static const cudaError_t attr = cudaFuncSetAttribute(
      wavelet3d_kernel<N, KIND, INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((static_cast<size_t>(N) * N * (N + 1) + kMaxWeights) * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  wavelet3d_kernel<N, KIND, INV><<<static_cast<unsigned>(nblocks), kThreads, smem, stream>>>(
      in, out, w, nw, levels);
  return cudaGetLastError();
}

template <int N, bool INV>
cudaError_t launch_kind(int kind, const float* in, float* out, const float* w,
                        int nw, long long nblocks, int levels, cudaStream_t stream) {
  switch (kind) {
    case kW4i: return launch<N, kW4i, INV>(in, out, w, nw, nblocks, levels, stream);
    case kW4l: return launch<N, kW4l, INV>(in, out, w, nw, nblocks, levels, stream);
    case kW3ai: return launch<N, kW3ai, INV>(in, out, w, nw, nblocks, levels, stream);
    default: return cudaErrorInvalidValue;
  }
}

int max_levels(int n) {
  int lv = 0;
  while (n >= 8) {
    n /= 2;
    ++lv;
  }
  return lv;
}

template <bool INV>
int run(const void* in, void* out, const void* w, int nw, long long nblocks,
        int n, int kind, int levels, void* stream) {
  if (nblocks < 1 || nblocks > 0x7fffffffLL || levels < 1 || levels > max_levels(n) ||
      nw < 1 || nw > kMaxWeights)
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(in);
  float* y = static_cast<float*>(out);
  const float* wt = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_kind<8, INV>(kind, x, y, wt, nw, nblocks, levels, st);
    case 16: return launch_kind<16, INV>(kind, x, y, wt, nw, nblocks, levels, st);
    case 32: return launch_kind<32, INV>(kind, x, y, wt, nw, nblocks, levels, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream`, does not
// synchronize, and returns cudaGetLastError() after the launch (0 = success).
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
