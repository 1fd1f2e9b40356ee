// Lorenzo encode and decode of (B, n, n, n) blocks, for Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/lorenzo.py::
// lorenzo_encode_pallas (_enc_kernel) and ::lorenzo_decode_pallas
// (_dec_kernel).  Encode: compensated dual quantization of float32 x onto
// the 2 eps grid,
//   q0 = rint(x * inv);  err = x - q0 * two;  q = int32(q0 + rint(err * inv)),
// then the 3D Lorenzo residual, three first differences with a zero prepend
// along the axes -3, -2, -1.  Decode: three inclusive prefix sums along
// -1, -2, -3, then float(q) * two.  inv = 1/(2 eps) and two = 2 eps come
// from the wrapper as float32 (repro_torch/core/szx.py::grid).
//
// Design.  Encode: one thread per column (b, :, j, k) walks i = 0 .. n-1.
// The residual at (i, j, k) is the signed sum of q over the 2x2x2 corner
// below it (q = 0 outside the block); the thread quantizes the four values
// (i, j|j-1, k|k-1) of plane i, keeps their signed sum D(i) in a register,
// and writes D(i) - D(i-1).  The quantizer is deterministic, so quantizing a
// neighbour's value again gives the neighbour's q exactly; neighbouring
// threads read neighbouring addresses, and L1 serves the re-reads.
// Decode: three passes through global memory, one thread per line along
// the axis of the pass: along -1 from the residuals into the output buffer,
// along -2 in place, then along -3 in place ending with the product.  Each
// thread reads its line in batches of 8 loads issued together.  Lines are
// independent and nothing is held on chip, so any n >= 1 works, n = 64
// (a 1 MiB block) included.  The sums wrap mod 2^32, so the order of the
// passes and of the additions does not change a bit.
//
// Bound: device-memory bytes, 4 read and 4 written per element.  Encode does
// four quantizations (about 7 operations each) per element; decode adds.
//
// Bit-exact against the plain version, and so against the reference on the
// CPU, whose float semantics are XLA's:
//   * err is one FMA (__fmaf_rn), rounded once: XLA fuses x - q0 * two so.
//   * every multiply and add is an explicit _rn intrinsic, so the compiler
//     contracts nothing else into an FMA.
//   * rintf rounds half to even, as jnp.round does.
//   * the correction is added in float32 (__fadd_rn), not in int32: past
//     |q0| = 2^24 the sum rounds, and the reference keeps that rounding.
//   * __float2int_rn saturates and maps NaN to 0, as XLA's convert does.
//   * Subnormals are flushed explicitly, not by compiler flags: inputs and
//     every product and result below the smallest normal float become a
//     zero of the same sign.  This source needs no -ftz.
//   * int32 adds and subtracts are done in uint32 (two's complement wrap,
//     no undefined overflow).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 8;  // loads in flight per thread in a decode pass
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

// q of one value, as repro_torch/core/szx.py::quantize
__device__ __forceinline__ uint32_t quantize(float x, float inv, float two) {
  x = flush(x);
  const float q0 = rintf(flush(__fmul_rn(x, inv)));
  const float err = flush(__fmaf_rn(-q0, two, x));
  const float q = __fadd_rn(q0, rintf(flush(__fmul_rn(err, inv))));
  return static_cast<uint32_t>(__float2int_rn(q));
}

// thread g of B n^2 -> (b, j, k), as the offset of (b, 0, j, k)
__device__ __forceinline__ long long column_origin(long long g, int n) {
  const long long nn = static_cast<long long>(n) * n;
  const long long b = g / nn;
  return b * n * nn + (g - b * nn);
}

__global__ void __launch_bounds__(kThreads)
lorenzo_encode_kernel(const float* __restrict__ x, int32_t* __restrict__ r,
                      long long ncols, int n, float inv, float two) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= ncols) return;
  const long long nn = static_cast<long long>(n) * n;
  const int jk = static_cast<int>(g % nn);
  const bool has_j = jk >= n, has_k = jk % n != 0;
  const long long base = column_origin(g, n);
  const float* p = x + base;
  int32_t* o = r + base;
  uint32_t prev = 0;  // D(i - 1), 0 before the block
#pragma unroll 4
  for (int i = 0; i < n; ++i, p += nn, o += nn) {
    uint32_t d = quantize(p[0], inv, two);
    if (has_k) d -= quantize(p[-1], inv, two);
    if (has_j) d -= quantize(p[-n], inv, two);
    if (has_j && has_k) d += quantize(p[-n - 1], inv, two);
    *o = static_cast<int32_t>(d - prev);
    prev = d;
  }
}

// Inclusive prefix sum of one line of n int32 at `stride`, read from `src`
// and written by `store(address in dst, sum)`; src and dst may be the same
// line.  The line goes in batches of kBatch: each batch's loads are issued
// together, before its stores, so a thread has kBatch loads in flight
// rather than one (the compiler cannot hoist a load above a store to the
// same buffer by itself).
template <typename Store>
__device__ __forceinline__ void scan_line(const int32_t* src, int32_t* dst, long long stride,
                                          int n, Store store) {
  uint32_t s = 0;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = i0 + u < n ? static_cast<uint32_t>(src[(i0 + u) * stride]) : 0u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u < n) {
        s += v[u];
        store(dst + (i0 + u) * stride, s);
      }
    }
  }
}

struct StoreInt {
  __device__ void operator()(int32_t* p, uint32_t s) const { *p = static_cast<int32_t>(s); }
};

// float(q) * two, flushed, stored as its bits in the int32 buffer
struct StoreDequantized {
  float two;
  __device__ void operator()(int32_t* p, uint32_t s) const {
    *p = __float_as_int(flush(__fmul_rn(__int2float_rn(static_cast<int32_t>(s)), two)));
  }
};

// pass 1, along -1, residuals -> out: thread g owns the row starting at g n
__global__ void __launch_bounds__(kThreads)
lorenzo_decode_scan_k(const int32_t* __restrict__ res, int32_t* __restrict__ out,
                      long long nrows, int n) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= nrows) return;
  scan_line(res + g * n, out + g * n, 1, n, StoreInt{});
}

// pass 2, along -2, in place: thread g owns (plane g / n, k = g % n)
__global__ void __launch_bounds__(kThreads)
lorenzo_decode_scan_j(int32_t* buf, long long nlines, int n) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= nlines) return;
  const long long plane = g / n;
  int32_t* p = buf + plane * n * n + (g - plane * n);
  scan_line(p, p, n, n, StoreInt{});
}

// pass 3, along -3, in place, ending with float(q) * two: thread g owns the
// column (b, :, j, k)
__global__ void __launch_bounds__(kThreads)
lorenzo_decode_scan_i(int32_t* buf, long long ncols, int n, float two) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= ncols) return;
  int32_t* p = buf + column_origin(g, n);
  scan_line(p, p, static_cast<long long>(n) * n, n, StoreDequantized{two});
}

// lines of n elements in a batch (B n^2), or -1 if the shape is not one the
// kernels take
long long line_count(long long nblocks, int n) {
  if (nblocks < 1 || n < 1) return -1;
  const long long lines = nblocks * n * n;
  if ((lines + kThreads - 1) / kThreads > 0x7fffffffLL) return -1;
  return lines;
}

unsigned grid_of(long long lines) {
  return static_cast<unsigned>((lines + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream`, does not
// synchronize, and returns cudaGetLastError() after its launches
// (0 = success).
extern "C" int lorenzo_encode_launch(const void* x, void* r, long long nblocks, int n,
                                     float inv, float two, void* stream) {
  const long long lines = line_count(nblocks, n);
  if (lines < 0) return cudaErrorInvalidValue;
  lorenzo_encode_kernel<<<grid_of(lines), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(r), lines, n, inv, two);
  return cudaGetLastError();
}

// `out` is float32 (B, n, n, n); the first two passes keep their int32
// partial sums in it
extern "C" int lorenzo_decode_launch(const void* res, void* out, long long nblocks, int n,
                                     float two, void* stream) {
  const long long lines = line_count(nblocks, n);
  if (lines < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* buf = static_cast<int32_t*>(out);
  lorenzo_decode_scan_k<<<grid_of(lines), kThreads, 0, s>>>(
      static_cast<const int32_t*>(res), buf, lines, n);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  lorenzo_decode_scan_j<<<grid_of(lines), kThreads, 0, s>>>(buf, lines, n);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  lorenzo_decode_scan_i<<<grid_of(lines), kThreads, 0, s>>>(buf, lines, n, two);
  return cudaGetLastError();
}

extern "C" const char* lorenzo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
