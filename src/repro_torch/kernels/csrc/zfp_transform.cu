// zfpx encode and decode of (B, n, n, n) float32 blocks in 4^3 cells, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels repro/kernels/zfp_transform.py::
// zfpx_encode_pallas (_encode_kernel) and ::zfpx_decode_pallas
// (_decode_kernel).  Encode, per cell: emax = the frexp exponent of the
// cell's max |x| (-127 for a zero cell), q = round(x * 2^(28 - emax)) as
// int32, the ZFP integer lifting along the three axes, the total-sequency
// reorder, and the plane truncation (q >> p) << p with
// p = clip(floor(log2 eps) - (emax - 28) - 2, 0, 31).  Decode inverts it:
// inverse reorder, inverse lifting along the axes -1, -2, -3, times
// 2^(emax - 28), zero cells -> 0.
//
// Design: one thread per cell.  Cells are independent, so nothing needs a
// whole block on chip and any n % 4 == 0 works (64 included).  A thread
// loads its cell as 16 rows of 4 floats (float4: a row is 16-byte aligned
// because n % 4 == 0), holds the 64 values in registers, and runs the
// lifting and the permutation unrolled at compile time, so every index is a
// constant and nothing spills to local memory.  The 256-byte q row of each
// cell is staged through shared memory (pitch 68 int32, so 16-byte accesses
// of 8 neighbouring threads fall in distinct banks) and leaves the CTA as
// one contiguous, coalesced run of 128 cells; decode stages its input the
// same way.
//
// Bound: device-memory bytes.  Encode reads 4 bytes and writes 4 bytes of q
// per element, plus 4 bytes of emax per 64 elements, for about 20 integer
// and float operations per element.
//
// Bit-exact against the reference on the CPU, whose float semantics are
// XLA's (repro_torch/core/zfpx.py says the same of the plain version):
//   * Subnormals are flushed explicitly, not by compiler flags: inputs
//     below the smallest normal float read as 0, and decoded values below
//     it become a zero of the same sign.  This source needs no -ftz.
//   * The scale 2^k is looked up in the float32 table the wrapper passes
//     (k = -127 .. 128, index k + 127): the reference's exp2 of an integer
//     is not exact (XLA evaluates it as exp(k ln 2)), and the table holds
//     its values, 0 below the normal range and inf at 128.
//   * __float2int_rn rounds half to even, saturates, and maps NaN to 0,
//     exactly as XLA's round-then-convert does.
//   * int32 adds, subtracts and left shifts are done in uint32 (two's
//     complement wrap, no undefined overflow); right shifts are arithmetic.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kThreads = 128;  // cells per CTA, one thread each
constexpr int kPitch = 68;     // int32 per staged q row (64 + 4 of padding)
constexpr int kScaleBits = 28;
constexpr int kGuardBits = 2;
constexpr int kZeroEmax = -127;
constexpr int kExp2Min = -127;  // the scale table holds 2^k for k = -127 .. 128
constexpr int kExp2Max = 128;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32

struct Perm {
  int v[64];
};

// total-sequency order of a cell's 64 coefficients, as
// repro_torch/core/zfpx.py::sequency_perm (np.lexsort by i + j + k, then i,
// j, k): sequency slot s holds coefficient v[s] = 16 i + 4 j + k
__host__ __device__ constexpr Perm sequency_perm() {
  Perm p{};
  int s = 0;
  for (int t = 0; t <= 9; ++t)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int k = t - i - j;
        if (k >= 0 && k < 4) p.v[s++] = 16 * i + 4 * j + k;
      }
  return p;
}

template <int S>
struct SeqPerm {
  static constexpr int value = sequency_perm().v[S];
};

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t shl(int32_t a, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) << s);
}

// ZFP forward lifting of one 4-vector (repro/core/zfpx.py::_lift4)
__device__ __forceinline__ void lift4(int32_t& x, int32_t& y, int32_t& z, int32_t& w) {
  x = add(x, w); x >>= 1; w = sub(w, x);
  z = add(z, y); z >>= 1; y = sub(y, z);
  x = add(x, z); x >>= 1; z = sub(z, x);
  w = add(w, y); w >>= 1; y = sub(y, w);
  w = add(w, y >> 1); y = sub(y, w >> 1);
}

// its inverse (repro/core/zfpx.py::_unlift4)
__device__ __forceinline__ void unlift4(int32_t& x, int32_t& y, int32_t& z, int32_t& w) {
  y = add(y, w >> 1); w = sub(w, y >> 1);
  y = add(y, w); w = shl(w, 1); w = sub(w, y);
  z = add(z, x); x = shl(x, 1); x = sub(x, z);
  y = add(y, z); z = shl(z, 1); z = sub(z, y);
  w = add(w, x); x = shl(x, 1); x = sub(x, w);
}

// the lifting along one axis of a cell held as c[16 i + 4 j + k]; STRIDE is
// 16, 4 or 1 for the axes -3, -2, -1.  Line l starts at the index whose
// coordinate on this axis is 0.
template <int STRIDE, bool INV>
__device__ __forceinline__ void lift_axis(int32_t (&c)[64]) {
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    const int b = (l / STRIDE) * (4 * STRIDE) + l % STRIDE;
    if (INV) {
      unlift4(c[b], c[b + STRIDE], c[b + 2 * STRIDE], c[b + 3 * STRIDE]);
    } else {
      lift4(c[b], c[b + STRIDE], c[b + 2 * STRIDE], c[b + 3 * STRIDE]);
    }
  }
}

template <int... S>
__device__ __forceinline__ void to_sequency(const int32_t (&c)[64], int32_t (&o)[64],
                                            std::integer_sequence<int, S...>) {
  ((o[S] = c[SeqPerm<S>::value]), ...);
}

template <int... S>
__device__ __forceinline__ void from_sequency(const int32_t (&o)[64], int32_t (&c)[64],
                                              std::integer_sequence<int, S...>) {
  ((c[SeqPerm<S>::value] = o[S]), ...);
}

__device__ __forceinline__ float scale_of(const float* exp2tab, int k) {
  return exp2tab[min(max(k, kExp2Min), kExp2Max) - kExp2Min];
}

// first float of cell c of block b: rows (4 ci + i, 4 cj + j) of the block
// start at the returned pointer + (i n + j) n
template <typename T>
__device__ __forceinline__ T* cell_origin(T* base, long long b, int c, int n) {
  const int m = n >> 2;
  const int ci = c / (m * m), cj = (c / m) % m, ck = c % m;
  return base + ((b * n + 4 * ci) * n + 4 * cj) * n + 4 * ck;
}

__device__ __forceinline__ int32_t truncate(int32_t q, int p, bool zero) {
  return zero ? 0 : shl(q >> p, p);
}

__device__ __forceinline__ float dequantize(int32_t c, float scale, bool zero) {
  const float v = __fmul_rn(__int2float_rn(c), scale);
  if (zero) return 0.0f;
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

__global__ void __launch_bounds__(kThreads)
zfpx_encode_kernel(const float* __restrict__ x, const float* __restrict__ exp2tab,
                   int32_t* __restrict__ emax_out, int32_t* __restrict__ q_out,
                   long long ncells, int n, int log_eps) {
  __shared__ __align__(16) int32_t stage[kThreads * kPitch];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long g = first + threadIdx.x;
  const int m = n >> 2;
  const int nc = m * m * m;
  if (g < ncells) {
    const long long b = g / nc;
    const float* p = cell_origin(x, b, static_cast<int>(g - b * nc), n);
    float f[64];
#pragma unroll
    for (int r = 0; r < 16; ++r) {  // row r = 4 i + j
      const float4 v = *reinterpret_cast<const float4*>(
          p + (static_cast<long long>(r >> 2) * n + (r & 3)) * n);
      f[4 * r] = v.x;
      f[4 * r + 1] = v.y;
      f[4 * r + 2] = v.z;
      f[4 * r + 3] = v.w;
    }
    float amax = 0.0f;
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      f[t] = fabsf(f[t]) < kFltMin ? 0.0f : f[t];
      amax = fmaxf(amax, fabsf(f[t]));
    }
    // frexp exponent of a normal float: its biased exponent - 126
    const int emax = amax > 0.0f ? ((__float_as_int(amax) >> 23) & 0xff) - 126 : kZeroEmax;
    const float scale = scale_of(exp2tab, kScaleBits - emax);
    int32_t q[64];
#pragma unroll
    for (int t = 0; t < 64; ++t) q[t] = __float2int_rn(__fmul_rn(f[t], scale));
    lift_axis<16, false>(q);
    lift_axis<4, false>(q);
    lift_axis<1, false>(q);
    int32_t o[64];
    to_sequency(q, o, std::make_integer_sequence<int, 64>{});
    const int drop = min(max(log_eps - (emax - kScaleBits) - kGuardBits, 0), 31);
    const bool zero = emax == kZeroEmax;
    int4* row = reinterpret_cast<int4*>(stage + threadIdx.x * kPitch);
#pragma unroll
    for (int v = 0; v < 16; ++v)
      row[v] = make_int4(truncate(o[4 * v], drop, zero), truncate(o[4 * v + 1], drop, zero),
                         truncate(o[4 * v + 2], drop, zero), truncate(o[4 * v + 3], drop, zero));
    emax_out[g] = emax;
  }
  __syncthreads();
  const long long left = ncells - first;
  const int nvec = 16 * static_cast<int>(left < kThreads ? left : kThreads);
  int4* dst = reinterpret_cast<int4*>(q_out + first * 64);
  for (int u = threadIdx.x; u < nvec; u += kThreads)
    dst[u] = *reinterpret_cast<const int4*>(stage + (u >> 4) * kPitch + (u & 15) * 4);
}

__global__ void __launch_bounds__(kThreads)
zfpx_decode_kernel(const int32_t* __restrict__ emax_in, const int32_t* __restrict__ q_in,
                   const float* __restrict__ exp2tab, float* __restrict__ out,
                   long long ncells, int n) {
  __shared__ __align__(16) int32_t stage[kThreads * kPitch];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = ncells - first;
  const int nvec = 16 * static_cast<int>(left < kThreads ? left : kThreads);
  const int4* src = reinterpret_cast<const int4*>(q_in + first * 64);
  for (int u = threadIdx.x; u < nvec; u += kThreads)
    *reinterpret_cast<int4*>(stage + (u >> 4) * kPitch + (u & 15) * 4) = src[u];
  __syncthreads();
  const long long g = first + threadIdx.x;
  if (g >= ncells) return;
  int32_t o[64];
  const int4* row = reinterpret_cast<const int4*>(stage + threadIdx.x * kPitch);
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    const int4 w = row[v];
    o[4 * v] = w.x;
    o[4 * v + 1] = w.y;
    o[4 * v + 2] = w.z;
    o[4 * v + 3] = w.w;
  }
  int32_t c[64];
  from_sequency(o, c, std::make_integer_sequence<int, 64>{});
  lift_axis<1, true>(c);
  lift_axis<4, true>(c);
  lift_axis<16, true>(c);
  const int emax = emax_in[g];
  const float scale = scale_of(exp2tab, emax - kScaleBits);
  const bool zero = emax == kZeroEmax;
  const int m = n >> 2;
  const int nc = m * m * m;
  const long long b = g / nc;
  float* p = cell_origin(out, b, static_cast<int>(g - b * nc), n);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    *reinterpret_cast<float4*>(p + (static_cast<long long>(r >> 2) * n + (r & 3)) * n) =
        make_float4(dequantize(c[4 * r], scale, zero), dequantize(c[4 * r + 1], scale, zero),
                    dequantize(c[4 * r + 2], scale, zero), dequantize(c[4 * r + 3], scale, zero));
  }
}

// cells of a batch, or -1 if the shape is not one the kernels take
long long cell_count(long long nblocks, int n) {
  if (nblocks < 1 || n < 4 || n % 4) return -1;
  const long long m = n / 4;
  const long long ncells = nblocks * m * m * m;
  if ((ncells + kThreads - 1) / kThreads > 0x7fffffffLL) return -1;
  return ncells;
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream`, does not
// synchronize, and returns cudaGetLastError() after the launch (0 = success).
// `exp2tab` is the 256-entry float32 scale table on the device.
extern "C" int zfpx_encode_launch(const void* x, const void* exp2tab, void* emax, void* q,
                                  long long nblocks, int n, int log_eps, void* stream) {
  const long long ncells = cell_count(nblocks, n);
  if (ncells < 0) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((ncells + kThreads - 1) / kThreads);
  zfpx_encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(exp2tab),
      static_cast<int32_t*>(emax), static_cast<int32_t*>(q), ncells, n, log_eps);
  return cudaGetLastError();
}

extern "C" int zfpx_decode_launch(const void* emax, const void* q, const void* exp2tab,
                                  void* out, long long nblocks, int n, void* stream) {
  const long long ncells = cell_count(nblocks, n);
  if (ncells < 0) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>((ncells + kThreads - 1) / kThreads);
  zfpx_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(emax), static_cast<const int32_t*>(q),
      static_cast<const float*>(exp2tab), static_cast<float*>(out), ncells, n);
  return cudaGetLastError();
}

extern "C" const char* zfpx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
