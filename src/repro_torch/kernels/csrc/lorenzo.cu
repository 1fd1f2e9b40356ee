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
// Encode: one thread per column (b, :, j, k) walks i = 0 .. n-1.  The
// residual at (i, j, k) is the signed sum of q over the 2x2x2 corner below
// it (q = 0 outside the block); the thread quantizes the four values
// (i, j|j-1, k|k-1) of plane i, keeps their signed sum D(i) in a register,
// and writes D(i) - D(i-1).  The quantizer is deterministic, so quantizing a
// neighbour's value again gives the neighbour's q exactly; neighbouring
// threads read neighbouring addresses, and L1 serves the re-reads.
//
// Decode, dispatch by n alone (a refused launch raises on every n; nothing
// falls back to another design):
//
// * n <= 64: the cluster kernel, one launch.  A CTA holds P planes of n^2
//   int32 in shared memory, P = planes_per_cta(n):
//     n <= 16: P is a whole number of blocks, at least 16 KiB of them
//       (n = 16: one block, n = 8: 8, n = 4: 64), one CTA per P / n blocks.
//     16 < n <= 64: a cluster of K = ceil(n / P) CTAs holds a block, a slab
//       of P = max(4096 / n^2, ceil(n / 16)) planes each, about 16 KiB and
//       at most 16 CTAs per block (n = 17: K = 2; n = 32: slabs of 4
//       planes, K = 8, so a read chunk of 32 blocks is 256 CTAs, about two
//       per SM; n = 33: K = 11; n = 64: slabs of 4 planes, K = 16, above
//       the portable 8, which Hopper grants on request).
//     P is a constant of n.  Of the slab sizes that
//     repro_torch/launch/lorenzo_decode_designs.py times, this rule's are
//     the fastest at n = 32 and 33 and tie at n = 64 (PERF.md).
//   A block is n^3 contiguous int32 with axis -3 outermost, so what a CTA
//   holds is one contiguous range: it arrives by up to 8 TMA bulk copies
//   (cp.async.bulk, completion on an mbarrier each), one per group of
//   planes, and the scan of a plane starts when its group has landed.  A
//   bulk copy needs 16-byte aligned addresses and sizes: for odd n, or
//   residuals that do not start 16-byte aligned (a slice of a batch), the
//   CTA loads with plain coalesced 4-byte loads instead.
//   Then, in shared memory:
//     1. along -2: one thread per column (plane, k) walks j, 8 loads in
//        flight;
//     2. (K > 1) the carry along -3: each CTA but the last sums its slab's
//        planes into a total plane T_r; cluster.sync(); CTA r takes the
//        r-th slice of the plane and, through distributed shared memory,
//        replaces each rank's T by the sum of the totals of the ranks
//        below it, so each CTA reads and writes about one plane whatever
//        K (had each CTA read the totals of every rank below it, rank 15
//        at n = 64 would read 15 planes: slower on the H100);
//        cluster.sync(), after which no CTA touches another's shared
//        memory;
//     3. along -3 and -1, fused with the store: one thread per 4 values
//        (j, k .. k+3) of a row walks the planes of its block or slab,
//        carrying the sum along -3 in registers (starting from the carry
//        of step 2), scans the row with warp shuffles over the n / 4
//        threads that hold it, dequantizes, and stores 16 bytes (odd n:
//        one or two values per thread and scalar stores).
//   The block crosses device memory once each way.
// * n > 64: a 128^3 block is 8 MiB, more than a cluster's shared memory.
//   The staged path runs three passes through global memory, one thread
//   per line along the axis of the pass: along -1 from the residuals into
//   the output buffer, along -2 in place, then along -3 in place ending
//   with the product, each thread's loads in batches of 8.
//
// Every sum wraps mod 2^32, so the order of the axes and of the additions
// does not change a bit; the one float step, flush(float(q) * two), is the
// same in both designs.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // encode and the staged decode
constexpr int kBatch = 8;      // loads in flight per thread along a line
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

// float(q) * two, flushed
__device__ __forceinline__ float dequantize(uint32_t q, float two) {
  return flush(__fmul_rn(__int2float_rn(static_cast<int32_t>(q)), two));
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
template <typename Store, typename Stride>
__device__ __forceinline__ void scan_line(const int32_t* src, int32_t* dst, Stride stride, int n,
                                          Store store) {
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

// float(q) * two, stored as its bits in the int32 buffer
struct StoreDequantized {
  float two;
  __device__ void operator()(int32_t* p, uint32_t s) const {
    *p = __float_as_int(dequantize(s, two));
  }
};

// ---------------------------------------------------------------------------
// Decode, n <= 64: the cluster kernel
// ---------------------------------------------------------------------------

constexpr int kMaxClusterSide = 64;
constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kMaxPieces = 8;                   // bulk copies (and mbarriers) per CTA
constexpr size_t kMaxSmem = 227 * 1024;         // a CTA's shared memory on Hopper

__host__ __device__ constexpr int planes_per_cta(int n) {
  if (n <= 16) {
    const int block = n * n * n;
    return n * ((4096 + block - 1) / block);  // whole blocks, >= 16 KiB
  }
  const int p = 4096 / (n * n);                  // a slab of about 16 KiB,
  return p > (n + 15) / 16 ? p : (n + 15) / 16;  // at most 16 CTAs per block
}

// CTAs per block: 1 when a CTA holds whole blocks
__host__ __device__ constexpr int cluster_of(int n) {
  const int planes = planes_per_cta(n);
  return planes < n ? (n + planes - 1) / planes : 1;
}

// int32 ahead of the mbarriers: the planes, and a total plane when K > 1
__host__ __device__ constexpr long long smem_words(int n) {
  const long long nn = static_cast<long long>(n) * n;
  const long long w = planes_per_cta(n) * nn + (cluster_of(n) > 1 ? nn : 0);
  return (w + 1) / 2 * 2;  // the mbarriers are 8-byte aligned
}

constexpr size_t smem_bytes(int n) {
  return static_cast<size_t>(smem_words(n)) * 4 + kMaxPieces * sizeof(uint64_t);
}

// every side the cluster kernel takes fits a cluster and a CTA's shared memory
constexpr bool cluster_sides_fit() {
  for (int n = 1; n <= kMaxClusterSide; ++n)
    if (cluster_of(n) > kMaxCluster || smem_bytes(n) > kMaxSmem) return false;
  return true;
}
static_assert(cluster_sides_fit(), "planes_per_cta gives a cluster or a CTA too large");

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_address(bar)) : "memory");
}

// makes the initialised mbarriers visible to the bulk copies
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// into this CTA's shared memory, completing the current phase of `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_address(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               ::"r"(smem_address(dst)), "l"(src), "r"(bytes), "r"(smem_address(bar))
               : "memory");
}

// waits until the first phase of `bar` has completed
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_address(bar)) : "memory");
  }
}

// E consecutive int32 of a row, those at k0 + e >= n (or all, !ok) as 0
template <int E>
__device__ __forceinline__ void load_values(const int32_t* p, int k0, int n, bool ok,
                                            uint32_t (&v)[E]) {
  if constexpr (E == 4) {  // n % 4 == 0: the 4 are all in the row or all past it
    const int4 a = ok && k0 < n ? *reinterpret_cast<const int4*>(p) : make_int4(0, 0, 0, 0);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = ok && k0 + e < n ? static_cast<uint32_t>(p[e]) : 0u;
  }
}

// NT: n when fixed at compile time, else 0.  E: values per thread along -1
// in step 3 (4 when n % 4 == 0, else 1 for n <= 32 and 2 above).
template <int NT, int E>
__global__ void __launch_bounds__(kClusterThreads)
lorenzo_decode_cluster_kernel(const int32_t* __restrict__ res, float* __restrict__ out,
                              long long nblocks, int n_arg, float two) {
  const int n = NT ? NT : n_arg;
  const int nn = n * n;
  const int tid = threadIdx.x;
  const int planes_per = planes_per_cta(n);
  const int K = cluster_of(n);
  extern __shared__ __align__(128) int4 smem[];
  int32_t* sm = reinterpret_cast<int32_t*>(smem);
  int32_t* total = sm + planes_per * nn;  // T_r, K > 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + smem_words(n));
  const cg::cluster_group cl = cg::this_cluster();

  // what this CTA holds: planes [gp0, gp0 + planes) of the batch, walked in
  // groups of L (a block, or the slab)
  long long gp0;
  int planes, L, rank = 0;
  if (K == 1) {
    const int per = planes_per / n;
    const long long b0 = static_cast<long long>(blockIdx.x) * per;
    planes = static_cast<int>(nblocks - b0 < per ? nblocks - b0 : per) * n;
    gp0 = b0 * n;
    L = n;
  } else {
    rank = static_cast<int>(cl.block_rank());
    const int first = rank * planes_per;
    planes = n - first < planes_per ? n - first : planes_per;
    gp0 = static_cast<long long>(blockIdx.x / K) * n + first;
    L = planes;
  }
  const int32_t* src = res + gp0 * nn;

  // load
  const bool bulk = nn % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int per_piece = (planes + kMaxPieces - 1) / kMaxPieces;
  if (bulk) {
    const int pieces = (planes + per_piece - 1) / per_piece;
    if (tid == 0) {
      for (int i = 0; i < pieces; ++i) mbarrier_init(&bars[i]);
      fence_mbarrier_init();
    }
    __syncthreads();
    if (tid < pieces) {
      const int p0 = tid * per_piece;
      const int np = planes - p0 < per_piece ? planes - p0 : per_piece;
      bulk_load(sm + p0 * nn, src + static_cast<long long>(p0) * nn,
                static_cast<uint32_t>(np) * nn * 4, &bars[tid]);
    }
  } else {
    for (int e = tid; e < planes * nn; e += kClusterThreads) sm[e] = src[e];
    __syncthreads();
  }

  // 1. along -2: thread per column (p, k)
  for (int c = tid; c < planes * n; c += kClusterThreads) {
    const int p = c / n;
    if (bulk) mbarrier_wait(&bars[p / per_piece]);
    int32_t* col = sm + p * nn + (c - p * n);
    scan_line(col, col, n, n, StoreInt{});
  }
  __syncthreads();

  // 2. the carry along -3 into each slab: every rank but the last sums its
  // slab into its total plane T_r; then rank r takes slice r of the plane
  // and, for each (j, k) in it, walks the ranks, replacing T_r' by the sum
  // of the totals below r' (loads of 8 ranks in flight)
  if (K > 1) {
    if (rank < K - 1) {
      for (int e = tid; e < nn; e += kClusterThreads) {
        uint32_t s = 0;
        for (int p = 0; p < planes; ++p) s += static_cast<uint32_t>(sm[p * nn + e]);
        total[e] = static_cast<int32_t>(s);
      }
    }
    cl.sync();
    const int slice = (nn + K - 1) / K;
    const int end = (rank + 1) * slice < nn ? (rank + 1) * slice : nn;
    for (int e = rank * slice + tid; e < end; e += kClusterThreads) {
      uint32_t below = 0;
      for (int r0 = 0; r0 < K; r0 += kBatch) {
        uint32_t t[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          t[u] = r0 + u < K - 1 ? static_cast<uint32_t>(*cl.map_shared_rank(total + e, r0 + u))
                                : 0u;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (r0 + u < K) {
            *cl.map_shared_rank(total + e, r0 + u) = static_cast<int32_t>(below);
            below += t[u];
          }
        }
      }
    }
    cl.sync();  // the last access to another CTA's shared memory
  }

  // 3. along -3 and -1, dequantize, store: item (g, j, q) is lane q of the
  // W-lane segment that holds row j of group g
  const int m = (n + E - 1) / E;
  int W = 1;
  while (W < m) W <<= 1;
  const int items = planes / L * n * W;
  const int rounds = (items + kClusterThreads - 1) / kClusterThreads;
  const int q = tid % W;  // kClusterThreads is a multiple of W
  const int k0 = q * E;
  for (int rd = 0; rd < rounds; ++rd) {
    const int it = rd * kClusterThreads + tid;
    const bool ok = it < items;
    const int gj = it / W;
    const int g = gj / n, j = gj - g * n;
    uint32_t acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0;
    if (rank > 0) load_values<E>(total + j * n + k0, k0, n, ok, acc);  // the carry
    for (int i = 0; i < L; ++i) {
      const int p = g * L + i;
      uint32_t v[E];
      load_values<E>(sm + p * nn + j * n + k0, k0, n, ok, v);
      uint32_t s[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[e] += v[e];
        s[e] = e ? s[e - 1] + acc[e] : acc[e];
      }
      uint32_t x = s[E - 1];
      for (int d = 1; d < W; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, x, d, W);
        if (q >= d) x += y;
      }
      const uint32_t before = x - s[E - 1];
      if (ok && k0 < n) {
        float* o = out + (gp0 + p) * nn + j * n + k0;
        if constexpr (E == 4) {
          *reinterpret_cast<float4*>(o) =
              make_float4(dequantize(s[0] + before, two), dequantize(s[1] + before, two),
                          dequantize(s[2] + before, two), dequantize(s[3] + before, two));
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (k0 + e < n) o[e] = dequantize(s[e] + before, two);
        }
      }
    }
  }
}

template <int NT, int E>
cudaError_t launch_cluster(const int32_t* res, float* out, long long nblocks, int n, float two,
                           cudaStream_t stream) {
  const int K = cluster_of(n);
  if (E == 4 && reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorMisalignedAddress;
  const long long per = planes_per_cta(n) / n;
  const long long grid = K > 1 ? nblocks * K : (nblocks + per - 1) / per;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* kernel = lorenzo_decode_cluster_kernel<NT, E>;
  // a function-local static is initialized exactly once, thread-safely
  static const cudaError_t attr = [kernel] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxSmem));
    // K = 16 at n = 64: above the portable 8, which Hopper allows on request
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = K;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem_bytes(n);
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, res, out, nblocks, n, two);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t decode_cluster(const int32_t* res, float* out, long long nblocks, int n, float two,
                           cudaStream_t st) {
  switch (n) {
    case 8: return launch_cluster<8, 4>(res, out, nblocks, n, two, st);
    case 16: return launch_cluster<16, 4>(res, out, nblocks, n, two, st);
    case 32: return launch_cluster<32, 4>(res, out, nblocks, n, two, st);
    case 64: return launch_cluster<64, 4>(res, out, nblocks, n, two, st);
    default:
      if (n % 4 == 0) return launch_cluster<0, 4>(res, out, nblocks, n, two, st);
      return n <= 32 ? launch_cluster<0, 1>(res, out, nblocks, n, two, st)
                     : launch_cluster<0, 2>(res, out, nblocks, n, two, st);
  }
}

// ---------------------------------------------------------------------------
// Decode, n > 64: the staged path, three passes through global memory
// ---------------------------------------------------------------------------

// pass 1, along -1, residuals -> out: thread g owns the row starting at g n
__global__ void __launch_bounds__(kThreads)
lorenzo_decode_scan_k(const int32_t* __restrict__ res, int32_t* __restrict__ out,
                      long long nrows, int n) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= nrows) return;
  scan_line(res + g * n, out + g * n, 1LL, n, StoreInt{});
}

// pass 2, along -2, in place: thread g owns (plane g / n, k = g % n)
__global__ void __launch_bounds__(kThreads)
lorenzo_decode_scan_j(int32_t* buf, long long nlines, int n) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= nlines) return;
  const long long plane = g / n;
  int32_t* p = buf + plane * n * n + (g - plane * n);
  scan_line(p, p, static_cast<long long>(n), n, StoreInt{});
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

// `out` is float32 (B, n, n, n); the first two passes keep their int32
// partial sums in it
cudaError_t decode_staged(const int32_t* res, float* out, long long lines, int n, float two,
                          cudaStream_t s) {
  int32_t* buf = reinterpret_cast<int32_t*>(out);
  lorenzo_decode_scan_k<<<grid_of(lines), kThreads, 0, s>>>(res, buf, lines, n);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  lorenzo_decode_scan_j<<<grid_of(lines), kThreads, 0, s>>>(buf, lines, n);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  lorenzo_decode_scan_i<<<grid_of(lines), kThreads, 0, s>>>(buf, lines, n, two);
  return cudaGetLastError();
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

// `out` is float32 (B, n, n, n), 16-byte aligned
extern "C" int lorenzo_decode_launch(const void* res, void* out, long long nblocks, int n,
                                     float two, void* stream) {
  const long long lines = line_count(nblocks, n);
  if (lines < 0) return cudaErrorInvalidValue;
  const int32_t* r = static_cast<const int32_t*>(res);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kMaxClusterSide) return decode_staged(r, o, lines, n, two, s);
  return decode_cluster(r, o, nblocks, n, two, s);
}

// The decode's design at side n, as lorenzo_decode_launch chooses it:
// planes per CTA and CTAs per block of the cluster kernel, 0 and 0 for the
// staged path
extern "C" int lorenzo_decode_planes_per_cta(int n) {
  return n >= 1 && n <= kMaxClusterSide ? planes_per_cta(n) : 0;
}

extern "C" int lorenzo_decode_cluster_ctas(int n) {
  return n >= 1 && n <= kMaxClusterSide ? cluster_of(n) : 0;
}

extern "C" const char* lorenzo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
