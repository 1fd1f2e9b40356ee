// Significance packing of (B, n, n, n) float32 wavelet coefficients for
// Hopper (sm_90a), for every power-of-two block side n >= 8: the selection
// that the wavelet scheme's serialize made on the host, made on the card.
//
// Replaces no TPU kernel: the reference brings the dense coefficients and a
// byte-per-cell mask to the host and selects there (numpy coeffs[mask],
// np.packbits).  This kernel selects where the coefficients lie, so that
// only the scheme's payload crosses the bus: per block a u32 count of its
// significant details, its mask packed to bits, its coarse corner, and one
// stream of every block's significant details.  A detail is significant when
// |c| >= eps, compared in float32 (eps rounded to float32 by the caller, as
// torch's comparison with a Python float rounds it); the coarse corner
// [0:c, 0:c, 0:c] is never a detail.  Values are copied as bits.
//
// Bound: device-memory bytes.  Each coefficient is read once to test it
// (4 B a cell); the mask is written at 1/8 B a cell, and each significant
// detail is read again and written once.  There is no arithmetic to speak
// of: a compare, a ballot and a population count per cell.
//
// Three launches, in order on the caller's stream:
// 1. wavelet_pack_mask_kernel: one CTA per tile of T = min(n^3, 8192)
//    consecutive cells of one block.  Each warp takes a contiguous stretch
//    of the tile, 32 cells a step; a __ballot_sync of the test gives 32 mask
//    bits, stored as one word in numpy's packbits order (cell 8k to bit 7
//    of byte k, so the word is the ballot bit-reversed and byte-swapped).
//    The coarse corner is copied out on the way.  The tile's count of
//    significant cells goes to tile_counts.
// 2. wavelet_pack_scan_kernel: one CTA scans tile_counts into exclusive
//    int64 offsets (warp shuffles, then the warps' totals, 1024 tiles a
//    round, a running carry between rounds); the last offset is the total,
//    and each block's count is the difference of its tiles' offsets.
// 3. wavelet_pack_select_kernel: the same tiles.  Each warp counts its
//    stretch's bits from the mask words, the CTA scans the warps' counts, and
//    each warp walks its stretch again: a step whose mask word is 0 loads
//    nothing; otherwise each significant lane writes its value at the warp's
//    running offset plus the bits below its lane.  So the details come out in
//    C order, block after block, and the order is the stable one.
// The caller reads the total after launch 2 to size the detail stream
// exactly, then launches 3.
//
// Every output depends on its own block's values alone, in a fixed order,
// so a block's bits do not depend on the batch it came in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // 32-cell steps a warp loads at once
constexpr int kMaxTileLog2 = 13;   // tiles of at most 8192 cells
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool is_detail(long long cell, int lg, int c) {
  const long long side = (1LL << lg) - 1;
  const long long i = cell >> (2 * lg), j = (cell >> lg) & side, k = cell & side;
  return !(i < c && j < c && k < c);
}

// the ballot's bits (lane i at bit i) in packbits order as stored in memory
__device__ __forceinline__ uint32_t to_packbits(uint32_t ballot) {
  return __byte_perm(__brev(ballot), 0, 0x0123);
}

__device__ __forceinline__ uint32_t from_packbits(uint32_t word) {
  return __brev(__byte_perm(word, 0, 0x0123));
}

__global__ void __launch_bounds__(kThreads)
wavelet_pack_mask_kernel(const uint32_t* __restrict__ x, float eps, int lg, int c,
                         int tile_lg, long long tiles_per_block, uint32_t* __restrict__ words,
                         uint32_t* __restrict__ coarse, uint32_t* __restrict__ tile_counts) {
  __shared__ uint32_t warp_counts[kWarps];
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stretch = (1 << tile_lg) / kWarps;  // a multiple of 32 * kUnroll
  const long long block = tile / tiles_per_block;
  const long long first =
      ((tile % tiles_per_block) << tile_lg) + static_cast<long long>(warp) * stretch;
  const uint32_t* src = x + (tile << tile_lg) + static_cast<long long>(warp) * stretch;
  uint32_t* dst = words + (((tile << tile_lg) + static_cast<long long>(warp) * stretch) >> 5);
  uint32_t count = 0;
  for (int s = 0; s < stretch; s += 32 * kUnroll) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[s + 32 * u + lane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long cell = first + s + 32 * u + lane;
      const bool detail = is_detail(cell, lg, c);
      const uint32_t b = __ballot_sync(0xffffffffu, detail && fabsf(__uint_as_float(v[u])) >= eps);
      if (lane == 0) dst[(s >> 5) + u] = to_packbits(b);
      count += __popc(b);
      if (!detail) {
        const long long side = (1LL << lg) - 1;
        const long long i = cell >> (2 * lg), j = (cell >> lg) & side, k = cell & side;
        coarse[((block * c + i) * c + j) * c + k] = v[u];
      }
    }
  }
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    tile_counts[tile] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
wavelet_pack_scan_kernel(const uint32_t* __restrict__ tile_counts, long long ntiles,
                         long long tiles_per_block, long long nblocks,
                         long long* offsets, uint32_t* __restrict__ block_counts) {
  __shared__ long long warp_sums[kScanThreads / 32];
  __shared__ long long carry;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long round = 0; round < ntiles; round += kScanThreads) {
    const long long t = round + threadIdx.x;
    const long long v = t < ntiles ? tile_counts[t] : 0;
    long long incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long up = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += up;
      }
      warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const long long before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (t < ntiles) offsets[t] = before + incl - v;
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == 0) carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[ntiles] = carry;
  __syncthreads();  // the offsets written above are visible to the whole CTA
  for (long long b = threadIdx.x; b < nblocks; b += kScanThreads)
    block_counts[b] = static_cast<uint32_t>(offsets[(b + 1) * tiles_per_block] -
                                            offsets[b * tiles_per_block]);
}

__global__ void __launch_bounds__(kThreads)
wavelet_pack_select_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ words,
                           const long long* __restrict__ offsets, int tile_lg,
                           uint32_t* __restrict__ details) {
  __shared__ uint32_t warp_counts[kWarps];
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stretch = (1 << tile_lg) / kWarps;
  const long long start = (tile << tile_lg) + static_cast<long long>(warp) * stretch;
  const uint32_t* src = x + start;
  const uint32_t* mask = words + (start >> 5);
  uint32_t count = 0;
  for (int w = lane; w < stretch / 32; w += 32) count += __popc(mask[w]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) count += __shfl_xor_sync(0xffffffffu, count, d);
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  long long out = offsets[tile];
  for (int w = 0; w < warp; ++w) out += warp_counts[w];
  const uint32_t below = (1u << lane) - 1;
  for (int s = 0; s < stretch; s += 32) {
    const uint32_t word = mask[s >> 5];
    if (word == 0) continue;  // the same word in every lane: the warp skips together
    const uint32_t b = from_packbits(word);
    if (b >> lane & 1u) details[out + __popc(b & below)] = src[s + lane];
    out += __popc(b);
  }
}

int log2_of(long long n) {
  int lg = 0;
  while ((1LL << lg) < n) ++lg;
  return lg;
}

bool valid_side(int n) { return n >= 8 && (n & (n - 1)) == 0 && n <= 1024; }

int tile_log2(int n) {
  const int cells = 3 * log2_of(n);
  return cells < kMaxTileLog2 ? cells : kMaxTileLog2;
}

}  // namespace

// Plain C interface for ctypes.  Each launch function launches on
// `stream`, does not synchronize, and returns the first CUDA error of its
// launches (0 = success).

// Tiles a block of side n is cut into (0 for a side the kernels refuse):
// the caller sizes tile_counts (nblocks x this) and offsets (one more).
extern "C" long long wavelet_pack_tiles_per_block(int n) {
  if (!valid_side(n)) return 0;
  return 1LL << (3 * log2_of(n) - tile_log2(n));
}

// Launches 1 and 2.  `x` is float32 (nblocks, n, n, n); `words` u8
// (nblocks, n^3 / 8), 4-byte aligned; `coarse` float32 (nblocks, c, c, c);
// `tile_counts` u32 and `offsets` int64 as wavelet_pack_tiles_per_block
// says; `block_counts` u32 (nblocks).  offsets[last] is the total.
extern "C" int wavelet_pack_mask_launch(const void* x, long long nblocks, int n, int c,
                                        float eps, void* words, void* coarse,
                                        void* tile_counts, void* offsets, void* block_counts,
                                        void* stream) {
  if (!valid_side(n) || c < 1 || c > n || nblocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lg = log2_of(n), tile_lg = tile_log2(n);
  const long long per_block = wavelet_pack_tiles_per_block(n);
  const long long ntiles = nblocks * per_block;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  wavelet_pack_mask_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(x), eps, lg, c, tile_lg, per_block,
      static_cast<uint32_t*>(words), static_cast<uint32_t*>(coarse),
      static_cast<uint32_t*>(tile_counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wavelet_pack_scan_kernel<<<1, kScanThreads, 0, st>>>(
      static_cast<const uint32_t*>(tile_counts), ntiles, per_block, nblocks,
      static_cast<long long*>(offsets), static_cast<uint32_t*>(block_counts));
  return cudaGetLastError();
}

// Launch 3.  `details` float32, exactly offsets[last] values.
extern "C" int wavelet_pack_select_launch(const void* x, long long nblocks, int n,
                                          const void* words, const void* offsets,
                                          void* details, void* stream) {
  if (!valid_side(n) || nblocks < 1) return cudaErrorInvalidValue;
  const long long ntiles = nblocks * wavelet_pack_tiles_per_block(n);
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  wavelet_pack_select_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(words),
      static_cast<const long long*>(offsets), tile_log2(n), static_cast<uint32_t*>(details));
  return cudaGetLastError();
}

extern "C" const char* wavelet_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
