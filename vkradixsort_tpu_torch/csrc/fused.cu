// Whole stable LSD radix sort of a small array in one launch of one block.
//
// Replaces vkradixsort_tpu/ops/fused.py::_make_kernel (launched by
// _sort_fused_impl), which held the whole array in VMEM as 16-bit float
// planes and ran 4-bit sub-passes whose permutation was applied by one-hot
// matrix products, since the TPU has neither atomics nor a scatter.
//
// What bounds it on an H100: not device memory (N <= 32768 keys and payloads
// are read once and written once: 0.5 MB for u32 kv, 0.15 us at 3.35 TB/s)
// but being one block on one SM: 4 (u32) or 8 (u64) passes run one after
// another, each a chain of shared-memory atomics, scans, warp matches and
// block barriers over N / 1024 elements per thread, and the passes' ping-pong
// buffers (2 x 0.5 MB at N = 32768) stay in L2.
//
// Design: the reference's single-workgroup shader (single_radixsort.comp
// 42-137), with 1024 threads (32 warps) and 8-bit digits. Warp w owns a
// contiguous part of the array, a whole number of 32-element strips. Each
// pass:
//   1. each warp counts its part's digits in its own row of shared memory
//      (integer atomicAdd);
//   2. the digit totals (sum of the rows) are scanned exclusively across the
//      256 bins with warp shuffles, and each warp's row becomes its starting
//      destination per digit: the digit's scan plus earlier warps' counts;
//   3. each warp walks its strips in element order and ranks them with
//      __match_any_sync and popc (radix.cuh: strip_rank, as in
//      radix_dest.cu), then scatters the key and its payload to the other of
//      two global buffers;
//   4. __syncthreads() makes the scatter visible to the block for the next
//      pass.
// Pass 0 reads the caller's input, which is never written; pass p writes
// buffer B when p is even and A when it is odd, so after the even number of
// passes the result is in A. The TPU's 4-bit sub-passes, float planes,
// one-hot matmul permutation and padding to 8192 are not carried over: a
// stable LSD sort's result does not depend on the digit width.
#include <type_traits>

#include "radix.cuh"

namespace vkrs {
namespace {

constexpr int kFusedWarps = 32;
constexpr int kFusedThreads = kFusedWarps * 32;

template <typename K, int VBYTES>
__global__ void __launch_bounds__(kFusedThreads)
    fused_kernel(const K* keys_in, const void* vals_in, K* ka, K* kb, void* va, void* vb, int n) {
  using V = std::conditional_t<VBYTES == 8, unsigned long long, unsigned>;
  constexpr int kPasses = static_cast<int>(sizeof(K));  // one per byte
  __shared__ int count[kFusedWarps][kBins];
  __shared__ int total[kBins];
  __shared__ int inclusive[kBins];
  __shared__ int warp_sum[kBins / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int part = ((n + kFusedThreads - 1) / kFusedThreads) * 32;
  const int begin = min(warp * part, n);
  const int end = min(begin + part, n);

  for (int p = 0; p < kPasses; ++p) {
    // never __restrict__: the block reads what it wrote in the pass before
    const K* src = p == 0 ? keys_in : (p % 2 ? kb : ka);
    K* dst = p % 2 ? ka : kb;
    const V* vsrc = static_cast<const V*>(p == 0 ? vals_in : (p % 2 ? vb : va));
    V* vdst = static_cast<V*>(p % 2 ? va : vb);
    const int shift = 8 * p;

    for (int i = threadIdx.x; i < kFusedWarps * kBins; i += kFusedThreads) {
      (&count[0][0])[i] = 0;
    }
    __syncthreads();
    for (int i = begin + lane; i < end; i += 32) {
      atomicAdd(&count[warp][static_cast<unsigned>(src[i] >> shift) & (kBins - 1)], 1);
    }
    __syncthreads();

    if (threadIdx.x < kBins) {  // warps 0-7, whole warps: one thread per digit
      const int d = threadIdx.x;
      int t = 0;
      for (int w = 0; w < kFusedWarps; ++w) t += count[w][d];
      total[d] = t;
      int inc = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      inclusive[d] = inc;
      if (lane == 31) warp_sum[warp] = inc;
    }
    __syncthreads();
    if (threadIdx.x < kBins) {
      const int d = threadIdx.x;
      int run = inclusive[d] - total[d];
      for (int w = 0; w < warp; ++w) run += warp_sum[w];
      for (int w = 0; w < kFusedWarps; ++w) {
        const int c = count[w][d];
        count[w][d] = run;
        run += c;
      }
    }
    __syncthreads();

    for (int s = begin; s < end; s += 32) {  // warp-uniform bounds
      const int i = s + lane;
      const bool ok = i < end;
      const K k = ok ? src[i] : K(0);
      const unsigned d = ok ? static_cast<unsigned>(k >> shift) & (kBins - 1) : kNoDigit;
      const int at = strip_rank(count[warp], d, ok);
      if (ok) {
        dst[at] = k;
        if constexpr (VBYTES != 0) vdst[at] = vsrc[i];
      }
    }
    __syncthreads();
  }
}

template <typename K, int VBYTES>
cudaError_t launch_fused(const void* keys_in, const void* vals_in, void* ka, void* kb, void* va,
                         void* vb, int n, cudaStream_t stream) {
  fused_kernel<K, VBYTES><<<1, kFusedThreads, 0, stream>>>(
      static_cast<const K*>(keys_in), vals_in, static_cast<K*>(ka), static_cast<K*>(kb), va, vb,
      n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// Sorts n keys of key_bytes (4 or 8) bytes, as unsigned ints, stably, and
// carries a payload of val_bytes (0, 4 or 8) bytes; the sorted keys and
// payloads land in ka / va. kb / vb are scratch of the same sizes; keys_in /
// vals_in are only read. Payload pointers may be null when val_bytes is 0.
// n >= 1. Returns the cudaError_t of the launch.
extern "C" int vkrs_fused(int device, const void* keys_in, const void* vals_in, void* ka,
                          void* kb, void* va, void* vb, int n, int key_bytes, int val_bytes,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using K32 = unsigned;
  using K64 = unsigned long long;
  switch (key_bytes * 10 + val_bytes) {
    case 40: err = vkrs::launch_fused<K32, 0>(keys_in, vals_in, ka, kb, va, vb, n, s); break;
    case 44: err = vkrs::launch_fused<K32, 4>(keys_in, vals_in, ka, kb, va, vb, n, s); break;
    case 48: err = vkrs::launch_fused<K32, 8>(keys_in, vals_in, ka, kb, va, vb, n, s); break;
    case 80: err = vkrs::launch_fused<K64, 0>(keys_in, vals_in, ka, kb, va, vb, n, s); break;
    case 84: err = vkrs::launch_fused<K64, 4>(keys_in, vals_in, ka, kb, va, vb, n, s); break;
    case 88: err = vkrs::launch_fused<K64, 8>(keys_in, vals_in, ka, kb, va, vb, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
