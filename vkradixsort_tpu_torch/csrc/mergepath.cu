// Merge-path level: merges sorted runs of `run` elements pairwise into
// sorted runs of 2 * run, one launch per run-doubling level, ping-ponging
// between the input and the output buffers.
//
// Replaces vkradixsort_tpu/ops/merge.py::_mergepath_kernel (launched by
// _mergepath_call once per level) and the split-point search of
// merge.py::_level_splits, which the TPU version ran in XLA before each
// launch.
//
// What bounds it on an H100: device memory. A level reads and writes every
// plane once (8 bytes per element per plane), against about 3.35 TB/s; the
// comparisons are a few per element. Below that, each block's split search
// is log2(run) dependent reads from device memory.
//
// Design: each block owns one fixed range of kMergeTile outputs inside one
// run pair (A, B) and finds its own split points (co-ranks) by binary search
// in device memory, with the predicate of _level_splits: A[x] <= B[d-1-x],
// so A wins ties. The block then stages exactly the A and B elements its
// outputs consist of, every plane, in shared memory with coalesced loads.
// Each thread co-ranks its own slice of the outputs inside the staged
// windows and merges it serially, recording where each output comes from;
// the block then writes keys and carries together with coalesced stores.
// A wins ties at both levels of the search and in the serial merge, so the
// merge is stable and the result is bitwise the JAX engine's. A lone last
// run with no partner is copied. Runs are stored ascending and offsets are
// 64-bit, so inputs past 2^31 elements sort too.
#include <algorithm>

#include "planes.cuh"

namespace vkrs {
namespace {

constexpr int kMergeThreads = 256;
constexpr int kMergeTile = 4096;  // outputs per block (when 2 * run allows)

// A[i] <= B[j] lexicographically on the compare planes, in device memory.
template <int NCK>
__device__ __forceinline__ bool le_global(const Planes& P, long long i, long long j) {
  const int a = P.in[0][i], b = P.in[0][j];
  if (NCK == 1) return a <= b;
  if (a != b) return a < b;
  return P.in[1][i] <= P.in[1][j];
}

// The same on the staged windows: plane k of slot i lives at s[k * tile + i].
template <int NCK>
__device__ __forceinline__ bool le_shared(const int* s, int tile, int i, int j) {
  const int a = s[i], b = s[j];
  if (NCK == 1) return a <= b;
  if (a != b) return a < b;
  return s[tile + i] <= s[tile + j];
}

template <int NCK, int NCARRY>
__global__ void __launch_bounds__(kMergeThreads)
    mergepath_kernel(Planes P, long long n, long long run, int tile) {
  constexpr int NP = NCK + NCARRY;
  extern __shared__ int smem[];
  int* src = smem + NP * tile;  // staged slot each output comes from
  __shared__ long long corank[2];

  const long long out_start = static_cast<long long>(blockIdx.x) * tile;
  const long long a_start = out_start / (2 * run) * (2 * run);
  const long long a_len = min(run, n - a_start);
  const long long b_start = a_start + run;
  const long long b_len = b_start < n ? min(run, n - b_start) : 0;
  const long long diag = out_start - a_start;
  const int count = static_cast<int>(min(static_cast<long long>(tile), a_len + b_len - diag));

  if (b_len == 0) {  // lone last run
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
#pragma unroll
      for (int k = 0; k < NP; ++k) P.out[k][out_start + i] = P.in[k][out_start + i];
    }
    return;
  }

  // co-ranks of the block's first and one-past-last output, in parallel
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    const long long d = threadIdx.x == 0 ? diag : diag + count;
    long long lo = max(0LL, d - b_len), hi = min(d, a_len);
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (le_global<NCK>(P, a_start + mid, b_start + d - 1 - mid)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    corank[threadIdx.x == 0 ? 0 : 1] = lo;
  }
  __syncthreads();
  const long long a_lo = corank[0];
  const int na = static_cast<int>(corank[1] - a_lo);
  const int nb = count - na;
  const long long b_lo = b_start + diag - a_lo;

  // stage the A window at slots [0, na) and the B window at [na, count)
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    int* s = smem + k * tile;
    for (int i = threadIdx.x; i < na; i += blockDim.x) s[i] = P.in[k][a_start + a_lo + i];
    for (int i = threadIdx.x; i < nb; i += blockDim.x) s[na + i] = P.in[k][b_lo + i];
  }
  __syncthreads();

  const int per = (tile + blockDim.x - 1) / blockDim.x;
  const int first = threadIdx.x * per;
  if (first < count) {
    const int last = min(first + per, count);
    int lo = max(0, first - nb), hi = min(first, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (le_shared<NCK>(smem, tile, mid, na + first - 1 - mid)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int i = lo, j = first - lo;
    for (int r = first; r < last; ++r) {
      const bool take_a = j >= nb || (i < na && le_shared<NCK>(smem, tile, i, na + j));
      src[r] = take_a ? i++ : na + j++;
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int* s = smem + k * tile;
    for (int r = threadIdx.x; r < count; r += blockDim.x) P.out[k][out_start + r] = s[src[r]];
  }
}

template <int NCK, int NCARRY>
cudaError_t launch_mergepath(const Planes& P, long long n, long long run, cudaStream_t stream) {
  const int tile = static_cast<int>(std::min(2 * run, static_cast<long long>(kMergeTile)));
  const int smem = (NCK + NCARRY + 1) * tile * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(mergepath_kernel<NCK, NCARRY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + tile - 1) / tile;
  mergepath_kernel<NCK, NCARRY>
      <<<static_cast<unsigned>(blocks), kMergeThreads, smem, stream>>>(P, n, run, tile);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// Merges the sorted runs of `run` elements (a power of two) of the planes
// in[0..nck+ncarry) pairwise into out[...] on `device`; n >= 1. Returns the
// cudaError_t of the launch.
extern "C" int vkrs_mergepath(int device, void* const* in, void* const* out, int nck,
                              int ncarry, long long n, long long run, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const vkrs::Planes P = vkrs::make_planes(in, out, nck + ncarry);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VKRS_DISPATCH_PLANES(nck, ncarry, vkrs::launch_mergepath, P, n, run, s)
}
