// Bitonic engine: the whole padded array through one bitonic network.
//
// Replaces vkradixsort_tpu/ops/bitonic.py::_make_kernel (launched by
// bitonic_sort_block), which ran every stage of the network over the whole
// array in one launch from VMEM, with the partner i ^ j fetched by rolls.
//
// What bounds it on an H100: its O(log^2 n) stages, each a pass over the key
// and position planes, and shared memory. A stage is a few compares per pair,
// so a stage that runs from device memory is bound by its pass over the
// planes, and one that runs in a block is bound by shared-memory bandwidth
// and the block barrier after it.
//
// Design: the standard global bitonic sort, since a GPU cannot synchronise
// across blocks inside a launch. The array of npad (a power of two) elements
// lives in a work buffer of NCK key planes and a position plane, npad int32
// each (ops/bitonic.py pads to npad with (INT_MAX..., position)).
//   - bitonic_block_kernel, level 0: one block per tile of `tile` elements
//     (the largest power of two whose planes fit shared memory twice over
//     on one SM, ops/merge.default_tile) stages its slice of the input
//     planes, padded, with positions base + i, sorts it by the network up to
//     size `tile` with directions from the global index, and writes it to
//     the work buffer. When npad <= tile this is the whole sort.
//   - for every level k > tile: one bitonic_global_kernel launch per
//     distance j >= tile, each thread comparing and exchanging the pair
//     (i, i ^ j) in device memory; then bitonic_block_kernel with level k
//     runs the stages j < tile of the level in shared memory, so every
//     stage below the tile size stays out of device memory.
//   - payloads never enter the network: gather_kernel moves each one (4 or
//     8 bytes, any number of them, one launch each) by the final positions.
// The compare, the compare-exchange and the padding are network.cuh's,
// shared with the tile sort. Offsets are 64-bit.
#include <algorithm>

#include "network.cuh"

namespace vkrs {
namespace {

constexpr int kBlockThreads = 1024;
constexpr int kStageThreads = 256;

template <int NCK>
__global__ void __launch_bounds__(kBlockThreads)
    bitonic_block_kernel(const int* in0, const int* in1, int* work, long long n, long long npad,
                         int tile, long long level) {
  extern __shared__ int smem[];
  int* sk = smem;                // NCK key planes of `tile` slots
  int* spos = smem + NCK * tile;  // positions
  int* wpos = work + NCK * npad;
  const long long base = static_cast<long long>(blockIdx.x) * tile;

  if (level == 0) {
    const int* in[2] = {in0, in1};
    const int valid = static_cast<int>(max(0LL, min(static_cast<long long>(tile), n - base)));
    stage_padded<NCK>(in, sk, spos, base, valid, tile, base);
    __syncthreads();
    for (long long size = 2; size <= tile; size <<= 1) {
      tile_stages<NCK>(sk, spos, tile, base, size, static_cast<int>(size >> 1));
    }
  } else {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
#pragma unroll
      for (int k = 0; k < NCK; ++k) sk[k * tile + i] = work[k * npad + base + i];
      spos[i] = wpos[base + i];
    }
    __syncthreads();
    tile_stages<NCK>(sk, spos, tile, base, level, tile >> 1);
  }

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NCK; ++k) work[k * npad + base + i] = sk[k * tile + i];
    wpos[base + i] = spos[i];
  }
}

template <int NCK>
__global__ void __launch_bounds__(kStageThreads)
    bitonic_global_kernel(int* work, long long npad, long long level, long long j) {
  int* wpos = work + NCK * npad;
  const long long half = npad >> 1;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < half;
       p += step) {
    const long long i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    compare_exchange<NCK>(work, wpos, npad, i, i + j, (i & level) == 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kStageThreads)
    gather_kernel(const T* __restrict__ src, const int* __restrict__ pos, T* __restrict__ dst,
                  long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    dst[i] = src[pos[i]];
  }
}

unsigned grid_for(long long work_items) {
  return static_cast<unsigned>(
      std::min<long long>((work_items + kStageThreads - 1) / kStageThreads, 1LL << 20));
}

template <int NCK>
cudaError_t launch_block(const void* in0, const void* in1, void* work, long long n,
                         long long npad, int tile, long long level, cudaStream_t stream) {
  const int smem = (NCK + 1) * tile * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(bitonic_block_kernel<NCK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = std::min(tile / 2, kBlockThreads);
  bitonic_block_kernel<NCK><<<static_cast<unsigned>(npad / tile), threads, smem, stream>>>(
      static_cast<const int*>(in0), static_cast<const int*>(in1), static_cast<int*>(work), n,
      npad, tile, level);
  return cudaGetLastError();
}

template <int NCK>
cudaError_t launch_global(void* work, long long npad, long long level, long long j,
                          cudaStream_t stream) {
  bitonic_global_kernel<NCK><<<grid_for(npad / 2), kStageThreads, 0, stream>>>(
      static_cast<int*>(work), npad, level, j);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// One in-block launch over the work buffer of nk (1 or 2) key planes and a
// position plane, npad int32 each (npad a power of two, a multiple of
// tile). level 0: pads and sorts every tile of the n-element input planes
// in0 (and in1 when nk is 2) into the work buffer. level > tile: runs the
// stages j < tile of that level on the work buffer in place. Returns the
// cudaError_t of the launch.
extern "C" int vkrs_bitonic_block(int device, const void* in0, const void* in1, void* work,
                                  int nk, long long n, long long npad, int tile, long long level,
                                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < 2 || npad % tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (nk) {
    case 1: return static_cast<int>(vkrs::launch_block<1>(in0, in1, work, n, npad, tile, level, s));
    case 2: return static_cast<int>(vkrs::launch_block<2>(in0, in1, work, n, npad, tile, level, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One compare-exchange stage at distance j of level `level` over the whole
// work buffer in device memory. Returns the cudaError_t of the launch.
extern "C" int vkrs_bitonic_global(int device, void* work, int nk, long long npad,
                                   long long level, long long j, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nk) {
    case 1: return static_cast<int>(vkrs::launch_global<1>(work, npad, level, j, s));
    case 2: return static_cast<int>(vkrs::launch_global<2>(work, npad, level, j, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dst[i] = src[pos[i]] for i < n, elements of `bytes` (4 or 8) bytes.
// Returns the cudaError_t of the launch.
extern "C" int vkrs_bitonic_gather(int device, const void* src, const void* pos, void* dst,
                                   long long n, int bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = vkrs::grid_for(n);
  const int* p = static_cast<const int*>(pos);
  if (bytes == 4) {
    vkrs::gather_kernel<unsigned><<<grid, vkrs::kStageThreads, 0, s>>>(
        static_cast<const unsigned*>(src), p, static_cast<unsigned*>(dst), n);
  } else if (bytes == 8) {
    vkrs::gather_kernel<unsigned long long><<<grid, vkrs::kStageThreads, 0, s>>>(
        static_cast<const unsigned long long*>(src), p, static_cast<unsigned long long*>(dst), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
