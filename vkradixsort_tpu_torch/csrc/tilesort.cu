// Tile sort: turns raw input into sorted runs of `tile` elements.
//
// Replaces vkradixsort_tpu/ops/merge.py::_tilesort_kernel (launched by
// _tilesort_call), the bitonic network that sorts each T-element tile of
// int32 planes in VMEM.
//
// What bounds it on an H100: not device memory (one read and one write of
// each plane per element) but the network inside the tile, log2(T) *
// (log2(T) + 1) / 2 compare-exchange stages over shared memory with a block
// barrier between stages, and the 227 KB of shared memory a block may hold.
//
// Design: one block per tile. The compare planes are staged in shared memory
// beside each element's in-tile position, and the network sorts
// lexicographically on (key planes..., position). Positions are distinct, so
// the order is strict and total and the bitonic network yields exactly the
// stable order: tiles are cut from the input in input order, so in-tile
// position is the stable tie-break (the TPU kernel's synthetic XOR tie plane
// only undid the descending blocks its seeded, chunked network left behind).
// The ragged last tile is padded in shared memory with (INT32_MAX, position);
// pads carry positions past every real element, so real keys equal to
// INT32_MAX still sort first. Every run is stored ascending. Carry planes
// never enter shared memory: after the sort each thread gathers
// carry[tile_base + position] for its outputs, a read that stays inside the
// tile's own span of the carry plane. Global offsets are 64-bit. The
// compare-exchange network and the padding are network.cuh's, shared with
// the bitonic engine.
#include <algorithm>

#include "network.cuh"
#include "planes.cuh"

namespace vkrs {
namespace {

constexpr int kTileThreads = 1024;

template <int NCK, int NCARRY>
__global__ void __launch_bounds__(kTileThreads)
    tilesort_kernel(Planes P, long long n, int tile) {
  extern __shared__ int smem[];
  int* sk = smem;                // NCK planes of `tile` keys
  int* spos = smem + NCK * tile;  // in-tile positions
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const int valid = static_cast<int>(min(static_cast<long long>(tile), n - base));

  stage_padded<NCK>(P.in, sk, spos, base, valid, tile, 0);
  __syncthreads();
  // gbase 0: directions from the in-tile index, so every run ends ascending
  for (int size = 2; size <= tile; size <<= 1) tile_stages<NCK>(sk, spos, tile, 0, size, size >> 1);

  // the first `valid` sorted entries are exactly the tile's real elements
  for (int i = threadIdx.x; i < valid; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NCK; ++k) P.out[k][base + i] = sk[k * tile + i];
    const long long src = base + spos[i];
#pragma unroll
    for (int c = 0; c < NCARRY; ++c) P.out[NCK + c][base + i] = P.in[NCK + c][src];
  }
}

template <int NCK, int NCARRY>
cudaError_t launch_tilesort(const Planes& P, long long n, int tile, cudaStream_t stream) {
  const int threads = std::min(tile / 2, kTileThreads);
  const int smem = (NCK + 1) * tile * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(tilesort_kernel<NCK, NCARRY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + tile - 1) / tile;
  tilesort_kernel<NCK, NCARRY>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(P, n, tile);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// Sorts every `tile`-element tile of the planes in[0..nck+ncarry) into
// out[...] on `device`. tile: a power of two >= 2 whose planes fit shared
// memory; n >= 1. Returns the cudaError_t of the launch.
extern "C" int vkrs_tilesort(int device, void* const* in, void* const* out, int nck,
                             int ncarry, long long n, int tile, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const vkrs::Planes P = vkrs::make_planes(in, out, nck + ncarry);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VKRS_DISPATCH_PLANES(nck, ncarry, vkrs::launch_tilesort, P, n, tile, s)
}
