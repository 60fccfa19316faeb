// Tile sort: turns raw input into sorted runs of `tile` elements.
//
// Replaces vkradixsort_tpu/ops/merge.py::_tilesort_kernel (launched by
// _tilesort_call), the bitonic network that sorts each T-element tile of
// int32 planes in VMEM.
//
// What bounds it on an H100: device memory bounds it at 16 bytes an element
// for one key and one carry plane (0.48 ms for 1e8 at 3.35 TB/s), but a
// sorting network in shared memory is far from that: at 8192, 91
// barrier-separated stages of one compare-exchange per thread, with bank
// conflicts below distance 32, about 45 compare-exchanges an element. A
// stable radix rank costs a few instructions an element per 8-bit digit;
// what is left bounding the sort is the chain of each pass (count, scan,
// rank, scatter, read back, with a block barrier between) and, with one
// block an SM at 16384, the tile's load and store, which no other block on
// the SM overlaps.
//
// Design: an in-block stable LSD radix sort, the fused kernel's pass
// structure (fused.cu) in one block, with no cluster. One block per tile,
// tile / 16 threads (at least 256), 16 elements a thread:
//   - load once: warp w owns tile elements [512 w, 512 w + 512), a thread
//     its lane of each 32-element strip, into registers, each key turned to
//     unsigned order (sign bit flipped; two key planes as one 64-bit key,
//     three as a 96-bit one, first plane on top) beside its in-tile
//     position. Elements past the input's end take no part in any pass, so
//     the ragged last tile needs no padding;
//   - 8-bit passes, low digit first (4 for one key plane, 8 for two, 12 for
//     three): each
//     warp counts its digits in its own row of shared memory; 256 threads
//     scan the digits over the warps; each warp ranks its strips in element
//     order (radix.cuh: strip_rank_ballot, the fused sort's rank) and
//     scatters key and position into the block's shared memory (one key
//     plane: one store of both, packed in one slot); every thread then reads
//     its elements of the next pass back into registers;
//   - after the last pass each thread writes the sorted keys coalesced and
//     gathers each carry plane by the final positions, a read that stays
//     inside the tile's own span of the plane.
// An LSD radix sort keeps equal keys in their input order, so in-tile
// position is the tie-break without entering any compare, and the result is
// the one stable order. Every run is stored ascending. Shared memory: the
// slots (8 bytes an element for one key plane, 10 for two, 14 for three)
// and the warps' counters (1 KB a warp): 80 KB at 8192 with one key plane,
// 160 KB at 16384, 128 KB at 8192 with three (16384 does not fit one
// block at three, so those blocks have at most 512 threads and registers
// for the 96-bit keys). Global offsets are 64-bit.
#include <algorithm>
#include <type_traits>

#include "planes.cuh"
#include "radix.cuh"

namespace vkrs {
namespace {

constexpr int kTilePer = 16;                  // elements a thread holds
constexpr int kTileWarpSpan = 32 * kTilePer;  // elements a warp holds
constexpr int kTileMinThreads = kBins;        // one thread per digit in the scan
constexpr unsigned kSignBit = 0x80000000u;

// Threads of a tile-sort block: 1024 for one and two key planes; 512 for
// three, whose largest tile is 8192 (shared memory), so that a thread may
// hold its sixteen 96-bit keys in registers.
constexpr int tile_max_threads(int nck) { return nck == 3 ? 512 : 1024; }

// A 96-bit key: planes 0 and 1 in `hi`, plane 2 in `lo`.
struct Key96 {
  unsigned long long hi;
  unsigned lo;
};

// Digit (k >> shift) & 255 of a tile's key (radix.cuh: digit_of).
template <typename K>
__device__ __forceinline__ unsigned tile_digit(K k, int shift) {
  return vkrs::digit_of(k, shift);
}
__device__ __forceinline__ unsigned tile_digit(const Key96& k, int shift) {
  return shift < 32 ? vkrs::digit_of(k.lo, shift) : vkrs::digit_of(k.hi, shift - 32);
}

// Key of an element in unsigned order: the signed planes' lexicographic
// order is the unsigned order of the planes with their sign bits flipped.
template <int NCK>
using TileKey = std::conditional_t<NCK == 1, unsigned,
                                   std::conditional_t<NCK == 2, unsigned long long, Key96>>;

__device__ __forceinline__ unsigned load_plane(const Planes& P, int q, long long i) {
  return static_cast<unsigned>(P.in[q][i]) ^ kSignBit;
}

__device__ __forceinline__ void store_plane(const Planes& P, int q, long long i, unsigned k) {
  P.out[q][i] = static_cast<int>(k ^ kSignBit);
}

template <int NCK>
__device__ __forceinline__ TileKey<NCK> load_key(const Planes& P, long long i) {
  if constexpr (NCK == 1) {
    return load_plane(P, 0, i);
  } else {
    const unsigned long long hi =
        (static_cast<unsigned long long>(load_plane(P, 0, i)) << 32) | load_plane(P, 1, i);
    if constexpr (NCK == 2) {
      return hi;
    } else {
      return Key96{hi, load_plane(P, 2, i)};
    }
  }
}

template <int NCK>
__device__ __forceinline__ void store_key(const Planes& P, long long i, const TileKey<NCK>& k) {
  if constexpr (NCK == 1) {
    store_plane(P, 0, i, k);
  } else if constexpr (NCK == 2) {
    store_plane(P, 0, i, static_cast<unsigned>(k >> 32));
    store_plane(P, 1, i, static_cast<unsigned>(k));
  } else {
    store_plane(P, 0, i, static_cast<unsigned>(k.hi >> 32));
    store_plane(P, 1, i, static_cast<unsigned>(k.hi));
    store_plane(P, 2, i, k.lo);
  }
}

// Position of strip s's element, two 16-bit positions to a register.
__device__ __forceinline__ int tile_pos(const unsigned (&pos2)[kTilePer / 2], int s) {
  return static_cast<int>((pos2[s >> 1] >> (16 * (s & 1))) & 0xFFFFu);
}

// The tile in shared memory between passes: one key plane packs key and
// position in one 8-byte slot (radix.cuh: Slot), so that the scatter moves
// an element with one store; two key planes keep the 64-bit keys and the
// 16-bit positions in two arrays (10 bytes an element), so that a tile of
// 16384 fits one block; three keep the key's high 64 bits, its low 32 bits
// and the positions in three arrays (14 bytes an element).
template <int NCK>
struct TileSlots;
template <>
struct TileSlots<1> {
  using S = Slot<unsigned>;
  S::T* slot;
  __device__ explicit TileSlots(unsigned char* smem, int) : slot(reinterpret_cast<S::T*>(smem)) {}
  static constexpr int kBytes = sizeof(S::T);
  __device__ void put(int i, unsigned k, int pos) const { slot[i] = S::pack(k, pos); }
  __device__ void get(int i, unsigned& k, int& pos) const {
    const S::T v = slot[i];
    k = S::key(v);
    pos = S::pos(v);
  }
};
template <>
struct TileSlots<2> {
  unsigned long long* key;
  unsigned short* pos;
  __device__ TileSlots(unsigned char* smem, int tile)
      : key(reinterpret_cast<unsigned long long*>(smem)),
        pos(reinterpret_cast<unsigned short*>(smem + 8 * static_cast<size_t>(tile))) {}
  static constexpr int kBytes = 10;
  __device__ void put(int i, unsigned long long k, int p) const {
    key[i] = k;
    pos[i] = static_cast<unsigned short>(p);
  }
  __device__ void get(int i, unsigned long long& k, int& p) const {
    k = key[i];
    p = pos[i];
  }
};
template <>
struct TileSlots<3> {
  unsigned long long* hi;
  unsigned* lo;
  unsigned short* pos;
  __device__ TileSlots(unsigned char* smem, int tile)
      : hi(reinterpret_cast<unsigned long long*>(smem)),
        lo(reinterpret_cast<unsigned*>(smem + 8 * static_cast<size_t>(tile))),
        pos(reinterpret_cast<unsigned short*>(smem + 12 * static_cast<size_t>(tile))) {}
  static constexpr int kBytes = 14;
  __device__ void put(int i, const Key96& k, int p) const {
    hi[i] = k.hi;
    lo[i] = k.lo;
    pos[i] = static_cast<unsigned short>(p);
  }
  __device__ void get(int i, Key96& k, int& p) const {
    k.hi = hi[i];
    k.lo = lo[i];
    p = pos[i];
  }
};

template <int NCK, int NCARRY>
__global__ void __launch_bounds__(tile_max_threads(NCK))
    tilesort_kernel(Planes P, long long n, int tile) {
  using K = TileKey<NCK>;
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSlots<NCK> slots(smem, tile);  // the tile, between passes
  int* count = reinterpret_cast<int*>(smem + static_cast<size_t>(tile) * TileSlots<NCK>::kBytes);
  __shared__ int warp_sum[kTileMinThreads / 32];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const int valid = static_cast<int>(min(static_cast<long long>(tile), n - base));
  const int first = warp * kTileWarpSpan + lane;  // strip s's element: first + 32 s
  int* my_count = count + warp * kBins;

  K key[kTilePer];
  unsigned pos2[kTilePer / 2];
#pragma unroll
  for (int s = 0; s < kTilePer; ++s) {
    const int i = first + 32 * s;
    key[s] = i < valid ? load_key<NCK>(P, base + i) : K{};
  }
#pragma unroll
  for (int s = 0; s < kTilePer; s += 2) {
    pos2[s >> 1] = static_cast<unsigned>(first + 32 * s) |
                   (static_cast<unsigned>(first + 32 * (s + 1)) << 16);
  }

  constexpr int kPasses = 4 * NCK;
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 8 * p;
    for (int i = threadIdx.x; i < nwarps * kBins; i += blockDim.x) count[i] = 0;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kTilePer; ++s) {
      if (first + 32 * s < valid) atomicAdd(&my_count[tile_digit(key[s], shift)], 1);
    }
    __syncthreads();

    int total;
    block_digit_offsets(count, nwarps, warp_sum, total);
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kTilePer; ++s) {
      const bool ok = first + 32 * s < valid;
      const unsigned d = ok ? tile_digit(key[s], shift) : kNoDigit;
      const int at = strip_rank_ballot(my_count, d, ok);
      if (ok) slots.put(at, key[s], tile_pos(pos2, s));
    }
    __syncthreads();  // the scatter is complete

    if (p + 1 < kPasses) {
#pragma unroll
      for (int s = 0; s < kTilePer; s += 2) {
        int lo = 0, hi = 0;
        if (first + 32 * s < valid) slots.get(first + 32 * s, key[s], lo);
        if (first + 32 * (s + 1) < valid) slots.get(first + 32 * (s + 1), key[s + 1], hi);
        pos2[s >> 1] = static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
      }
    }
  }

  // the first `valid` slots hold the tile's elements in stable order
  for (int i = threadIdx.x; i < valid; i += blockDim.x) {
    K k;
    int pos;
    slots.get(i, k, pos);
    store_key<NCK>(P, base + i, k);
    const long long src = base + pos;
#pragma unroll
    for (int c = 0; c < NCARRY; ++c) P.out[NCK + c][base + i] = P.in[NCK + c][src];
  }
}

template <int NCK, int NCARRY>
cudaError_t launch_tilesort(const Planes& P, long long n, int tile, cudaStream_t stream) {
  const int threads = std::max(tile / kTilePer, kTileMinThreads);
  const int smem = tile * TileSlots<NCK>::kBytes + threads / 32 * kBins * static_cast<int>(sizeof(int));
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
// out[...] on `device`. tile: a power of two >= 2 of at most 16384 (8192 at
// nck 3) whose slots fit shared memory; n >= 1. Returns the cudaError_t of
// the launch.
extern "C" int vkrs_tilesort(int device, void* const* in, void* const* out, int nck,
                             int ncarry, long long n, int tile, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile > vkrs::tile_max_threads(nck) * vkrs::kTilePer) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vkrs::Planes P = vkrs::make_planes(in, out, nck + ncarry);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VKRS_DISPATCH_PLANES(nck, ncarry, vkrs::launch_tilesort, P, n, tile, s)
}
