// Bitonic engine: the whole padded array through one bitonic network.
//
// Replaces vkradixsort_tpu/ops/bitonic.py::_make_kernel (launched by
// bitonic_sort_block), which ran every stage of the network over the whole
// array in one launch from VMEM, with the partner i ^ j fetched by rolls.
//
// What bounds it on an H100: its log2(n) (log2(n) + 1) / 2 stages. A stage is
// a few compares per pair, so moving the elements between stages is what
// costs: a stage run from device memory is a pass over the key and position
// planes, one run in a block a sweep over shared memory and a barrier. The
// design runs several stages per move, from registers; what bounds it then
// is integer issue in the in-block passes (compares and selects), while the
// global groups run at about the rate the L2 cache serves their planes.
//
// Design: the global bitonic sort on the schedule ops/bitonic.py::plan
// builds, since a GPU cannot synchronise across blocks inside a launch. The
// array of npad (a power of two) elements lives in a work buffer of NCK key
// planes and a position plane, npad int32 each (padded with
// (INT_MAX..., position)). In registers an element is packed so that one
// 64-bit compare orders it (network.cuh: Elem).
//   - bitonic_group_kernel runs R consecutive global distances of one level,
//     2^top ... 2^(top - R + 1), all >= the tile. Elements whose indices
//     differ only in those R bits form closed groups of 2^R: each thread
//     loads one group into registers, runs the R stages there and writes it
//     back, so R stages cost one pass over the planes. Consecutive threads
//     take consecutive groups, whose elements are consecutive in every
//     plane, so every load and store of a warp is coalesced.
//   - bitonic_block_kernel, one block per tile of `tile` elements, runs a
//     list of stages whose distances lie below the tile: the first launch
//     pads the input and runs every level up to the tile, each later one
//     the stages below the tile of one level. The tile is staged into
//     shared memory and back with coalesced copies; its stages run in
//     rounds. In a round each thread holds in registers the 16 elements
//     whose in-tile indices differ only in four bits (the window), runs
//     every stage of the round there and writes them back; one barrier
//     separates rounds. At a tile of 16384 a later pass (14 stages) takes 4
//     rounds, the first (105 stages) 29, in place of one barrier per stage.
//     Bank conflicts: a thread's id fills the bits outside the window, its
//     lane the lowest free bit of each residue mod 5 (thread_base), and a
//     slot's bank folds in bits 5-14 of its index (swizzle), so the 32 lanes
//     of every load and store hit 32 banks.
//   - payloads never enter the network: gather_kernel moves each one (4 or
//     8 bytes, any number of them, one launch each) by the final positions.
// The compare, the padding and the total order are network.cuh's.
// thread_base and swizzle are mirrored in
// ops/bitonic.py, whose plain torch run of the schedule the CPU tests hold
// against the network. Offsets into the planes are 64-bit.
#include <algorithm>

#include "network.cuh"

namespace vkrs {
namespace {

constexpr int kBlockThreads = 512;  // a thread may keep 128 registers
constexpr int kStageThreads = 256;
constexpr int kRoundBits = 4;               // ops/bitonic.py ROUND_BITS
constexpr int kRound = 1 << kRoundBits;     // elements a thread holds in a round
constexpr int kMaxStages = 128;             // ops/bitonic.py MAX_BLOCK_STAGES
constexpr int kMinTile = 1 << 10;           // thread_base's lanes need bits 0-9
constexpr int kMaxTile = 1 << 15;           // swizzle folds bits 5-14

// The stages of one in-block launch, each packed as
// window top << 10 | size log2 << 5 | distance log2, in network order.
struct Stages {
  unsigned short packed[kMaxStages];
};

// Shared-memory slot of in-tile index i: bits 5-14 folded onto the bank
// bits, so bit p moves the bank by bit p % 5. Linear over XOR, so the slot of
// i ^ j for bit-disjoint i, j is swizzle(i) ^ swizzle(j).
__device__ __forceinline__ int swizzle(int i) { return i ^ (((i >> 5) ^ (i >> 10)) & 31); }

// x with a zero bit inserted at bit h (the bits from h up move up by one).
__device__ __forceinline__ int insert_zero(int x, int h) {
  return (x & ((1 << h) - 1)) | ((x >> h) << (h + 1));
}

// In-tile index of element 0 of thread t's group in a round whose window is
// bits lo ... lo + 3, for tiles of at least 2^10: lane bit c goes to bit
// c, or to c + 5 when c lies in the window (the lowest free bit of each
// residue mod 5, so the lanes' slots fall in 32 distinct banks); the warp
// bits fill the other bits from 5 up, ascending (ops/bitonic.py
// thread_bit_positions). Bits 0-4 are all taken by the window or the lanes,
// so the warp bits skip four holes: the window bits from 5 up, then the
// window bits below 5 moved up by 5, which lie above them.
__device__ __forceinline__ int thread_base(int t, int lo) {
  const int low = ((kRound - 1) << lo) & 31;
  const int lane = t & 31;
  const int lanes = (lane & ~low) | ((lane & low) << 5);
  int w = (t >> 5) << 5;
#pragma unroll
  for (int i = 0; i < kRoundBits; ++i) {
    if (lo + i >= 5) w = insert_zero(w, lo + i);
  }
#pragma unroll
  for (int i = 0; i < kRoundBits; ++i) {
    if (lo + i < 5) w = insert_zero(w, lo + i + 5);
  }
  return lanes | w;
}

// Slot offset of element m of a group, swizzle(m << lo), from the slots of
// the window's bits (m is a constant once the loops unroll).
__device__ __forceinline__ int element_slot(int m, const int (&e)[kRoundBits]) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < kRoundBits; ++i) s ^= (m >> i) & 1 ? e[i] : 0;
  return s;
}

// One stage of a round at window bit BO over a thread's 16 elements. The pair
// sorts descending when bit `size` of its global index is set: that bit is
// bit `mmask` of m when it lies in the window (early levels of the first
// pass), else the thread's own (`tdesc`, one direction for the stage).
template <int BO, int NCK>
__device__ __forceinline__ void round_stage(Elem<NCK> (&e)[kRound], unsigned mmask, bool tdesc) {
  if (mmask == 0) {
#pragma unroll
    for (int m = 0; m < kRound; ++m) {
      if (!(m & (1 << BO))) exchange_elems<NCK, kRound>(e, m, m | (1 << BO), !tdesc);
    }
  } else {
#pragma unroll
    for (int m = 0; m < kRound; ++m) {
      if (!(m & (1 << BO))) exchange_elems<NCK, kRound>(e, m, m | (1 << BO), !(m & mmask));
    }
  }
}

template <int NCK>
__global__ void __launch_bounds__(kBlockThreads)
    bitonic_block_kernel(const int* in0, const int* in1, int* work, long long n, long long npad,
                         int tile, int first, Stages st, int nstages) {
  extern __shared__ int smem[];
  __shared__ unsigned short packed[kMaxStages];
  int* sk = smem;                 // NCK key planes of `tile` slots, swizzled
  int* spos = smem + NCK * tile;  // positions
  int* wpos = work + NCK * npad;
  const long long base = static_cast<long long>(blockIdx.x) * tile;

  for (int i = threadIdx.x; i < nstages; i += blockDim.x) packed[i] = st.packed[i];
  if (first) {
    const int* in[2] = {in0, in1};
    const long long valid = min(static_cast<long long>(tile), n - base);
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int s = swizzle(i);
#pragma unroll
      for (int q = 0; q < NCK; ++q) sk[q * tile + s] = i < valid ? in[q][base + i] : kPadKey;
      spos[s] = static_cast<int>(base + i);
    }
  } else {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int s = swizzle(i);
#pragma unroll
      for (int q = 0; q < NCK; ++q) sk[q * tile + s] = work[q * npad + base + i];
      spos[s] = wpos[base + i];
    }
  }
  __syncthreads();

  for (int begin = 0; begin < nstages;) {
    const int top = packed[begin] >> 10;
    int end = begin + 1;
    while (end < nstages && (packed[end] >> 10) == top) ++end;
    const int lo = top - kRoundBits + 1;
    int ew[kRoundBits];
#pragma unroll
    for (int i = 0; i < kRoundBits; ++i) ew[i] = swizzle(1 << (lo + i));

    for (int t = threadIdx.x; t < (tile >> kRoundBits); t += blockDim.x) {
      const int tb = thread_base(t, lo);
      const int stb = swizzle(tb);
      Elem<NCK> e[kRound];
#pragma unroll
      for (int m = 0; m < kRound; ++m) {
        const int s = stb ^ element_slot(m, ew);
        int k[NCK];
#pragma unroll
        for (int q = 0; q < NCK; ++q) k[q] = sk[q * tile + s];
        e[m] = Elem<NCK>::of(k, spos[s]);
      }
      const long long gt = base | tb;
      for (int i = begin; i < end; ++i) {
        const int size_log = (packed[i] >> 5) & 31;
        const int ms = size_log - lo;
        const unsigned mmask = static_cast<unsigned>(ms) < kRoundBits ? 1u << ms : 0u;
        const bool tdesc = mmask == 0 && ((gt >> size_log) & 1);
        switch ((packed[i] & 31) - lo) {
          case 0: round_stage<0, NCK>(e, mmask, tdesc); break;
          case 1: round_stage<1, NCK>(e, mmask, tdesc); break;
          case 2: round_stage<2, NCK>(e, mmask, tdesc); break;
          default: round_stage<3, NCK>(e, mmask, tdesc); break;
        }
      }
#pragma unroll
      for (int m = 0; m < kRound; ++m) {
        const int s = stb ^ element_slot(m, ew);
#pragma unroll
        for (int q = 0; q < NCK; ++q) sk[q * tile + s] = e[m].key(q);
        spos[s] = e[m].pos();
      }
    }
    __syncthreads();
    begin = end;
  }

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int s = swizzle(i);
#pragma unroll
    for (int q = 0; q < NCK; ++q) work[q * npad + base + i] = sk[q * tile + s];
    wpos[base + i] = spos[s];
  }
}

template <int NCK, int R>
__global__ void __launch_bounds__(kStageThreads)
    bitonic_group_kernel(int* work, long long npad, int level, int top) {
  constexpr int kN = 1 << R;
  const int lo = top - R + 1;
  const long long jlow = 1LL << lo;
  int* wpos = work + NCK * npad;
  const long long groups = npad >> R;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += step) {
    const long long low = g & (jlow - 1);
    const long long base = ((g - low) << R) | low;
    Elem<NCK> e[kN];
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const long long i = base + (static_cast<long long>(m) << lo);
      int k[NCK];
#pragma unroll
      for (int q = 0; q < NCK; ++q) k[q] = work[q * npad + i];
      e[m] = Elem<NCK>::of(k, wpos[i]);
    }
    const bool ascending = ((base >> level) & 1) == 0;
#pragma unroll
    for (int b = R - 1; b >= 0; --b) {
#pragma unroll
      for (int m = 0; m < kN; ++m) {
        if (!(m & (1 << b))) exchange_elems<NCK, kN>(e, m, m | (1 << b), ascending);
      }
    }
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const long long i = base + (static_cast<long long>(m) << lo);
#pragma unroll
      for (int q = 0; q < NCK; ++q) work[q * npad + i] = e[m].key(q);
      wpos[i] = e[m].pos();
    }
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
                         long long npad, int tile, int first, const Stages& st, int nstages,
                         cudaStream_t stream) {
  const int smem = (NCK + 1) * tile * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(bitonic_block_kernel<NCK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = std::min(tile >> kRoundBits, kBlockThreads);
  bitonic_block_kernel<NCK><<<static_cast<unsigned>(npad / tile), threads, smem, stream>>>(
      static_cast<const int*>(in0), static_cast<const int*>(in1), static_cast<int*>(work), n,
      npad, tile, first, st, nstages);
  return cudaGetLastError();
}

template <int NCK, int R>
cudaError_t launch_group(void* work, long long npad, int level, int top, cudaStream_t stream) {
  bitonic_group_kernel<NCK, R><<<grid_for(npad >> R), kStageThreads, 0, stream>>>(
      static_cast<int*>(work), npad, level, top);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// One in-block launch over the work buffer of nk (1 or 2) key planes and a
// position plane, npad int32 each (npad a power of two, a multiple of tile,
// 2^10 <= tile <= 2^15). Runs the nstages stages packed in `stages` (host
// memory; window top << 10 | size log2 << 5 | distance log2, in network
// order, consecutive stages of one window forming a round). first != 0: pads
// every tile of the n-element input planes in0 (and in1 when nk is 2) into
// the work buffer, positions base + i, first; otherwise works on the work
// buffer in place. Returns the cudaError_t of the launch.
extern "C" int vkrs_bitonic_block(int device, const void* in0, const void* in1, void* work,
                                  int nk, long long n, long long npad, int tile, int first,
                                  const int* stages, int nstages, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < vkrs::kMinTile || tile > vkrs::kMaxTile || (tile & (tile - 1)) || npad % tile != 0 ||
      nstages < 0 || nstages > vkrs::kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vkrs::Stages st = {};
  for (int i = 0; i < nstages; ++i) st.packed[i] = static_cast<unsigned short>(stages[i]);
  switch (nk) {
    case 1:
      return static_cast<int>(
          vkrs::launch_block<1>(in0, in1, work, n, npad, tile, first, st, nstages, s));
    case 2:
      return static_cast<int>(
          vkrs::launch_block<2>(in0, in1, work, n, npad, tile, first, st, nstages, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The r (1-4) stages at distances 2^top, ..., 2^(top - r + 1) of the level
// of size 2^level over the whole work buffer in device memory, in one
// launch. Returns the cudaError_t of the launch.
extern "C" int vkrs_bitonic_group(int device, void* work, int nk, long long npad, int level,
                                  int top, int r, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (top - r + 1 < 0 || top >= level) return static_cast<int>(cudaErrorInvalidValue);
  switch (nk * 10 + r) {
    case 11: return static_cast<int>(vkrs::launch_group<1, 1>(work, npad, level, top, s));
    case 12: return static_cast<int>(vkrs::launch_group<1, 2>(work, npad, level, top, s));
    case 13: return static_cast<int>(vkrs::launch_group<1, 3>(work, npad, level, top, s));
    case 14: return static_cast<int>(vkrs::launch_group<1, 4>(work, npad, level, top, s));
    case 21: return static_cast<int>(vkrs::launch_group<2, 1>(work, npad, level, top, s));
    case 22: return static_cast<int>(vkrs::launch_group<2, 2>(work, npad, level, top, s));
    case 23: return static_cast<int>(vkrs::launch_group<2, 3>(work, npad, level, top, s));
    case 24: return static_cast<int>(vkrs::launch_group<2, 4>(work, npad, level, top, s));
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
