// Primitives shared by the radix kernels (histogram.cu, radix_dest.cu,
// onesweep.cu, fused.cu, tilesort.cu): an 8-bit digit of a key, a payload's
// type, an element packed with its position in one shared-memory slot, the
// stable rank of a warp's elements among equal digits, found by
// __match_any_sync (strip_rank), by eight ballots (strip_rank_ballot) or by
// a ballot and shared-memory atomicOr (strip_rank_or), a strip's digit count
// (strip_count), and the block scan of an in-block pass
// (block_digit_offsets).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace vkrs {

constexpr int kBins = 256;
constexpr unsigned kNoDigit = kBins;  // what a lane without an element matches on

// Digit (x >> shift) & 255 of element i of a strided int32 view: the 32-bit
// half of a key that holds the digit (stride 1 for u32 keys, 2 for u64).
__device__ __forceinline__ unsigned digit_at(const int* x, long long i, int stride, int shift) {
  return (static_cast<unsigned>(x[i * stride]) >> shift) & (kBins - 1);
}

// The unsigned type of a payload of VB bytes (1, 2, 4 or 8).
template <int VB>
using Payload = std::conditional_t<
    VB == 1, uint8_t,
    std::conditional_t<VB == 2, uint16_t, std::conditional_t<VB == 4, uint32_t, uint64_t>>>;

// Digit (k >> shift) & 255 of an unsigned key.
template <typename K>
__device__ __forceinline__ unsigned digit_of(K k, int shift) {
  return static_cast<unsigned>(k >> shift) & (kBins - 1);
}

// An element in shared memory: an unsigned key and its position in one
// slot, so that a scatter moves it with one store.
template <typename K>
struct Slot;
template <>
struct Slot<unsigned> {
  using T = unsigned long long;  // position << 32 | key
  __device__ static T pack(unsigned k, int pos) { return (static_cast<T>(pos) << 32) | k; }
  __device__ static unsigned key(T s) { return static_cast<unsigned>(s); }
  __device__ static int pos(T s) { return static_cast<int>(s >> 32); }
};
template <>
struct Slot<unsigned long long> {
  using T = ulonglong2;  // {key, position}
  __device__ static T pack(unsigned long long k, int pos) {
    return make_ulonglong2(k, static_cast<unsigned long long>(pos));
  }
  __device__ static unsigned long long key(T s) { return s.x; }
  __device__ static int pos(T s) { return static_cast<int>(s.y); }
};

// One 32-element strip of a warp's elements, in element order: every lane
// of the warp calls this together, `valid` lanes with their element's digit
// `d`. Returns counter[d] plus the number of lower lanes with the same digit
// (the element's stable place), and advances counter[d] past the strip's
// elements of that digit. `counter` belongs to this warp alone.
__device__ __forceinline__ int strip_rank(int* counter, unsigned d, bool valid) {
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? d : kNoDigit);
  const unsigned lane = threadIdx.x & 31;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int start = valid ? counter[d] : 0;
  __syncwarp();  // every lane has read counter[d] before its group's first lane moves it
  if (valid && rank == 0) counter[d] = start + __popc(peers);
  __syncwarp();
  return start + rank;
}

// strip_rank with the lanes of equal digit found by eight ballots, one per
// digit bit, in place of __match_any_sync, whose throughput bounds a pass
// when one SM ranks many strips: the same peers, so the same stable rank.
// Every lane of the warp calls it together; `counter` is the warp's.
__device__ __forceinline__ int strip_rank_ballot(int* counter, unsigned d, bool valid) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? vote : ~vote;
  }
  const unsigned lane = threadIdx.x & 31;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int start = valid ? counter[d] : 0;
  __syncwarp();  // every lane has read counter[d] before its group's first lane moves it
  if (valid && rank == 0) counter[d] = start + __popc(peers);
  __syncwarp();
  return start + rank;
}

// Counts a warp's 32-element strip into `counter` (the warp's own): every
// lane of the warp calls it together, `valid` lanes with their digit `d`.
// The lanes that share lane 0's digit add once, through lane 0, and the
// others one each, so a strip of one digit (a skewed pass) costs one add.
__device__ __forceinline__ void strip_count(int* counter, unsigned d, bool valid) {
  const unsigned lead = __shfl_sync(0xffffffffu, d, 0);
  const unsigned same = __ballot_sync(0xffffffffu, valid && d == lead);
  if (valid && d != lead) atomicAdd(&counter[d], 1);
  if ((threadIdx.x & 31) == 0 && same) atomicAdd(&counter[lead], __popc(same));
}

// strip_rank with the lanes of equal digit found by one ballot for lane 0's
// digit and, for the other lanes, one shared-memory atomicOr a lane into
// peers[d] (the warp's own 256 words, zero between strips): a fraction of
// the instructions of eight ballots, and one ballot where a strip holds one
// digit. The same peers, so the same stable rank. Every lane of the warp
// calls it together; `counter` and `peers` are the warp's.
__device__ __forceinline__ int strip_rank_or(int* counter, unsigned* peers, unsigned d,
                                             bool valid) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned lead = __shfl_sync(0xffffffffu, d, 0);
  const unsigned same = __ballot_sync(0xffffffffu, valid && d == lead);
  const bool other = valid && d != lead;
  if (other) atomicOr(&peers[d], 1u << lane);
  __syncwarp();
  const unsigned group = other ? peers[d] : same;
  const int rank = __popc(group & ((1u << lane) - 1u));
  const int start = valid ? counter[d] : 0;
  __syncwarp();  // every lane has read counter[d] and peers[d] before its group's leader moves them
  if (valid && rank == 0) {
    counter[d] = start + __popc(group);
    if (other) peers[d] = 0;
  }
  __syncwarp();
  return start + rank;
}

// The block scan of one in-block radix pass (tilesort.cu, radix_dest.cu):
// turns each warp's digit counts, row w of `count` (nwarps rows of 256, in
// shared memory), into that warp's first slot for each digit in the block's
// digit-sorted order: the elements of smaller digits, then those of the same
// digit in earlier warps. Every thread of the block calls it after a barrier
// that completes the counts; threads 0-255 (one per digit) do the work, so
// the block has at least 256 threads. It returns, to thread d < 256, the
// first slot of digit d and in `total` the digit's count (0 to the others).
// `warp_sum`: 8 ints of shared memory. The rows hold the slots after the
// caller's next barrier.
__device__ __forceinline__ int block_digit_offsets(int* count, int nwarps, int* warp_sum,
                                                   int& total) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int inc = 0;
  total = 0;
  if (threadIdx.x < kBins) {
    for (int w = 0; w < nwarps; ++w) total += count[w * kBins + threadIdx.x];
    inc = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) warp_sum[warp] = inc;
  }
  __syncthreads();
  int start = 0;
  if (threadIdx.x < kBins) {
    start = inc - total;
    for (int w = 0; w < warp; ++w) start += warp_sum[w];
    int run = start;
    for (int w = 0; w < nwarps; ++w) {
      const int c = count[w * kBins + threadIdx.x];
      count[w * kBins + threadIdx.x] = run;
      run += c;
    }
  }
  return start;
}

}  // namespace vkrs
