// Primitives shared by the radix kernels (histogram.cu, radix_dest.cu,
// fused.cu): an 8-bit digit of a key, and the stable rank of a warp's
// elements among equal digits (fused.cu finds the same rank by ballots).
#pragma once

#include <cuda_runtime.h>

namespace vkrs {

constexpr int kBins = 256;
constexpr unsigned kNoDigit = kBins;  // what a lane without an element matches on

// Digit (x >> shift) & 255 of element i of a strided int32 view: the 32-bit
// half of a key that holds the digit (stride 1 for u32 keys, 2 for u64).
__device__ __forceinline__ unsigned digit_at(const int* x, long long i, int stride, int shift) {
  return (static_cast<unsigned>(x[i * stride]) >> shift) & (kBins - 1);
}

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

}  // namespace vkrs
