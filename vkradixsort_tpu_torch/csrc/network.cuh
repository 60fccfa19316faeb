// The bitonic compare-exchange network shared by the tile sort (tilesort.cu)
// and the bitonic engine (bitonic.cu). Elements are NCK int32 key planes
// compared lexicographically, then a position that is distinct for every
// element, so the order is strict and total and any bitonic network sorts it
// to the one stable order. Key plane k of element x lives at sk[k * stride +
// x] and its position at spos[x], in shared or in device memory alike.
#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace vkrs {

// Key of a padding slot, in every plane. Pads carry positions past every
// real element, so real keys equal to INT_MAX still sort first.
constexpr int kPadKey = INT_MAX;

// True when element i orders after element l on (keys..., position).
template <int NCK, typename I>
__device__ __forceinline__ bool orders_after(const int* sk, const int* spos, I stride, I i, I l) {
  int a = sk[i], b = sk[l];
  if (a != b) return a > b;
  if (NCK == 2) {
    a = sk[stride + i];
    b = sk[stride + l];
    if (a != b) return a > b;
  }
  return spos[i] > spos[l];
}

// Puts elements i < l in ascending (or descending) order.
template <int NCK, typename I>
__device__ __forceinline__ void compare_exchange(int* sk, int* spos, I stride, I i, I l,
                                                 bool ascending) {
  if (orders_after<NCK>(sk, spos, stride, i, l) == ascending) {
#pragma unroll
    for (int k = 0; k < NCK; ++k) {
      const int t = sk[k * stride + i];
      sk[k * stride + i] = sk[k * stride + l];
      sk[k * stride + l] = t;
    }
    const int t = spos[i];
    spos[i] = spos[l];
    spos[l] = t;
  }
}

// Stages one tile of `tile` slots in shared memory, by the whole block: slot
// i < valid holds in[k][base + i], the others (kPadKey...); slot i's
// position is pos0 + i.
template <int NCK>
__device__ __forceinline__ void stage_padded(const int* const* in, int* sk, int* spos,
                                             long long base, int valid, int tile, long long pos0) {
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const bool real = i < valid;
#pragma unroll
    for (int k = 0; k < NCK; ++k) sk[k * tile + i] = real ? in[k][base + i] : kPadKey;
    spos[i] = static_cast<int>(pos0 + i);
  }
}

// Stages j = first, first / 2, ..., 1 of the network's level `size` on a
// tile staged in shared memory, by the whole block, with a barrier after
// each. Slot i sorts ascending when bit `size` of its global index gbase + i
// is clear.
template <int NCK>
__device__ __forceinline__ void tile_stages(int* sk, int* spos, int tile, long long gbase,
                                            long long size, int first) {
  const int half = tile >> 1;
  for (int j = first; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      compare_exchange<NCK>(sk, spos, tile, i, i + j, ((gbase + i) & size) == 0);
    }
    __syncthreads();
  }
}

}  // namespace vkrs
