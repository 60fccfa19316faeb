// The bitonic compare-exchange network shared by the tile sort (tilesort.cu)
// and the bitonic engine (bitonic.cu). Elements are NCK int32 key planes
// compared lexicographically, then a position that is distinct for every
// element, so the order is strict and total and any bitonic network sorts it
// to the one stable order. Key plane k of element x lives at sk[k * stride +
// x] and its position at spos[x], in shared or in device memory alike, or in
// a thread's registers (Elem).
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

// An element held in a thread's registers, packed so that one compare orders
// it on (keys..., position) as orders_after does: one key plane and the
// position as key << 32 | position (the position is not negative, so one
// signed 64-bit compare is the lexicographic one); two key planes as
// hi << 32 | (lo with its sign bit flipped), whose signed 64-bit order is the
// planes' lexicographic order, then the position.
template <int NCK>
struct Elem;

// x's bits in the high half of a 64-bit word.
__device__ __forceinline__ unsigned long long high(int x) {
  return static_cast<unsigned long long>(static_cast<unsigned>(x)) << 32;
}

template <>
struct Elem<1> {
  long long v;
  __device__ __forceinline__ static Elem of(const int (&k)[1], int pos) {
    return {static_cast<long long>(high(k[0]) | static_cast<unsigned>(pos))};
  }
  __device__ __forceinline__ bool after(const Elem& o) const { return v > o.v; }
  __device__ __forceinline__ int key(int) const { return static_cast<int>(v >> 32); }
  __device__ __forceinline__ int pos() const { return static_cast<int>(v); }
};

template <>
struct Elem<2> {
  long long v;
  int p;
  __device__ __forceinline__ static Elem of(const int (&k)[2], int pos) {
    return {static_cast<long long>(high(k[0]) | (static_cast<unsigned>(k[1]) ^ 0x80000000u)),
            pos};
  }
  __device__ __forceinline__ bool after(const Elem& o) const {
    return v != o.v ? v > o.v : p > o.p;
  }
  __device__ __forceinline__ int key(int q) const {
    return q == 0 ? static_cast<int>(v >> 32) : static_cast<int>(v) ^ INT_MIN;
  }
  __device__ __forceinline__ int pos() const { return p; }
};

// The compare-exchange on elements e[a], e[b] (a < b) of a thread's
// registers. a and b must be compile-time constants after unrolling, so the
// array stays in registers.
template <int NCK, int N>
__device__ __forceinline__ void exchange_elems(Elem<NCK> (&e)[N], int a, int b, bool ascending) {
  const bool swap = e[a].after(e[b]) == ascending;
  const Elem<NCK> x = e[a], y = e[b];
  e[a] = swap ? y : x;
  e[b] = swap ? x : y;
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
