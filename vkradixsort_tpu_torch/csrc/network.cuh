// The bitonic engine's compare-exchange (bitonic.cu). Elements are NCK int32
// key planes compared lexicographically, then a position that is distinct
// for every element, so the order is strict and total and any bitonic
// network sorts it to the one stable order. An element in a thread's
// registers is an Elem.
#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace vkrs {

// Key of a padding slot, in every plane. Pads carry positions past every
// real element, so real keys equal to INT_MAX still sort first.
constexpr int kPadKey = INT_MAX;

// An element held in a thread's registers, packed so that one compare orders
// it lexicographically on (keys..., position): one key plane and the
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

}  // namespace vkrs
