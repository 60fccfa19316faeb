// The key-order transform of 4- and 8-byte keys in one pass:
// out[i] = in[i] ^ (top bit of in[i] set ? set_mask : clear_mask).
//
// Every sort path sorts unsigned keys in ascending order, so the dispatcher
// (ops/dispatch.py) maps other keys to their u32/u64 encoded order first and
// back after the sort (ops/common.encode_keys, complement, decode_keys):
// signed ints flip the sign bit; floats flip every bit if negative and the
// sign bit otherwise (IEEE-754 total order); descending= complements the
// result. Each of those, and each inverse, is one XOR with a mask chosen by
// the top bit of the input, so one kernel with two masks runs every
// direction (ops/keyorder.py works the masks out). torch runs the same
// transform in up to four launches each way, with a temporary each. It
// replaces no TPU kernel: XLA fuses the JAX package's transform into one
// pass of its own.
//
// What bounds it on an H100: device memory. The least traffic reads each
// key once and writes it once, 2 x key bytes a row. A thread moves kVecs
// 16-byte vectors, all loaded before any is stored; neighbouring threads
// take neighbouring vectors, so every access is coalesced. Where in or out
// is not 16-byte aligned (a slice of a tensor) the same kernel moves one key
// per access instead. in may equal out: each key is read and then written
// by the same thread, so the sort's output can be decoded in place.
#include <cstdint>

namespace vkrs {
namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // accesses in flight a thread

template <typename T>
struct Signed;
template <>
struct Signed<unsigned> {
  using type = int;
};
template <>
struct Signed<unsigned long long> {
  using type = long long;
};

// kPer keys of one access: 16 bytes when aligned, else one key
template <typename T, int kPer>
struct alignas(sizeof(T) * kPer) Pack {
  T v[kPer];
};

template <typename T>
__device__ __forceinline__ T reorder(T x, T set_mask, T clear_mask) {
  return x ^ (static_cast<typename Signed<T>::type>(x) < 0 ? set_mask : clear_mask);
}

// packs: whole accesses of kPer keys; the tail (fewer than kPer keys after
// them) goes to block 0's first threads.
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
    key_order_kernel(const Pack<T, kPer>* in, Pack<T, kPer>* out, long long packs,
                     const T* in_tail, T* out_tail, int tail, T set_mask, T clear_mask) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kVecs + threadIdx.x;
  Pack<T, kPer> p[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long i = first + static_cast<long long>(j) * kThreads;
    if (i < packs) p[j] = in[i];
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long i = first + static_cast<long long>(j) * kThreads;
    if (i < packs) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) p[j].v[k] = reorder(p[j].v[k], set_mask, clear_mask);
      out[i] = p[j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    out_tail[threadIdx.x] = reorder(in_tail[threadIdx.x], set_mask, clear_mask);
  }
}

template <typename T, int kPer>
void launch(const void* in, void* out, long long n, T set_mask, T clear_mask, cudaStream_t s) {
  const long long packs = n / kPer;
  const int tail = static_cast<int>(n - packs * kPer);
  const long long per_block = static_cast<long long>(kThreads) * kVecs;
  const long long blocks = packs > 0 ? (packs + per_block - 1) / per_block : 1;
  key_order_kernel<T, kPer><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const Pack<T, kPer>*>(in), static_cast<Pack<T, kPer>*>(out), packs,
      static_cast<const T*>(in) + packs * kPer, static_cast<T*>(out) + packs * kPer, tail,
      set_mask, clear_mask);
}

template <typename T>
void launch_width(const void* in, void* out, long long n, unsigned long long set_mask,
                  unsigned long long clear_mask, cudaStream_t s) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(in) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T sm = static_cast<T>(set_mask), cm = static_cast<T>(clear_mask);
  if (aligned) {
    launch<T, static_cast<int>(16 / sizeof(T))>(in, out, n, sm, cm, s);
  } else {
    launch<T, 1>(in, out, n, sm, cm, s);
  }
}

}  // namespace
}  // namespace vkrs

// out[i] = in[i] ^ (top bit of in[i] ? set_mask : clear_mask) for i < n
// keys of `width` bytes (4 or 8; the masks' low `width` bytes are used), on
// `device`. out is in, or apart from it. n >= 1. Returns the first
// cudaError_t.
extern "C" int vkrs_key_order(int device, const void* in, void* out, long long n, int width,
                              unsigned long long set_mask, unsigned long long clear_mask,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || (width != 4 && width != 8)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4) {
    vkrs::launch_width<unsigned>(in, out, n, set_mask, clear_mask, s);
  } else {
    vkrs::launch_width<unsigned long long>(in, out, n, set_mask, clear_mask, s);
  }
  return static_cast<int>(cudaGetLastError());
}
