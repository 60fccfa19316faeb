// One stable radix pass after its histogram and scan: each element ranked
// among the equal digits of its tile and, in the scatter mode, moved with its
// payload to base[tile, digit] + rank; in the destination mode, that slot is
// only written out.
//
// Replaces vkradixsort_tpu/ops/radix_tiled.py::_dest_kernel (launched by
// pass_destinations), which ranked each tile's elements by a log-doubling
// prefix sum of a (256, T) digit one-hot over lane rolls, since the TPU has
// no warp ballot, and the XLA scatter of keys and payload that followed it
// (radix_tiled.py:125-132).
//
// What bounds it on an H100: device memory. The scatter mode reads each key
// and payload once and writes them once (16 B an element for u32 keys with a
// 4-byte payload: 0.48 ms a pass for 1e8 at 3.35 TB/s), and reads the
// [num_tiles, 256] base table (1 KB a tile). A scatter whose every 4-byte
// store lands on its own address costs a 32-byte sector a store; a pass
// that writes each digit's elements of a tile as one run of consecutive
// addresses fills its sectors.
//
// Design: the reference's rank-and-scatter shader (multi_radixsort.comp
// 83-126) and onesweep's local sort, with the tile sort's in-block pass
// (tilesort.cu). One block per tile of `tile` elements, taken in rounds of
// kPer elements a thread (16 for elements of 8 bytes or less, 8 for 16; one
// round for tiles up to 16384 or 8192):
//   1. load: warp w owns round elements [32 kPer w, 32 kPer (w + 1)),
//      a thread its lane of each 32-element strip, so every warp load reads
//      whole 128-byte lines; key and payload go to registers once;
//   2. each warp counts its digits in its own row of shared memory; the block
//      scan (radix.cuh: block_digit_offsets) turns the rows into each warp's
//      first slot per digit in the round's digit-sorted order;
//   3. each warp ranks its strips in element order (radix.cuh:
//      strip_rank_ballot, eight ballots a strip) and
//        - scatter mode: stores key and payload, packed into one slot where
//          they fit 8 or 16 bytes, into shared memory at that slot; then
//          thread i reads slot i and writes it to next[d] + (i - first[d]),
//          so consecutive threads write consecutive addresses within each
//          digit's run;
//        - destination mode: writes next[d] + (slot - first[d]) as int32 at
//          the element's own index;
//      where first[d] is the round's first slot of digit d and next[d] the
//      global slot of the tile's next element of digit d (base[t, d], moved
//      on by every round's count).
// Equal digits keep element order within a strip, across strips and warps
// (the scan), across rounds (next) and across tiles (the bin-major base
// table), so each pass is the stable pass and the sort is the one stable
// order. Offsets are int32: the wrapper refuses n >= 2^31.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "radix.cuh"

namespace vkrs {
namespace {

constexpr int kPassMinThreads = kBins;  // one thread per digit in the scan
constexpr int kPassMaxThreads = 1024;

// An element staged in shared memory: key and payload in one slot, so that
// the rank's scatter moves it with one store. VB = 0: the key alone; a
// 4-byte key and a payload of at most 4 bytes: one 8-byte word (payload
// above); otherwise 16 bytes, {key, payload}.
template <typename K, int VB>
struct Staged {
  using V = Payload<VB == 0 ? 1 : VB>;
  static constexpr bool kWide = VB != 0 && (sizeof(K) == 8 || VB == 8);
  using T = std::conditional_t<VB == 0, K, std::conditional_t<kWide, ulonglong2, uint64_t>>;
  // Elements a thread holds in a round: 16 where an element fits 8 bytes,
  // so that a tile of 8192 takes 512 threads and two blocks fit an SM's
  // registers; 8 for 16-byte elements, whose registers 16 would exceed.
  static constexpr int kPer = sizeof(T) <= 8 ? 16 : 8;
  __device__ static T pack(K k, V v) {
    if constexpr (VB == 0) {
      return k;
    } else if constexpr (kWide) {
      return make_ulonglong2(k, v);
    } else {
      return (static_cast<uint64_t>(v) << 32) | k;
    }
  }
  __device__ static K key(T t) {
    if constexpr (VB == 0) {
      return t;
    } else if constexpr (kWide) {
      return static_cast<K>(t.x);
    } else {
      return static_cast<K>(t);
    }
  }
  __device__ static V val(T t) {
    if constexpr (VB == 0) {
      return 0;
    } else if constexpr (kWide) {
      return static_cast<V>(t.y);
    } else {
      return static_cast<V>(t >> 32);
    }
  }
};

// keys: the keys; in the destination mode, the 32-bit half of each key that
// holds the digit, element i at keys[i * stride]. vals/out_vals: VB bytes an
// element (unused at VB = 0). The scatter mode writes out_keys and out_vals,
// the destination mode dest.
template <typename K, int VB, bool kScatter>
__global__ void __launch_bounds__(kPassMaxThreads)
    radix_pass_kernel(const K* __restrict__ keys, int stride,
                      const typename Staged<K, VB>::V* __restrict__ vals, long long n, int shift,
                      int tile, const int* __restrict__ base, K* __restrict__ out_keys,
                      typename Staged<K, VB>::V* __restrict__ out_vals, int* __restrict__ dest) {
  using S = Staged<K, VB>;
  using V = typename S::V;
  constexpr int kPer = S::kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next[kBins];   // global slot of the tile's next element of each digit
  __shared__ int first[kBins];  // the round's first slot of each digit
  __shared__ int warp_sum[kPassMinThreads / 32];
  const int nwarps = blockDim.x >> 5;
  const int cap = blockDim.x * kPer;
  typename S::T* stage = reinterpret_cast<typename S::T*>(smem);
  int* count = reinterpret_cast<int*>(smem + (kScatter ? cap * sizeof(typename S::T) : 0));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mine = warp * 32 * kPer + lane;  // strip s's element: mine + 32 s
  int* my_count = count + warp * kBins;
  const long long t0 = static_cast<long long>(blockIdx.x) * tile;
  const int len = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  if (threadIdx.x < kBins) {
    next[threadIdx.x] = base[static_cast<long long>(blockIdx.x) * kBins + threadIdx.x];
  }

  for (int r0 = 0; r0 < len; r0 += cap) {
    const long long g0 = t0 + r0;
    const int valid = min(cap, len - r0);
    K key[kPer];
    V val[kPer];
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int i = mine + 32 * s;
      const long long at = kScatter ? g0 + i : (g0 + i) * stride;
      key[s] = i < valid ? keys[at] : K(0);
      if constexpr (VB != 0) {
        val[s] = i < valid ? vals[g0 + i] : V(0);
      } else {
        val[s] = V(0);
      }
    }
    for (int i = threadIdx.x; i < nwarps * kBins; i += blockDim.x) count[i] = 0;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      if (mine + 32 * s < valid) atomicAdd(&my_count[digit_of(key[s], shift)], 1);
    }
    __syncthreads();
    int total;
    const int start = block_digit_offsets(count, nwarps, warp_sum, total);
    if (threadIdx.x < kBins) first[threadIdx.x] = start;
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int i = mine + 32 * s;
      if (i - lane >= valid) break;  // warp-uniform: the strip holds no element
      const bool ok = i < valid;
      const unsigned d = ok ? digit_of(key[s], shift) : kNoDigit;
      const int at = strip_rank_ballot(my_count, d, ok);
      if (ok) {
        if constexpr (kScatter) {
          stage[at] = S::pack(key[s], val[s]);
        } else {
          dest[g0 + i] = next[d] + (at - first[d]);
        }
      }
    }
    if constexpr (kScatter) {
      __syncthreads();  // the round is staged in digit order
      for (int i = threadIdx.x; i < valid; i += blockDim.x) {
        const typename S::T t = stage[i];
        const K k = S::key(t);
        const unsigned d = digit_of(k, shift);
        const int o = next[d] + (i - first[d]);
        out_keys[o] = k;
        if constexpr (VB != 0) out_vals[o] = S::val(t);
      }
    }
    __syncthreads();  // every thread is done with next, first, the rows and the stage
    if (threadIdx.x < kBins) next[threadIdx.x] += total;
  }
}

// One launch, one block per tile, with enough threads for the tile in one
// round (a multiple of 32 from 256 to 1024) and the dynamic shared memory
// they need: the stage (scatter mode) and a row of 256 counters a warp.
template <typename K, int VB, bool kScatter>
cudaError_t launch_pass(const void* keys, int stride, const void* vals, long long n, int shift,
                        int tile, const void* base, void* out_keys, void* out_vals, void* dest,
                        cudaStream_t stream) {
  using S = Staged<K, VB>;
  using V = typename S::V;
  constexpr int kPer = S::kPer;
  const long long want = (static_cast<long long>(tile) + kPer - 1) / kPer;
  const int threads = static_cast<int>(std::min<long long>(
      std::max<long long>((want + 31) / 32 * 32, kPassMinThreads), kPassMaxThreads));
  const int stage_bytes = threads * kPer * static_cast<int>(sizeof(typename S::T));
  const int rows_bytes = threads / 32 * kBins * static_cast<int>(sizeof(int));
  const int smem = (kScatter ? stage_bytes : 0) + rows_bytes;
  if (smem > 40 * 1024) {  // past the default 48 KB, with the static arrays (2 KB)
    const cudaError_t err = cudaFuncSetAttribute(
        radix_pass_kernel<K, VB, kScatter>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (n + tile - 1) / tile;
  radix_pass_kernel<K, VB, kScatter><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const K*>(keys), stride, static_cast<const V*>(vals), n, shift, tile,
      static_cast<const int*>(base), static_cast<K*>(out_keys), static_cast<V*>(out_vals),
      static_cast<int*>(dest));
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_scatter(const void* keys, const void* vals, int val_bytes, long long n,
                           int shift, int tile, const void* base, void* out_keys,
                           void* out_vals, cudaStream_t s) {
  switch (val_bytes) {
    case 0:
      return launch_pass<K, 0, true>(keys, 1, vals, n, shift, tile, base, out_keys, out_vals,
                                     nullptr, s);
    case 1:
      return launch_pass<K, 1, true>(keys, 1, vals, n, shift, tile, base, out_keys, out_vals,
                                     nullptr, s);
    case 2:
      return launch_pass<K, 2, true>(keys, 1, vals, n, shift, tile, base, out_keys, out_vals,
                                     nullptr, s);
    case 4:
      return launch_pass<K, 4, true>(keys, 1, vals, n, shift, tile, base, out_keys, out_vals,
                                     nullptr, s);
    case 8:
      return launch_pass<K, 8, true>(keys, 1, vals, n, shift, tile, base, out_keys, out_vals,
                                     nullptr, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vkrs

// Writes dest[i] = base[i / tile, d_i] + #(j < i in the same tile with
// d_j = d_i), d_i = (x[i * stride] >> shift) & 255, for i < n, on `device`.
// base: [cdiv(n, tile), 256] int32; dest: n int32. n >= 1, tile >= 1,
// 0 <= shift < 32. Returns the cudaError_t of the launch.
extern "C" int vkrs_radix_dest(int device, const void* x, long long n, int stride, int shift,
                               int tile, const void* base, void* dest, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vkrs::launch_pass<unsigned, 0, false>(
      x, stride, nullptr, n, shift, tile, base, nullptr, nullptr, dest,
      static_cast<cudaStream_t>(stream)));
}

// Moves key i (key_bytes 4 or 8) and its payload (val_bytes 0, 1, 2, 4 or
// 8; vals and out_vals unused at 0) to slot base[i / tile, d_i] + #(j < i in
// the same tile with d_j = d_i) of out_keys and out_vals, d_i = (key_i >>
// shift) & 255, for i < n, on `device`. base: [cdiv(n, tile), 256] int32, the
// exclusive scan of the tiles' digit counts in bin-major order, so that the
// slots are a permutation of [0, n). n >= 1, tile >= 1,
// 0 <= shift < 8 * key_bytes. Returns the cudaError_t of the launch.
extern "C" int vkrs_radix_scatter(int device, const void* keys, int key_bytes, const void* vals,
                                  int val_bytes, long long n, int shift, int tile,
                                  const void* base, void* out_keys, void* out_vals,
                                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    return static_cast<int>(vkrs::launch_scatter<unsigned>(keys, vals, val_bytes, n, shift, tile,
                                                           base, out_keys, out_vals, s));
  }
  if (key_bytes == 8) {
    return static_cast<int>(vkrs::launch_scatter<unsigned long long>(
        keys, vals, val_bytes, n, shift, tile, base, out_keys, out_vals, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
