// Samplesort run placement: copies every (row, bucket) run of the sorted
// rows into its static slot of the bucket matrix, with the fill around it.
//
// Replaces vkradixsort_tpu/ops/samplesort.py::_placement_kernel (launched by
// _place_runs), which DMA'd each run HBM->HBM from its start floored to 1024
// (the TPU's HBM tiling), and the masking pass after it
// (samplesort.py:257-264, :420-430), which set everything outside each
// slot's valid window [pre, pre + len) to the fill.
//
// What bounds it on an H100: bytes. It is a pure copy: every element of the
// rows is read once and every slot element written once. At 1e8 stable u32
// kv (G = 48 rows of C = 2,083,456, B = 48 buckets, cap = 58,752) it reads
// about 1.2 GB and writes 48 * 48 * 58,752 * 3 * 4 B = 1.62 GB, about
// 0.84 ms at 3.35 TB/s.
//
// Design: one block per slot (b, g), blockIdx.x = b * G + g, which copies
// row g's run [start, start + len) of every plane into slot (b, g) and
// writes the plane's fill into the rest, in the same pass, with consecutive
// threads on consecutive elements (coalesced loads and stores). The GPU
// needs no alignment of the start, so the valid window of every slot is
// [0, len) (pre = 0) and the slot width is `cap`. The keys-value pipeline
// moves its three planes (keys, positions, values; fills sentinel, INT32_MAX
// and 0) in one launch. Element widths are template parameters (4 or 8
// bytes), so 8-byte keys move as they are. Offsets are 64-bit.
#include <type_traits>

#include <cuda_runtime.h>

namespace vkrs {
namespace {

constexpr int kPlaceThreads = 256;
constexpr int kMaxPlacePlanes = 3;

struct PlacePlanes {
  const void* src[kMaxPlacePlanes];  // (G, C) rows
  void* dst[kMaxPlacePlanes];        // (B, G, cap) slots
  unsigned long long fill[kMaxPlacePlanes];
};

template <int BYTES>
__device__ __forceinline__ void place_plane(const void* src, void* dst, unsigned long long fill,
                                            long long src_off, long long dst_off, int len,
                                            int cap) {
  using T = std::conditional_t<BYTES == 8, unsigned long long, unsigned>;
  const T* s = static_cast<const T*>(src) + src_off;
  T* d = static_cast<T*>(dst) + dst_off;
  const T f = static_cast<T>(fill);
  for (int j = threadIdx.x; j < cap; j += blockDim.x) d[j] = j < len ? s[j] : f;
}

// B0, B1, B2: element bytes of planes 0, 1, 2 (0: no such plane).
template <int B0, int B1, int B2>
__global__ void __launch_bounds__(kPlaceThreads)
    placement_kernel(PlacePlanes P, const int* __restrict__ starts, const int* __restrict__ lens,
                     int G, long long C, int B, int cap) {
  const int g = blockIdx.x % G;
  const int b = blockIdx.x / G;
  const long long src_off = g * C + starts[g * B + b];
  const long long dst_off = static_cast<long long>(blockIdx.x) * cap;
  const int len = lens[g * B + b];
  place_plane<B0>(P.src[0], P.dst[0], P.fill[0], src_off, dst_off, len, cap);
  if constexpr (B1 != 0) place_plane<B1>(P.src[1], P.dst[1], P.fill[1], src_off, dst_off, len, cap);
  if constexpr (B2 != 0) place_plane<B2>(P.src[2], P.dst[2], P.fill[2], src_off, dst_off, len, cap);
}

template <int B0, int B1, int B2>
cudaError_t launch_placement(const PlacePlanes& P, const int* starts, const int* lens, int G,
                             long long C, int B, int cap, cudaStream_t stream) {
  placement_kernel<B0, B1, B2><<<static_cast<unsigned>(G) * B, kPlaceThreads, 0, stream>>>(
      P, starts, lens, G, C, B, cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// Places the runs of the (G, C) row planes src[0..nplanes) into the
// (B, G, cap) slot planes dst[...]: slot (b, g) of a plane holds
// src[g, starts[g, b] + j] for j < lens[g, b] and fill[plane] for the rest
// (starts and lens (G, B) int32, every run inside its row and at most cap
// long). nplanes 1 (keys of key_bytes) or 3 (keys, int32 positions, values
// of val_bytes); widths 4 or 8. Returns the cudaError_t of the launch.
extern "C" int vkrs_placement(int device, void* const* src, void* const* dst,
                              const unsigned long long* fill, int nplanes, int key_bytes,
                              int val_bytes, const void* starts, const void* lens, int G,
                              long long C, int B, int cap, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  vkrs::PlacePlanes P = {};
  for (int i = 0; i < nplanes && i < vkrs::kMaxPlacePlanes; ++i) {
    P.src[i] = src[i];
    P.dst[i] = dst[i];
    P.fill[i] = fill[i];
  }
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nplanes * 100 + key_bytes * 10 + val_bytes) {
    case 140: return static_cast<int>(vkrs::launch_placement<4, 0, 0>(P, st, ln, G, C, B, cap, s));
    case 180: return static_cast<int>(vkrs::launch_placement<8, 0, 0>(P, st, ln, G, C, B, cap, s));
    case 344: return static_cast<int>(vkrs::launch_placement<4, 4, 4>(P, st, ln, G, C, B, cap, s));
    case 348: return static_cast<int>(vkrs::launch_placement<4, 4, 8>(P, st, ln, G, C, B, cap, s));
    case 384: return static_cast<int>(vkrs::launch_placement<8, 4, 4>(P, st, ln, G, C, B, cap, s));
    case 388: return static_cast<int>(vkrs::launch_placement<8, 4, 8>(P, st, ln, G, C, B, cap, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
