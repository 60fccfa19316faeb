// Scatter destinations of one radix pass: base[tile, digit] + stable rank.
//
// Replaces vkradixsort_tpu/ops/radix_tiled.py::_dest_kernel (launched by
// pass_destinations), which ranked each tile's elements by a log-doubling
// prefix sum of a (256, T) digit one-hot over lane rolls, since the TPU has
// no warp ballot.
//
// What bounds it on an H100: device memory. It reads the 32-bit half of each
// key that holds the digit (4 B per key) and the [num_tiles, 256] base table
// (1 KB per tile) once, and writes one int32 destination per key: 0.85 GB,
// about 0.25 ms a pass at 3.35 TB/s, for 1e8 u32 keys at tile 2048.
//
// Design: the reference's rank-and-scatter shader (multi_radixsort.comp
// 83-126), without the scatter. One block of 8 warps per tile; warp w owns
// a contiguous part of the tile, a whole number of 32-element strips.
//   1. Each warp counts its part's digits in its own row of shared memory
//      (integer atomicAdd, exact in any order).
//   2. One thread per digit turns the rows into each warp's starting
//      destination: base[t, d] plus the counts of digit d in earlier warps.
//   3. Each warp walks its strips in element order: __match_any_sync on the
//      digit finds the lanes with equal digits, popc(peers & lanemask_lt) is
//      the rank among them, and the warp's running counter for the digit
//      carries the rank from strip to strip (radix.cuh: strip_rank).
// Equal digits thus keep element order within strips, across strips, across
// warps (step 2) and across tiles (the bin-major base table), so the pass is
// stable. Step 3 reads the keys again; a tile is 8 KB, so they come from L2.
// Destinations are int32: the wrapper refuses n >= 2^31.
#include "radix.cuh"

namespace vkrs {
namespace {

constexpr int kDestWarps = 8;

__global__ void __launch_bounds__(kDestWarps * 32)
    radix_dest_kernel(const int* x, long long n, int stride, int shift, int tile,
                      const int* base, int* dest) {
  __shared__ int count[kDestWarps][kBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kDestWarps * kBins; i += blockDim.x) (&count[0][0])[i] = 0;
  __syncthreads();

  const long long t0 = static_cast<long long>(blockIdx.x) * tile;
  const int valid = static_cast<int>(min(static_cast<long long>(tile), n - t0));
  const int part = ((tile + kDestWarps * 32 - 1) / (kDestWarps * 32)) * 32;
  const int begin = min(warp * part, valid);
  const int end = min(begin + part, valid);

  for (int i = begin + lane; i < end; i += 32) {
    atomicAdd(&count[warp][digit_at(x, t0 + i, stride, shift)], 1);
  }
  __syncthreads();

  for (int d = threadIdx.x; d < kBins; d += blockDim.x) {
    int run = base[static_cast<long long>(blockIdx.x) * kBins + d];
#pragma unroll
    for (int w = 0; w < kDestWarps; ++w) {
      const int c = count[w][d];
      count[w][d] = run;
      run += c;
    }
  }
  __syncthreads();

  for (int s = begin; s < end; s += 32) {  // warp-uniform bounds
    const int i = s + lane;
    const bool ok = i < end;
    const unsigned d = ok ? digit_at(x, t0 + i, stride, shift) : kNoDigit;
    const int at = strip_rank(count[warp], d, ok);
    if (ok) dest[t0 + i] = at;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + tile - 1) / tile;
  vkrs::radix_dest_kernel<<<static_cast<unsigned>(blocks), vkrs::kDestWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), n, stride, shift, tile, static_cast<const int*>(base),
      static_cast<int*>(dest));
  return static_cast<int>(cudaGetLastError());
}
