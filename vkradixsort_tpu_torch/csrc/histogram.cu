// Per-tile 256-bin digit histograms: one radix pass's counting step.
//
// Replaces vkradixsort_tpu/ops/histogram.py::_hist_kernel (launched by
// tile_histograms), which counted each tile's digits as a (16, T) x (T, 16)
// one-hot contraction on the TPU's matrix unit, since the TPU has no atomics.
//
// What bounds it on an H100: device memory. It reads each key's 32-bit half
// that holds the digit once (4 B per key, 0.4 GB for 1e8 u32 keys) and
// writes 1 KB per tile (0.05 GB at tile 2048), so about 0.13 ms a pass at
// 3.35 TB/s.
//
// Design: the reference's histogram shader (multi_radixsort_histograms.comp
// 31-56). One block of 256 threads per tile builds the tile's 256-bin
// histogram in shared memory with integer atomicAdd, exact in any order,
// and writes it as row t of the [num_tiles, 256] table. Elements past n are
// never read (the guard i < n), so no sentinel padding exists and the ragged
// last tile counts only its real elements. u64 keys are read as a strided
// int32 view of the half that holds the digit.
#include "radix.cuh"

namespace vkrs {
namespace {

__global__ void __launch_bounds__(kBins)
    histogram_kernel(const int* x, long long n, int stride, int shift, int tile, int* out) {
  __shared__ int hist[kBins];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const int valid = static_cast<int>(min(static_cast<long long>(tile), n - base));
  for (int i = threadIdx.x; i < valid; i += blockDim.x) {
    atomicAdd(&hist[digit_at(x, base + i, stride, shift)], 1);
  }
  __syncthreads();
  out[static_cast<long long>(blockIdx.x) * kBins + threadIdx.x] = hist[threadIdx.x];
}

}  // namespace
}  // namespace vkrs

// Writes the [cdiv(n, tile), 256] int32 histograms of the digits
// (x[i * stride] >> shift) & 255, i < n, to `out` on `device`. n >= 1,
// tile >= 1, 0 <= shift < 32. Returns the cudaError_t of the launch.
extern "C" int vkrs_histogram(int device, const void* x, long long n, int stride, int shift,
                              int tile, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + tile - 1) / tile;
  vkrs::histogram_kernel<<<static_cast<unsigned>(blocks), vkrs::kBins, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), n, stride, shift, tile, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
