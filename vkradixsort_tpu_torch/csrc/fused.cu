// Whole stable LSD radix sort of a small array in one launch.
//
// Replaces vkradixsort_tpu/ops/fused.py::_make_kernel (launched by
// _sort_fused_impl), which held the whole array in VMEM as 16-bit float
// planes and ran 4-bit sub-passes whose permutation was applied by one-hot
// matrix products, since the TPU has neither atomics nor a scatter.
//
// What bounds it on an H100: not device memory (N <= 32768 keys and payloads
// are read once and written once: 0.5 MB for u32 kv, 0.15 us at 3.35 TB/s)
// but latency: 4 (u32) or 8 (u64) passes run one after another, each a chain
// of shared-memory atomics, a scan, warp ballots and barriers, and a scatter
// whose stores cross SMs. So the design keeps every pass on chip, every load
// in flight at once, and spreads the ranking over eight SMs.
//
// Design: the reference's single-workgroup shader (single_radixsort.comp
// 42-137), with 8-bit digits, on a cluster of kFusedCtas = 8 blocks of 512
// threads whose shared memory holds the array between passes:
//   - load once: global warp W (of 128) owns a contiguous part of the array,
//     a whole number of 32-element strips, and each thread loads its element
//     of every strip into registers with all loads in flight (at most 8).
//     An element carries its position (below 2^15, two to a register) in
//     place of the payload.
//   - each pass, from registers:
//     1. each warp counts its digits in its own row of shared memory
//        (integer atomicAdd);
//     2. each block sums its rows per digit, the blocks trade these sums
//        through distributed shared memory after a cluster barrier, and a
//        scan over the 256 digits turns each warp's row into its starting
//        destination per digit: the digit's scan, plus the counts of
//        earlier blocks, plus those of earlier warps;
//     3. each warp ranks its strips in element order (strip_rank_ballot:
//        radix.cuh's stable rank, with the lanes of equal digit found by
//        eight ballots) and scatters each element, key and position packed
//        in one slot, with one store into the shared memory of the block
//        that owns its destination (distributed shared memory for the
//        others);
//     4. a cluster barrier, then each thread reads its elements of the next
//        pass back into registers. No pass touches device memory.
//   - write once: after the last pass each block writes its part of the
//     sorted keys and gathers the payload by the final positions, coalesced
//     on the write side.
// Why a cluster: one block holding 32768 u32 keys and positions in
// registers needs 48 of the 64 registers a thread has at 1024 threads, and
// 32768 u64 keys (256 KB) do not fit one block's 227 KB of shared memory; a
// cluster of blocks shares the array, and u32 and u64 keys take one design.
// Eight blocks, the portable most, because the scatter's stores into other
// blocks' shared memory bound a pass by the stores each SM issues. The TPU's
// 4-bit sub-passes, float planes, one-hot matmul permutation and padding to
// 8192 are not carried over: a stable LSD sort's result does not depend on
// the digit width.
#include <cooperative_groups.h>

#include <type_traits>

#include "radix.cuh"

namespace cg = cooperative_groups;

namespace vkrs {
namespace {

constexpr int kFusedWarps = 16;
constexpr int kFusedThreads = kFusedWarps * 32;
constexpr int kFusedCtas = 8;        // blocks of the cluster (the portable most)
constexpr int kFusedMaxN = 1 << 15;  // positions fit 15 bits (ops/fused.py MAX_N)
constexpr int kFusedPerBlock = kFusedMaxN / kFusedCtas;      // elements a block holds at most
constexpr int kFusedStrips = kFusedPerBlock / kFusedThreads;  // elements a thread holds

// Slot (radix.cuh): key and position in one slot, so that the scatter moves
// it with one store.
template <typename K>
constexpr int fused_smem_bytes() {
  return kFusedPerBlock * static_cast<int>(sizeof(typename Slot<K>::T));
}

// Position of strip s's element, two 16-bit positions to a register.
__device__ __forceinline__ int pos_of(const unsigned (&pos2)[kFusedStrips / 2], int s) {
  return static_cast<int>((pos2[s >> 1] >> (16 * (s & 1))) & 0xFFFFu);
}

template <typename K, int VBYTES>
__global__ void __launch_bounds__(kFusedThreads, 1)
    fused_kernel(const K* __restrict__ keys_in, const void* __restrict__ vals_in,
                 K* __restrict__ keys_out, void* __restrict__ vals_out, int n) {
  using V = std::conditional_t<VBYTES == 8, unsigned long long, unsigned>;
  constexpr int kPasses = static_cast<int>(sizeof(K));  // one per byte
  extern __shared__ __align__(16) unsigned char smem[];
  using S = Slot<K>;
  auto* slots = reinterpret_cast<typename S::T*>(smem);  // this block's part of the array
  __shared__ int count[kFusedWarps][kBins];
  __shared__ int block_total[kBins];
  __shared__ int warp_sum[kBins / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int part = (n + kFusedCtas * kFusedThreads - 1) / (kFusedCtas * kFusedThreads) * 32;
  const int strips = part / 32;  // warp-uniform
  const int per_block = kFusedWarps * part;
  const int local0 = warp * part + lane;  // strip s's element: local0 + 32 s in this block
  const int first = rank * per_block + local0;  // and first + 32 s in the array

  K key[kFusedStrips];
  unsigned pos2[kFusedStrips / 2];
#pragma unroll
  for (int s = 0; s < kFusedStrips; ++s) {
    const int i = first + 32 * s;
    key[s] = s < strips && i < n ? keys_in[i] : K(0);
  }
#pragma unroll
  for (int s = 0; s < kFusedStrips; s += 2) {
    pos2[s >> 1] = static_cast<unsigned>(first + 32 * s) |
                   (static_cast<unsigned>(first + 32 * (s + 1)) << 16);
  }

  for (int p = 0; p < kPasses; ++p) {
    const int shift = 8 * p;

    for (int i = threadIdx.x; i < kFusedWarps * kBins; i += kFusedThreads) {
      (&count[0][0])[i] = 0;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kFusedStrips; ++s) {
      if (s < strips && first + 32 * s < n) atomicAdd(&count[warp][digit_of(key[s], shift)], 1);
    }
    __syncthreads();

    // one thread per digit (warps 0-7, whole warps)
    int total = 0, all = 0, inc = 0, before = 0;
    if (threadIdx.x < kBins) {
      for (int w = 0; w < kFusedWarps; ++w) total += count[w][threadIdx.x];
      block_total[threadIdx.x] = total;
    }
    cluster.sync();  // every block's totals are written, and every element is in registers
    if (threadIdx.x < kBins) {
      for (int r = 0; r < kFusedCtas; ++r) {
        const int t = r == rank ? total : *cluster.map_shared_rank(&block_total[threadIdx.x], r);
        all += t;
        if (r < rank) before += t;
      }
      inc = all;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      if (lane == 31) warp_sum[warp] = inc;
    }
    __syncthreads();
    if (threadIdx.x < kBins) {
      const int d = threadIdx.x;
      int run = inc - all + before;
      for (int w = 0; w < warp; ++w) run += warp_sum[w];
      for (int w = 0; w < kFusedWarps; ++w) {
        const int c = count[w][d];
        count[w][d] = run;
        run += c;
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kFusedStrips; ++s) {
      if (s < strips) {  // warp-uniform: every lane ranks the strip together
        const bool ok = first + 32 * s < n;
        const unsigned d = ok ? digit_of(key[s], shift) : kNoDigit;
        const int at = strip_rank_ballot(count[warp], d, ok);
        if (ok) {
          const int owner = at / per_block;
          const int local = at - owner * per_block;
          cluster.map_shared_rank(slots, owner)[local] = S::pack(key[s], pos_of(pos2, s));
        }
      }
    }
    cluster.sync();  // the scatter is complete in every block

    if (p + 1 < kPasses) {
#pragma unroll
      for (int s = 0; s < kFusedStrips; s += 2) {
        unsigned lo = 0, hi = 0;
        if (s < strips && first + 32 * s < n) {
          const auto v = slots[local0 + 32 * s];
          key[s] = S::key(v);
          lo = S::pos(v);
        }
        if (s + 1 < strips && first + 32 * (s + 1) < n) {
          const auto v = slots[local0 + 32 * (s + 1)];
          key[s + 1] = S::key(v);
          hi = S::pos(v);
        }
        pos2[s >> 1] = lo | (hi << 16);
      }
    }
  }

  // each block reads only its own shared memory from here on
  const int base = rank * per_block;
  const int mine = min(per_block, n - base);
  for (int i = threadIdx.x; i < mine; i += kFusedThreads) {
    const auto v = slots[i];
    keys_out[base + i] = S::key(v);
    if constexpr (VBYTES != 0) {
      static_cast<V*>(vals_out)[base + i] = static_cast<const V*>(vals_in)[S::pos(v)];
    }
  }
}

template <typename K, int VBYTES>
cudaError_t launch_fused(const void* keys_in, const void* vals_in, void* keys_out,
                         void* vals_out, int n, cudaStream_t stream) {
  const int smem = fused_smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<K, VBYTES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kFusedCtas);
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kFusedCtas;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_kernel<K, VBYTES>, static_cast<const K*>(keys_in), vals_in,
                           static_cast<K*>(keys_out), vals_out, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// Sorts n (1 <= n <= 32768) keys of key_bytes (4 or 8) bytes, as unsigned
// ints, stably, and carries a payload of val_bytes (0, 4 or 8) bytes; the
// sorted keys and payloads land in keys_out / vals_out; keys_in / vals_in
// are only read. Payload pointers may be null when val_bytes is 0. Returns
// the cudaError_t of the launch.
extern "C" int vkrs_fused(int device, const void* keys_in, const void* vals_in, void* keys_out,
                          void* vals_out, int n, int key_bytes, int val_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > vkrs::kFusedMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using K32 = unsigned;
  using K64 = unsigned long long;
  switch (key_bytes * 10 + val_bytes) {
    case 40: err = vkrs::launch_fused<K32, 0>(keys_in, vals_in, keys_out, vals_out, n, s); break;
    case 44: err = vkrs::launch_fused<K32, 4>(keys_in, vals_in, keys_out, vals_out, n, s); break;
    case 48: err = vkrs::launch_fused<K32, 8>(keys_in, vals_in, keys_out, vals_out, n, s); break;
    case 80: err = vkrs::launch_fused<K64, 0>(keys_in, vals_in, keys_out, vals_out, n, s); break;
    case 84: err = vkrs::launch_fused<K64, 4>(keys_in, vals_in, keys_out, vals_out, n, s); break;
    case 88: err = vkrs::launch_fused<K64, 8>(keys_in, vals_in, keys_out, vals_out, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
