// Merge-path level: merges sorted runs of `run` elements pairwise into
// sorted runs of 2 * run, one launch per run-doubling level, ping-ponging
// between the input and the output buffers.
//
// Replaces vkradixsort_tpu/ops/merge.py::_mergepath_kernel (launched by
// _mergepath_call once per level) and the split-point search of
// merge.py::_level_splits, which the TPU version ran in XLA before each
// launch.
//
// What bounds it on an H100: device memory. A level reads and writes every
// plane once (8 bytes per element per plane, 1.6 GB for 1e8 keys with one
// carry, 0.48 ms at 3.35 TB/s); the comparisons are a few per element. To
// come near that rate, many bytes must be in flight at every moment: a
// block that searches its splits by log2(run) dependent loads while its
// other threads wait, or that stages its windows and merges them in turn,
// leaves the memory idle (one block a tile of that shape reached about
// 1.1 TB/s on the H100).
//
// Design: persistent blocks, about two per SM, each owning a contiguous
// range of the level's output tiles of `tile` elements (a tile never spans
// two run pairs: tile divides 2 * run). A block is one producer warp and
// eight merging warps around a ring of two stages in shared memory:
//   - the producer warp finds each tile's co-ranks (how many of the outputs
//     before the tile's start, and before its end, come from the pair's A
//     run) cooperatively: each round its 32 lanes probe 32 evenly spaced
//     points of the interval with the predicate of _level_splits,
//     A[x] <= B[d-1-x] (A wins ties), and a ballot keeps the crossing, so a
//     full search takes at most six dependent loads at run 2^26 and a
//     tile's end, searched within `tile` of its start, three;
//   - it then stages the tile's A and B windows of every plane with TMA
//     bulk copies (cp.async.bulk, completion counted on the stage's
//     mbarrier). A window may start at any element, while a bulk copy
//     needs 16-byte-aligned addresses and sizes: the window lands at its
//     offset within its 16-byte line, the aligned middle goes by one bulk
//     copy, and the at most three elements before and after it by plain
//     loads, so nothing past a plane's end is read. The next tile's
//     co-ranks and copies proceed while the merging warps work on the
//     staged one;
//   - the merging warps find each thread's split inside the staged windows
//     by binary search (A first on ties again), merge its 4-16 outputs on
//     the key planes, and record each output's source as 16-byte chunks in
//     an XOR-swizzled array (conflict-free to write and to read), then
//     write every plane with coalesced 16-byte stores, each value read from
//     its staged window by source, and release the stage.
// A wins ties at the warp search, at the thread split and in the merge, so
// the merge is stable and the result is bitwise the JAX engine's. A lone
// last run with no partner has co-ranks equal to its diagonals and is
// copied through the same path. Runs are stored ascending and offsets are
// 64-bit, so inputs past 2^31 elements sort too.
#include <algorithm>
#include <cstdint>

#include "planes.cuh"

namespace vkrs {
namespace {

constexpr int kMergeConsumers = 256;                 // threads that merge and store
constexpr int kMergeThreads = kMergeConsumers + 32;  // and one producer warp
constexpr int kMergeStages = 2;
constexpr int kMergeSlack = 16;  // ints a staged plane holds past the tile (alignment)
constexpr int kMergeHeader = 256;  // bytes of barriers and tile records

struct TileMeta {
  long long out_start;
  int count, na, nb;
  // Source v of an output is A window element v for v < na, else B window
  // element v - na; plane k holds it at slot (v < na ? a_off[k] : b_off[k]) + v
  // of its staged windows.
  int a_off[kMaxPlanes];
  int b_off[kMaxPlanes];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16) from device memory to
// shared memory, both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(int* dst, const int* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The merging warps' barrier (named barrier 1; the producer never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kMergeConsumers) : "memory");
}

// Stages the `len` int32 elements at src (device memory) at dst + lead,
// lead being src's int offset within its 16-byte line, so that dst + lead
// + w and src + w share their alignment: lane 0 moves the aligned middle
// by one bulk copy (adding its bytes to bar's expected transactions), lanes
// 1-3 and 4-6 the at most three elements before and after it by plain
// loads. dst is 16-byte aligned. Returns lead.
__device__ __forceinline__ int stage_window(int* dst, const int* src, int len,
                                            unsigned long long* bar, int lane) {
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int h = min(len, (4 - lead) & 3);            // first aligned element
  const int t = max(h, ((lead + len) & ~3) - lead);  // end of the aligned middle
  if (lane == 0) {
    if (t > h) {
      const unsigned bytes = 4u * static_cast<unsigned>(t - h);
      mbar_expect_tx(bar, bytes);
      bulk_copy(dst + lead + h, src + h, bytes, bar);
    }
  } else if (lane <= 3) {
    const int w = lane - 1;
    if (w < h) dst[lead + w] = src[w];
  } else if (lane <= 6) {
    const int w = t + lane - 4;
    if (w < len) dst[lead + w] = src[w];
  }
  return lead;
}

// A[i] <= B[j] lexicographically on the compare planes, in device memory.
template <int NCK>
__device__ __forceinline__ bool le_global(const Planes& P, long long i, long long j) {
#pragma unroll
  for (int q = 0; q + 1 < NCK; ++q) {
    const int a = P.in[q][i], b = P.in[q][j];
    if (a != b) return a < b;
  }
  return P.in[NCK - 1][i] <= P.in[NCK - 1][j];
}

// Co-rank of diagonal d of the run pair whose A run starts at a0 and B run
// at b0, known to lie in [lo, hi]: the smallest x there with
// !(A[x] <= B[d-1-x]), or hi. The predicate holds on a prefix of the
// interval, so each round the warp's 32 probes, evenly spaced, cut it to
// the gap between the last probe that holds and the first that fails.
// Mirrored by ops/merge.coranks_plain.
template <int NCK>
__device__ long long warp_corank(const Planes& P, long long a0, long long b0, long long d,
                                 long long lo, long long hi, int lane) {
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long x = lo + lane * step;
    const bool p = x < hi && le_global<NCK>(P, a0 + x, b0 + d - 1 - x);
    const int k = __popc(__ballot_sync(0xffffffffu, p));
    if (k == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + k * step);
      lo += (k - 1) * step + 1;
    }
  }
  return lo;
}

// The staged key planes of one tile's windows: A[i] and B[j] of plane q at
// a[q][i] and b[q][j].
template <int NCK>
struct StagedKeys {
  const int* a[NCK];
  const int* b[NCK];
  __device__ __forceinline__ bool le(int i, int j) const {  // A[i] <= B[j]
#pragma unroll
    for (int q = 0; q + 1 < NCK; ++q) {
      const int x = a[q][i], y = b[q][j];
      if (x != y) return x < y;
    }
    return a[NCK - 1][i] <= b[NCK - 1][j];
  }
};

// Slot of 16-byte chunk c of a tile's source array: XOR-swizzled inside
// each group of eight chunks, so that a quarter warp writing chunks 4t + q
// and one reading chunks j, j + 1, ... both hit 32 distinct banks.
__device__ __forceinline__ int src_chunk(int c) { return c ^ ((c >> 3) & 7); }

template <int NCK, int NCARRY>
__global__ void __launch_bounds__(kMergeThreads)
    mergepath_kernel(Planes P, long long n, long long run, int tile, long long ntiles) {
  constexpr int NP = NCK + NCARRY;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* full = reinterpret_cast<unsigned long long*>(smem);  // [kMergeStages]
  unsigned long long* empty = full + kMergeStages;           // [kMergeStages]
  auto* meta = reinterpret_cast<TileMeta*>(empty + kMergeStages);
  const int cap = tile + kMergeSlack;  // ints a staged plane holds
  int* stage = reinterpret_cast<int*>(smem + kMergeHeader);  // [stage][plane][cap]
  int* srcs = stage + kMergeStages * NP * cap;                // [stage][tile]

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMergeStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kMergeConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long t0 = blockIdx.x * ntiles / gridDim.x;
  const long long ntile_mine = (blockIdx.x + 1) * ntiles / gridDim.x - t0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kMergeConsumers / 32) {
    // ---- producer: co-ranks, then the windows of every plane
    long long prev = -1;  // co-rank of the current tile's start
    for (long long it = 0; it < ntile_mine; ++it) {
      const int s = static_cast<int>(it % kMergeStages);
      const unsigned phase = static_cast<unsigned>(it / kMergeStages) & 1u;
      const long long out_start = (t0 + it) * tile;
      const long long a_start = out_start / (2 * run) * (2 * run);
      const long long a_len = min(run, n - a_start);
      const long long b_start = a_start + run;
      const long long b_len = b_start < n ? min(run, n - b_start) : 0;
      const long long diag = out_start - a_start;
      const int count = static_cast<int>(min(static_cast<long long>(tile), a_len + b_len - diag));
      if (prev < 0) {
        prev = warp_corank<NCK>(P, a_start, b_start, diag, max(0LL, diag - b_len),
                                min(diag, a_len), lane);
      }
      const long long d = diag + count;
      const bool pair_end = d == a_len + b_len;
      const long long a_hi =
          pair_end ? a_len
                   : warp_corank<NCK>(P, a_start, b_start, d, max(prev, d - b_len),
                                      min(prev + count, a_len), lane);
      const long long a_lo = prev;
      const int na = static_cast<int>(a_hi - a_lo);
      const int nb = count - na;
      prev = pair_end ? 0 : a_hi;

      mbar_wait(&empty[s], phase ^ 1u);  // the merging warps are done with stage s
      __syncwarp();
      if (lane == 0) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      TileMeta& m = meta[s];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        int* dst = stage + (s * NP + k) * cap;
        const int lead_a = stage_window(dst, P.in[k] + a_start + a_lo, na, &full[s], lane);
        const int b_dst = (lead_a + na + 3) & ~3;
        const int lead_b =
            stage_window(dst + b_dst, P.in[k] + b_start + (diag - a_lo), nb, &full[s], lane);
        if (lane == 0) {
          m.a_off[k] = lead_a;
          m.b_off[k] = b_dst + lead_b - na;
        }
      }
      if (lane == 0) {
        m.out_start = out_start;
        m.count = count;
        m.na = na;
        m.nb = nb;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- merging warps
  bool vec = true;  // every output plane 16-byte aligned
#pragma unroll
  for (int k = 0; k < NP; ++k) vec = vec && (reinterpret_cast<uintptr_t>(P.out[k]) & 15) == 0;
  // outputs a thread merges: a whole number of 16-byte chunks
  const int per = max(4, ((tile + kMergeConsumers - 1) / kMergeConsumers + 3) & ~3);
  const int ctid = threadIdx.x;
  for (long long it = 0; it < ntile_mine; ++it) {
    const int s = static_cast<int>(it % kMergeStages);
    mbar_wait(&full[s], static_cast<unsigned>(it / kMergeStages) & 1u);
    const TileMeta& m = meta[s];
    const int count = m.count, na = m.na, nb = m.nb;
    const int* st = stage + s * NP * cap;
    int* sr = srcs + s * tile;

    const int first = ctid * per;
    if (first < count) {
      const int last = min(first + per, count);
      StagedKeys<NCK> keys;
#pragma unroll
      for (int q = 0; q < NCK; ++q) {
        keys.a[q] = st + q * cap + m.a_off[q];
        keys.b[q] = st + q * cap + m.b_off[q] + na;
      }
      int lo = max(0, first - nb), hi = min(first, na);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys.le(mid, first - 1 - mid)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int i = lo, j = first - lo;
      for (int r = first; r < last; r += 4) {
        int v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (r + q < last) {
            const bool take_a = j >= nb || (i < na && keys.le(i, j));
            v[q] = take_a ? i++ : na + j++;
          }
        }
        *reinterpret_cast<int4*>(sr + 4 * src_chunk(r >> 2)) = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
    consumers_sync();  // every source of the tile is recorded

    const long long out_start = m.out_start;
    int a_off[NP], b_off[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      a_off[k] = m.a_off[k];
      b_off[k] = m.b_off[k];
    }
    for (int c = ctid; 4 * c < count; c += kMergeConsumers) {
      const int r = 4 * c;
      const int4 v4 = *reinterpret_cast<const int4*>(sr + 4 * src_chunk(c));
      const int v[4] = {v4.x, v4.y, v4.z, v4.w};
      const bool whole = vec && r + 4 <= count;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int* pk = st + k * cap;
        int o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = r + q < count ? pk[(v[q] < na ? a_off[k] : b_off[k]) + v[q]] : 0;
        }
        int* out = P.out[k] + out_start + r;
        if (whole) {
          *reinterpret_cast<int4*>(out) = make_int4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (r + q < count) out[q] = o[q];
          }
        }
      }
    }
    mbar_arrive(&empty[s]);  // stage s and its record may be refilled
  }
}

int mergepath_smem_bytes(int nplanes, int tile) {
  return kMergeHeader +
         kMergeStages * (nplanes * (tile + kMergeSlack) + tile) * static_cast<int>(sizeof(int));
}

// Blocks of mergepath_kernel<NCK, NCARRY> at `smem` bytes that `device`
// holds at once. The queries cost the host more than a launch, so each
// (device, shared memory) is asked once and remembered.
template <int NCK, int NCARRY>
cudaError_t resident_blocks(int device, int smem, long long* blocks) {
  struct Known {
    int device, smem;
    long long blocks;
  };
  static Known known[16];
  static int nknown = 0;
  for (int i = 0; i < nknown; ++i) {
    if (known[i].device == device && known[i].smem == smem) {
      *blocks = known[i].blocks;
      return cudaSuccess;
    }
  }
  auto* kernel = mergepath_kernel<NCK, NCARRY>;
  int sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // allow every size the device takes, so that no later launch needs a call
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMergeThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;  // more shared memory than a block may take
  *blocks = static_cast<long long>(sms) * per_sm;
  if (nknown < 16) known[nknown++] = {device, smem, *blocks};
  return cudaSuccess;
}

template <int NCK, int NCARRY>
cudaError_t launch_mergepath(const Planes& P, long long n, long long run, int tile, int device,
                             cudaStream_t stream) {
  tile = static_cast<int>(std::min(2 * run, static_cast<long long>(tile)));
  const int smem = mergepath_smem_bytes(NCK + NCARRY, tile);
  auto* kernel = mergepath_kernel<NCK, NCARRY>;
  long long resident = 0;
  cudaError_t err = resident_blocks<NCK, NCARRY>(device, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + tile - 1) / tile;
  const long long blocks = std::min(ntiles, resident);
  kernel<<<static_cast<unsigned>(blocks), kMergeThreads, smem, stream>>>(P, n, run, tile, ntiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vkrs

// Merges the sorted runs of `run` elements (a power of two) of the planes
// in[0..nck+ncarry) pairwise into out[...] on `device`, in output tiles of
// min(tile, 2 * run) elements (tile: a power of two >= 4); n >= 1. Returns
// the cudaError_t of the launch.
extern "C" int vkrs_mergepath(int device, void* const* in, void* const* out, int nck,
                              int ncarry, long long n, long long run, int tile, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile < 4 || (tile & (tile - 1))) return static_cast<int>(cudaErrorInvalidValue);
  const vkrs::Planes P = vkrs::make_planes(in, out, nck + ncarry);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VKRS_DISPATCH_PLANES(nck, ncarry, vkrs::launch_mergepath, P, n, run, tile, device, s)
}
