// The card's radix sort: onesweep (Adinets & Merrill, "Onesweep: A Faster
// Least Significant Digit Radix Sort for GPUs", 2022). One upfront kernel
// counts the digits of every pass in one read of the keys and scans them
// (digit_histograms); then one kernel a pass ranks each tile's elements and
// moves them with their payload, its tiles finding their global digit bases
// by decoupled look-back (onesweep_pass).
//
// On the sort route (ops/radix_tiled.sort_radix_tiled on a CUDA tensor) they
// stand for vkradixsort_tpu/ops/histogram.py::_hist_kernel, launched once a
// pass there, and vkradixsort_tpu/ops/radix_tiled.py::_dest_kernel, with the
// XLA scan between them and the XLA scatter after. The per-pass kernels of
// the JAX package's API (histogram.cu, radix_dest.cu) stay for that API.
//
// What bounds them on an H100: device memory. The histogram reads each key
// once (4 or 8 B: 0.12 ms for 1e8 u32 keys at 3.35 TB/s); a pass reads and
// writes each key and payload once (16 B an element for u32 keys with a
// 4-byte payload: 0.48 ms for 1e8). The per-pass pipeline also read every
// key once a pass to count it, built and scanned a [tiles, 256] table, and
// ran one 1024-thread block on each SM that loaded, counted, ranked and
// wrote in turn. Here:
//   - the histogram kernel counts every pass's digits in one read, in shared
//     memory; a thread keeps a run of equal digits a pass and adds a run
//     with one atomic, so under skew (Zipf keys put 97-100% of a pass in one
//     digit) it adds once for many keys. Its last block to finish (a done
//     counter) scans each pass's 256 counts into offset[p, d], the first
//     output slot of digit d in pass p;
//   - a pass takes tiles in the order of an atomic counter, not blockIdx, so
//     a tile waits only on tiles that run or are done. A tile counts its
//     digits (strip_count: one add for the lanes that share lane 0's digit),
//     publishes the counts, scans them in the block, and thread d < 256 sums
//     digit d's counts of earlier tiles back to the first that published its
//     inclusive prefix, then publishes its own: offset[p, d] plus digit d in
//     earlier tiles, the [tiles, 256] table's row, with no table and no scan;
//   - the warps past the first 256 threads rank their strips (strips of 32
//     elements, ranked in order by strip_rank_or) and stage them in digit
//     order while the look-back runs; the tile is written from the stage,
//     each digit's run to consecutive addresses;
//   - a tile is kThreads x kPer elements a block, sized so that two blocks
//     share an SM (registers and shared memory), so one block's loads and
//     stores overlap the other's rank and look-back (PERF.md has the sweep);
//   - a sort of keys with their u32 row positions (an argsort, or keys whose
//     payload set is gathered after the sort) runs its first pass as the
//     positions instance (vkrs_onesweep_positions_pass), which makes each
//     element's position from its index where the others read a payload, so
//     the positions are never written out before the sort nor read by it.
//
// The row-segmented kernels sort every row of a [rows, width] array on its
// own (a batched segment sort, as a top-p sampler sorts each request's
// logits), where the JAX package ran one lax.sort along dimension 1: one
// digit_histograms_rows_kernel counts and scans every row's digits of every
// pass and adds the row's first slot; one onesweep_rows_kernel a pass cuts
// each row into tiles of its own (the last one partial), so a tile never
// holds two rows, and its look-back stops at the row's first tile, which
// publishes the row's offsets as its prefix. Their positions instance makes
// row-local positions (index - row x width). Each shares its body with its
// 1-D kernel (count_and_scan_digits, onesweep_tile), which runs it as the
// case of one row.
//
// Look-back words (32 bits, one a tile and digit, zeroed before each pass):
// 0 not yet published; count + 1 (below 2^31) the tile's count; kInclusive
// | prefix the sum of the digit over tiles up to this one, the pass's offset
// included. The prefix is below n < 2^31, the envelope the wrapper keeps.
// Words are read and written as relaxed device-scope atomics
// (ld/st.relaxed.gpu): a word carries all that its reader uses, and no other
// memory is read on the strength of it, so no acquire or release order is
// needed; the acquire and release forms cost 15% of the pass and more
// (PERF.md).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "radix.cuh"

namespace vkrs {
namespace {

constexpr unsigned kInclusive = 0x80000000u;
constexpr int kHistThreads = 1024;
constexpr int kHistUnroll = 2;  // 16-byte loads in flight a thread
constexpr int kHistBlocksPerSm = 2;

// Threads and elements a thread of each (key, payload) width's pass: two
// blocks on each SM (registers cap a thread at 64 at 512 threads, 128 at
// 256; the stage and the rows fit two blocks' shared memory), and the
// look-back words of 1e8 rows below 16 MB for elements of up to 12 bytes.
template <typename K, int VB>
struct Shape {
  static constexpr int kBytes = static_cast<int>(sizeof(K)) + VB;  // an element's
  static constexpr int kThreads = kBytes <= 12 ? 512 : 256;
  static constexpr int kPer = kBytes <= 8 ? 15 : kBytes <= 12 ? 13 : 23;
  static constexpr int kMinBlocks = 2;
  static constexpr int kTile = kThreads * kPer;
  static constexpr int kWarps = kThreads / 32;  // a count row and a peers row each
  static constexpr int kStageBytes = kTile * kBytes;  // keys, then payloads
  static constexpr int kSmemBytes = kStageBytes + 2 * kWarps * kBins * 4;
};

__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A thread's runs of equal digits, one a pass: a key adds to its pass's run,
// and a run goes to h ([passes][256] in shared memory) with one atomic when
// the digit changes, so under skew a thread adds once for many keys.
template <typename K>
struct DigitRuns {
  static constexpr int kPasses = sizeof(K);
  unsigned digit[kPasses];
  int count[kPasses];

  __device__ DigitRuns() {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) digit[p] = count[p] = 0;
  }

  __device__ void add(int* h, K k) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const unsigned d = digit_of(k, 8 * p);
      if (d != digit[p]) {
        if (count[p]) atomicAdd(&h[p * kBins + digit[p]], count[p]);
        digit[p] = d;
        count[p] = 0;
      }
      ++count[p];
    }
  }

  __device__ void flush(int* h) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (count[p]) atomicAdd(&h[p * kBins + digit[p]], count[p]);
    }
  }
};

// The histogram kernels' body for keys [rows, width] (rows 1 for the 1-D
// kernel), `parts` blocks a row: this block is part `part` of row `row`,
// whose keys start at `keys`, and it loads and counts as the other parts do.
// offsets: [passes][rows][256] int32 and one done count a row after them,
// zeroed; the row's last block to finish turns each pass's counts of the row
// into their exclusive scan plus `first`, the row's first output slot.
template <typename K>
__device__ __forceinline__ void count_and_scan_digits(const K* __restrict__ keys,
                                                      long long width, long long rows,
                                                      long long row, int part, int parts,
                                                      int first, int* offsets) {
  constexpr int kPasses = sizeof(K);
  constexpr int kVec = 16 / sizeof(K);  // keys a 16-byte load
  __shared__ int h[kPasses * kBins];
  __shared__ int warp_sum[kBins / 32];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kPasses * kBins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  // keys [0, head) of the row before its first 16-byte boundary and the
  // tail after its last whole vector go to thread 0 of the row's part 0
  const long long skip = (16 - reinterpret_cast<uintptr_t>(keys) % 16) % 16 / sizeof(K);
  const long long head = min(width, skip);
  const long long nvec = (width - head) / kVec;
  const uint4* body = reinterpret_cast<const uint4*>(keys + head);
  const long long stride = static_cast<long long>(parts) * blockDim.x;
  DigitRuns<K> runs;
  for (long long v0 = static_cast<long long>(part) * blockDim.x + threadIdx.x; v0 < nvec;
       v0 += stride * kHistUnroll) {
    uint4 x[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const long long v = v0 + stride * u;
      x[u] = v < nvec ? __ldg(body + v) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (v0 + stride * u >= nvec) break;
      K k[kVec];
      static_assert(sizeof(k) == sizeof(uint4), "a vector is 16 bytes of keys");
      memcpy(k, &x[u], sizeof(uint4));
#pragma unroll
      for (int e = 0; e < kVec; ++e) runs.add(h, k[e]);
    }
  }
  if (part == 0 && threadIdx.x == 0) {
    for (long long i = 0; i < head; ++i) runs.add(h, keys[i]);
    for (long long i = head + nvec * kVec; i < width; ++i) runs.add(h, keys[i]);
  }
  runs.flush(h);
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kBins; i += blockDim.x) {
    if (h[i]) atomicAdd(&offsets[(i / kBins * rows + row) * kBins + i % kBins], h[i]);
  }
  __threadfence();  // this block's counts are in device memory before it counts itself done
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&offsets[kPasses * rows * kBins + row], 1) == parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = 0; p < kPasses; ++p) {
    int* mine = offsets + (p * rows + row) * kBins;
    int* sums = h + p * kBins;
    if (threadIdx.x < kBins) sums[threadIdx.x] = __ldcg(&mine[threadIdx.x]);
    __syncthreads();
    int total;
    const int start = block_digit_offsets(sums, 1, warp_sum, total);
    if (threadIdx.x < kBins) mine[threadIdx.x] = first + start;
    __syncthreads();  // warp_sum is free for the next pass
  }
}

// offsets: [passes * 256 + 1] int32, zeroed; counts into [0, passes * 256),
// the last word counts the blocks done. The last block turns each pass's
// counts into their exclusive scan.
template <typename K>
__global__ void __launch_bounds__(kHistThreads)
    digit_histograms_kernel(const K* __restrict__ keys, long long n, int* offsets) {
  count_and_scan_digits<K>(keys, n, 1, 0, blockIdx.x, gridDim.x, 0, offsets);
}

// The row-segmented digit_histograms_kernel: keys [rows, width], `parts`
// blocks a row (block b takes part b % parts of row b / parts). offsets:
// [passes][rows][256] int32 and one done count a row after them, zeroed; a
// row's offsets start at row x width, the row's first output slot.
template <typename K>
__global__ void __launch_bounds__(kHistThreads)
    digit_histograms_rows_kernel(const K* __restrict__ row0, long long rows, long long width,
                                 int parts, int* offsets) {
  const long long row = blockIdx.x / parts;
  const int part = blockIdx.x - static_cast<int>(row) * parts;
  count_and_scan_digits<K>(row0 + row * width, width, rows, row, part, parts,
                           static_cast<int>(row * width),  // below rows x width < 2^31
                           offsets);
}

// The pass kernels' body: one stable pass over the digit (key >> shift) &
// 255 of keys [rows, width] (kRows) or of n = width keys in one row. Block b
// takes tile t (from next_tile): tile t % tiles_per_row of row t /
// tiles_per_row, whose tiles start at row x width (the last one partial), so
// no tile holds two rows; it writes element i of the tile to offset[row, d]
// + (digit d in the row's tiles before it) + (digit d before i in the tile),
// the look-back stopping at the row's first tile, which publishes its
// inclusive prefix at once. offset: [rows, 256], the pass's slab of the
// digit histograms. status: [tiles, 256] look-back words, zeroed.
// kPositions (VB 4 only): an element's payload is its u32 position in its
// row, made here and not read (vals unused).
template <typename K, int VB, bool kPositions, bool kRows>
__device__ __forceinline__ void onesweep_tile(const K* __restrict__ keys,
                                              const Payload<VB == 0 ? 1 : VB>* __restrict__ vals,
                                              long long width, int tiles_per_row, int shift,
                                              const int* __restrict__ offset, unsigned* status,
                                              int* next_tile, K* __restrict__ out_keys,
                                              Payload<VB == 0 ? 1 : VB>* __restrict__ out_vals) {
  using S = Shape<K, VB>;
  using V = Payload<VB == 0 ? 1 : VB>;
  static_assert(!kPositions || VB == 4, "positions are u32");
  constexpr int kPer = S::kPer;
  __shared__ int base[kBins];  // digit d's first global slot, less its first slot in the tile
  __shared__ int warp_sum[kBins / 32];
  __shared__ int tile_id;
  extern __shared__ __align__(16) unsigned char smem[];
  K* stage_k = reinterpret_cast<K*>(smem);
  V* stage_v = reinterpret_cast<V*>(smem + S::kTile * sizeof(K));
  // a row of digit counts and a row of strip_rank_or's words a warp
  int* count = reinterpret_cast<int*>(smem + S::kStageBytes);
  unsigned* peers = reinterpret_cast<unsigned*>(count + S::kWarps * kBins);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mine = warp * 32 * kPer + lane;  // strip s's element: mine + 32 s
  int* my_count = count + warp * kBins;
  unsigned* my_peers = peers + warp * kBins;

  for (int i = threadIdx.x; i < S::kWarps * kBins; i += S::kThreads) count[i] = peers[i] = 0;
  if (threadIdx.x == 0) tile_id = atomicAdd(next_tile, 1);
  __syncthreads();
  const int t = tile_id;
  int in_row = t;
  long long g0 = 0;  // the row's first element
  if constexpr (kRows) {
    const int row = t / tiles_per_row;
    in_row = t - row * tiles_per_row;
    g0 = row * width;
    offset += static_cast<size_t>(row) * kBins;  // the row's first slots
  }
  const long long p0 = static_cast<long long>(in_row) * S::kTile;  // the tile's place in its row
  g0 += p0;
  const int valid = static_cast<int>(min(static_cast<long long>(S::kTile), width - p0));
  const bool first = in_row == 0;  // the row's first tile

  // 1. load: warp w owns elements [32 kPer w, 32 kPer (w + 1)), a lane its
  //    place in each 32-element strip, so each warp load reads whole lines
  K key[kPer];
  V val[kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int i = mine + 32 * s;
    key[s] = i < valid ? keys[g0 + i] : K(0);
    if constexpr (kPositions) {
      val[s] = static_cast<V>(p0 + i);  // its place in its row, below width < 2^31
    } else if constexpr (VB != 0) {
      val[s] = i < valid ? vals[g0 + i] : V(0);
    } else {
      val[s] = V(0);
    }
  }
  // 2. count: each warp its digits in its row
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int i = mine + 32 * s;
    if (i - lane >= valid) break;  // warp-uniform: the strip holds no element
    const bool ok = i < valid;
    strip_count(my_count, ok ? digit_of(key[s], shift) : kNoDigit, ok);
  }
  __syncthreads();
  // 3. publish the tile's counts; the tile's first slot of each digit (each
  //    warp's in its row); look back for the tile's global bases
  unsigned* word = status + static_cast<size_t>(t) * kBins + threadIdx.x;
  if (threadIdx.x < kBins) {
    int total = 0;
    for (int w = 0; w < S::kWarps; ++w) total += count[w * kBins + threadIdx.x];
    store_word(word, first ? kInclusive | static_cast<unsigned>(offset[threadIdx.x] + total)
                           : static_cast<unsigned>(total) + 1u);
  }
  int total;
  const int start = block_digit_offsets(count, S::kWarps, warp_sum, total);
  __syncthreads();  // the rows hold each warp's first slots
  if (threadIdx.x < kBins) {
    // thread d sums digit d's counts of the tiles before this one back to
    // the first that published its inclusive prefix
    const int d = threadIdx.x;
    int before = offset[d];  // slots of digit d before this tile's first
    if (!first) {
      before = 0;
      for (const unsigned* p = word - kBins;; p -= kBins) {  // ends at the row's first tile
        unsigned w;
        do {
          w = load_word(p);
        } while (w == 0);
        if (w & kInclusive) {
          before += static_cast<int>(w & ~kInclusive);
          break;
        }
        before += static_cast<int>(w - 1u);
      }
      store_word(word, kInclusive | static_cast<unsigned>(before + total));
    }
    base[d] = before - start;
  }
  // 4. rank, from the rows, and stage the tile in digit order; the warps
  //    past the look-back's rank while it runs
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int i = mine + 32 * s;
    if (i - lane >= valid) break;
    const bool ok = i < valid;
    const unsigned d = ok ? digit_of(key[s], shift) : kNoDigit;
    const int at = strip_rank_or(my_count, my_peers, d, ok);
    if (ok) {
      stage_k[at] = key[s];
      if constexpr (VB != 0) stage_v[at] = val[s];
    }
  }
  __syncthreads();  // the tile is staged; base is set
  // 5. write: thread i moves slot i to base[d] + i, so consecutive threads
  //    write consecutive addresses within each digit's run
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * S::kThreads;
    if (i < valid) {
      const K k = stage_k[i];
      const int o = base[digit_of(k, shift)] + i;
      out_keys[o] = k;
      if constexpr (VB != 0) out_vals[o] = stage_v[i];
    }
  }
}

// One stable pass over the digit (key >> shift) & 255 of n keys: block b
// takes tile t (from next_tile), elements [t * kTile, (t + 1) * kTile), and
// writes element i of it to offset[d] + (digit d in tiles before t) + (digit
// d before i in tile t). status: [tiles, 256] look-back words, zeroed.
// kPositions (VB 4 only): element g's payload is g, its u32 row position,
// made here and not read (vals unused).
template <typename K, int VB, bool kPositions = false>
__global__ void __launch_bounds__(Shape<K, VB>::kThreads, Shape<K, VB>::kMinBlocks)
    onesweep_kernel(const K* __restrict__ keys, const Payload<VB == 0 ? 1 : VB>* __restrict__ vals,
                    long long n, int shift, const int* __restrict__ offset, unsigned* status,
                    int* next_tile, K* __restrict__ out_keys,
                    Payload<VB == 0 ? 1 : VB>* __restrict__ out_vals) {
  onesweep_tile<K, VB, kPositions, false>(keys, vals, n, 0, shift, offset, status, next_tile,
                                          out_keys, out_vals);
}

// onesweep_kernel for every row of [rows, width] on its own, tiles_per_row
// tiles a row. offset: [rows, 256], the pass's slab of the row histograms.
// kPositions: an element's payload is its u32 position in its row.
template <typename K, int VB, bool kPositions = false>
__global__ void __launch_bounds__(Shape<K, VB>::kThreads, Shape<K, VB>::kMinBlocks)
    onesweep_rows_kernel(const K* __restrict__ keys,
                         const Payload<VB == 0 ? 1 : VB>* __restrict__ vals, long long width,
                         int tiles_per_row, int shift, const int* __restrict__ offset,
                         unsigned* status, int* next_tile, K* __restrict__ out_keys,
                         Payload<VB == 0 ? 1 : VB>* __restrict__ out_vals) {
  onesweep_tile<K, VB, kPositions, true>(keys, vals, width, tiles_per_row, shift, offset, status,
                                         next_tile, out_keys, out_vals);
}

template <typename K, int VB, bool kPositions = false, bool kRows = false>
cudaError_t set_stage(void) {
  if constexpr (kRows) {
    return cudaFuncSetAttribute(onesweep_rows_kernel<K, VB, kPositions>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Shape<K, VB>::kSmemBytes);
  } else {
    return cudaFuncSetAttribute(onesweep_kernel<K, VB, kPositions>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Shape<K, VB>::kSmemBytes);
  }
}

// Zeroes the look-back words and tile counter and launches one pass of the
// instance onesweep_kernel<K, VB, kPositions> on stream s.
template <typename K, int VB, bool kPositions>
cudaError_t launch_pass(const void* keys, const void* vals, long long n, int shift,
                        const void* offset, void* lookback, void* out_keys, void* out_vals,
                        cudaStream_t s) {
  using S = Shape<K, VB>;
  using V = Payload<VB == 0 ? 1 : VB>;
  const long long tiles = (n + S::kTile - 1) / S::kTile;
  cudaError_t e = set_stage<K, VB, kPositions>();
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(lookback, 0, (tiles * kBins + 1) * sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  unsigned* status = static_cast<unsigned*>(lookback);
  const unsigned blocks = static_cast<unsigned>(tiles);
  onesweep_kernel<K, VB, kPositions><<<blocks, S::kThreads, S::kSmemBytes, s>>>(
      static_cast<const K*>(keys), static_cast<const V*>(vals), n, shift,
      static_cast<const int*>(offset), status, reinterpret_cast<int*>(status + tiles * kBins),
      static_cast<K*>(out_keys), static_cast<V*>(out_vals));
  return cudaGetLastError();
}

// launch_pass for the rows of [rows, width]: onesweep_rows_kernel<K, VB,
// kPositions>, cdiv(width, kTile) tiles a row.
template <typename K, int VB, bool kPositions>
cudaError_t launch_rows_pass(const void* keys, const void* vals, long long rows, long long width,
                             int shift, const void* offset, void* lookback, void* out_keys,
                             void* out_vals, cudaStream_t s) {
  using S = Shape<K, VB>;
  using V = Payload<VB == 0 ? 1 : VB>;
  const long long per_row = (width + S::kTile - 1) / S::kTile;
  const long long tiles = rows * per_row;
  cudaError_t e = set_stage<K, VB, kPositions, true>();
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(lookback, 0, (tiles * kBins + 1) * sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  unsigned* status = static_cast<unsigned*>(lookback);
  onesweep_rows_kernel<K, VB, kPositions><<<static_cast<unsigned>(tiles), S::kThreads,
                                            S::kSmemBytes, s>>>(
      static_cast<const K*>(keys), static_cast<const V*>(vals), width,
      static_cast<int>(per_row), shift, static_cast<const int*>(offset), status,
      reinterpret_cast<int*>(status + tiles * kBins), static_cast<K*>(out_keys),
      static_cast<V*>(out_vals));
  return cudaGetLastError();
}

// Calls f(K(), std::integral_constant<int, VB>()) for the kernel instance of
// these widths.
template <typename K, typename F>
cudaError_t by_payload(int val_bytes, F&& f) {
  switch (val_bytes) {
    case 0:
      return f(K(), std::integral_constant<int, 0>());
    case 1:
      return f(K(), std::integral_constant<int, 1>());
    case 2:
      return f(K(), std::integral_constant<int, 2>());
    case 4:
      return f(K(), std::integral_constant<int, 4>());
    case 8:
      return f(K(), std::integral_constant<int, 8>());
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t by_widths(int key_bytes, int val_bytes, F&& f) {
  if (key_bytes == 4) return by_payload<unsigned>(val_bytes, f);
  if (key_bytes == 8) return by_payload<unsigned long long>(val_bytes, f);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace vkrs

// Writes offsets[p * 256 + d] = #(i < n with (key_i >> 8p) & 255 < d) for
// every pass p of the keys (4 for key_bytes 4, 8 for 8), on `device`.
// offsets: int32, passes * 256 + 1 words (the last is the kernel's own); it
// is zeroed here. n >= 1. Returns the first cudaError_t.
extern "C" int vkrs_digit_histograms(int device, const void* keys, int key_bytes, long long n,
                                     void* offsets, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (key_bytes != 4 && key_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(offsets, 0, (key_bytes * vkrs::kBins + 1) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = 16LL / key_bytes * vkrs::kHistUnroll * vkrs::kHistThreads;
  const long long blocks =
      std::max(1LL, std::min<long long>((n + per_block - 1) / per_block,
                                        static_cast<long long>(sms) * vkrs::kHistBlocksPerSm));
  if (key_bytes == 4) {
    vkrs::digit_histograms_kernel<unsigned><<<static_cast<unsigned>(blocks), vkrs::kHistThreads,
                                              0, s>>>(static_cast<const unsigned*>(keys), n,
                                                      static_cast<int*>(offsets));
  } else {
    vkrs::digit_histograms_kernel<unsigned long long>
        <<<static_cast<unsigned>(blocks), vkrs::kHistThreads, 0, s>>>(
            static_cast<const unsigned long long*>(keys), n, static_cast<int*>(offsets));
  }
  return static_cast<int>(cudaGetLastError());
}

// The pass kernel's shape for these widths: shape[0..3] = threads, elements
// a thread, tile (their product) and the blocks that fit an SM of `device`.
extern "C" int vkrs_onesweep_shape(int device, int key_bytes, int val_bytes, int* shape) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vkrs::by_widths(key_bytes, val_bytes, [&](auto k, auto vb) {
    using K = decltype(k);
    constexpr int VB = decltype(vb)::value;
    using S = vkrs::Shape<K, VB>;
    cudaError_t e = vkrs::set_stage<K, VB>();
    if (e != cudaSuccess) return e;
    shape[0] = S::kThreads;
    shape[1] = S::kPer;
    shape[2] = S::kTile;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &shape[3], vkrs::onesweep_kernel<K, VB>, S::kThreads, S::kSmemBytes);
  }));
}

// One stable pass over the digit (key_i >> shift) & 255: key i (key_bytes 4
// or 8) and its payload (val_bytes 0, 1, 2, 4 or 8; vals and out_vals unused
// at 0) go to out slot offset[d] + #(j < i with digit d), on `device`.
// offset: the pass's 256 int32 (a row of vkrs_digit_histograms); lookback:
// int32, cdiv(n, tile) * 256 + 1 words for the tile of vkrs_onesweep_shape,
// zeroed here. n >= 1, 0 <= shift < 8 * key_bytes. Returns the first
// cudaError_t.
extern "C" int vkrs_onesweep_pass(int device, const void* keys, int key_bytes, const void* vals,
                                  int val_bytes, long long n, int shift, const void* offset,
                                  void* lookback, void* out_keys, void* out_vals, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vkrs::by_widths(key_bytes, val_bytes, [&](auto k, auto vb) {
    return vkrs::launch_pass<decltype(k), decltype(vb)::value, false>(
        keys, vals, n, shift, offset, lookback, out_keys, out_vals,
        static_cast<cudaStream_t>(stream));
  }));
}

// vkrs_onesweep_pass with the u32 row positions as the payload, made by the
// pass (out_positions[slot of key i] = i) instead of read: the first pass of
// a sort of keys with their positions. The shape and the look-back words are
// those of val_bytes 4. n >= 1 and n < 2^31, so a position fits a u32.
extern "C" int vkrs_onesweep_positions_pass(int device, const void* keys, int key_bytes,
                                            long long n, int shift, const void* offset,
                                            void* lookback, void* out_keys, void* out_positions,
                                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4) {
    return static_cast<int>(vkrs::launch_pass<unsigned, 4, true>(
        keys, nullptr, n, shift, offset, lookback, out_keys, out_positions, s));
  }
  if (key_bytes == 8) {
    return static_cast<int>(vkrs::launch_pass<unsigned long long, 4, true>(
        keys, nullptr, n, shift, offset, lookback, out_keys, out_positions, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// vkrs_digit_histograms for every row of keys [rows, width] on its own:
// offsets[(p * rows + r) * 256 + d] = r * width + #(i < width with
// (key[r, i] >> 8p) & 255 < d), the first output slot of digit d of row r
// in pass p. offsets: int32, passes * rows * 256 + rows words (the last rows
// are the kernel's own); it is zeroed here. rows, width >= 1 and
// rows * width < 2^31. Returns the first cudaError_t.
extern "C" int vkrs_digit_histograms_rows(int device, const void* keys, int key_bytes,
                                          long long rows, long long width, void* offsets,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((key_bytes != 4 && key_bytes != 8) || rows < 1 || width < 1 ||
      rows * width >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(offsets, 0, (key_bytes * vkrs::kBins + 1) * rows * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks a row: enough to fill the card when the rows are few, none idle
  const long long per_block = 16LL / key_bytes * vkrs::kHistUnroll * vkrs::kHistThreads;
  const long long wanted = (static_cast<long long>(sms) * vkrs::kHistBlocksPerSm + rows - 1) / rows;
  const int parts = static_cast<int>(
      std::max(1LL, std::min<long long>((width + per_block - 1) / per_block, wanted)));
  const unsigned blocks = static_cast<unsigned>(rows * parts);
  if (key_bytes == 4) {
    vkrs::digit_histograms_rows_kernel<unsigned><<<blocks, vkrs::kHistThreads, 0, s>>>(
        static_cast<const unsigned*>(keys), rows, width, parts, static_cast<int*>(offsets));
  } else {
    vkrs::digit_histograms_rows_kernel<unsigned long long><<<blocks, vkrs::kHistThreads, 0, s>>>(
        static_cast<const unsigned long long*>(keys), rows, width, parts,
        static_cast<int*>(offsets));
  }
  return static_cast<int>(cudaGetLastError());
}

// vkrs_onesweep_pass for every row of keys [rows, width] on its own, a chain
// of look-back a row: key [r, i] and its payload go to out slot
// offset[r, d] + #(j < i with digit d in row r). offset: [rows, 256] int32,
// a pass's slab of vkrs_digit_histograms_rows; lookback: int32, rows *
// cdiv(width, tile) * 256 + 1 words for the tile of vkrs_onesweep_shape,
// zeroed here. positions != 0 (val_bytes 4; vals unused): the payload is
// each element's u32 position in its row, made by the pass. rows, width >= 1,
// rows * width < 2^31, 0 <= shift < 8 * key_bytes. Returns the first
// cudaError_t.
extern "C" int vkrs_onesweep_rows_pass(int device, const void* keys, int key_bytes,
                                       const void* vals, int val_bytes, int positions,
                                       long long rows, long long width, int shift,
                                       const void* offset, void* lookback, void* out_keys,
                                       void* out_vals, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || width < 1 || rows * width >= (1LL << 31) || (positions && val_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vkrs::by_widths(key_bytes, val_bytes, [&](auto k, auto vb) {
    using K = decltype(k);
    constexpr int VB = decltype(vb)::value;
    if constexpr (VB == 4) {
      if (positions) {
        return vkrs::launch_rows_pass<K, 4, true>(keys, nullptr, rows, width, shift, offset,
                                                  lookback, out_keys, out_vals, s);
      }
    }
    return vkrs::launch_rows_pass<K, VB, false>(keys, vals, rows, width, shift, offset,
                                                lookback, out_keys, out_vals, s);
  }));
}
