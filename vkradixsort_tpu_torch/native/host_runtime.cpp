// Native host runtime for vkradixsort_tpu_torch.
//
// The port's own copy of the JAX package's host runtime
// (vkradixsort_tpu/native/host_runtime.cpp), same C ABI (vkrs_*, ABI
// version 1) and same algorithms. Where the reference generates fixtures
// with mt19937 (reference singleradixsort/src/SingleRadixSort.cpp:85-98),
// sorts a CPU baseline with std::sort (SingleRadixSort.cpp:106-111) and
// verifies element-wise (SingleRadixSort.cpp:113-126), this library provides
// the same as a C ABI consumed from Python via ctypes, plus what a 1e8-scale
// check needs and the reference did not have: a multi-threaded stable LSD
// radix sort / argsort oracle (std::sort at 1e8 keys is the bottleneck of
// the verification loop, not the device).
//
// Build: see vkradixsort_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

unsigned hw_threads() {
  unsigned t = std::thread::hardware_concurrency();
  return t ? t : 4;
}

// One shared chunk-boundary plan so every phase of a multi-phase algorithm
// partitions [0, n) identically (the radix passes depend on that).
struct ChunkPlan {
  unsigned nt;
  std::size_t chunk;
};

ChunkPlan plan_chunks(std::size_t n) {
  unsigned nt =
      std::min<std::size_t>(hw_threads(), std::max<std::size_t>(n / 65536, 1));
  if (nt < 1) nt = 1;
  return {nt, (n + nt - 1) / nt};
}

// Parallel for over [0, n) in contiguous chunks.
template <typename F>
void parallel_chunks(std::size_t n, F&& fn) {
  ChunkPlan p = plan_chunks(n);
  if (p.nt <= 1) {
    fn(std::size_t{0}, n, 0u);
    return;
  }
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < p.nt; ++t) {
    std::size_t lo = t * p.chunk;
    std::size_t hi = std::min(n, lo + p.chunk);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi, t] { fn(lo, hi, t); });
  }
  for (auto& th : threads) th.join();
}

// Parallel for over a FIXED grid of kSeedChunks chunks, independent of
// hardware_concurrency: seeded generation derives per-chunk generators from
// the chunk index, so the same seed must mean the same chunk boundaries on
// every machine.
constexpr unsigned kSeedChunks = 64;

template <typename F>
void seeded_chunks(std::size_t n, F&& fn) {
  std::size_t chunk = (n + kSeedChunks - 1) / kSeedChunks;
  unsigned nt = std::min<unsigned>(hw_threads(), kSeedChunks);
  auto worker = [&](unsigned t) {
    for (unsigned c = t; c < kSeedChunks; c += nt) {
      std::size_t lo = std::size_t{c} * chunk;
      std::size_t hi = std::min(n, lo + chunk);
      if (lo < hi) fn(lo, hi, c);
    }
  };
  if (nt <= 1) {
    worker(0);
    return;
  }
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t) threads.emplace_back([&, t] { worker(t); });
  for (auto& th : threads) th.join();
}

// Record the smallest mismatching index across racing threads.
void atomic_min_index(std::atomic<std::int64_t>& first, std::int64_t mine) {
  std::int64_t cur = first.load(std::memory_order_relaxed);
  while ((cur == -1 || cur > mine) && !first.compare_exchange_weak(cur, mine)) {
  }
}

// One stable LSD pass over 8-bit digit `shift` with per-thread histograms:
// phase 1 counts, phase 2 computes per-(thread, bin) bases by a serial scan
// over the (256 x nt) table, phase 3 scatters. Matches the reference's
// histogram -> scan -> rank-and-scatter pass structure
// (multi_radixsort_histograms.comp + multi_radixsort.comp) on the host.
template <typename K, typename V>
void radix_pass(const K* in_k, const V* in_v, K* out_k, V* out_v,
                std::size_t n, unsigned shift) {
  unsigned nt = plan_chunks(n).nt;  // parallel_chunks partitions identically
  std::vector<std::size_t> hist(std::size_t{256} * nt, 0);

  parallel_chunks(n, [&](std::size_t lo, std::size_t hi, unsigned t) {
    std::size_t* h = &hist[std::size_t{256} * t];
    for (std::size_t i = lo; i < hi; ++i) h[(in_k[i] >> shift) & 0xFF]++;
  });

  // Exclusive scan in bin-major order: base[t][b] = sum over (b' < b, all t')
  // + sum over (b, t' < t).
  std::size_t total = 0;
  for (unsigned b = 0; b < 256; ++b) {
    for (unsigned t = 0; t < nt; ++t) {
      std::size_t c = hist[std::size_t{256} * t + b];
      hist[std::size_t{256} * t + b] = total;
      total += c;
    }
  }

  parallel_chunks(n, [&](std::size_t lo, std::size_t hi, unsigned t) {
    std::size_t* base = &hist[std::size_t{256} * t];
    for (std::size_t i = lo; i < hi; ++i) {
      std::size_t d = (in_k[i] >> shift) & 0xFF;
      std::size_t pos = base[d]++;
      out_k[pos] = in_k[i];
      if (in_v) out_v[pos] = in_v[i];
    }
  });
}

template <typename K, typename V>
void radix_sort_kv(K* keys, V* values, std::size_t n) {
  std::vector<K> tmp_k(n);
  std::vector<V> tmp_v(values ? n : 0);
  K* a_k = keys;
  K* b_k = tmp_k.data();
  V* a_v = values;
  V* b_v = values ? tmp_v.data() : nullptr;
  unsigned passes = sizeof(K);  // 4 for u32, 8 for u64 (8-bit digits)
  for (unsigned p = 0; p < passes; ++p) {
    radix_pass<K, V>(a_k, a_v, b_k, b_v, n, 8 * p);
    std::swap(a_k, b_k);
    std::swap(a_v, b_v);
  }
  // passes is even, so the result sits back in the caller's buffers — the
  // same even-parity ping-pong argument as the reference
  // (single_radixsort.comp:40 ELEMENT_IN parity).
  static_assert(sizeof(K) % 2 == 0, "even pass count keeps result in place");
}

}  // namespace

extern "C" {

// ---- fixture generation (reference SingleRadixSort.cpp:85-98) ----

void vkrs_generate_u32(std::uint64_t seed, std::uint32_t lo, std::uint32_t hi,
                       std::uint32_t* out, std::size_t n) {
  // Uniform in [lo, hi] like the reference's distribution(0, 0x0FFFFFFF).
  // Seeded per fixed chunk (seed, chunk) so generation parallelizes AND the
  // same seed reproduces the identical array on any machine.
  seeded_chunks(n, [&](std::size_t a, std::size_t b, unsigned t) {
    std::mt19937 gen(static_cast<std::uint32_t>(seed * 0x9E3779B9u + t));
    std::uniform_int_distribution<std::uint32_t> dist(lo, hi);
    for (std::size_t i = a; i < b; ++i) out[i] = dist(gen);
  });
}

void vkrs_generate_u64(std::uint64_t seed, std::uint64_t lo, std::uint64_t hi,
                       std::uint64_t* out, std::size_t n) {
  seeded_chunks(n, [&](std::size_t a, std::size_t b, unsigned t) {
    std::mt19937_64 gen(seed * 0x9E3779B97F4A7C15ull + t);
    std::uniform_int_distribution<std::uint64_t> dist(lo, hi);
    for (std::size_t i = a; i < b; ++i) out[i] = dist(gen);
  });
}

// Descending sequence (numElements - i), the reference's commented-out
// alternate fixture (SingleRadixSort.cpp:96).
void vkrs_generate_descending_u32(std::uint32_t* out, std::size_t n) {
  parallel_chunks(n, [&](std::size_t a, std::size_t b, unsigned) {
    for (std::size_t i = a; i < b; ++i)
      out[i] = static_cast<std::uint32_t>(n - i);
  });
}

// ---- oracle sorts (reference SingleRadixSort.cpp:106-111 std::sort) ----

void vkrs_std_sort_u32(std::uint32_t* keys, std::size_t n) {
  std::sort(keys, keys + n);
}

void vkrs_std_sort_u64(std::uint64_t* keys, std::size_t n) {
  std::sort(keys, keys + n);
}

// Multi-threaded stable LSD radix sort (in place). The fast oracle for
// 1e8-scale verification.
void vkrs_radix_sort_u32(std::uint32_t* keys, std::size_t n) {
  radix_sort_kv<std::uint32_t, std::uint32_t>(keys, nullptr, n);
}

void vkrs_radix_sort_u64(std::uint64_t* keys, std::size_t n) {
  radix_sort_kv<std::uint64_t, std::uint32_t>(keys, nullptr, n);
}

// Stable key-value sort; values permuted alongside keys (both in place).
void vkrs_radix_sort_kv_u32(std::uint32_t* keys, std::uint32_t* values,
                            std::size_t n) {
  radix_sort_kv<std::uint32_t, std::uint32_t>(keys, values, n);
}

void vkrs_radix_sort_kv_u64(std::uint64_t* keys, std::uint64_t* values,
                            std::size_t n) {
  radix_sort_kv<std::uint64_t, std::uint64_t>(keys, values, n);
}

// Stable argsort: writes the permutation into idx (caller passes iota or
// anything; contents are overwritten with 0..n-1 before sorting).
void vkrs_stable_argsort_u32(const std::uint32_t* keys, std::uint32_t* idx,
                             std::size_t n) {
  std::vector<std::uint32_t> k(keys, keys + n);
  parallel_chunks(n, [&](std::size_t a, std::size_t b, unsigned) {
    for (std::size_t i = a; i < b; ++i) idx[i] = static_cast<std::uint32_t>(i);
  });
  radix_sort_kv<std::uint32_t, std::uint32_t>(k.data(), idx, n);
}

// ---- verification (reference SingleRadixSort.cpp:113-126 testSort) ----

// Exact element-wise compare; returns first mismatching index, or -1.
std::int64_t vkrs_first_mismatch_u32(const std::uint32_t* a,
                                     const std::uint32_t* b, std::size_t n) {
  std::atomic<std::int64_t> first{-1};
  parallel_chunks(n, [&](std::size_t lo, std::size_t hi, unsigned) {
    for (std::size_t i = lo; i < hi; ++i) {
      if (a[i] != b[i]) {
        atomic_min_index(first, static_cast<std::int64_t>(i));
        return;
      }
    }
  });
  return first.load();
}

std::int64_t vkrs_first_mismatch_u64(const std::uint64_t* a,
                                     const std::uint64_t* b, std::size_t n) {
  std::atomic<std::int64_t> first{-1};
  parallel_chunks(n, [&](std::size_t lo, std::size_t hi, unsigned) {
    for (std::size_t i = lo; i < hi; ++i) {
      if (a[i] != b[i]) {
        atomic_min_index(first, static_cast<std::int64_t>(i));
        return;
      }
    }
  });
  return first.load();
}

// Sortedness check without a reference array: returns first index i where
// a[i] > a[i+1], or -1 if non-decreasing.
std::int64_t vkrs_first_unsorted_u32(const std::uint32_t* a, std::size_t n) {
  if (n < 2) return -1;
  std::atomic<std::int64_t> first{-1};
  parallel_chunks(n - 1, [&](std::size_t lo, std::size_t hi, unsigned) {
    for (std::size_t i = lo; i < hi; ++i) {
      if (a[i] > a[i + 1]) {
        atomic_min_index(first, static_cast<std::int64_t>(i));
        return;
      }
    }
  });
  return first.load();
}

int vkrs_abi_version() { return 1; }

}  // extern "C"
