// Payload columns moved through a permutation in one launch:
// out_c[i] = src_c[perm[i]] for up to kMaxColumns columns of 1, 2, 4 or 8
// bytes an element, perm a u32 permutation.
//
// The radix_tiled sort of a payload set (ops/radix_tiled.sort_radix_tiled)
// sorts the keys with their u32 positions and then moves every column here.
// It stands for the torch indexing of the library route
// (ops/segsort.sort_flat_pairs), which reads an int64 index (8 B a row) once
// a column and launches once a column.
//
// What bounds it on an H100: device memory. The least traffic reads each
// position once and each column element once, and writes each element once:
// 4 + 2 x (payload bytes) a row. The reads of the columns are random, so
// each one pulls a 32-byte sector for its 1 to 8 bytes. A thread takes
// kRows consecutive rows: it reads their positions with one 16-byte load,
// issues the random reads of every column before it writes any (kRows x
// columns reads in flight a thread), then writes each column's kRows values
// with one vector store, so the writes are coalesced.
#include <cstdint>

namespace vkrs {
namespace {

constexpr int kMaxColumns = 8;
constexpr int kRows = 4;  // rows a thread: one 16-byte load of positions
constexpr int kGatherThreads = 256;

struct Columns {
  const void* src[kMaxColumns];
  void* dst[kMaxColumns];
  int width[kMaxColumns];
};

__device__ __forceinline__ unsigned long long read_elem(const void* src, int width,
                                                       unsigned p) {
  switch (width) {
    case 1:
      return __ldg(static_cast<const unsigned char*>(src) + p);
    case 2:
      return __ldg(static_cast<const unsigned short*>(src) + p);
    case 4:
      return __ldg(static_cast<const unsigned*>(src) + p);
    default:
      return __ldg(static_cast<const unsigned long long*>(src) + p);
  }
}

__device__ __forceinline__ void write_elem(void* dst, int width, long long i,
                                           unsigned long long v) {
  switch (width) {
    case 1:
      static_cast<unsigned char*>(dst)[i] = static_cast<unsigned char>(v);
      break;
    case 2:
      static_cast<unsigned short*>(dst)[i] = static_cast<unsigned short>(v);
      break;
    case 4:
      static_cast<unsigned*>(dst)[i] = static_cast<unsigned>(v);
      break;
    default:
      static_cast<unsigned long long*>(dst)[i] = v;
  }
}

// kRows values of one column to rows row0 .. row0 + kRows - 1, row0 a
// multiple of kRows, dst aligned to 16 bytes: one store of kRows x width
// bytes (two for 8-byte columns).
__device__ __forceinline__ void write_rows(void* dst, int width, long long row0,
                                           const unsigned long long (&v)[kRows]) {
  switch (width) {
    case 1:
      reinterpret_cast<unsigned*>(dst)[row0 / kRows] =
          static_cast<unsigned>(v[0] & 0xFF) | static_cast<unsigned>(v[1] & 0xFF) << 8 |
          static_cast<unsigned>(v[2] & 0xFF) << 16 | static_cast<unsigned>(v[3] & 0xFF) << 24;
      break;
    case 2:
      reinterpret_cast<uint2*>(dst)[row0 / kRows] =
          make_uint2(static_cast<unsigned>(v[0] & 0xFFFF) | static_cast<unsigned>(v[1]) << 16,
                     static_cast<unsigned>(v[2] & 0xFFFF) | static_cast<unsigned>(v[3]) << 16);
      break;
    case 4:
      reinterpret_cast<uint4*>(dst)[row0 / kRows] =
          make_uint4(static_cast<unsigned>(v[0]), static_cast<unsigned>(v[1]),
                     static_cast<unsigned>(v[2]), static_cast<unsigned>(v[3]));
      break;
    default: {
      ulonglong2* out = reinterpret_cast<ulonglong2*>(dst) + row0 / 2;
      out[0] = make_ulonglong2(v[0], v[1]);
      out[1] = make_ulonglong2(v[2], v[3]);
    }
  }
}

// NC columns (a template argument, so every loop over columns unrolls and the
// values stay in registers). perm_vec: perm is 16-byte aligned, so a whole
// group of kRows positions is one load.
template <int NC>
__global__ void __launch_bounds__(kGatherThreads)
    gather_columns_kernel(const unsigned* __restrict__ perm, long long n, Columns cols,
                          int perm_vec) {
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x) * kRows;
  if (row0 >= n) return;
  const bool whole = row0 + kRows <= n;
  unsigned p[kRows];
  if (whole && perm_vec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(perm) + row0 / kRows);
    p[0] = q.x;
    p[1] = q.y;
    p[2] = q.z;
    p[3] = q.w;
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = row0 + r < n ? __ldg(perm + row0 + r) : 0u;
  }
  unsigned long long v[NC][kRows];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      v[c][r] = row0 + r < n ? read_elem(cols.src[c], cols.width[c], p[r]) : 0ull;
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (whole) {
      write_rows(cols.dst[c], cols.width[c], row0, v[c]);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < n) write_elem(cols.dst[c], cols.width[c], row0 + r, v[c][r]);
      }
    }
  }
}

template <int NC>
void launch(const unsigned* perm, long long n, const Columns& cols, int perm_vec,
            cudaStream_t s) {
  const long long threads = (n + kRows - 1) / kRows;
  const long long blocks = (threads + kGatherThreads - 1) / kGatherThreads;
  gather_columns_kernel<NC>
      <<<static_cast<unsigned>(blocks), kGatherThreads, 0, s>>>(perm, n, cols, perm_vec);
}

}  // namespace
}  // namespace vkrs

// out_c[i] = src_c[perm[i]] for i < n and each of the ncols columns (1 to 8),
// on `device`. perm: n u32, each below the columns' length; widths[c]: 1, 2,
// 4 or 8 bytes; dst[c]: n elements of widths[c], 16-byte aligned, apart from
// every source. n >= 1. Returns the first cudaError_t.
extern "C" int vkrs_gather_columns(int device, const void* perm, long long n, int ncols,
                                   const void* const* src, void* const* dst, const int* widths,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ncols < 1 || ncols > vkrs::kMaxColumns || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vkrs::Columns cols{};
  for (int c = 0; c < ncols; ++c) {
    const int w = widths[c];
    if ((w != 1 && w != 2 && w != 4 && w != 8) ||
        reinterpret_cast<uintptr_t>(dst[c]) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cols.src[c] = src[c];
    cols.dst[c] = dst[c];
    cols.width[c] = w;
  }
  const unsigned* p = static_cast<const unsigned*>(perm);
  const int perm_vec = reinterpret_cast<uintptr_t>(perm) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: vkrs::launch<1>(p, n, cols, perm_vec, s); break;
    case 2: vkrs::launch<2>(p, n, cols, perm_vec, s); break;
    case 3: vkrs::launch<3>(p, n, cols, perm_vec, s); break;
    case 4: vkrs::launch<4>(p, n, cols, perm_vec, s); break;
    case 5: vkrs::launch<5>(p, n, cols, perm_vec, s); break;
    case 6: vkrs::launch<6>(p, n, cols, perm_vec, s); break;
    case 7: vkrs::launch<7>(p, n, cols, perm_vec, s); break;
    default: vkrs::launch<8>(p, n, cols, perm_vec, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
