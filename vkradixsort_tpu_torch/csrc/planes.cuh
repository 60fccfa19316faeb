// Plane bundle shared by the merge engine's kernels (tilesort.cu,
// mergepath.cu). An element is up to five int32 planes: NCK compare planes
// (keys in signed order, compared lexicographically), then NCARRY carry
// planes that move with their key. Each kernel is instantiated for
// NCK in {1, 2, 3} and NCARRY in {0, 1, 2}.
#pragma once

#include <cuda_runtime.h>

namespace vkrs {

constexpr int kMaxPlanes = 5;

struct Planes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
};

inline Planes make_planes(void* const* in, void* const* out, int nplanes) {
  Planes p = {};
  for (int i = 0; i < nplanes && i < kMaxPlanes; ++i) {
    p.in[i] = static_cast<const int*>(in[i]);
    p.out[i] = static_cast<int*>(out[i]);
  }
  return p;
}

// Calls LAUNCH<NCK, NCARRY>(args...) for the instantiated combinations and
// returns cudaErrorInvalidValue for the others.
#define VKRS_DISPATCH_PLANES(NCK, NCARRY, LAUNCH, ...)                  \
  switch ((NCK) * 10 + (NCARRY)) {                                      \
    case 10: return static_cast<int>(LAUNCH<1, 0>(__VA_ARGS__));        \
    case 11: return static_cast<int>(LAUNCH<1, 1>(__VA_ARGS__));        \
    case 12: return static_cast<int>(LAUNCH<1, 2>(__VA_ARGS__));        \
    case 20: return static_cast<int>(LAUNCH<2, 0>(__VA_ARGS__));        \
    case 21: return static_cast<int>(LAUNCH<2, 1>(__VA_ARGS__));        \
    case 22: return static_cast<int>(LAUNCH<2, 2>(__VA_ARGS__));        \
    case 30: return static_cast<int>(LAUNCH<3, 0>(__VA_ARGS__));        \
    case 31: return static_cast<int>(LAUNCH<3, 1>(__VA_ARGS__));        \
    case 32: return static_cast<int>(LAUNCH<3, 2>(__VA_ARGS__));        \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

}  // namespace vkrs
