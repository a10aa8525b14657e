// Stationary kernel maps g(r^2) shared by the CUDA kernels.
//
// The ids match approximategps_tpu_torch/core/kernels.py::KernelMapId; the
// formulas match the k_of_r2 staticmethods there (and those of
// approximategps_tpu/core/kernels.py).
#pragma once

#include <cuda_runtime.h>

namespace agp {

enum KernelMapId : int { kSE = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

template <typename T>
__device__ __forceinline__ T safe_r(T r2) {
  return r2 > T(0) ? sqrt(r2) : T(0);
}

template <typename T>
__device__ __forceinline__ T kernel_map(int id, T r2) {
  switch (id) {
    case kSE:
      return exp(T(-0.5) * r2);
    case kMatern12:
      return exp(-safe_r(r2));
    case kMatern32: {
      const T t = T(1.7320508075688772) * safe_r(r2);
      return (T(1) + t) * exp(-t);
    }
    case kMatern52: {
      const T t = T(2.23606797749979) * safe_r(r2);
      return (T(1) + t + T(5.0 / 3.0) * r2) * exp(-t);
    }
    default:
      return T(0);
  }
}

// g'(r^2), the derivative of kernel_map in r^2, with the JAX package's
// convention at r^2 = 0: there its double-where sqrt has a zero gradient, so
// the Matern maps lose the terms that come through r, which leaves 0 for
// Matern-1/2 and -3/2 and 5/3 (the r^2 term) for Matern-5/2.  Matches
// core/kernels.py::KernelMap.dk_of_r2.
template <typename T>
__device__ __forceinline__ T kernel_map_dr2(int id, T r2) {
  const bool pos = r2 > T(0);
  switch (id) {
    case kSE:
      return T(-0.5) * exp(T(-0.5) * r2);
    case kMatern12: {
      const T r = safe_r(r2);
      return pos ? T(-0.5) * exp(-r) / r : T(0);
    }
    case kMatern32:
      return pos ? T(-1.5) * exp(T(-1.7320508075688772) * safe_r(r2)) : T(0);
    case kMatern52: {
      const T t = T(2.23606797749979) * safe_r(r2);
      return pos ? T(-5.0 / 6.0) * (T(1) + t) * exp(-t) : T(5.0 / 3.0);
    }
    default:
      return T(0);
  }
}

// Whether the host-side id names a map above.
inline bool valid_kernel_map(int id) { return id >= kSE && id <= kMatern52; }

}  // namespace agp
