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
__device__ __forceinline__ T kernel_map(int id, T r2) {
  const T r = r2 > T(0) ? sqrt(r2) : T(0);
  switch (id) {
    case kSE:
      return exp(T(-0.5) * r2);
    case kMatern12:
      return exp(-r);
    case kMatern32: {
      const T t = T(1.7320508075688772) * r;
      return (T(1) + t) * exp(-t);
    }
    case kMatern52: {
      const T t = T(2.23606797749979) * r;
      return (T(1) + t + T(5.0 / 3.0) * r2) * exp(-t);
    }
    default:
      return T(0);
  }
}

// Whether the host-side id names a map above.
inline bool valid_kernel_map(int id) { return id >= kSE && id <= kMatern52; }

}  // namespace agp
