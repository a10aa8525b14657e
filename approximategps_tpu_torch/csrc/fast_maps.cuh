// Fast f32 stationary maps for row 5 (gram_matvec.cu, gram_matvec_mma.cu,
// gram_matvec_self_bwd.cu).
//
// The same maps, derivatives and r^2 = 0 conventions as kernel_maps.cuh, but
// with one ex2.approx a map (the exponent scaled by log2 e) and sqrt.approx /
// rsqrt.approx in place of the full-precision expf and sqrtf, which cost
// about ten instructions each.  ex2.approx.ftz has a relative error of about
// 2^-22 and flushes results below 2^-126 to zero; the maps' own rounding of
// the exponent (|a| eps) is the same as expf's.  The kernels of rows 6-11
// keep kernel_maps.cuh, so their bits do not change.
#pragma once

#include <cuda_runtime.h>

#include "kernel_maps.cuh"

namespace agp {

__device__ __forceinline__ float ex2_fast(float a) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}

__device__ __forceinline__ float sqrt_fast(float a) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}

__device__ __forceinline__ float rsqrt_fast(float a) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

// g(r^2), or g'(r^2) with DERIV, for MAP one of KernelMapId.
template <int MAP, bool DERIV>
__device__ __forceinline__ float fast_map(float r2) {
  const bool pos = r2 > 0.f;
  if constexpr (MAP == kSE) {
    const float e = ex2_fast(r2 * (-0.5f * kLog2e));
    return DERIV ? -0.5f * e : e;
  } else if constexpr (MAP == kMatern12) {
    if constexpr (DERIV) {
      const float rr = rsqrt_fast(r2);  // inf at r^2 = 0, where the select drops it
      const float e = ex2_fast(-kLog2e * (r2 * rr));
      return pos ? -0.5f * e * rr : 0.f;
    } else {
      return ex2_fast(-kLog2e * sqrt_fast(r2));
    }
  } else if constexpr (MAP == kMatern32) {
    const float t = kSqrt3 * sqrt_fast(r2);
    const float e = ex2_fast(-kLog2e * t);
    if constexpr (DERIV) return pos ? -1.5f * e : 0.f;
    return (1.f + t) * e;
  } else {
    const float t = kSqrt5 * sqrt_fast(r2);
    const float e = ex2_fast(-kLog2e * t);
    if constexpr (DERIV) return pos ? (-5.f / 6.f) * (1.f + t) * e : 5.f / 3.f;
    return (1.f + t + (5.f / 3.f) * r2) * e;
  }
}

// g and g' of one r^2 from one exp: SE g' = -g / 2; the Matern maps share
// sqrt(r^2) (or rsqrt) and exp(-t).
template <int MAP>
__device__ __forceinline__ void fast_map_both(float r2, float& g, float& dg) {
  const bool pos = r2 > 0.f;
  if constexpr (MAP == kSE) {
    g = ex2_fast(r2 * (-0.5f * kLog2e));
    dg = -0.5f * g;
  } else if constexpr (MAP == kMatern12) {
    const float rr = rsqrt_fast(r2);
    const float r = pos ? r2 * rr : 0.f;
    g = ex2_fast(-kLog2e * r);
    dg = pos ? -0.5f * g * rr : 0.f;
  } else if constexpr (MAP == kMatern32) {
    const float t = kSqrt3 * sqrt_fast(r2);
    const float e = ex2_fast(-kLog2e * t);
    g = (1.f + t) * e;
    dg = pos ? -1.5f * e : 0.f;
  } else {
    const float t = kSqrt5 * sqrt_fast(r2);
    const float e = ex2_fast(-kLog2e * t);
    g = (1.f + t + (5.f / 3.f) * r2) * e;
    dg = pos ? (-5.f / 6.f) * (1.f + t) * e : 5.f / 3.f;
  }
}

// The SE map's exponent folded into the coordinates: x' = s x with
// s = sqrt(log2(e) / 2) gives r'^2 = s^2 r^2 and g = ex2(-r'^2), one
// multiply a pair fewer.  A point paired with itself still gives r'^2 = 0
// exactly.  The Matern maps take their coordinates as they are (s = 1).
constexpr float kSEScale = 0.8493218002880191f;

template <int MAP>
__host__ __device__ constexpr float coord_scale() {
  return MAP == kSE ? kSEScale : 1.f;
}

// fast_map of r'^2 = coord_scale<MAP>()^2 r^2.
template <int MAP, bool DERIV>
__device__ __forceinline__ float fast_map_scaled(float r2s) {
  if constexpr (MAP == kSE) {
    const float e = ex2_fast(-r2s);
    return DERIV ? -0.5f * e : e;
  } else {
    return fast_map<MAP, DERIV>(r2s);
  }
}

// The passes' entry for MODE = 4 m + map: g (m = 0), g' (m = 1) or r^2 g'(r^2)
// (m = 2, the lengthscale's cotangent), of r'^2 = coord_scale<map>()^2 r^2.
template <int MODE>
__device__ __forceinline__ float fast_entry_scaled(float r2s) {
  constexpr int MAP = MODE & 3;
  const float h = fast_map_scaled<MAP, (MODE >= 4)>(r2s);
  if constexpr (MODE >= 8) {
    constexpr float cs = coord_scale<MAP>();
    return h * (r2s * (1.f / (cs * cs)));
  } else {
    return h;
  }
}

// fast_map_both of r'^2 = coord_scale<MAP>()^2 r^2.
template <int MAP>
__device__ __forceinline__ void fast_map_both_scaled(float r2s, float& g, float& dg) {
  if constexpr (MAP == kSE) {
    g = ex2_fast(-r2s);
    dg = -0.5f * g;
  } else {
    fast_map_both<MAP>(r2s, g, dg);
  }
}

}  // namespace agp
