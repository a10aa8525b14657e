// What the Vecchia band kernel (vecchia_band.cu) and its pullback
// (vecchia_band_bwd.cu) share: a window to a team of TEAM = 4 threads of one
// warp (W = 8 windows a warp, one warp a block), the window's values in
// dynamic shared memory in the [entry][window] layout (entry e of a team's
// window at [e * W]), the bordered factorization of the window's Gram, and
// the dispatch over the coordinate count D and the map.
//
// For window n, slot t < k is neighbour t and slot k the conditioned point:
//   1. Gm = g(r^2) over the k+1 slots, r^2 from exact coordinate differences;
//   2. invalid neighbour slots become identity rows with zero coupling;
//   3. the nugget adds to the valid diagonal (slot k only with nugget_self);
//   4. chol(Gm): each pivot floored at 8 eps |Gm_jj| (the original diagonal)
//      and a floored pivot deflates its column (off-diagonal entries 0).
// L is built row by row (up-looking): row i needs only rows j < i and its own
// Gram entries, computed first into row i's place (independent of each
// other, off the solve's dependent chain) and then solved there four columns
// at a time (one load of row i feeds four sums).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "kernel_maps.cuh"

namespace agp {
namespace vecchia {

constexpr int TEAM = 4;           // threads a window
constexpr int W = 32 / TEAM;      // windows a block (one warp)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr float value = 1.1920928955078125e-07f;
};
template <>
struct Eps<double> {
  static constexpr double value = 2.220446049250313e-16;
};

// the sum of v over the team's lanes, in every lane
template <typename T>
__device__ __forceinline__ T team_sum(T v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// sum_t a[t] b[t] over t < n, entries W apart, summed over the team
template <typename T>
__device__ __forceinline__ T team_dot(const T* a, const T* b, int n, int lane) {
  T s = T(0);
  for (int t = lane; t < n; t += TEAM) s = fma(a[t * W], b[t * W], s);
  return team_sum(s);
}

// Window n's coordinates (slot j, coordinate d at xn[d*sxd + j*sxj]) into X
// ((k+1) x D); returns the mask bits (bit t: neighbour t is valid; mask entry
// t at vn[t*svj]), the same in every lane of the team.
template <typename T, int D>
__device__ __forceinline__ unsigned long long load_window(const T* xn, long long sxd,
                                                          long long sxj, const T* vn,
                                                          long long svj, T* X, int k, int lane) {
  for (int j = lane; j <= k; j += TEAM)
#pragma unroll
    for (int d = 0; d < D; ++d) X[(j * D + d) * W] = xn[d * sxd + j * sxj];
  unsigned long long vm = 0;
  for (int t = lane; t < k; t += TEAM)
    if (vn[t * svj] != T(0)) vm |= 1ull << t;
  vm |= __shfl_xor_sync(kFull, vm, 1);
  vm |= __shfl_xor_sync(kFull, vm, 2);
  __syncwarp();
  return vm;
}

// The bordered factorization of the window's masked Gram: rows 0..k of L into
// Lt (row i from entry i(i+1)/2) and the column scales into cs (1 / pivot, 0
// where the pivot was floored: cs[j] != 0 is the column's "live").  With kn
// not null, kn[j] receives Gm[k][j] for j < k (the masked kni) before row k
// is solved over it.
template <typename T, int D, int MAP>
__device__ __forceinline__ void factor_window(const T* X, T* cs, T* Lt, T* kn,
                                              unsigned long long vm, T nug, bool nugget_self,
                                              int k, int lane) {
  const int kp1 = k + 1;
  const T g0 = kernel_map<T>(MAP, T(0));
  const T eps8 = T(8) * Eps<T>::value;
  for (int i = 0; i < kp1; ++i) {
    const bool vi = i == k || ((vm >> i) & 1ull);
    T xi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) xi[d] = X[(i * D + d) * W];
    T* const row = Lt + i * (i + 1) / 2 * W;
    // Gm[i][j], j < i: zero coupling unless both slots are valid
    for (int j = lane; j < i; j += TEAM) {
      T g = T(0);
      if (vi && ((vm >> j) & 1ull)) {
        T r2 = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const T dd = xi[d] - X[(j * D + d) * W];
          r2 = fma(dd, dd, r2);
        }
        g = kernel_map<T>(MAP, r2);
      }
      row[j * W] = g;
      if (kn != nullptr && i == k) kn[j * W] = g;
    }
    __syncwarp();
    // row i of L = L_{<i}^-1 Gm[i][:i], four columns at a time
    int j = 0;
    for (; j + 4 <= i; j += 4) {
      const T* const r0 = Lt + j * (j + 1) / 2 * W;
      const T* const r1 = r0 + (j + 1) * W;
      const T* const r2 = r1 + (j + 2) * W;
      const T* const r3 = r2 + (j + 3) * W;
      T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
      for (int t = lane; t < j; t += TEAM) {
        const T x = row[t * W];
        s0 = fma(x, r0[t * W], s0);
        s1 = fma(x, r1[t * W], s1);
        s2 = fma(x, r2[t * W], s2);
        s3 = fma(x, r3[t * W], s3);
      }
      T a0 = row[j * W] - team_sum(s0);
      T a1 = row[(j + 1) * W] - team_sum(s1);
      T a2 = row[(j + 2) * W] - team_sum(s2);
      T a3 = row[(j + 3) * W] - team_sum(s3);
      const T l0 = a0 * cs[j * W];
      a1 = fma(-l0, r1[j * W], a1);
      const T l1 = a1 * cs[(j + 1) * W];
      a2 = fma(-l1, r2[(j + 1) * W], fma(-l0, r2[j * W], a2));
      const T l2 = a2 * cs[(j + 2) * W];
      a3 = fma(-l2, r3[(j + 2) * W], fma(-l1, r3[(j + 1) * W], fma(-l0, r3[j * W], a3)));
      const T l3 = a3 * cs[(j + 3) * W];
      __syncwarp();  // every lane has read the Gram entries it overwrites
      row[(j + lane) * W] = lane == 0 ? l0 : lane == 1 ? l1 : lane == 2 ? l2 : l3;
      __syncwarp();
    }
    for (; j < i; ++j) {
      const T a = row[j * W] - team_dot(row, Lt + j * (j + 1) / 2 * W, j, lane);
      __syncwarp();
      if (lane == 0) row[j * W] = a * cs[j * W];
      __syncwarp();
    }
    // the pivot, floored relative to the original diagonal
    const T diag0 = vi ? g0 + ((i < k || nugget_self) ? nug : T(0)) : T(1);
    const T d_raw = diag0 - team_dot(row, row, i, lane);
    const T fl = eps8 * fabs(diag0);
    const T sq = sqrt(d_raw >= fl ? d_raw : fl);
    if (lane == 0) {
      row[i * W] = sq;
      cs[i * W] = d_raw >= fl ? T(1) / sq : T(0);
    }
    __syncwarp();
  }
}

template <int D, typename F>
cudaError_t by_map(int map, F& launch) {
  switch (map) {
    case 0: return launch(std::integral_constant<int, D>{}, std::integral_constant<int, 0>{});
    case 1: return launch(std::integral_constant<int, D>{}, std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, D>{}, std::integral_constant<int, 2>{});
    case 3: return launch(std::integral_constant<int, D>{}, std::integral_constant<int, 3>{});
    default: return cudaErrorInvalidValue;
  }
}

// launch(d, m) with d and m std::integral_constants of the runtime D (1..8)
// and map id, so that both are template arguments of the kernel
template <typename F>
cudaError_t dispatch(int D, int map, F&& launch) {
  switch (D) {
    case 1: return by_map<1>(map, launch);
    case 2: return by_map<2>(map, launch);
    case 3: return by_map<3>(map, launch);
    case 4: return by_map<4>(map, launch);
    case 5: return by_map<5>(map, launch);
    case 6: return by_map<6>(map, launch);
    case 7: return by_map<7>(map, launch);
    case 8: return by_map<8>(map, launch);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vecchia
}  // namespace agp
