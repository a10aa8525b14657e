// Fused stationary Gram matvec: out = K(Xq, Zk) V with K never stored.
//
// Replaces approximategps_tpu/ops/gram_matvec.py::pallas_gram_matvec
// (_forward_multi, _gmv_kernel), forward and the passes of its pullback
// (_coord_cotangent, _gmv_bwd):
//
//     out[i, r] = sum_j h(|xq_i - zk_j|^2) V[j, r],   h = g, or g' in
//     derivative mode,
//
// for Xq (N, D), Zk (M, D), V (M, R), out (N, R), any N and M, 1 <= D <= 8,
// 1 <= R <= 128, f32 or f64 (accumulated in the input type, the right-hand
// side kept in it too), and the four maps of kernel_maps.cuh.  r^2 is summed
// from exact differences, so a point paired with itself gives r^2 = 0 exactly
// and g'(0) takes the JAX package's value (the self-Gram's diagonal).
//
// What bounds it on the H100: operations, not bytes.  At N = M = 10^5 and
// D = 2 there are 10^10 entries and under 15 MB to move; each entry costs
// 2D subtract/FMA, one exp (the special-function units: 16 a clock an SM)
// and R FMAs on the SIMT units.
//
// The TPU kernel carries the sum over the key axis in VMEM scratch from one
// grid step to the next.  Hopper blocks run in no order, so here one block
// of NT threads owns NT query rows, one row a thread, and loops over all of
// Zk inside: TJ keys at a time, their coordinates and V's rows for the
// block's columns staged in shared memory (each a broadcast read for the
// whole block).  Each h(r^2) is computed once in registers and feeds all RB
// of the thread's columns.  A tile's products are summed apart and then
// added to the running total, so a sum over M = 10^5 keys in f32 carries
// about (TJ + M / TJ) roundings rather than M.  Each block writes its rows
// once: no atomics, a fixed order of summation, results that repeat
// bitwise.  R > 32 (the
// pullback's (1 + D) R columns) runs chunks of 32 columns over a second grid
// dimension, which recomputes h per chunk.  The ragged key tile is masked by
// its loop bound and rows >= N store nothing.  No tensor cores: the work is
// exp and FMAs, not a product of stored tiles.

#include <cuda_runtime.h>

#include "kernel_maps.cuh"

namespace {

constexpr int NT = 128;  // threads (query rows) per block
constexpr int TJ = 128;  // keys staged per shared-memory tile

// MAP < 4: the map g of kernel_maps.cuh; MAP >= 4: its derivative g'.
template <typename T, int MAP>
__device__ __forceinline__ T entry(T r2) {
  if constexpr (MAP < 4) {
    return agp::kernel_map<T>(MAP, r2);
  } else {
    return agp::kernel_map_dr2<T>(MAP - 4, r2);
  }
}

template <typename T, int D, int RB, int MAP>
__global__ void __launch_bounds__(NT)
    gram_matvec_kernel(const T* __restrict__ xq, const T* __restrict__ zk,
                       const T* __restrict__ v, T* __restrict__ out, int N, int M, int R,
                       int c0) {
  __shared__ __align__(16) T zs[TJ * D];
  __shared__ __align__(16) T vs[TJ * RB];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * NT + tid;
  const int cb = c0 + blockIdx.y * RB;  // first column of this block

  T x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = i < N ? xq[(size_t)i * D + d] : T(0);
  T acc[RB];
#pragma unroll
  for (int c = 0; c < RB; ++c) acc[c] = T(0);

  for (int j0 = 0; j0 < M; j0 += TJ) {
    const int jn = min(TJ, M - j0);
    T part[RB];  // this tile's sums, added to acc once: two-level summation
#pragma unroll
    for (int c = 0; c < RB; ++c) part[c] = T(0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < jn * D; e += NT) zs[e] = zk[(size_t)j0 * D + e];
    for (int e = tid; e < jn * RB; e += NT) {
      const int jj = e / RB;
      const int col = cb + (e - jj * RB);
      vs[e] = col < R ? v[(size_t)(j0 + jj) * R + col] : T(0);
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < jn; ++jj) {
      T r2 = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const T diff = x[d] - zs[jj * D + d];
        r2 = fma(diff, diff, r2);
      }
      const T h = entry<T, MAP>(r2);
#pragma unroll
      for (int c = 0; c < RB; ++c) part[c] = fma(h, vs[jj * RB + c], part[c]);
    }
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[c] += part[c];
  }
  if (i < N) {
#pragma unroll
    for (int c = 0; c < RB; ++c)
      if (cb + c < R) out[(size_t)i * R + cb + c] = acc[c];
  }
}

template <typename T, int D, int RB, int MAP>
cudaError_t launch(const T* xq, const T* zk, const T* v, T* out, int N, int M, int R, int c0,
                   int chunks, cudaStream_t s) {
  const dim3 grid((N + NT - 1) / NT, chunks);
  gram_matvec_kernel<T, D, RB, MAP><<<grid, NT, 0, s>>>(xq, zk, v, out, N, M, R, c0);
  return cudaGetLastError();
}

// Columns [0, 32 * (R / 32)) in chunks of 32, then the rest with the
// narrowest tile that holds it (1, 16 or 32 columns).
template <typename T, int D, int MAP>
cudaError_t by_columns(const T* xq, const T* zk, const T* v, T* out, int N, int M, int R,
                       cudaStream_t s) {
  const int full = R / 32;
  if (full > 0) {
    const cudaError_t err = launch<T, D, 32, MAP>(xq, zk, v, out, N, M, R, 0, full, s);
    if (err != cudaSuccess) return err;
  }
  const int c0 = 32 * full;
  const int rest = R - c0;
  if (rest == 0) return cudaSuccess;
  if (rest == 1) return launch<T, D, 1, MAP>(xq, zk, v, out, N, M, R, c0, 1, s);
  if (rest <= 16) return launch<T, D, 16, MAP>(xq, zk, v, out, N, M, R, c0, 1, s);
  return launch<T, D, 32, MAP>(xq, zk, v, out, N, M, R, c0, 1, s);
}

template <typename T, int D>
cudaError_t by_map(int map, const T* xq, const T* zk, const T* v, T* out, int N, int M, int R,
                   cudaStream_t s) {
  switch (map) {
    case 0: return by_columns<T, D, 0>(xq, zk, v, out, N, M, R, s);
    case 1: return by_columns<T, D, 1>(xq, zk, v, out, N, M, R, s);
    case 2: return by_columns<T, D, 2>(xq, zk, v, out, N, M, R, s);
    case 3: return by_columns<T, D, 3>(xq, zk, v, out, N, M, R, s);
    case 4: return by_columns<T, D, 4>(xq, zk, v, out, N, M, R, s);
    case 5: return by_columns<T, D, 5>(xq, zk, v, out, N, M, R, s);
    case 6: return by_columns<T, D, 6>(xq, zk, v, out, N, M, R, s);
    case 7: return by_columns<T, D, 7>(xq, zk, v, out, N, M, R, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int gram_matvec(const void* xq_, const void* zk_, const void* v_, void* out_, int N, int M,
                int D, int R, int kmap, int deriv, void* stream) {
  if (N < 1 || M < 1 || D < 1 || D > 8 || R < 1 || R > 128 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const T* xq = static_cast<const T*>(xq_);
  const T* zk = static_cast<const T*>(zk_);
  const T* v = static_cast<const T*>(v_);
  T* out = static_cast<T*>(out_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int map = kmap + (deriv ? 4 : 0);
  switch (D) {
    case 1: return by_map<T, 1>(map, xq, zk, v, out, N, M, R, s);
    case 2: return by_map<T, 2>(map, xq, zk, v, out, N, M, R, s);
    case 3: return by_map<T, 3>(map, xq, zk, v, out, N, M, R, s);
    case 4: return by_map<T, 4>(map, xq, zk, v, out, N, M, R, s);
    case 5: return by_map<T, 5>(map, xq, zk, v, out, N, M, R, s);
    case 6: return by_map<T, 6>(map, xq, zk, v, out, N, M, R, s);
    case 7: return by_map<T, 7>(map, xq, zk, v, out, N, M, R, s);
    default: return by_map<T, 8>(map, xq, zk, v, out, N, M, R, s);
  }
}

}  // namespace

// This file builds the f32 entry point; gram_matvec_f64.cu includes it with
// the two macros set for f64, so that the two sets of template instances
// compile in parallel.
#ifndef AGP_GRAM_MATVEC_T
#define AGP_GRAM_MATVEC_T float
#define AGP_GRAM_MATVEC_ENTRY agp_gram_matvec_f32
#endif

extern "C" {

// xq: (N, D), zk: (M, D), v: (M, R), out: (N, R); all row-major, one dtype.
// deriv != 0 takes g' in place of g.  Returns a cudaError_t.
int AGP_GRAM_MATVEC_ENTRY(const void* xq, const void* zk, const void* v, void* out, int N,
                          int M, int D, int R, int kmap, int deriv, void* stream) {
  return gram_matvec<AGP_GRAM_MATVEC_T>(xq, zk, v, out, N, M, D, R, kmap, deriv, stream);
}

}  // extern "C"
