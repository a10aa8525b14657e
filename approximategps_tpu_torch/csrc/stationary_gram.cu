// Fused stationary Gram: K = g(|x_i - z_j|^2) tile by tile, r^2 and the map
// in registers, K written once by 16-byte streaming stores.
//
// Replaces approximategps_tpu/ops/gram.py::pallas_stationary_gram (_forward,
// _gram_kernel): X (N, D), Z (M, D) -> K (N, M) in X's type, for a static
// stationary map.  The TPU kernel forms r^2 by the |x|^2 identity on centred
// inputs (the MXU's dot); here r^2 is summed from exact coordinate
// differences, which is at least as accurate, costs no more at the D of the
// repo's paths, and gives r^2 = 0 exactly for a point paired with itself
// (where the Matern maps meet safe_r).
//
// Any N and M (the ragged tiles are masked), any D >= 1, a batch of B
// independent Grams over the grid's third dimension (the autograd
// Function's vmap rule), f32 or f64 computed in the input type, the four
// maps of kernel_maps.cuh.  X and Z come in through strides; K is written
// row-major, (B, N, M) contiguous.
//
// What bounds it on the H100: bytes.  At the minibatch step's Kuf, N = 2048
// inducing points by M = 8192 batch points, D = 8, it writes 67 MB (0.02 ms
// at 3.35 TB/s) against 2.7e8 FMAs and subtractions and 1.7e7 exps, under
// 0.01 ms on their units.  So the design is about the write:
//   - a thread owns V neighbouring columns (V = 4 in f32, 2 in f64: 16
//     bytes) and RPT rows, and writes each row's run as one 16-byte store
//     with the streaming hint (st.global.cs: K is not read back here), so a
//     warp stores 512 contiguous bytes of a row at once;
//   - the block's 64 rows of X and TJ columns of Z are staged once in shared
//     memory, coordinate-major, by coalesced reads (a thread's own 32 Z
//     values read straight from device memory would take a sector each, 32
//     scattered requests a warp instruction); then each thread holds
//     its columns' coordinates in registers (one 16-byte shared read a
//     coordinate) and reads each row's as a broadcast.  For D <= DC, the
//     repo's paths, that is one barrier and no loop; a larger D (a kernel
//     of its own) stages DC coordinates at a time, two barriers a chunk,
//     zeros past D adding exactly 0 to r^2;
//   - a row whose start is not 16-byte aligned (M not a multiple of V, or a
//     batch of such Grams) and the run that crosses column M are written by
//     scalar streaming stores: a misaligned vector store would fault.
// No tensor cores: the work is a difference, an FMA and a map per entry,
// not a product of stored tiles.  No TMA store either: the vector stores
// already leave the tile in registers straight for the memory system.

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_maps.cuh"

namespace {

constexpr int WARPS = 8;        // warps a block, one above the other
constexpr int RPT = 8;          // rows a warp (and each of its threads) owns
constexpr int TI = WARPS * RPT; // rows of X a block owns
constexpr int DC = 8;           // coordinates held in registers at a time

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
struct GramArgs {
  const T* x;
  long long sxb, sxn, sxd;
  const T* z;
  long long szb, szm, szd;
  T* out;
  int N, M, D;
};

// one 16-byte streaming store of v[0 .. V-1]
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

__device__ __forceinline__ void unpack(const float4& t, float (&z)[4]) {
  z[0] = t.x;
  z[1] = t.y;
  z[2] = t.z;
  z[3] = t.w;
}
__device__ __forceinline__ void unpack(const double2& t, double (&z)[2]) {
  z[0] = t.x;
  z[1] = t.y;
}

// WIDE: D > DC, staged DC coordinates at a time (two barriers a chunk);
// otherwise the one chunk is staged once, behind one barrier.
template <typename T, int MAP, bool WIDE>
__global__ void __launch_bounds__(32 * WARPS) stationary_gram_kernel(const GramArgs<T> a) {
  constexpr int V = Vec<T>::n, TJ = 32 * V;  // columns a block owns
  using VT = typename Vec<T>::type;
  __shared__ __align__(16) T xs[DC][TI];
  __shared__ __align__(16) T zs[DC][TJ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const int j = j0 + V * lane;  // this thread's first column
  const int r0 = warp * RPT;    // this warp's first row in the tile
  const long long b = blockIdx.z;
  const T* const xb = a.x + b * a.sxb;
  const T* const zb = a.z + b * a.szb;

  T acc[RPT][V];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = T(0);

  for (int d0 = 0; d0 < (WIDE ? a.D : 1); d0 += DC) {
    if (WIDE) __syncthreads();  // the previous chunk is consumed
    // the tile's rows and columns, coordinate-major, zeros past N, M and D
    for (int e = tid; e < TI * DC; e += 32 * WARPS) {
      const int i = e / DC, d = e % DC;
      xs[d][i] = i0 + i < a.N && d0 + d < a.D ? xb[(i0 + i) * a.sxn + (d0 + d) * a.sxd] : T(0);
    }
    for (int e = tid; e < TJ * DC; e += 32 * WARPS) {
      const int c = e / DC, d = e % DC;
      zs[d][c] = j0 + c < a.M && d0 + d < a.D ? zb[(j0 + c) * a.szm + (d0 + d) * a.szd] : T(0);
    }
    __syncthreads();
    // this thread's columns into registers (a 16-byte read a coordinate),
    // then each row's coordinates as broadcasts
    T z[DC][V];
#pragma unroll
    for (int d = 0; d < DC; ++d) unpack(*reinterpret_cast<const VT*>(&zs[d][V * lane]), z[d]);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        const T x = xs[d][r0 + r];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const T dd = x - z[d][v];
          acc[r][v] = fma(dd, dd, acc[r][v]);
        }
      }
  }

  if (j >= a.M) return;
  T* const ob = a.out + b * (long long)a.N * a.M + (long long)i0 * a.M + j;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (i0 + r0 + r >= a.N) break;  // warp-uniform
    T k[V];
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] = agp::kernel_map<T>(MAP, acc[r][v]);
    T* const p = ob + (long long)(r0 + r) * a.M;
    if (j + V <= a.M && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
      store_vec(p, k);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (j + v < a.M) __stcs(p + v, k[v]);
    }
  }
}

constexpr int kMaxGridZ = 65535;

// a batch past the grid's third dimension goes in chunks of kMaxGridZ Grams
template <typename T, int MAP>
cudaError_t launch(GramArgs<T> a, int B, cudaStream_t s) {
  constexpr int TJ = 32 * Vec<T>::n;
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const int nb = B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ;
    const dim3 grid((unsigned)((a.M + TJ - 1) / TJ), (unsigned)((a.N + TI - 1) / TI),
                    (unsigned)nb);
    if (a.D > DC)
      stationary_gram_kernel<T, MAP, true><<<grid, 32 * WARPS, 0, s>>>(a);
    else
      stationary_gram_kernel<T, MAP, false><<<grid, 32 * WARPS, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.x += nb * a.sxb;
    a.z += nb * a.szb;
    a.out += (long long)nb * a.N * a.M;
  }
  return cudaSuccess;
}

template <typename T>
int stationary_gram(const void* x, long long sxb, long long sxn, long long sxd, const void* z,
                    long long szb, long long szm, long long szd, void* out, int B, int N, int M,
                    int D, int kmap, void* stream) {
  if (B < 1 || N < 1 || N > 65535 * TI || M < 1 || D < 1 ||
      !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const GramArgs<T> a{static_cast<const T*>(x), sxb, sxn, sxd, static_cast<const T*>(z),
                      szb, szm, szd, static_cast<T*>(out), N, M, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kmap) {
    case 0: return launch<T, 0>(a, B, s);
    case 1: return launch<T, 1>(a, B, s);
    case 2: return launch<T, 2>(a, B, s);
    default: return launch<T, 3>(a, B, s);
  }
}

}  // namespace

// This file builds the f32 entry point; stationary_gram_f64.cu includes it
// with the two macros set for f64, so that the two compile in parallel.
#ifndef AGP_STATIONARY_GRAM_T
#define AGP_STATIONARY_GRAM_T float
#define AGP_STATIONARY_GRAM_ENTRY agp_stationary_gram_f32
#endif

extern "C" {

// Gram b, entry (i, j) = g(|x_bi - z_bj|^2), x (b, i, d) at
// x[b*sxb + i*sxn + d*sxd], z likewise, out (B, N, M) row-major.  Returns a
// cudaError_t.
int AGP_STATIONARY_GRAM_ENTRY(const void* x, long long sxb, long long sxn, long long sxd,
                              const void* z, long long szb, long long szm, long long szd,
                              void* out, int B, int N, int M, int D, int kmap, void* stream) {
  return stationary_gram<AGP_STATIONARY_GRAM_T>(x, sxb, sxn, sxd, z, szb, szm, szd, out, B, N,
                                                M, D, kmap, stream);
}

}  // extern "C"
