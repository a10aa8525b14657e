// Fused stationary Gram: K = g(|x_i - z_j|^2) tile by tile, r^2 and the map
// in registers, K written once.
//
// Replaces approximategps_tpu/ops/gram.py::pallas_stationary_gram (_forward,
// _gram_kernel): X (N, D), Z (M, D) -> K (N, M) in X's type, for a static
// stationary map.  The TPU kernel forms r^2 by the |x|^2 identity on centred
// inputs (the MXU's dot); here r^2 is summed from exact coordinate
// differences, which is at least as accurate, costs no more at the D of the
// repo's paths, and gives r^2 = 0 exactly for a point paired with itself
// (where the Matern maps meet safe_r).
//
// Any N and M (the ragged tiles are masked), any D >= 1 (staged in chunks of
// DC coordinates, the last one zero-filled), a batch of B independent Grams
// over the grid's third dimension (the autograd Function's vmap rule), f32
// or f64 computed in the input type, the four maps of kernel_maps.cuh.  X and
// Z come in through strides; K is written row-major, (B, N, M) contiguous.
//
// What bounds it on the H100: bytes.  At the minibatch step's Kuf, N = 2048
// inducing points by M = 8192 batch points, D = 8, it writes 67 MB (0.02 ms
// at 3.35 TB/s) against 2.7e8 FMAs and subtractions and 1.7e7 exps, under
// 0.01 ms on their units.  So the design is about the write: each block owns
// a TI x TJ tile, a thread one column j and TI / RY rows of it, so that the
// 64 threads along x store 64 neighbouring entries of a row (256 bytes in
// f32) at once.  The tile's X rows and Z columns are staged in shared memory
// d-major: a warp reads one X entry (a broadcast) and 32 neighbouring Z
// entries (32 banks).  No tensor cores: the work is a difference, an FMA and
// a map per entry, not a product of stored tiles.

#include <cuda_runtime.h>

#include "kernel_maps.cuh"

namespace {

constexpr int TI = 64;       // rows of X a block owns
constexpr int TJ = 64;       // columns (rows of Z) a block owns: blockDim.x
constexpr int RY = 4;        // blockDim.y: each thread owns TI / RY rows
constexpr int DC = 8;        // coordinates staged at a time
constexpr int RPT = TI / RY;

template <typename T>
struct GramArgs {
  const T* x;
  long long sxb, sxn, sxd;
  const T* z;
  long long szb, szm, szd;
  T* out;
  int N, M, D;
};

template <typename T, int MAP>
__global__ void __launch_bounds__(TJ * RY) stationary_gram_kernel(const GramArgs<T> a) {
  __shared__ T xs[DC][TI];
  __shared__ T zs[DC][TJ];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TJ + tx;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const long long b = blockIdx.z;
  const T* const xb = a.x + b * a.sxb;
  const T* const zb = a.z + b * a.szb;

  T acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = T(0);

  for (int d0 = 0; d0 < a.D; d0 += DC) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < TI * DC; e += TJ * RY) {
      const int i = e / DC, d = e % DC;
      const bool in = i0 + i < a.N && d0 + d < a.D;
      xs[d][i] = in ? xb[(i0 + i) * a.sxn + (d0 + d) * a.sxd] : T(0);
    }
    for (int e = tid; e < TJ * DC; e += TJ * RY) {
      const int j = e / DC, d = e % DC;
      const bool in = j0 + j < a.M && d0 + d < a.D;
      zs[d][j] = in ? zb[(j0 + j) * a.szm + (d0 + d) * a.szd] : T(0);
    }
    __syncthreads();
    T zj[DC];
#pragma unroll
    for (int d = 0; d < DC; ++d) zj[d] = zs[d][tx];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = ty + r * RY;
#pragma unroll
      for (int d = 0; d < DC; ++d) {
        const T dd = xs[d][i] - zj[d];
        acc[r] = fma(dd, dd, acc[r]);
      }
    }
  }

  const int j = j0 + tx;
  if (j >= a.M) return;
  T* const ob = a.out + b * (long long)a.N * a.M;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = i0 + ty + r * RY;
    if (i < a.N) ob[(long long)i * a.M + j] = agp::kernel_map<T>(MAP, acc[r]);
  }
}

constexpr int kMaxGridZ = 65535;

// a batch past the grid's third dimension goes in chunks of kMaxGridZ Grams
template <typename T, int MAP>
cudaError_t launch(GramArgs<T> a, int B, cudaStream_t s) {
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const int nb = B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ;
    const dim3 grid((unsigned)((a.M + TJ - 1) / TJ), (unsigned)((a.N + TI - 1) / TI),
                    (unsigned)nb);
    stationary_gram_kernel<T, MAP><<<grid, dim3(TJ, RY), 0, s>>>(a);
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
