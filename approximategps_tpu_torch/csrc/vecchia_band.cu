// Vecchia band rows: point windows -> Gram -> bordered Cholesky -> band row,
// one window to a team of four threads.
//
// Replaces three functions of approximategps_tpu/ops/batched_chol.py, which
// share one contract (windows (N, D, k+1) or (D, k+1, N) -> band (N, k+1)):
//   pallas_vecchia_band        (_vecchia_band_kernel, masked-column math),
//   pallas_vecchia_band_lanes  (_vecchia_band_kernel_lanes, the bordered
//                               (k+1) Cholesky, optional nugget),
//   pallas_vecchia_band_lanes_t (the same on transposed windows).
// Both layouts come in through strides, so neither is transposed or copied.
//
// For window n the factorization of vecchia_window.cuh, then: the last row of
// L is [w, sqrt(F)], w = L^-1 kni; b = L^-T w over the leading k x k block;
// out[n] = [-b F^-1/2, F^-1/2]; invalid slots give exactly 0 (b_t = 0).
// Any N (the ragged last block is masked), 1 <= k <= 64, 1 <= D <= 8, f32 or
// f64 computed in the input type, the four maps of kernel_maps.cuh.  The
// nugget is read from device memory (null: none).
//
// What bounds it on the H100: operations.  At k = 32 a window costs about
// (k+1)^3/6 FMAs for the factor, k^2/2 for the back substitution and
// (k+1)k/2 Gram entries, each with D FMAs, a sqrt and an exp: 7.5e3 FMAs and
// about 1e3 special-function results against 524 bytes of windows, mask and
// band.  So the design keeps everything a window needs on chip and reads
// each input byte once.
//
// Design.  Windows are independent (the TPU kernel's batch-on-lanes idea).
// A window's working set (the (k+1) x (k+1) triangle of L, its coordinates
// and a column scale: 660 values at k = 32, D = 2) does not fit in
// registers, so it lives in dynamic shared memory, and shared memory a
// window is what bounds how many windows an SM holds (about 90 at k = 32 in
// f32).  With one thread a window that is under three warps an SM, and every
// load's latency shows.  So a window belongs to a team of TEAM = 4 threads
// of one warp (8 windows a warp, one warp a block): the team splits each dot
// product and the Gram entries of a row over its lanes and sums with two
// shuffles, which gives four times the warps for the same shared memory.
// Layout [entry][window]: a team's lanes read neighbouring entries of one
// window and the teams of a warp neighbouring windows, so a warp's access
// touches 32 banks.  Teams past the ragged end repeat the last window and
// store nothing, so every lane of a warp takes the same path through the
// barriers.

#include <cuda_runtime.h>

#include "vecchia_window.cuh"

namespace {

using namespace agp::vecchia;

// values a window keeps in shared memory: coordinates (k+1)*D, the column
// scales (k+1) and the triangle of rows 0..k
inline long long per_window(int k, int D) {
  const long long kp1 = k + 1;
  return kp1 * D + kp1 + kp1 * (kp1 + 1) / 2;
}

// The kernel's arguments: window (n, d, j) at xw[n*sxn + d*sxd + j*sxj],
// mask (n, t) at valid[n*svn + t*svj], nugget null or one value, out
// (N, k+1) row-major.
template <typename T>
struct BandArgs {
  const T* xw;
  long long sxn, sxd, sxj;
  const T* valid;
  long long svn, svj;
  const T* nugget;
  int nugget_self;
  T* out;
  int N, k;
};

template <typename T, int D, int MAP>
__global__ void __launch_bounds__(32) vecchia_band_kernel(const BandArgs<T> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = args.N, k = args.k, nugget_self = args.nugget_self;
  const int lane = threadIdx.x % TEAM;
  const int w = threadIdx.x / TEAM;
  const long long n0 = (long long)blockIdx.x * W + w;
  const bool active = n0 < N;
  const long long n = active ? n0 : N - 1;
  const int kp1 = k + 1;

  // entry e of this team's window is at [e * W]
  T* const X = reinterpret_cast<T*>(smem_raw) + w;  // (k+1) x D coordinates; later b
  T* const cs = X + kp1 * D * W;   // column scales: 1 / pivot, 0 where deflated
  T* const Lt = cs + kp1 * W;      // rows 0..k of L, row i from entry i(i+1)/2

  const unsigned long long vm = load_window<T, D>(args.xw + n * args.sxn, args.sxd, args.sxj,
                                                  args.valid + n * args.svn, args.svj, X, k, lane);
  const T nug = args.nugget != nullptr ? *args.nugget : T(0);
  factor_window<T, D, MAP>(X, cs, Lt, static_cast<T*>(nullptr), vm, nug, nugget_self != 0, k,
                           lane);

  // b = L_k^-T w over the leading k x k block, w = row k; b overwrites X
  const T* const rk = Lt + k * kp1 / 2 * W;
  const T inv_sqrt_F = T(1) / rk[k * W];
  T* const o = args.out + n * kp1;
  T* const b = X;
  for (int i = k - 1; i >= 0; --i) {
    // column i of L below the diagonal: L[t][i] at t(t+1)/2 + i
    T s = T(0);
    for (int t = i + 1 + lane; t < k; t += TEAM)
      s = fma(Lt[(t * (t + 1) / 2 + i) * W], b[t * W], s);
    const T bi = (rk[i * W] - team_sum(s)) / Lt[(i * (i + 1) / 2 + i) * W];
    if (lane == 0) b[i * W] = bi;
    if (active && lane == i % TEAM) o[i] = -bi * inv_sqrt_F;
    __syncwarp();
  }
  if (active && lane == 0) o[k] = inv_sqrt_F;
}

template <typename T, int D, int MAP>
cudaError_t launch(const BandArgs<T>& a, cudaStream_t s) {
  // at most 2730 values a window (k = 64, D = 8): 175 KB a block in f64,
  // inside the 227 KB a block may have
  const size_t bytes = (size_t)(per_window(a.k, D) * W * (long long)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(vecchia_band_kernel<T, D, MAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.N + W - 1) / W);
  vecchia_band_kernel<T, D, MAP><<<blocks, 32, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int vecchia_band(const void* xw, long long sxn, long long sxd, long long sxj, const void* valid,
                 long long svn, long long svj, const void* nugget, int nugget_self, void* out,
                 int N, int D, int k, int kmap, void* stream) {
  if (N < 1 || D < 1 || D > 8 || k < 1 || k > 64 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const BandArgs<T> a{static_cast<const T*>(xw), sxn, sxd, sxj, static_cast<const T*>(valid),
                      svn, svj, static_cast<const T*>(nugget), nugget_self,
                      static_cast<T*>(out), N, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(D, kmap, [&](auto d, auto m) {
    return launch<T, decltype(d)::value, decltype(m)::value>(a, s);
  });
}

}  // namespace

// This file builds the f32 entry point; vecchia_band_f64.cu includes it with
// the two macros set for f64, so that the two sets of template instances
// compile in parallel.
#ifndef AGP_VECCHIA_BAND_T
#define AGP_VECCHIA_BAND_T float
#define AGP_VECCHIA_BAND_ENTRY agp_vecchia_band_f32
#endif

extern "C" {

// Window (n, d, j) at xw[n*sxn + d*sxd + j*sxj], mask (n, t) at
// valid[n*svn + t*svj] (0 or 1, the type of xw), nugget null or one value on
// the device, out (N, k+1) row-major.  Returns a cudaError_t.
int AGP_VECCHIA_BAND_ENTRY(const void* xw, long long sxn, long long sxd, long long sxj,
                           const void* valid, long long svn, long long svj, const void* nugget,
                           int nugget_self, void* out, int N, int D, int k, int kmap,
                           void* stream) {
  return vecchia_band<AGP_VECCHIA_BAND_T>(xw, sxn, sxd, sxj, valid, svn, svj, nugget,
                                          nugget_self, out, N, D, k, kmap, stream);
}

}  // extern "C"
