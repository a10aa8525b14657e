// Vecchia band rows: point windows -> Gram -> bordered Cholesky -> band row,
// one window to the lanes of a warp, its Gram and factor in their registers.
//
// Replaces three functions of approximategps_tpu/ops/batched_chol.py, which
// share one contract (windows (N, D, k+1) or (D, k+1, N) -> band (N, k+1)):
//   pallas_vecchia_band        (_vecchia_band_kernel, masked-column math),
//   pallas_vecchia_band_lanes  (_vecchia_band_kernel_lanes, the bordered
//                               (k+1) Cholesky, optional nugget),
//   pallas_vecchia_band_lanes_t (the same on transposed windows).
// Both layouts come in through strides, so neither is transposed or copied.
//
// For window n (slot t < k neighbour t, slot k the conditioned point):
//   1. Gm = g(r^2) over the k+1 slots, r^2 from exact coordinate differences;
//      invalid neighbour slots become identity rows with zero coupling; the
//      nugget adds to the valid diagonal (slot k only with nugget_self);
//   2. the bordered factorization chol(Gm): each pivot floored at 8 eps of
//      its slot's original diagonal, a floored pivot deflating its column;
//      the last row of L is [w, sqrt(F)], w = L^-1 kni, and the last pivot
//      F = Gm_kk - w.w floored at 8 eps Gm_kk;
//   3. b = L^-T w over the leading k x k block; out[n] = [-b F^-1/2, F^-1/2];
//      invalid slots give exactly 0 (b_t = 0).
// Any N (the ragged last block is masked), 1 <= k <= 64, 1 <= D <= 8, f32 or
// f64 computed in the input type, the four maps of kernel_maps.cuh.  The
// nugget is read from device memory (null: none).
//
// What bounds it on the H100: operations.  At k = 32 a window costs about
// (k+1)^3/6 FMAs for the factor, k^2/2 for the back substitution and
// (k+1)k/2 Gram entries, each with D FMAs, a sqrt and an exp: 7.5e3 FMAs and
// about 1e3 special-function results against 524 bytes of windows, mask and
// band.  What held the earlier design (a team of four threads a window, its
// triangle in shared memory; 7.7 ms for 10^6 windows, PERF.md section 6) at
// 30x that bound was latency: 11 warps an SM, an up-looking factor whose
// every group of four columns waited on shuffle sums and two __syncwarp,
// and a back substitution of k serial steps through shared memory.
//
// Design: row 6's (band_rows.cu), with the Gram formed where it is used.
// The window's k x k block is padded to KW (8, 16, 32 or 64, the first
// >= k) and owned by KW / 2 lanes, two rows a lane in registers
// (vecchia_window.cuh); slot k, the border, is not padded into the width
// but carried as the vector kni (k = 32 keeps KW = 32).
//   - Load: a block takes consecutive windows and stages their coordinates
//     and mask in shared memory (stage_in): 16-byte vectors where each
//     window is contiguous (the gathered (N, k+1, D) points), consecutive
//     threads on consecutive windows otherwise (row 10's (D, k+1, N) layout,
//     where a window's slots lie N apart, coalesces so).
//   - Gram: each lane forms r^2 of its rows against every slot from the
//     staged coordinates (16-byte broadcasts, one coordinate at a time) in
//     the registers that then hold the Gram (gram_rows), and kni_i.
//   - Factor: factor_rows, right-looking, w = L^-1 kni alongside (each w_j
//     the quotient by the pivot); every lane subtracts w_j^2 from Gm_kk as
//     the columns go by, which gives the bordered last pivot F.
//   - Back substitution: L goes once to a packed triangle in shared memory
//     and is read by columns; b_t by a quotient by the pivot (row 6 found
//     products by the reciprocal there 5e-5 off on ill-conditioned f32
//     windows), one shuffle a step.
//   - Store: the band rows through shared memory, written by the block in
//     order (the block's rows are one run of memory).
// No atomics and every sum in a fixed order: a call repeats bitwise.
//
// Occupancy (ptxas -v in the build log): at KW = 32 in f32 a lane holds 48
// entries of rows, __launch_bounds__ asks for six four-warp blocks an SM
// (ptxas takes 80 registers and spills 72 bytes, as row 6 does): 24 warps an
// SM, 48 windows; shared memory (the coordinates and the triangle, 2.3 KB a
// window at D = 1) does not bind.  Six blocks beat five (96 registers, next
// to no spills), four and three at both of the paths' shapes on the H100
// (scripts/occupancy_vecchia_torch.py; PERF.md section 6 has the times).
// f64 at KW = 64 spills (about 1 KB); no path runs it.

#include <cuda_runtime.h>

#include "vecchia_window.cuh"

namespace {

using namespace agp::window;

// The kernel's arguments: windows, mask and out as Entries (window (n, d, j)
// at xw + n*sn + d*sd + j*sj; mask (n, t) at valid + n*sn + t*sj; out (N, k+1)
// row-major), nugget null or one value.
template <typename T>
struct BandArgs {
  const T* xw;
  Entries ex;
  const T* valid;
  Entries ev;
  const T* nugget;
  int nugget_self;
  T* out;
  Entries eo;
  int N, k, D;
};

// values a window keeps in shared memory: D coordinate rows, then the
// packed triangle (which first holds the staged mask, then the factor's two
// columns, then L, then the band row)
template <typename T, int KW>
inline int window_values(int D) {
  return D * Shape<T, KW>::XP + Shape<T, KW>::TRI;
}

template <typename T, int KW, int MAP>
__global__ void __launch_bounds__(32 * Shape<T, KW>::WARPS, Shape<T, KW>::MIN_BLOCKS)
    vecchia_band_kernel(const BandArgs<T> a) {
  using S = Shape<T, KW>;
  constexpr int LPW = S::LPW, WB = S::WB, XP = S::XP, NT = 32 * S::WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPW, r = lane % LPW;
  const int k = a.k, kp1 = k + 1, D = a.D;
  const int sw = D * XP + S::TRI;
  const long long n0 = (long long)blockIdx.x * WB;
  const int nw = (int)min((long long)WB, a.N - n0);
  const int wb = warp * S::G + grp;  // this group's window in the block
  const bool active = wb < nw;
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const xs = smem + wb * sw;  // coordinates: row d at xs + d * XP
  T* const tri = xs + D * XP;

  zero_padding<T, KW>(xs, D, kp1, active, r);
  stage_in<T, WB, XP, NT>(a.xw, a.ex, n0, nw, smem, sw, tid);
  stage_in<T, WB, XP, NT>(a.valid, a.ev, n0, nw, smem + D * XP, sw, tid);
  __syncthreads();

  const unsigned long long vm = window_mask<T, KW>(tri, k, r, grp);
  const T nug = a.nugget != nullptr ? *a.nugget : T(0);
  T rows[2][KW], dg[2], cc[2];
  gram_rows<T, KW, MAP>(xs, D, k, vm, nug, r, rows, dg, cc);

  // the factor; F = Gm_kk - w.w, Gm_kk = g(0) plus the nugget with nugget_self
  const T dk = agp::kernel_map<T>(MAP, T(0)) + (a.nugget_self ? nug : T(0));
  T w[2], piv[2], linv[2], F = dk;
  bool live[2];
  factor_rows<T, KW>(rows, dg, cc, tri, r, w, piv, linv, live, F);
  const T fF = T(8) * Eps<T>::value * fabs(dk);
  const T u0 = T(1) / sqrt(F >= fF ? F : fF);

  __syncwarp();  // every lane has read the factor's last column
  store_tri<T, KW>(tri, rows, r);
  __syncwarp();
  T b[2];
  back_sub<T, KW>(tri, w, piv, linv, live, r, b);
  __syncwarp();  // every lane has read L

  // the band row to the triangle's place, then out by the block
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
    if (i < k) tri[i] = -b[q] * u0;
  }
  if (r == 0) tri[k] = u0;
  __syncthreads();
  stage_out<T, WB, XP, NT>(a.out, a.eo, n0, nw, smem + D * XP, sw, tid);
}

template <typename T, int KW, int MAP>
cudaError_t launch(const BandArgs<T>& a, cudaStream_t s) {
  using S = Shape<T, KW>;
  const size_t bytes = (size_t)S::WB * window_values<T, KW>(a.D) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(vecchia_band_kernel<T, KW, MAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.N + S::WB - 1) / S::WB);
  vecchia_band_kernel<T, KW, MAP><<<blocks, 32 * S::WARPS, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int vecchia_band(const void* xw, long long sxn, long long sxd, long long sxj, const void* valid,
                 long long svn, long long svj, const void* nugget, int nugget_self, void* out,
                 int N, int D, int k, int kmap, void* stream) {
  if (N < 1 || D < 1 || D > 8 || k < 1 || k > 64 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const BandArgs<T> a{static_cast<const T*>(xw), make_entries(sxn, sxd, sxj, D, k + 1),
                      static_cast<const T*>(valid), make_entries(svn, 0, svj, 1, k),
                      static_cast<const T*>(nugget), nugget_self, static_cast<T*>(out),
                      make_entries(k + 1, 0, 1, 1, k + 1), N, k, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(k, [&](auto kw) {
    return by_map(kmap, [&](auto m) {
      return launch<T, decltype(kw)::value, decltype(m)::value>(a, s);
    });
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
