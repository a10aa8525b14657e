// The pullback of the Vecchia band rows: point windows and the band's
// cotangent -> the windows' cotangent and, with a nugget, one nugget partial
// a window; one window to a team of four threads.
//
// Replaces approximategps_tpu/ops/batched_chol.py::
// _vecchia_band_lanes_bwd_pallas_t (the kernel _vecchia_band_bwd_kernel_lanes),
// the backward of pallas_vecchia_band_lanes and pallas_vecchia_band_lanes_t.
// It takes the forward's inputs with the same strides (so row 10's (D, k+1, N)
// windows and row 8's gathered (N, k+1, D) points both arrive as views) and
// writes xwbar in the strides it is given.
//
// For window n (vecchia_window.cuh builds and factors the masked bordered
// Gram exactly as the forward does), with b = Kw^-1 kni, F = kdiag - kni.b,
// u0 = F^-1/2 and the cotangent gbar = [gr, gd]:
//   1. b = L_k^-T w (w = row k of L), deflated coordinates 0;
//   2. F = max(kdiag - kni.b, 8 eps kdiag) from this expression (not from the
//      factor's last pivot, whose floor differs), u0 = 1/sqrt(F);
//   3. u0bar = gd - gr.b, Fbar = -u0^3 u0bar / 2, bbar = -u0 gr - kni Fbar;
//   4. Sbbar = Kw^-1 bbar by a forward and a back substitution, deflated
//      coordinates forced to 0 in both;
//   5. nugget partial = -sum_j Sbbar_j b_j valid_j (+ Fbar with nugget_self);
//   6. knibar = (Sbbar - b Fbar) valid; the symmetric Gram cotangent is
//        Gs[i][j] = -(Sbbar_i b_j + Sbbar_j b_i) / 2   (i, j < k, both valid)
//        Gs[i][k] = knibar_i / 2
//      and r2bar = g'(r^2) Gs (kernel_map_dr2, the JAX convention at 0);
//   7. xwbar[d][t] = 4 sum_i r2bar[i][t] (w_d[t] - w_d[i]).
// Step 7 sums the full (i, t) and (t, i) pairs of the JAX kernel's -4 sum_i
// r2bar (w_i - w_t): each unordered pair reaches both of its slots.  Each lane
// owns the slots t = lane, lane + 4, ... and sums over every i for them, so
// no slot is written by two threads and nothing is summed across windows
// (the wrapper sums the nugget partials in a fixed order).
//
// Any N, 1 <= k <= 64, 1 <= D <= 8, f32 or f64 computed in the input type, the
// four maps; the nugget read from device memory (null: none, and no partials).
//
// What bounds it on the H100: operations.  At k = 32 a window costs the
// forward's factor (about 6e3 FMAs), three triangular solves (3 x 496 FMAs)
// and for each of the (k+1)k ordered pairs of valid slots D differences, D
// FMAs, a few flops of g' and its sqrt and exp, against 528 bytes of windows,
// mask, cotangents and outputs.  So, like the forward, it keeps a window on
// chip and reads each input once.
//
// Design (simple first): the forward's team of four threads a window and its
// shared-memory layout, with three more (k) vectors beside the triangle: kni
// (later knibar), b and bbar (which the two substitutions overwrite in place
// with y and then Sbbar).  Gbar is never stored: each (i, t) entry is formed
// from those vectors where it is used.  Each pair's g' is computed twice (once
// for each of its slots), which is the price of owning slots without atomics.

#include <cuda_runtime.h>

#include "vecchia_window.cuh"

namespace {

using namespace agp::vecchia;

// values a window keeps in shared memory: coordinates (k+1)*D, the column
// scales (k+1), the triangle of rows 0..k and three (k) vectors.  At k = 64,
// D = 8: 2922 values, 8 windows a block 187 KB in f64, inside the 227 KB a
// block may have.
inline long long per_window(int k, int D) {
  const long long kp1 = k + 1;
  return kp1 * D + kp1 + kp1 * (kp1 + 1) / 2 + 3LL * k;
}

// window (n, d, j) at xw[n*sxn + d*sxd + j*sxj], mask (n, t) at
// valid[n*svn + t*svj], gbar (n, j) at gbar[n*sgn + j*sgj], xwbar (n, d, j) at
// xbar[n*sbn + d*sbd + j*sbj], nbar (N,) or null
template <typename T>
struct BwdArgs {
  const T* xw;
  long long sxn, sxd, sxj;
  const T* valid;
  long long svn, svj;
  const T* nugget;
  int nugget_self;
  const T* gbar;
  long long sgn, sgj;
  T* xbar;
  long long sbn, sbd, sbj;
  T* nbar;
  int N, k;
};

template <typename T, int D, int MAP>
__global__ void __launch_bounds__(32) vecchia_band_bwd_kernel(const BwdArgs<T> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = args.N, k = args.k;
  const bool nugget_self = args.nugget_self != 0;
  const int lane = threadIdx.x % TEAM;
  const int w = threadIdx.x / TEAM;
  const long long n0 = (long long)blockIdx.x * W + w;
  const bool active = n0 < N;
  const long long n = active ? n0 : N - 1;
  const int kp1 = k + 1;

  // entry e of this team's window is at [e * W]
  T* const X = reinterpret_cast<T*>(smem_raw) + w;  // (k+1) x D coordinates
  T* const cs = X + kp1 * D * W;   // column scales: 1 / pivot, 0 where deflated
  T* const Lt = cs + kp1 * W;      // rows 0..k of L, row i from entry i(i+1)/2
  T* const kn = Lt + kp1 * (kp1 + 1) / 2 * W;  // kni, later knibar
  T* const bv = kn + k * W;                    // b
  T* const sv = bv + k * W;                    // gr, bbar, y, Sbbar in turn

  const unsigned long long vm = load_window<T, D>(args.xw + n * args.sxn, args.sxd, args.sxj,
                                                  args.valid + n * args.svn, args.svj, X, k, lane);
  const T nug = args.nugget != nullptr ? *args.nugget : T(0);
  factor_window<T, D, MAP>(X, cs, Lt, kn, vm, nug, nugget_self, k, lane);

  // 1. b = L_k^-T w over the leading k x k block
  const T* const rk = Lt + k * kp1 / 2 * W;
  for (int i = k - 1; i >= 0; --i) {
    // column i of L below the diagonal: L[t][i] at t(t+1)/2 + i
    T s = T(0);
    for (int t = i + 1 + lane; t < k; t += TEAM)
      s = fma(Lt[(t * (t + 1) / 2 + i) * W], bv[t * W], s);
    s = team_sum(s);
    const T bi = cs[i * W] != T(0) ? (rk[i * W] - s) / Lt[(i * (i + 1) / 2 + i) * W] : T(0);
    if (lane == 0) bv[i * W] = bi;
    __syncwarp();
  }

  // 2.-3. F, u0 and the cotangents of u0, F and b
  const T* const gn = args.gbar + n * args.sgn;
  for (int t = lane; t < k; t += TEAM) sv[t * W] = gn[t * args.sgj];
  const T gd = gn[k * args.sgj];
  __syncwarp();
  const T kdiag = agp::kernel_map<T>(MAP, T(0)) + (nugget_self ? nug : T(0));
  const T eps8 = T(8) * Eps<T>::value;
  const T Fraw = kdiag - team_dot(kn, bv, k, lane);
  const T F = Fraw >= eps8 * kdiag ? Fraw : eps8 * kdiag;
  const T u0 = T(1) / sqrt(F);
  const T u0_bar = gd - team_dot(sv, bv, k, lane);
  const T F_bar = T(-0.5) * u0 * u0 * u0 * u0_bar;
  __syncwarp();  // every lane has read gr
  for (int t = lane; t < k; t += TEAM) sv[t * W] = -u0 * sv[t * W] - kn[t * W] * F_bar;
  __syncwarp();

  // 4. Sbbar = L_k^-T (L_k^-1 bbar), in place, deflated coordinates 0
  for (int i = 0; i < k; ++i) {
    const T s = team_dot(Lt + i * (i + 1) / 2 * W, sv, i, lane);  // sum_{t<i} L[i][t] y_t
    const T yi = (sv[i * W] - s) * cs[i * W];
    __syncwarp();
    if (lane == 0) sv[i * W] = yi;
    __syncwarp();
  }
  for (int i = k - 1; i >= 0; --i) {
    T s = T(0);
    for (int t = i + 1 + lane; t < k; t += TEAM)
      s = fma(Lt[(t * (t + 1) / 2 + i) * W], sv[t * W], s);
    s = team_sum(s);
    const T v = (sv[i * W] - s) * cs[i * W];
    __syncwarp();
    if (lane == 0) sv[i * W] = v;
    __syncwarp();
  }

  // 5. the nugget partial
  if (args.nbar != nullptr) {
    T p = T(0);
    for (int t = lane; t < k; t += TEAM)
      if ((vm >> t) & 1ull) p = fma(sv[t * W], bv[t * W], p);
    const T nb = -team_sum(p) + (nugget_self ? F_bar : T(0));
    if (active && lane == 0) args.nbar[n] = nb;
  }

  // 6. knibar over kni
  for (int t = lane; t < k; t += TEAM)
    kn[t * W] = ((vm >> t) & 1ull) ? sv[t * W] - bv[t * W] * F_bar : T(0);
  __syncwarp();

  // 7. xwbar of the slots this lane owns
  T* const xb = args.xbar + n * args.sbn;
  for (int t = lane; t <= k; t += TEAM) {
    const bool vt = t == k || ((vm >> t) & 1ull);
    T xt[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xt[d] = X[(t * D + d) * W];
      acc[d] = T(0);
    }
    if (vt) {
      const T st = t < k ? sv[t * W] : T(0);
      const T bt = t < k ? bv[t * W] : T(0);
      for (int i = 0; i <= k; ++i) {
        if (i == t || (i < k && !((vm >> i) & 1ull))) continue;
        const T gs = t == k   ? T(0.5) * kn[i * W]
                     : i == k ? T(0.5) * kn[t * W]
                              : T(-0.5) * (sv[i * W] * bt + st * bv[i * W]);
        T dd[D];
        T r2 = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dd[d] = xt[d] - X[(i * D + d) * W];
          r2 = fma(dd[d], dd[d], r2);
        }
        const T c = T(4) * agp::kernel_map_dr2<T>(MAP, r2) * gs;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fma(c, dd[d], acc[d]);
      }
    }
    if (active)
#pragma unroll
      for (int d = 0; d < D; ++d) xb[d * args.sbd + t * args.sbj] = acc[d];
  }
}

template <typename T, int D, int MAP>
cudaError_t launch(const BwdArgs<T>& a, cudaStream_t s) {
  const size_t bytes = (size_t)(per_window(a.k, D) * W * (long long)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(vecchia_band_bwd_kernel<T, D, MAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.N + W - 1) / W);
  vecchia_band_bwd_kernel<T, D, MAP><<<blocks, 32, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int vecchia_band_bwd(const void* xw, long long sxn, long long sxd, long long sxj,
                     const void* valid, long long svn, long long svj, const void* nugget,
                     int nugget_self, const void* gbar, long long sgn, long long sgj, void* xbar,
                     long long sbn, long long sbd, long long sbj, void* nbar, int N, int D, int k,
                     int kmap, void* stream) {
  if (N < 1 || D < 1 || D > 8 || k < 1 || k > 64 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const BwdArgs<T> a{static_cast<const T*>(xw), sxn, sxd, sxj, static_cast<const T*>(valid),
                     svn, svj, static_cast<const T*>(nugget), nugget_self,
                     static_cast<const T*>(gbar), sgn, sgj, static_cast<T*>(xbar), sbn, sbd, sbj,
                     static_cast<T*>(nbar), N, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(D, kmap, [&](auto d, auto m) {
    return launch<T, decltype(d)::value, decltype(m)::value>(a, s);
  });
}

}  // namespace

// This file builds the f32 entry point; vecchia_band_bwd_f64.cu includes it
// with the two macros set for f64, so that the two sets of template instances
// compile in parallel.
#ifndef AGP_VECCHIA_BAND_BWD_T
#define AGP_VECCHIA_BAND_BWD_T float
#define AGP_VECCHIA_BAND_BWD_ENTRY agp_vecchia_band_bwd_f32
#endif

extern "C" {

// The forward's inputs (windows, mask, nugget, nugget_self) with their
// strides, gbar (n, j) at gbar[n*sgn + j*sgj], xwbar written at
// xbar[n*sbn + d*sbd + j*sbj], nbar (N,) the nugget partials (null without
// a nugget).  Returns a cudaError_t.
int AGP_VECCHIA_BAND_BWD_ENTRY(const void* xw, long long sxn, long long sxd, long long sxj,
                               const void* valid, long long svn, long long svj,
                               const void* nugget, int nugget_self, const void* gbar,
                               long long sgn, long long sgj, void* xbar, long long sbn,
                               long long sbd, long long sbj, void* nbar, int N, int D, int k,
                               int kmap, void* stream) {
  return vecchia_band_bwd<AGP_VECCHIA_BAND_BWD_T>(xw, sxn, sxd, sxj, valid, svn, svj, nugget,
                                                  nugget_self, gbar, sgn, sgj, xbar, sbn, sbd,
                                                  sbj, nbar, N, D, k, kmap, stream);
}

}  // extern "C"
