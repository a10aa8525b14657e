// The pullback of the Vecchia band rows: point windows and the band's
// cotangent -> the windows' cotangent and, with a nugget, one nugget partial
// a window; one window to the lanes of a warp, its Gram and factor in their
// registers.
//
// Replaces approximategps_tpu/ops/batched_chol.py::
// _vecchia_band_lanes_bwd_pallas_t (the kernel _vecchia_band_bwd_kernel_lanes),
// the backward of pallas_vecchia_band_lanes and pallas_vecchia_band_lanes_t.
// It takes the forward's inputs with the same strides (so row 10's (D, k+1, N)
// windows and row 8's gathered (N, k+1, D) points both arrive as views) and
// writes xwbar in the strides it is given.
//
// For window n (the masked bordered Gram factored exactly as the forward,
// vecchia_band.cu, does), with b = Kw^-1 kni, F = kdiag - kni.b,
// u0 = F^-1/2 and the cotangent gbar = [gr, gd]:
//   1. b = L_k^-T w (w = L_k^-1 kni), deflated coordinates 0;
//   2. F = max(kdiag - kni.b, 8 eps kdiag) from this expression (the JAX
//      convention, not the factor's last pivot, whose floor differs),
//      u0 = 1/sqrt(F);
//   3. u0bar = gd - gr.b, Fbar = -u0^3 u0bar / 2, bbar = -u0 gr - kni Fbar;
//   4. Sbbar = Kw^-1 bbar by a forward and a back substitution, deflated
//      coordinates forced to 0 in both;
//   5. nugget partial = -sum_j Sbbar_j b_j valid_j (+ Fbar with nugget_self);
//   6. knibar = (Sbbar - b Fbar) valid; the symmetric Gram cotangent is
//        Gs[i][j] = -(Sbbar_i b_j + Sbbar_j b_i) / 2   (i, j < k, both valid)
//        Gs[i][k] = knibar_i / 2
//      and r2bar = g'(r^2) Gs (kernel_map_dr2, the JAX convention at 0);
//   7. xwbar[d][t] = 4 sum_i r2bar[i][t] (w_d[t] - w_d[i]).
// Any N, 1 <= k <= 64, 1 <= D <= 8, f32 or f64 computed in the input type, the
// four maps; the nugget read from device memory (null: none, and no partials).
//
// What bounds it on the H100: operations.  At k = 32 a window costs the
// forward's factor (about 6e3 FMAs), three triangular solves (3 x 496 FMAs)
// and for each of the (k+1)k/2 pairs of valid slots a Gram entry and g'
// (D differences, D FMAs, a few flops, a sqrt and an exp each) and the
// pair's two xwbar updates, against 528 bytes of windows, mask, cotangents
// and outputs.  The earlier design (a team of four threads a window, its
// triangle in shared memory; 17.0 ms for 10^6 windows, PERF.md section 6)
// ran at 51x that bound: 9 warps an SM, serial solves through shared memory,
// and step 7 formed every pair's g' twice, once for each of its slots.
//
// Design: the forward's (vecchia_band.cu), then the pullback on the lanes'
// rows.
//   - Load: the block stages its windows' coordinates, masks and cotangents
//     in shared memory (stage_in); the Gram and the factor are the
//     forward's (gram_rows, factor_rows), and L goes once to a packed
//     triangle in shared memory.
//   - Solves: b and Sbbar by columns of that triangle (back_sub), y = L^-1
//     bbar by its rows (fwd_sub), each a quotient by the pivot and one
//     shuffle a step; the dots of steps 2, 3 and 5 are sums over the
//     window's lanes (group_sum, the same bits in each).
//   - Step 7 forms each pair (i, j), j < i, once, on the lane of row i:
//     r^2 again from the staged coordinates into the registers that held
//     the Gram, then c_ij = 4 g'(r^2) Gs_ij with b and Sbbar read as
//     broadcasts.  For each coordinate d the lane adds c_ij (x_i - x_j) to
//     row i's cotangent and writes it to the triangle's place (i, j); after
//     one __syncwarp each lane sums its rows' columns of the triangle (slot
//     j's side, -c_ij (x_i - x_j) over i > j) in the order of i.  So g' is
//     formed once a pair (the earlier design: twice, the Gram's g once
//     more), no slot is written by two lanes, and nothing is summed across
//     windows: with the wrapper's fixed-order sum of the nugget partials, a
//     call repeats bitwise.  The other option, keeping each row's r^2 from
//     the Gram build, would hold a second 48 registers a lane at KW = 32
//     through the factor: some 140 registers, three blocks an SM, which
//     measured half again slower than five (bwd_min_blocks).
//   - Store: xwbar through shared memory (over the staged coordinates), in
//     the strides it is given, by the block (stage_out).
//
// Occupancy (ptxas -v in the build log): at KW = 32 in f32 five four-warp
// blocks an SM (bwd_min_blocks: 96 registers, some 200 bytes of spills), 20
// warps and 40 windows; shared memory 2.5 KB a window at D = 1 (coordinates,
// two vectors, the triangle) does not bind.

#include <cuda_runtime.h>

#include "vecchia_window.cuh"

namespace {

using namespace agp::window;

// window (n, d, j), mask (n, t), gbar (n, j) and xwbar (n, d, j) as Entries,
// nbar (N,) or null
template <typename T>
struct BwdArgs {
  const T* xw;
  Entries ex;
  const T* valid;
  Entries ev;
  const T* nugget;
  int nugget_self;
  const T* gbar;
  Entries eg;
  T* xbar;
  Entries eb;
  T* nbar;
  int N, k, D;
};

// values a window keeps in shared memory: D coordinate rows (xwbar at the
// end), two vectors (the staged cotangent, then b and Sbbar) and the packed
// triangle (the staged mask, the factor's two columns, L, then step 7's
// pair terms)
template <typename T, int KW>
inline int window_values(int D) {
  return (D + 2) * Shape<T, KW>::XP + Shape<T, KW>::TRI;
}

// blocks an SM the pullback asks for: one fewer than the forward at KW <= 32
// in f32 (at most 102 registers; ptxas takes 96 and spills about 200 bytes,
// against 80 and 400 at six blocks), the fastest of six, five, four (no
// spills) and three at the training step's shape on the H100
// (scripts/occupancy_vecchia_torch.py; PERF.md section 6 has the times)
template <typename T, int KW>
constexpr int bwd_min_blocks() {
  return sizeof(T) == 4 && KW <= 32 ? 5 : 1;
}

template <typename T, int KW, int MAP>
__global__ void __launch_bounds__(32 * Shape<T, KW>::WARPS, bwd_min_blocks<T, KW>())
    vecchia_band_bwd_kernel(const BwdArgs<T> a) {
  using S = Shape<T, KW>;
  constexpr int LPW = S::LPW, WB = S::WB, XP = S::XP, V = S::V, NT = 32 * S::WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPW, r = lane % LPW;
  const int k = a.k, kp1 = k + 1, D = a.D;
  const bool nugget_self = a.nugget_self != 0;
  const int sw = (D + 2) * XP + S::TRI;
  const long long n0 = (long long)blockIdx.x * WB;
  const int nw = (int)min((long long)WB, a.N - n0);
  const int wb = warp * S::G + grp;
  const bool active = wb < nw;
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const xs = smem + wb * sw;   // coordinates: row d at xs + d * XP; xwbar at the end
  T* const vb = xs + D * XP;      // the cotangent, then b
  T* const vs = vb + XP;          // Sbbar
  T* const tri = vs + XP;

  zero_padding<T, KW>(xs, D, kp1, active, r);
  stage_in<T, WB, XP, NT>(a.xw, a.ex, n0, nw, smem, sw, tid);
  stage_in<T, WB, XP, NT>(a.valid, a.ev, n0, nw, smem + (D + 2) * XP, sw, tid);
  stage_in<T, WB, XP, NT>(a.gbar, a.eg, n0, nw, smem + D * XP, sw, tid);
  __syncthreads();

  const unsigned long long vm = window_mask<T, KW>(tri, k, r, grp);
  T gr[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
    gr[q] = i < k ? vb[i] : T(0);
  }
  const T gd = vb[k];
  const T nug = a.nugget != nullptr ? *a.nugget : T(0);
  T rows[2][KW], dg[2], cc[2];
  gram_rows<T, KW, MAP>(xs, D, k, vm, nug, r, rows, dg, cc);
  T w[2], piv[2], linv[2], unused = T(0);
  bool live[2];
  factor_rows<T, KW>(rows, dg, cc, tri, r, w, piv, linv, live, unused);
  __syncwarp();  // every lane has read the factor's last column
  store_tri<T, KW>(tri, rows, r);
  __syncwarp();

  // 1.-3. b; F, u0 and the cotangents of u0, F and b
  T b[2];
  back_sub<T, KW>(tri, w, piv, linv, live, r, b);
  const T kdiag = agp::kernel_map<T>(MAP, T(0)) + (nugget_self ? nug : T(0));
  const T eps8 = T(8) * Eps<T>::value;
  const T Fraw = kdiag - group_sum<LPW>(fma(cc[1], b[1], cc[0] * b[0]));
  const T F = Fraw >= eps8 * kdiag ? Fraw : eps8 * kdiag;
  const T u0 = T(1) / sqrt(F);
  const T u0_bar = gd - group_sum<LPW>(fma(gr[1], b[1], gr[0] * b[0]));
  const T F_bar = T(-0.5) * u0 * u0 * u0 * u0_bar;
  T bb[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) bb[q] = -u0 * gr[q] - cc[q] * F_bar;

  // 4. Sbbar = L^-T (L^-1 bbar), deflated coordinates 0
  T y[2], sb[2];
  fwd_sub<T, KW>(tri, bb, piv, linv, live, r, y);
  back_sub<T, KW>(tri, y, piv, linv, live, r, sb);

  // 5. the nugget partial; 6. knibar
  bool vi[2];
  T kb[2];
  T p = T(0);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
    vi[q] = (vm >> i) & 1ull;
    if (vi[q]) p = fma(sb[q], b[q], p);
    kb[q] = vi[q] ? sb[q] - b[q] * F_bar : T(0);
  }
  p = group_sum<LPW>(p);
  if (a.nbar != nullptr && active && r == 0)
    a.nbar[n0 + wb] = -p + (nugget_self ? F_bar : T(0));

  // 7. each pair's term c_ij = 4 g'(r^2) Gs_ij on the lane of row i > j, and
  // the border's c_ik = 4 g'(r^2) knibar_i / 2
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
    vb[i] = b[q];
    vs[i] = sb[q];
  }
  __syncwarp();
  T ck[2];
  pair_r2<T, KW>(xs, D, k, r, rows, ck);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
#pragma unroll
    for (int c0 = 0; c0 < LPW * (q + 1); c0 += V) {
      T bv[V], sv[V];
      lds16(vb + c0, bv);
      lds16(vs + c0, sv);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int c = c0 + u;
        const bool on = vi[q] && ((vm >> c) & 1ull) && c < i;
        const T gs = T(-0.5) * (sb[q] * bv[u] + sv[u] * b[q]);
        rows[q][c] = on ? T(4) * agp::kernel_map_dr2<T>(MAP, rows[q][c]) * gs : T(0);
      }
    }
    ck[q] = vi[q] ? T(4) * agp::kernel_map_dr2<T>(MAP, ck[q]) * (T(0.5) * kb[q]) : T(0);
  }
  const int base[2] = {r * (r + 1) / 2, (r + LPW) * (r + LPW + 1) / 2};
  for (int d = 0; d < D; ++d) {
    T* const xd = xs + d * XP;
    T xi[2], acc[2], vk[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      xi[q] = xd[r + LPW * q];
      acc[q] = T(0);
    }
    const T xk = xd[k];
#pragma unroll
    for (int c0 = 0; c0 < KW; c0 += V) {
      T v[V];
      lds16(xd + c0, v);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int c = c0 + u;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (c < LPW * (q + 1) && c < r + LPW * q) {
            const T t = rows[q][c] * (xi[q] - v[u]);
            acc[q] += t;
            tri[base[q] + c] = t;
          }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      vk[q] = ck[q] * (xi[q] - xk);
      acc[q] += vk[q];
    }
    const T xbk = -group_sum<LPW>(vk[0] + vk[1]);
    __syncwarp();
    // slot i's side of the pairs (t, i), t > i: column i of the triangle
    T col[2] = {T(0), T(0)};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = r + LPW * q;
      int at = (i + 1) * (i + 2) / 2 + i;
      for (int t = i + 1; t < k; ++t) {
        col[q] += tri[at];
        at += t + 1;
      }
    }
    __syncwarp();  // every lane has read the triangle and this coordinate row
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = r + LPW * q;
      if (i < k) xd[i] = acc[q] - col[q];
    }
    if (r == 0) xd[k] = xbk;
  }
  __syncthreads();
  stage_out<T, WB, XP, NT>(a.xbar, a.eb, n0, nw, smem, sw, tid);
}

template <typename T, int KW, int MAP>
cudaError_t launch(const BwdArgs<T>& a, cudaStream_t s) {
  using S = Shape<T, KW>;
  const size_t bytes = (size_t)S::WB * window_values<T, KW>(a.D) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(vecchia_band_bwd_kernel<T, KW, MAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.N + S::WB - 1) / S::WB);
  vecchia_band_bwd_kernel<T, KW, MAP><<<blocks, 32 * S::WARPS, bytes, s>>>(a);
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
  const BwdArgs<T> a{static_cast<const T*>(xw),    make_entries(sxn, sxd, sxj, D, k + 1),
                     static_cast<const T*>(valid), make_entries(svn, 0, svj, 1, k),
                     static_cast<const T*>(nugget), nugget_self,
                     static_cast<const T*>(gbar),  make_entries(sgn, 0, sgj, 1, k + 1),
                     static_cast<T*>(xbar),        make_entries(sbn, sbd, sbj, D, k + 1),
                     static_cast<T*>(nbar),        N, k, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(k, [&](auto kw) {
    return by_map(kmap, [&](auto m) {
      return launch<T, decltype(kw)::value, decltype(m)::value>(a, s);
    });
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
