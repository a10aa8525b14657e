// What the warp-per-window kernels share: row 6 (band_rows.cu), the Vecchia
// band kernel (vecchia_band.cu) and its pullback (vecchia_band_bwd.cu).
//
// A window of k <= KW rows is padded to a template width KW (8, 16, 32 or
// 64; rows k..KW-1 are identity rows with zero coupling, which change no
// entry of rows < k) and owned by LPW = KW / 2 lanes of a warp: lane r holds
// rows r and r + LPW in registers whose index the unrolled loops fix at
// compile time (row r's entries below LPW only), and a warp takes 64 / KW
// windows.  factor_rows is the masked-column Cholesky of those rows,
// right-looking, with the forward substitution w = L^-1 c alongside; the
// rest of this header serves the two Vecchia kernels, which build each
// window's Gram from its points in the same registers:
//   - stage_in / stage_out: a block's windows move between device memory and
//     shared memory through any strides, coalesced (16-byte vectors where
//     each window is contiguous; consecutive threads on consecutive windows
//     otherwise, which coalesces where windows are the fastest dimension);
//   - gram_rows: the masked Gram of a window's slots in the lanes' registers
//     from the coordinates staged in shared memory, and its border (the
//     conditioned point's column) as a vector;
//   - back_sub / fwd_sub: triangular solves with L in a packed triangle of
//     shared memory, by columns or by rows, dividing by the pivot.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "kernel_maps.cuh"

namespace agp {
namespace window {

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

template <typename T, int KW>
struct Shape {
  static constexpr int LPW = KW / 2;             // lanes a window: two rows a lane
  static constexpr int G = 32 / LPW;             // windows a warp
  static constexpr int RPL = KW / LPW;           // rows a lane
  static constexpr int WARPS = KW <= 32 ? 4 : 2;  // warps a block
  static constexpr int WB = WARPS * G;           // windows a block
  static constexpr int LD = KW + 1;              // row 6's staging row pitch (odd: no bank conflicts)
  static constexpr int SW = KW * (KW + 3);       // row 6's shared values a window: staging + 2 columns
  static constexpr int V = 16 / sizeof(T);       // values a 16-byte vector
  static constexpr int XP = KW + V;              // a staged coordinate row: slots 0..KW, whole vectors
  static constexpr int TRI = KW * (KW + 1) / 2;  // a packed lower triangle
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 && KW <= 32 ? 6 : 1;
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void lds16(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void lds16(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}

// sqrt(x) and about 1 / sqrt(x): in f32 from the hardware's reciprocal square
// root, one Newton step and one correction of the root (a few FMAs in place
// of the branches and calls of a correctly rounded sqrt and division); in
// f64 correctly rounded
__device__ __forceinline__ void sqrt_and_inv(float x, float& sq, float& inv) {
  float r = rsqrtf(x);
  r = r * fmaf(-0.5f * x * r, r, 1.5f);
  sq = x * r;
  sq = fmaf(fmaf(-sq, sq, x), 0.5f * r, sq);
  inv = r;
}
__device__ __forceinline__ void sqrt_and_inv(double x, double& sq, double& inv) {
  sq = sqrt(x);
  inv = 1.0 / sq;
}

// num / d from inv, about 1 / d, and one correction of the quotient: the
// quotient a division gives, bar the last bit at times
template <typename T>
__device__ __forceinline__ T quotient(T num, T d, T inv) {
  const T q = num * inv;
  return fma(fma(-q, d, num), inv, q);
}

// The sum of s over the LPW lanes of a window, the same bits in each of them
// (each step adds two lanes' values in both of them, and addition commutes).
template <int LPW, typename T>
__device__ __forceinline__ T group_sum(T s) {
#pragma unroll
  for (int off = LPW / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off, LPW);
  return s;
}

// The masked-column Cholesky of the lanes' rows, right-looking, with
// w = L^-1 cc alongside.  On entry rows[q] holds row i = r + LPW q of the
// padded window (entries c <= i), dg[q] its original diagonal, cc[q] entry i
// of the right-hand side.  Column j: the pivot's lane floors it against
// 8 eps |dg| and broadcasts 1/pivot (0 where deflated) with one shuffle;
// each lane scales its own entries of column j, publishes them in a
// double-buffered column cb (2 KW values; one __syncwarp a column) and
// updates its rows' trailing entries from that column read back as 16-byte
// broadcasts.  w_j is published in the column's slot j and each lane adds
// L_ij w_j to its rows' running sums.  On return rows[q][c] is L_ic (c < i)
// and the pivot (c = i); w, piv (the pivots), linv (about their
// reciprocals) and live (not deflated) are each lane's rows'; fsum has had
// every w_j^2 subtracted, in the order of j, by fused multiply-adds.
template <typename T, int KW>
__device__ __forceinline__ void factor_rows(T (&rows)[2][KW], const T (&dg)[2], const T (&cc)[2],
                                            T* cb, int r, T (&w)[2], T (&piv)[2], T (&linv)[2],
                                            bool (&live)[2], T& fsum) {
  using S = Shape<T, KW>;
  constexpr int LPW = S::LPW, RPL = S::RPL, V = S::V;
  T acc[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    acc[q] = T(0);
    w[q] = piv[q] = linv[q] = T(0);
    live[q] = false;
  }
  const T eps8 = T(8) * Eps<T>::value;
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int qj = j / LPW, rj = j % LPW;
    T* const col = cb + (j & 1) * KW;
    // the pivot (meaningful on lane rj), floored against the original diagonal
    const T d_raw = rows[qj][j];
    const T fl = eps8 * fabs(dg[qj]);
    const bool lv = d_raw >= fl;
    T sq, inv;
    sqrt_and_inv(lv ? d_raw : fl, sq, inv);
    const T scale = __shfl_sync(kFull, lv ? inv : T(0), rj, LPW);
    const T wj_own = lv ? quotient(cc[qj] - acc[qj], sq, inv) : T(0);
    T l[RPL];
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int i = r + LPW * q;
      l[q] = T(0);
      if (j < LPW * (q + 1)) {
        if (i > j) {
          l[q] = rows[q][j] * scale;
          rows[q][j] = l[q];
          col[i] = l[q];
        } else if (i == j) {
          rows[q][j] = sq;
          piv[q] = sq;
          linv[q] = inv;
          live[q] = lv;
          w[q] = wj_own;
          col[j] = wj_own;
        }
      }
    }
    __syncwarp();
    const T wj = col[j];
    fsum = fma(-wj, wj, fsum);
#pragma unroll
    for (int q = 0; q < RPL; ++q) acc[q] = fma(l[q], wj, acc[q]);
    // the trailing rows: rows[q][c] -= L_ij L_cj for c > j
#pragma unroll
    for (int c0 = (j + 1) / V * V; c0 < KW; c0 += V) {
      T v[V];
      lds16(col + c0, v);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int c = c0 + u;
        if (c > j) {
#pragma unroll
          for (int q = 0; q < RPL; ++q)
            if (c < LPW * (q + 1)) rows[q][c] = fma(-l[q], v[u], rows[q][c]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The Vecchia kernels: windows of points in, band rows (or their cotangent)
// out.  Window n's slot t < k is neighbour t, slot k the conditioned point.
// ---------------------------------------------------------------------------

// n / d by one multiply and a shift, exact for n, d < 2^16 (m = ceil(2^32 / d),
// whose excess m d - 2^32 < d keeps n m / 2^32 below the next integer); the
// host makes m.  Every index a block divides is below 2^16 (at most
// WB (k+1) D <= 2304 entries a block).
struct Div {
  unsigned d;
  unsigned long long m;
};
inline Div make_div(unsigned d) { return {d, ((1ull << 32) + d - 1) / d}; }
__device__ __forceinline__ int udiv(int n, const Div& v) {
  return (int)(((unsigned long long)(unsigned)n * v.m) >> 32);
}

// One tensor of a block's windows: entry (n, d, j), d < D, j < J, at
// base[n sn + d sd + j sj], staged at window w's row d, slot j of shared
// memory.  contig: each window's entries lie in order (j, d) as one block of
// J D values, window after window (sd is not read when D = 1).
struct Entries {
  long long sn, sd, sj;
  int D, J;
  Div dE, dD, dJ;  // by J D, by D and by J
  int contig;
};
inline Entries make_entries(long long sn, long long sd, long long sj, int D, int J) {
  const int contig = (D == 1 || sd == 1) && sj == D && sn == (long long)J * D;
  return {sn, sd, sj, D, J, make_div(J * D), make_div(D), make_div(J), contig};
}

// Stage the entries of the block's nw windows n0.. into shared memory:
// entry (d, j) of window w to s[w * sw + d * XP + j].  Every thread of the
// block takes part; the caller synchronises the block afterwards.
template <typename T, int WB, int XP, int NT>
__device__ __forceinline__ void stage_in(const T* base, const Entries& e, long long n0, int nw,
                                         T* s, int sw, int tid) {
  const int E = e.D * e.J;
  if (e.contig) {
    // the block's windows are nw E values in a row
    const T* const src = base + n0 * E;
    const int total = nw * E;
    auto put = [&](int L, T v) {
      const int w = udiv(L, e.dE), rem = L - w * E;
      const int j = udiv(rem, e.dD), d = rem - j * e.D;
      s[w * sw + d * XP + j] = v;
    };
    int done = 0;
    if ((reinterpret_cast<std::uintptr_t>(src) & 15) == 0) {
      constexpr int V = 16 / sizeof(T);
      const int nv = total / V;
      for (int q = tid; q < nv; q += NT) {
        T v[V];
        load16(src + (long long)q * V, v);
#pragma unroll
        for (int u = 0; u < V; ++u) put(q * V + u, v[u]);
      }
      done = nv * V;
    }
    for (int L = done + tid; L < total; L += NT) put(L, __ldg(src + L));
  } else {
    // consecutive threads on consecutive windows
    for (int L = tid; L < WB * E; L += NT) {
      const int w = L % WB, rem = L / WB;
      if (w < nw) {
        const int d = udiv(rem, e.dJ), j = rem - d * e.J;
        s[w * sw + d * XP + j] = __ldg(base + (n0 + w) * e.sn + d * e.sd + j * e.sj);
      }
    }
  }
}

// The reverse of stage_in: window w's row d, slot j to entry (n0 + w, d, j).
template <typename T, int WB, int XP, int NT>
__device__ __forceinline__ void stage_out(T* base, const Entries& e, long long n0, int nw,
                                          const T* s, int sw, int tid) {
  const int E = e.D * e.J;
  if (e.contig) {
    T* const dst = base + n0 * E;
    for (int L = tid; L < nw * E; L += NT) {
      const int w = udiv(L, e.dE), rem = L - w * E;
      const int j = udiv(rem, e.dD), d = rem - j * e.D;
      dst[L] = s[w * sw + d * XP + j];
    }
  } else {
    for (int L = tid; L < WB * E; L += NT) {
      const int w = L % WB, rem = L / WB;
      if (w < nw) {
        const int d = udiv(rem, e.dJ), j = rem - d * e.J;
        base[(n0 + w) * e.sn + d * e.sd + j * e.sj] = s[w * sw + d * XP + j];
      }
    }
  }
}

// Zero a window's coordinate slots past k (every slot of a window past the
// ragged end), so that its padded rows read finite coordinates; the window's
// own lanes, before the block's barrier (stage_in writes none of these).
template <typename T, int KW>
__device__ __forceinline__ void zero_padding(T* xs, int D, int kp1, bool active, int r) {
  constexpr int LPW = KW / 2, XP = Shape<T, KW>::XP;
  for (int L = r; L < D * XP; L += LPW)
    if (!active || L % XP >= kp1) xs[L] = T(0);
}

// The mask bits of a window (bit t: neighbour t valid) from its k staged
// values m, the same in every lane of the window.
template <typename T, int KW>
__device__ __forceinline__ unsigned long long window_mask(const T* m, int k, int r, int grp) {
  constexpr int LPW = KW / 2;
  unsigned long long vm = 0;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int t = r + LPW * q;
    const unsigned bits = __ballot_sync(kFull, t < k && m[t] != T(0));
    const unsigned mine = LPW == 32 ? bits : (bits >> (grp * LPW)) & ((1u << LPW) - 1u);
    vm |= (unsigned long long)mine << (LPW * q);
  }
  return vm;
}

// r^2 of the lanes' rows against every slot below KW (rows[q][c]) and
// against slot k (rk[q]), from exact coordinate differences: xs holds the
// window's coordinates, row d at xs + d * XP.
template <typename T, int KW>
__device__ __forceinline__ void pair_r2(const T* xs, int D, int k, int r, T (&rows)[2][KW],
                                        T (&rk)[2]) {
  using S = Shape<T, KW>;
  constexpr int LPW = S::LPW, V = S::V, XP = S::XP;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int c = 0; c < LPW * (q + 1); ++c) rows[q][c] = T(0);
    rk[q] = T(0);
  }
  for (int d = 0; d < D; ++d) {
    const T* const xd = xs + d * XP;
    T xi[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) xi[q] = xd[r + LPW * q];
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
          if (c < LPW * (q + 1)) {
            const T dd = xi[q] - v[u];
            rows[q][c] = fma(dd, dd, rows[q][c]);
          }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const T dd = xi[q] - xk;
      rk[q] = fma(dd, dd, rk[q]);
    }
  }
}

// The masked Gram of the lanes' rows in their registers: rows[q][c], c <= i,
// the entries of row i = r + LPW q (g(r^2) where both slots are valid, 0
// where either is not; on the diagonal g(0) + nug for a valid slot and 1 for
// an invalid or padded one), dg[q] that diagonal, cc[q] the border entry
// g(r^2(x_i, x_k)) (0 for an invalid slot).
template <typename T, int KW, int MAP>
__device__ __forceinline__ void gram_rows(const T* xs, int D, int k, unsigned long long vm, T nug,
                                          int r, T (&rows)[2][KW], T (&dg)[2], T (&cc)[2]) {
  constexpr int LPW = KW / 2;
  pair_r2<T, KW>(xs, D, k, r, rows, cc);
  const T g0 = kernel_map<T>(MAP, T(0));
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
    const bool vi = (vm >> i) & 1ull;
#pragma unroll
    for (int c = 0; c < LPW * (q + 1); ++c) {
      const bool vc = (vm >> c) & 1ull;
      const T g = kernel_map<T>(MAP, rows[q][c]);
      rows[q][c] = c < i ? (vi && vc ? g : T(0)) : c == i ? (vi ? g0 + nug : T(1)) : T(0);
    }
    dg[q] = vi ? g0 + nug : T(1);
    cc[q] = vi ? kernel_map<T>(MAP, cc[q]) : T(0);
  }
}

// L's strictly lower entries from the lanes' rows to the packed triangle tri
// (L_ic at i (i + 1) / 2 + c).  The caller synchronises the warp before (the
// triangle may overlay the factor's columns) and after.
template <typename T, int KW>
__device__ __forceinline__ void store_tri(T* tri, const T (&rows)[2][KW], int r) {
  constexpr int LPW = KW / 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
    T* const row = tri + i * (i + 1) / 2;
#pragma unroll
    for (int c = 0; c < LPW * (q + 1); ++c)
      if (c < i) row[c] = rows[q][c];
  }
}

// x = L^-T y by columns of the packed triangle, dead coordinates 0: step t
// takes x_t = (y_t - sum_{i>t} L_it x_i) / L_tt on its lane and shuffles it
// out, and every lane adds L_ti x_t to its rows' sums.
template <typename T, int KW>
__device__ __forceinline__ void back_sub(const T* tri, const T (&y)[2], const T (&piv)[2],
                                         const T (&linv)[2], const bool (&live)[2], int r,
                                         T (&x)[2]) {
  constexpr int LPW = KW / 2;
  T acc[2] = {T(0), T(0)};
  x[0] = x[1] = T(0);
#pragma unroll
  for (int t = KW - 1; t >= 0; --t) {
    const int qt = t / LPW, rt = t % LPW;
    const T xt_own = live[qt] ? quotient(y[qt] - acc[qt], piv[qt], linv[qt]) : T(0);
    const T xt = __shfl_sync(kFull, xt_own, rt, LPW);
    if (r == rt) x[qt] = xt;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = r + LPW * q;
      if (t > LPW * q && t > i) acc[q] = fma(tri[t * (t + 1) / 2 + i], xt, acc[q]);
    }
  }
}

// x = L^-1 y by rows of the packed triangle, dead coordinates 0: step j
// takes x_j = (y_j - sum_{c<j} L_jc x_c) / L_jj on its lane and shuffles it
// out, and every lane adds L_ij x_j to its rows' sums.
template <typename T, int KW>
__device__ __forceinline__ void fwd_sub(const T* tri, const T (&y)[2], const T (&piv)[2],
                                        const T (&linv)[2], const bool (&live)[2], int r,
                                        T (&x)[2]) {
  constexpr int LPW = KW / 2;
  T acc[2] = {T(0), T(0)};
  x[0] = x[1] = T(0);
  const T* row[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = r + LPW * q;
    row[q] = tri + i * (i + 1) / 2;
  }
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int qj = j / LPW, rj = j % LPW;
    const T xj_own = live[qj] ? quotient(y[qj] - acc[qj], piv[qj], linv[qj]) : T(0);
    const T xj = __shfl_sync(kFull, xj_own, rj, LPW);
    if (r == rj) x[qj] = xj;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = r + LPW * q;
      if (j < LPW * (q + 1) - 1 && j < i) acc[q] = fma(row[q][j], xj, acc[q]);
    }
  }
}

// launch(m) with m a std::integral_constant of the runtime map id, so that
// the map is a template argument of the kernel
template <typename F>
cudaError_t by_map(int map, F&& launch) {
  switch (map) {
    case 0: return launch(std::integral_constant<int, 0>{});
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    default: return cudaErrorInvalidValue;
  }
}

// launch(kw) with kw a std::integral_constant of the template width for k
template <typename F>
cudaError_t by_width(int k, F&& launch) {
  if (k <= 8) return launch(std::integral_constant<int, 8>{});
  if (k <= 16) return launch(std::integral_constant<int, 16>{});
  if (k <= 32) return launch(std::integral_constant<int, 32>{});
  return launch(std::integral_constant<int, 64>{});
}

}  // namespace window
}  // namespace agp
