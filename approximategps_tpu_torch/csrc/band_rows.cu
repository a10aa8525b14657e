// Vecchia band rows from prebuilt masked Grams, one window to the lanes of a
// warp, the window's triangle in their registers.
//
// Replaces approximategps_tpu/ops/batched_chol.py::batched_chol_solve_band
// (_band_forward, _kernel): for window n, given Kw (k x k, symmetric, its
// masked slots already identity rows with zero coupling), kni (k) and kdiag,
//   1. the masked-column Cholesky of Kw: each pivot floored at
//      8 eps |Kw_jj| and a floored pivot deflates its column (off-diagonal
//      entries 0, the coordinate "dead");
//   2. b = Kw^-1 kni by forward and back substitution, dead coordinates 0;
//   3. F = kdiag - kni.b, floored at 8 eps |kdiag|;
//   4. out[n] = [-b F^-1/2, F^-1/2].
// This is the masked math of ops/batched_chol.py (_masked_chol_factor,
// _masked_spd_solve, _band_from_solve), entry for entry: the factor is the
// k x k one with floors against Kw's own diagonal and F a dot product after
// the solves.  Any B (the ragged last block is masked), 1 <= k <= 64, f32 or
// f64 computed in the input type; Kw, kni and kdiag through strides, only
// Kw's lower triangle used; out (B, k+1) row-major.
//
// What bounds it on the H100: bytes.  At k = 32 a window reads the triangle
// (528 values), kni and kdiag (2.2 KB in f32) and writes 132 bytes, against
// about 7e3 FMAs: about 3 FMAs a byte, where the card's f32 units need 20
// before they bind.  What held the earlier team-of-four kernel at 12x its
// bound was latency: eight windows a one-warp block, each window's triangle
// in shared memory (11 warps an SM at k = 32 in f32, 3 at k = 64), a chain of
// four-lane shuffle sums and two __syncwarp a group of four columns, and
// loads that touched eight windows 4 KB apart in one instruction.
//
// Design (the shape, the factor and its helpers are vecchia_window.cuh's,
// shared with the Vecchia band kernel and its pullback).  The window is
// padded to a template width KW (8, 16, 32 or 64;
// rows k..KW-1 are identity rows with zero coupling, which change no entry
// of rows < k) and owned by LPW = KW / 2 lanes: lane r holds rows r and
// r + LPW, in registers whose index the unrolled loops fix at compile time
// (row r's entries below LPW only), and a warp takes 64 / KW windows.  Two
// rows a lane, one short and one long, cut the work a window costs the warp:
// a column's updates run over the short row's columns and the long one's,
// 3/4 of what one row a lane over all KW lanes would issue, and the column's
// pivot, shuffles and barrier serve two windows at KW = 32.
//   - Load: a contiguous window (the layout of vecchia._window_rows) is read
//     as 16-byte vectors across its lanes (one warp instruction covers 512
//     consecutive bytes; vectors wholly above the diagonal are skipped) into
//     a staging tile in shared memory, from which each lane takes its rows;
//     any other stride reads the lower triangle entry by entry.
//   - Factor, right-looking: for column j the pivot's lane floors it and
//     broadcasts 1/pivot (0 where deflated) with one shuffle; each lane scales
//     its own entries of column j, publishes them in a double-buffered column
//     of shared memory (one __syncwarp a column), and updates its rows'
//     trailing entries from that column read back as 16-byte broadcasts.
//     The forward substitution rides along: w_j is published in the column's
//     slot j, and each lane adds L_ij w_j to its rows' running sums.
//   - Back substitution: the lanes write L once to the staging tile and read
//     it back by columns, so lane i holds column i of L; b_t goes out by one
//     shuffle a step and each lane adds L_ti b_t to its own sum.
//   - F: a shuffle sum of kni_i b_i over the window's lanes.
// The masked math's decisions are the same (the pivot against 8 eps |Kw_jj|,
// deflation, dead coordinates 0 in both substitutions, F's floor); the sums
// are taken in another order (right-looking updates in place of the plain
// version's column dots).  The factor's column is scaled by the pivot's
// reciprocal, and both substitutions divide by the pivot as the plain
// version does (a quotient from the reciprocal and one correction): with a
// product by the reciprocal there, chip_smoke.py phase 10's f32 windows at
// k = 32 (ill-conditioned, many pivots deflated) came out 5.2e-5 of the
// largest entry from the f32 plain version, with the quotients 8e-9; with
// a correctly rounded sqrt and division (branches and calls) in their place,
// 10^6 windows took 4.5 ms against about 3.4 (PERF.md section 6).  The work
// is instructions more than bytes: a lane's share of a window at k = 32 is
// some 500 FMAs over the columns of its row (the triangle's upper part
// included, for indices fixed at compile time), two shuffles, a sqrt and
// its reciprocal a column, and one quotient a column in each substitution.
//
// Occupancy (ptxas -v in the build log): at KW = 32 in f32 a lane holds 48
// entries of rows and then 48 of columns, and __launch_bounds__ asks for six
// four-warp blocks an SM (at most 85 registers): 24 warps an SM, 48 windows,
// bound by registers and shared memory alike (4.4 KB a window: the staging
// tile and two columns; 215 KB for 48).  At KW = 64 (96 registers of rows in
// f32, 192 in f64) shared memory bounds it: 17 KB a window in f32 (13
// windows an SM), 34 KB in f64 (6).

#include <cuda_runtime.h>

#include <cstdint>

#include "vecchia_window.cuh"

namespace {

using namespace agp::window;

template <typename T>
struct RowsArgs {
  const T* kw;
  long long skn, ski, skj;
  const T* kni;
  long long scn, sct;
  const T* kdiag;
  long long sdn;
  T* out;
  int B, k, vec;
};

template <typename T, int KW>
__global__ void __launch_bounds__(32 * Shape<T, KW>::WARPS, Shape<T, KW>::MIN_BLOCKS)
    band_rows_kernel(const RowsArgs<T> a) {
  using S = Shape<T, KW>;
  constexpr int LPW = S::LPW, RPL = S::RPL, LD = S::LD, V = S::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPW, r = lane % LPW;
  const long long n0 = ((long long)blockIdx.x * S::WARPS + warp) * S::G + grp;
  const bool active = n0 < a.B;
  const long long n = active ? n0 : a.B - 1;
  const int k = a.k;
  T* const st = reinterpret_cast<T*>(smem_raw) + (long long)(warp * S::G + grp) * S::SW;
  T* const cb = st + KW * LD;  // two columns of KW

  // stage the window's lower triangle
  const T* const kwn = a.kw + n * a.skn;
  if (a.vec) {
    // vector q starts at entry (i, j) = divmod(q V, k); the lane's next one
    // is LPW V entries on: no division in the loop
    const int nv = k * k / V, step_i = LPW * V / k, step_j = LPW * V - step_i * k;
    int i = r * V / k, j = r * V - i * k;
    for (int q = r; q < nv; q += LPW) {
      if (j + V <= k ? j <= i : true) {  // not wholly above the diagonal
        T v[V];
        load16(kwn + q * V, v);
        int ii = i, jj = j;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          st[ii * LD + jj] = v[u];
          if (++jj == k) jj = 0, ++ii;
        }
      }
      i += step_i;
      j += step_j;
      if (j >= k) j -= k, ++i;
    }
  } else {
    for (int i = 0; i < k; ++i)
      for (int j = r; j <= i; j += LPW) st[i * LD + j] = kwn[i * a.ski + j * a.skj];
  }
  __syncwarp();

  // this lane's rows i = r + LPW q: entries c <= i (c < LPW (q + 1)); rows
  // k..KW-1 are identity rows
  T rows[RPL][KW], dg[RPL], cc[RPL], w[RPL], piv[RPL], linv[RPL];
  bool live[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int i = r + LPW * q;
#pragma unroll
    for (int c = 0; c < LPW * (q + 1); ++c)
      rows[q][c] = i < k ? (c <= i ? st[i * LD + c] : T(0)) : (c == i ? T(1) : T(0));
    dg[q] = i < k ? st[i * LD + i] : T(1);
    cc[q] = i < k ? a.kni[n * a.scn + i * a.sct] : T(0);
  }

  // the masked-column Cholesky, right-looking, with w = L^-1 kni alongside
  T unused = T(0);
  factor_rows<T, KW>(rows, dg, cc, cb, r, w, piv, linv, live, unused);

  // L to the staging tile, read back by columns: lc[q][t] = L[t][i] for t > i
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int i = r + LPW * q;
#pragma unroll
    for (int c = 0; c < LPW * (q + 1); ++c)
      if (c <= i) st[i * LD + c] = rows[q][c];
  }
  __syncwarp();
  T lc[RPL][KW];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int i = r + LPW * q;
#pragma unroll
    for (int t = LPW * q; t < KW; ++t) lc[q][t] = t > i ? st[t * LD + i] : T(0);
  }

  // b = L^-T w; dead coordinates are 0
  T b[RPL], bacc[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) b[q] = bacc[q] = T(0);
#pragma unroll
  for (int t = KW - 1; t >= 0; --t) {
    const int qt = t / LPW, rt = t % LPW;
    const T bt_own = live[qt] ? quotient(w[qt] - bacc[qt], piv[qt], linv[qt]) : T(0);
    const T bt = __shfl_sync(kFull, bt_own, rt, LPW);
    if (r == rt) b[qt] = bt;
#pragma unroll
    for (int q = 0; q < RPL; ++q)
      if (t >= LPW * q) bacc[q] = fma(lc[q][t], bt, bacc[q]);
  }

  // F = kdiag - kni.b, floored; the band row
  T s = T(0);
#pragma unroll
  for (int q = 0; q < RPL; ++q) s = fma(cc[q], b[q], s);
  s = group_sum<LPW>(s);
  const T kd = a.kdiag[n * a.sdn];
  const T F_raw = kd - s;
  const T fF = T(8) * Eps<T>::value * fabs(kd);
  const T u0 = T(1) / sqrt(F_raw > fF ? F_raw : fF);
  if (!active) return;
  T* const o = a.out + n * (k + 1);
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int i = r + LPW * q;
    if (i < k) o[i] = -b[q] * u0;
  }
  if (r == 0) o[k] = u0;
}

template <typename T, int KW>
cudaError_t launch(const RowsArgs<T>& a, cudaStream_t stream) {
  using S = Shape<T, KW>;
  const size_t bytes = (size_t)S::WARPS * S::G * S::SW * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(band_rows_kernel<T, KW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long per_block = (long long)S::WARPS * S::G;
  const unsigned blocks = (unsigned)((a.B + per_block - 1) / per_block);
  band_rows_kernel<T, KW><<<blocks, 32 * S::WARPS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int band_rows(const void* kw, long long skn, long long ski, long long skj, const void* kni,
              long long scn, long long sct, const void* kdiag, long long sdn, void* out, int B,
              int k, void* stream) {
  if (B < 1 || k < 1 || k > 64) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  // a contiguous window, 16-byte aligned, whose k^2 values are whole vectors
  const int vec = skj == 1 && ski == k && skn == (long long)k * k && (k * k) % V == 0 &&
                  reinterpret_cast<std::uintptr_t>(kw) % 16 == 0;
  const RowsArgs<T> a{static_cast<const T*>(kw), skn, ski, skj, static_cast<const T*>(kni),
                      scn, sct, static_cast<const T*>(kdiag), sdn, static_cast<T*>(out), B, k,
                      vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return launch<T, 8>(a, s);
  if (k <= 16) return launch<T, 16>(a, s);
  if (k <= 32) return launch<T, 32>(a, s);
  return launch<T, 64>(a, s);
}

}  // namespace

// This file builds the f32 entry point; band_rows_f64.cu includes it with the
// two macros set for f64, so that the two compile in parallel.
#ifndef AGP_BAND_ROWS_T
#define AGP_BAND_ROWS_T float
#define AGP_BAND_ROWS_ENTRY agp_band_rows_f32
#endif

extern "C" {

// Kw (n, i, j) at kw[n*skn + i*ski + j*skj] (its lower triangle used), kni
// (n, t) at kni[n*scn + t*sct], kdiag (n) at kdiag[n*sdn], out (B, k+1)
// row-major.  Returns a cudaError_t.
int AGP_BAND_ROWS_ENTRY(const void* kw, long long skn, long long ski, long long skj,
                        const void* kni, long long scn, long long sct, const void* kdiag,
                        long long sdn, void* out, int B, int k, void* stream) {
  return band_rows<AGP_BAND_ROWS_T>(kw, skn, ski, skj, kni, scn, sct, kdiag, sdn, out, B, k,
                                    stream);
}

}  // extern "C"
