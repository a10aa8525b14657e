// Vecchia band rows from prebuilt masked Grams, one window to a team of four
// threads.
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
// the solves, not the last pivot of the bordered (k+1) factor of
// vecchia_band.cu, which rounds differently.  Any B (the ragged last block
// is masked), 1 <= k <= 64, f32 or f64 computed in the input type; Kw, kni
// and kdiag through strides, only Kw's lower triangle read; out (B, k+1)
// row-major.
//
// What bounds it on the H100: bytes.  At k = 32 a window reads the triangle
// (528 values), kni and kdiag (2.2 KB in f32) and writes 132 bytes, against
// about 7e3 FMAs (the factor's k^3/6, two substitutions of k^2/2): about
// 3 FMAs a byte, where the card's f32 units need 20 before they bind.
//
// Design: that of vecchia_band.cu (vecchia_window.cuh's team of TEAM = 4
// lanes a window, 8 windows a warp, one warp a block, a window's values in
// dynamic shared memory in the [entry][window] layout), so that the
// triangle's column dots split over the team.  The triangle is read from
// global memory once, in place of the Gram that vecchia_band.cu computes,
// and factored up-looking in place: row i's Kw entries are solved against
// rows j < i four columns at a time.  Per window: the triangle, the column
// scales, kni and b (k(k+1)/2 + 3k values: 18 KB at k = 64 in f64, 145 KB a
// block, inside the 227 KB a block may have).

#include <cuda_runtime.h>

#include "vecchia_window.cuh"

namespace {

using namespace agp::vecchia;

inline long long per_window(int k) { return (long long)k * (k + 1) / 2 + 3LL * k; }

template <typename T>
struct RowsArgs {
  const T* kw;
  long long skn, ski, skj;
  const T* kni;
  long long scn, sct;
  const T* kdiag;
  long long sdn;
  T* out;
  int B, k;
};

template <typename T>
__global__ void __launch_bounds__(32) band_rows_kernel(const RowsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k;
  const int lane = threadIdx.x % TEAM;
  const int w = threadIdx.x / TEAM;
  const long long n0 = (long long)blockIdx.x * W + w;
  const bool active = n0 < a.B;
  const long long n = active ? n0 : a.B - 1;

  // entry e of this team's window is at [e * W]
  T* const Lt = reinterpret_cast<T*>(smem_raw) + w;  // rows of L, row i from i(i+1)/2
  T* const cs = Lt + (long long)k * (k + 1) / 2 * W;  // 1 / pivot, 0 where deflated
  T* const c = cs + k * W;                              // kni
  T* const v = c + k * W;                               // w, then b in place

  const T* const kwn = a.kw + n * a.skn;
  for (int i = 0; i < k; ++i)
    for (int j = lane; j <= i; j += TEAM) Lt[(i * (i + 1) / 2 + j) * W] = kwn[i * a.ski + j * a.skj];
  for (int t = lane; t < k; t += TEAM) c[t * W] = a.kni[n * a.scn + t * a.sct];
  const T kd = a.kdiag[n * a.sdn];
  __syncwarp();

  // the masked-column Cholesky, up-looking: row i of L = L_{<i}^-1 Kw[i][:i]
  const T eps8 = T(8) * Eps<T>::value;
  for (int i = 0; i < k; ++i) {
    T* const row = Lt + i * (i + 1) / 2 * W;
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
      __syncwarp();  // every lane has read the entries it overwrites
      row[(j + lane) * W] = lane == 0 ? l0 : lane == 1 ? l1 : lane == 2 ? l2 : l3;
      __syncwarp();
    }
    for (; j < i; ++j) {
      const T x = row[j * W] - team_dot(row, Lt + j * (j + 1) / 2 * W, j, lane);
      __syncwarp();
      if (lane == 0) row[j * W] = x * cs[j * W];
      __syncwarp();
    }
    // the pivot, floored relative to Kw's own diagonal entry
    const T aii = row[i * W];
    const T d_raw = aii - team_dot(row, row, i, lane);
    const T fl = eps8 * fabs(aii);
    const T sq = sqrt(d_raw >= fl ? d_raw : fl);
    __syncwarp();
    if (lane == 0) {
      row[i * W] = sq;
      cs[i * W] = d_raw >= fl ? T(1) / sq : T(0);
    }
    __syncwarp();
  }

  // w = L^-1 kni, then b = L^-T w in place; dead coordinates are 0
  for (int i = 0; i < k; ++i) {
    const T* const row = Lt + i * (i + 1) / 2 * W;
    const T s = team_dot(row, v, i, lane);
    if (lane == 0) v[i * W] = cs[i * W] != T(0) ? (c[i * W] - s) / row[i * W] : T(0);
    __syncwarp();
  }
  for (int i = k - 1; i >= 0; --i) {
    // column i of L below the diagonal: L[t][i] at t(t+1)/2 + i
    T s = T(0);
    for (int t = i + 1 + lane; t < k; t += TEAM) s = fma(Lt[(t * (t + 1) / 2 + i) * W], v[t * W], s);
    s = team_sum(s);
    const T wi = v[i * W];
    __syncwarp();
    if (lane == 0)
      v[i * W] = cs[i * W] != T(0) ? (wi - s) / Lt[(i * (i + 1) / 2 + i) * W] : T(0);
    __syncwarp();
  }

  // F = kdiag - kni.b, floored; the band row
  const T F_raw = kd - team_dot(c, v, k, lane);
  const T fF = eps8 * fabs(kd);
  const T u0 = T(1) / sqrt(F_raw > fF ? F_raw : fF);
  if (!active) return;
  T* const o = a.out + n * (k + 1);
  for (int t = lane; t < k; t += TEAM) o[t] = -v[t * W] * u0;
  if (lane == 0) o[k] = u0;
}

template <typename T>
int band_rows(const void* kw, long long skn, long long ski, long long skj, const void* kni,
              long long scn, long long sct, const void* kdiag, long long sdn, void* out, int B,
              int k, void* stream) {
  if (B < 1 || k < 1 || k > 64) return cudaErrorInvalidValue;
  const RowsArgs<T> a{static_cast<const T*>(kw), skn, ski, skj, static_cast<const T*>(kni),
                      scn, sct, static_cast<const T*>(kdiag), sdn, static_cast<T*>(out), B, k};
  const size_t bytes = (size_t)(per_window(k) * W * (long long)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(band_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((B + W - 1) / W);
  band_rows_kernel<T><<<blocks, 32, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

// This file builds the f32 entry point; band_rows_f64.cu includes it with the
// two macros set for f64, so that the two compile in parallel.
#ifndef AGP_BAND_ROWS_T
#define AGP_BAND_ROWS_T float
#define AGP_BAND_ROWS_ENTRY agp_band_rows_f32
#endif

extern "C" {

// Kw (n, i, j) at kw[n*skn + i*ski + j*skj] (its lower triangle read), kni
// (n, t) at kni[n*scn + t*sct], kdiag (n) at kdiag[n*sdn], out (B, k+1)
// row-major.  Returns a cudaError_t.
int AGP_BAND_ROWS_ENTRY(const void* kw, long long skn, long long ski, long long skj,
                        const void* kni, long long scn, long long sct, const void* kdiag,
                        long long sdn, void* out, int B, int k, void* stream) {
  return band_rows<AGP_BAND_ROWS_T>(kw, skn, ski, skj, kni, scn, sct, kdiag, sdn, out, B, k,
                                    stream);
}

}  // extern "C"
