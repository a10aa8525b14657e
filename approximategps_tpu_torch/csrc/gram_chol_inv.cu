// (L, L^-1) factorizations in f64 for the SVGP posterior build and the
// streaming ELBO, in two forms that share one host loop (f32 takes
// gram_chol_inv_mma.cu's panel steps, for both forms).
//
// Gram-fused (row 1): replaces approximategps_tpu/ops/panel_chol.py::
// pallas_gram_chol_inv (_gram_chol_inv_kernel, _gram_panel, _chol_inv_rest,
// _fused_factor_inv):
//
//     K = sig2 * g(r2(Zs, Zs)) + jitter * I,   L = chol(K),   J = L^-1,
//
// with K never written whole to device memory.  sig2 and jitter are read
// from a two-element device array (coef), so that the caller need not bring
// a hyperparameter that lives on the card back to the host.
//
// Given matrix (row 4): replaces approximategps_tpu/ops/panel_chol.py::
// pallas_chol_inv (_chol_inv_kernel): L = chol(sym(A)), J = L^-1 for an SPD
// (M, M) matrix A.  Step (a) reads A's column panel, symmetrized on the fly
// as 0.5 (A[r, c] + A[c, r]), where row 1 generates the Gram panel; (b)-(d)
// are the same kernels.  Both forms give exact zeros above the diagonals of
// L and J.
//
// What bounds it on the H100: the factorization is a chain of M/P dependent
// panel steps (P = 64), so its time is the sum of each step's critical path,
// not its ~M^3 / 3 FMAs.  The TPU kernel relies on its grid running in
// order; CUDA blocks run in no order, so the host loop below launches, per
// panel k (columns c0 = kP .. c0 + P):
//   (a) panel_partial + panel_finish: the panel of K (the Gram generated from
//       Zs with exact broadcast differences summed over d in a fixed order,
//       or A's panel read) minus L[c0:, :c0] L[c0:c0+P, :c0]^T, written into
//       L's panel columns;
//   (b) diag_factor_inv: one block factors AND inverts the P x P diagonal
//       block (L_kk, X = L_kk^-1), which J's diagonal block receives;
//   (c) panel_trsm: L[c0+P:, panel] = C X^T;
//   (d) jrow_partial + jrow_finish: J[c0:c0+P, :c0] =
//       -X (L[c0:c0+P, :c0] J[:c0, :c0]).
// The products in (a) and (d) have few 64 x 64 output tiles but a depth of up
// to M, so each is split along its depth over about SPLIT_TARGET blocks that
// write partial tiles to a scratch buffer (in (d) already multiplied by -X);
// the finish kernels sum them in a fixed order, one element per thread (no
// atomics, so results repeat bitwise).  (b) runs the TPU kernel's one-loop
// factor-and-invert: per column c, one rank-1 update of the trailing block
// and one elementary row transform of X, each thread on its 4 x 4 share held
// in registers, one barrier a step.  The products are plain SIMT FMA tiles
// (4 x 4 outputs per thread, 16-deep shared-memory chunks, the next chunk's
// loads in flight during the current chunk's FMAs).  In f32 the products
// run on the tensor cores instead, one launch a panel step
// (gram_chol_inv_mma.cu); f64 keeps this loop.
//
// M need not be a multiple of P: the caller passes Mp = M rounded up, and
// rows/columns >= M carry an identity block with no coupling, so the leading
// M x M blocks of L and J are exactly the factors of K.

#include <cuda_runtime.h>

#include "kernel_maps.cuh"

namespace {

constexpr int P = 64;               // panel width; also every tile's edge
constexpr int TK = 16;              // depth of one shared-memory chunk
constexpr int NT = 256;             // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int LDS = P + 1;          // padded shared-memory row
constexpr int TILE = P * P;         // elements of one partial tile
constexpr int SPLIT_TARGET = 256;   // blocks a split product aims for (2 per SM)

// Partial tiles the scratch buffer must hold for Mp / P panels: at most
// max(ntiles, SPLIT_TARGET) for (a) and 2 SPLIT_TARGET + k for (d).
inline int scratch_tiles(int n_panels) { return 2 * SPLIT_TARGET + n_panels; }

// acc[i][j] += sum_{t < depth} A(r, t) * B(c, t), r = ty + 16 i, c = tx + 16 j,
// with A(r, t) = A[r * lda + t] and B(c, t) = B[c * ldb + t], or
// B[t * ldb + c] when B_KMAJOR.  depth is a multiple of TK.  Each thread
// moves 4 elements of A and 4 of B per chunk; the next chunk's are loaded
// into registers before the current chunk's FMAs.
template <typename T, bool B_KMAJOR>
__device__ __forceinline__ void gemm_tile(const T* A, int lda, const T* B, int ldb,
                                          int depth, T (&acc)[4][4], T* As, T* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  T ra[4], rb[4];
  auto load = [&](int t0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * NT;
      ra[q] = A[(size_t)(e / TK) * lda + t0 + e % TK];
      rb[q] = B_KMAJOR ? B[(size_t)(t0 + e / P) * ldb + e % P]
                       : B[(size_t)(e / TK) * ldb + t0 + e % TK];
    }
  };
  if (depth > 0) load(0);
  for (int t0 = 0; t0 < depth; t0 += TK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * NT;
      As[(e % TK) * LDS + e / TK] = ra[q];
      if (B_KMAJOR)
        Bs[(e / P) * LDS + e % P] = rb[q];
      else
        Bs[(e % TK) * LDS + e / TK] = rb[q];
    }
    __syncthreads();
    if (t0 + TK < depth) load(t0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * LDS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * LDS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* W, const T (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) W[(ty + 16 * i) * P + tx + 16 * j] = acc[i][j];
}

// (a, split part) Block (tile, s): the partial sum over panels
// [s len, (s + 1) len) of L[row, t] L[c0 + c, t] for the 64 rows of the tile
// (rows from c0 on), into W[s * ntiles + tile].
template <typename T>
__global__ void __launch_bounds__(NT)
panel_partial(const T* __restrict__ L, T* __restrict__ W, int ld, int c0, int len) {
  __shared__ T As[TK * LDS];
  __shared__ T Bs[TK * LDS];
  const int tile = blockIdx.x, s = blockIdx.y, ntiles = gridDim.x;
  const int p0 = s * len, p1 = min(c0 / P, p0 + len);
  if (p0 >= p1) return;
  const int row0 = c0 + tile * P;
  T acc[4][4] = {};
  gemm_tile<T, false>(L + (size_t)row0 * ld + p0 * P, ld, L + (size_t)c0 * ld + p0 * P, ld,
                      (p1 - p0) * P, acc, As, Bs);
  store_tile(W + (size_t)(s * ntiles + tile) * TILE, acc);
}

// (a, finish) L[row, c0 + j] = K[row, c0 + j] - sum of the n_split partials,
// one element per thread: block (tile, q) covers rows 4q .. 4q + 3 of the tile.
// K is A's entry, symmetrized, when FROM_A, else the Gram entry from z and
// coef = (sig2, jitter).
template <typename T, bool FROM_A>
__global__ void __launch_bounds__(NT)
panel_finish(const T* __restrict__ z, const T* __restrict__ A, const T* __restrict__ coef,
             T* L, const T* __restrict__ W, int ld, int M, int D, int c0, int n_split,
             int kmap) {
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int e = blockIdx.y * NT + threadIdx.x;  // element of the 64 x 64 tile
  const int row = c0 + tile * P + e / P, col = c0 + e % P;
  T k;
  if (row < M && col < M) {
    if (FROM_A) {
      k = T(0.5) * (A[(size_t)row * M + col] + A[(size_t)col * M + row]);
    } else {
      T r2 = T(0);
      for (int d = 0; d < D; ++d) {
        const T diff = z[(size_t)row * D + d] - z[(size_t)col * D + d];
        r2 += diff * diff;
      }
      k = coef[0] * agp::kernel_map(kmap, r2) + (row == col ? coef[1] : T(0));
    }
  } else {
    k = row == col ? T(1) : T(0);  // padding: identity, uncoupled
  }
  for (int s = 0; s < n_split; ++s) k -= W[(size_t)(s * ntiles + tile) * TILE + e];
  L[(size_t)row * ld + col] = k;
}

// (b) Factor the P x P diagonal block (its lower triangle is read) and invert
// the factor in one loop; write L_kk (zeros above) and J_kk = L_kk^-1.
// Column c of L is an elementary transform E_c; applying E_c^-1 to an
// identity accumulator X in the same step leaves L_kk^-1 in X at the end.
// Each thread keeps its 4 x 4 share of the block and of X in registers; per
// step the owners of column c publish it (and row c of X) to shared memory,
// double-buffered so that one barrier a step suffices.
template <typename T>
__global__ void __launch_bounds__(NT) diag_factor_inv(T* L, T* J, int ld, int c0) {
  __shared__ T col_buf[2][P];
  __shared__ T row_buf[2][P];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T* Lkk = L + (size_t)c0 * ld + c0;
  T* Jkk = J + (size_t)c0 * ld + c0;
  T a[4][4], x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, s = tx + 16 * j;
      a[i][j] = s <= r ? Lkk[(size_t)r * ld + s] : Lkk[(size_t)s * ld + r];
      x[i][j] = r == s ? T(1) : T(0);
    }
  for (int c = 0; c < P; ++c) {
    T* colc = col_buf[c & 1];
    T* rowc = row_buf[c & 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tx + 16 * j == c) colc[ty + 16 * i] = a[i][j];
        if (ty + 16 * i == c) rowc[tx + 16 * j] = x[i][j];
      }
    __syncthreads();
    const T piv = colc[c];
    const T d = sqrt(piv), inv = T(1) / d;
    T lr[4], ls[4], xc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lr[i] = colc[ty + 16 * i] * inv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ls[j] = colc[tx + 16 * j] * inv;
      xc[j] = rowc[tx + 16 * j] * inv;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        if (r > c) {
          if (s > c) a[i][j] -= lr[i] * ls[j];
          if (s == c) a[i][j] = lr[i];
          x[i][j] -= lr[i] * xc[j];
        } else if (r == c) {
          if (s == c) a[i][j] = d;
          x[i][j] = xc[j];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, s = tx + 16 * j;
      Lkk[(size_t)r * ld + s] = s <= r ? a[i][j] : T(0);
      Jkk[(size_t)r * ld + s] = s <= r ? x[i][j] : T(0);
    }
}

// (c) L[row, c0 + j] = sum_t C[row, t] X[j, t] for rows >= c0 + P, in place:
// each block owns its 64 rows and reads them all before it writes.
template <typename T>
__global__ void __launch_bounds__(NT) panel_trsm(T* L, const T* J, int ld, int c0) {
  __shared__ T As[TK * LDS];
  __shared__ T Bs[TK * LDS];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = c0 + P + blockIdx.x * P;
  T acc[4][4] = {};
  gemm_tile<T, false>(L + (size_t)row0 * ld + c0, ld, J + (size_t)c0 * ld + c0, ld, P, acc,
                      As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      L[(size_t)(row0 + ty + 16 * i) * ld + c0 + tx + 16 * j] = acc[i][j];
}

// (d, split part) Block (n, s): with T_s the partial sum over panels
// [n + s len, n + (s + 1) len) of L[c0 + r, t] J[t, nP + c], writes
// -X T_s into W[n * n_split + s] (X = J's diagonal block at c0).  J is zero
// above its diagonal, so the sum for column tile n starts at panel n.
template <typename T>
__global__ void __launch_bounds__(NT)
jrow_partial(const T* __restrict__ L, const T* __restrict__ J, T* __restrict__ W, int ld,
             int c0, int len) {
  __shared__ T As[TK * LDS];
  __shared__ T Ts[P * LDS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n = blockIdx.x, s = blockIdx.y, n_split = gridDim.y;
  const int p0 = n + s * len, p1 = min(c0 / P, p0 + len);
  if (p0 >= p1) return;
  T acc[4][4] = {};
  gemm_tile<T, true>(L + (size_t)c0 * ld + p0 * P, ld, J + (size_t)p0 * P * ld + n * P, ld,
                     (p1 - p0) * P, acc, As, Ts);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Ts[(ty + 16 * i) * LDS + tx + 16 * j] = acc[i][j];
      acc[i][j] = T(0);
    }
  __syncthreads();
  const T* X = J + (size_t)c0 * ld + c0;
  for (int t0 = 0; t0 < P; t0 += TK) {
    for (int e = tid; e < P * TK; e += NT) {
      const int r = e / TK, kk = e % TK;
      As[kk * LDS + r] = X[(size_t)r * ld + t0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * LDS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ts[(t0 + kk) * LDS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = -acc[i][j];
  store_tile(W + (size_t)(n * n_split + s) * TILE, acc);
}

// (d, finish) J[c0 + r, nP + c] = sum of column tile n's partials, one
// element per thread: block (n, q) covers rows 4q .. 4q + 3.
template <typename T>
__global__ void __launch_bounds__(NT)
jrow_finish(T* J, const T* __restrict__ W, int ld, int c0, int len, int n_split) {
  const int n = blockIdx.x, k = c0 / P;
  const int e = blockIdx.y * NT + threadIdx.x;
  const int parts = (k - n + len - 1) / len;
  T t = T(0);
  for (int s = 0; s < parts; ++s) t += W[(size_t)(n * n_split + s) * TILE + e];
  J[(size_t)(c0 + e / P) * ld + n * P + e % P] = t;
}

// The host loop; z and coef are read when !FROM_A, A when FROM_A.
template <typename T, bool FROM_A>
int chol_inv_loop(const T* z, const T* A, const T* coef, T* L, T* J, T* W, int M, int Mp,
                  int D, int kmap, cudaStream_t s) {
  if (M < 1 || Mp < M || Mp % P != 0) return cudaErrorInvalidValue;
  if (!FROM_A && (D < 1 || D > 64 || !agp::valid_kernel_map(kmap))) return cudaErrorInvalidValue;
  cudaError_t err;
  const size_t bytes = (size_t)Mp * Mp * sizeof(T);
  if ((err = cudaMemsetAsync(L, 0, bytes, s)) != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(J, 0, bytes, s)) != cudaSuccess) return err;
  const int n_panels = Mp / P;
  for (int k = 0; k < n_panels; ++k) {
    const int c0 = k * P, ntiles = n_panels - k;
    // (a): split the depth k (in panels) over about SPLIT_TARGET blocks
    int len = 0, n_split = 0;
    if (k > 0) {
      n_split = max(1, min(k, SPLIT_TARGET / ntiles));
      len = (k + n_split - 1) / n_split;
      n_split = (k + len - 1) / len;
      panel_partial<T><<<dim3(ntiles, n_split), NT, 0, s>>>(L, W, Mp, c0, len);
    }
    panel_finish<T, FROM_A><<<dim3(ntiles, TILE / NT), NT, 0, s>>>(z, A, coef, L, W, Mp, M, D,
                                                                   c0, n_split, kmap);
    diag_factor_inv<T><<<1, NT, 0, s>>>(L, J, Mp, c0);
    if (ntiles > 1) panel_trsm<T><<<ntiles - 1, NT, 0, s>>>(L, J, Mp, c0);
    if (k > 0) {
      // (d): column tile n has depth k - n panels; k (k + 1) / 2 in all
      len = max(1, (k * (k + 1) / 2 + SPLIT_TARGET - 1) / SPLIT_TARGET);
      n_split = (k + len - 1) / len;
      jrow_partial<T><<<dim3(k, n_split), NT, 0, s>>>(L, J, W, Mp, c0, len);
      jrow_finish<T><<<dim3(k, TILE / NT), NT, 0, s>>>(J, W, Mp, c0, len, n_split);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* agp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Elements of the scratch buffer either factorization needs at Mp (a
// multiple of 64).
long long agp_gram_chol_inv_scratch(int Mp) {
  return (long long)scratch_tiles(Mp / P) * TILE;
}

// z: (M, D) row-major f64; coef: (sig2, jitter) on the device; L, J: (Mp, Mp)
// row-major outputs; W: scratch of agp_gram_chol_inv_scratch(Mp) elements.
// Returns a cudaError_t (0 on success).
int agp_gram_chol_inv_f64(const void* z, const void* coef, void* L, void* J, void* W, int M,
                          int Mp, int D, int kmap, void* stream) {
  return chol_inv_loop<double, false>(static_cast<const double*>(z), nullptr,
                                      static_cast<const double*>(coef), static_cast<double*>(L),
                                      static_cast<double*>(J), static_cast<double*>(W), M, Mp,
                                      D, kmap, static_cast<cudaStream_t>(stream));
}

// A: (M, M) row-major f64 SPD (its symmetric part is factored); L, J: (Mp, Mp)
// row-major outputs; W: scratch of agp_gram_chol_inv_scratch(Mp) elements.
int agp_chol_inv_f64(const void* A, void* L, void* J, void* W, int M, int Mp, void* stream) {
  return chol_inv_loop<double, true>(nullptr, static_cast<const double*>(A), nullptr,
                                     static_cast<double*>(L), static_cast<double*>(J),
                                     static_cast<double*>(W), M, Mp, 0, 0,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
