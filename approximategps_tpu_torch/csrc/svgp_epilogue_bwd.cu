// Fused SVGP data-term epilogue, backward.
//
// Replaces approximategps_tpu/ops/svgp_epilogue.py::_bwd_fused (the pullback
// of svgp_data_epilogue, reached through _epilogue_bwd).  With
// K0 = g(r2(Zs, Xs)) (M, B), mu = K0^T ae and var = diag(K0^T Se K0), Se
// symmetric, and the cotangents dmu, dvar (B,):
//
//     Se_bar = (K0 o dvar) K0^T                       (M, M)
//     ae_bar = K0 dmu                                 (M,)
//     W      = (2 (Se K0) o dvar + ae (x) dmu) o g'(r2)  (M, B)
//     Xs_bar = 2 (xs o colsum W - W^T Zs)             (B, D)
//     Zs_bar = 2 (zs o rowsum W - W Xs)               (M, D)
//
// As in the TPU kernel, K0, Se K0 and W never reach device memory whole: K0
// is generated tile by tile from the points (the centred |x|^2 identity of
// the forward), and only per-tile partial sums of size O((M + B) D) and the
// partial tiles of Se_bar are written.  The caller centres Xs and Zs jointly;
// the centring needs no pullback (the cotangents of a joint shift sum to 0).
//
// What bounds it on the H100: per block of B points, Se K0 is M^2 B FMAs
// (all of it is needed, since W needs every entry, so the forward's
// symmetric halving does not apply) and Se_bar is M^2 B / 2 (symmetric): at
// M = 2048, B = 16384, 103 G FMA on the f32 SIMT units, three times the
// forward's work.  The K0 tiles are regenerated for every output tile (D + 1
// FMAs and one exp per entry, about (D + 20) / BT of the product's work).
//
// Hopper blocks run in no order, so every sum across blocks goes to scratch
// and a finish kernel adds it up in a fixed order (no atomics: results repeat
// bitwise):
//   1. sq_norms: |x_j|^2 and |z_a|^2.
//   2. w_tiles, grid (B / BT, M / BT): one BT x BT tile of T = Se K0 per
//      block, the depth M in TK-deep shared-memory chunks with the K0 chunk
//      generated in place; then W on the tile, and its partials: per point
//      j, colsum and W^T z over the tile's rows; per inducing row a, rowsum,
//      W x and K0 dmu over the tile's points.
//   3. se_bar_tiles, grid (tile pairs ta <= tb, depth splits): the upper
//      tiles of the SYRK (K0 o dvar) K0^T, with B split into parts so that
//      the card fills (see Plan).
//   4. finish_x, finish_z, finish_se: the fixed-order sums; finish_se also
//      mirrors, so Se_bar is exactly symmetric.
// Plain SIMT FMA tiles (TM x TM outputs a thread, 16 x 16 threads, each
// thread's rows and columns two runs of TM / 2 so that its operands come
// from shared memory as 16-byte loads); the next depth chunk's global loads
// are issued into registers before the current chunk's work.  The number
// of depth splits of the SYRK is chosen for whole waves of blocks on the
// card.  Tensor cores and a persistent schedule are later work.  Ragged M
// and B are masked in the kernels.

#include <cuda_runtime.h>

#include "kernel_maps.cuh"

namespace {

constexpr int NT = 256;               // threads a block: 16 x 16
constexpr int TK = 16;                // depth of one shared-memory chunk
constexpr int FIN = 256;              // threads a block of the finish kernels
// a chunk's K0 rows are generated one per row of 16 threads
static_assert(TK == NT / 16, "one chunk row per thread row");

// outputs a thread owns along each side of a tile: BT = 16 TM
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int TM = 8;
};
template <>
struct Tile<double> {
  static constexpr int TM = 4;
};

// A thread's i-th row (or column) of a tile, t its index along that side:
// two runs of TM / 2, one in each half of the tile, so that each run is one
// 16-byte shared-memory load and a warp's loads do not conflict.
template <typename T>
__device__ __forceinline__ int tile_idx(int t, int i) {
  constexpr int H = Tile<T>::TM / 2, BT = 16 * Tile<T>::TM;
  return (i < H ? 0 : BT / 2) + t * H + i % H;
}

// v[i] = row[tile_idx(t, i)] for the TM rows or columns of thread t.
__device__ __forceinline__ void load_frag(const float* row, int t, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + t * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + 64 + t * 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void load_frag(const double* row, int t, double (&v)[4]) {
  const double2 lo = *reinterpret_cast<const double2*>(row + t * 2);
  const double2 hi = *reinterpret_cast<const double2*>(row + 32 + t * 2);
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// row[tile_idx(t, i)] = v[i].
__device__ __forceinline__ void store_frag(float* row, int t, const float (&v)[8]) {
  *reinterpret_cast<float4*>(row + t * 4) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(row + 64 + t * 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_frag(double* row, int t, const double (&v)[4]) {
  *reinterpret_cast<double2*>(row + t * 2) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(row + 32 + t * 2) = make_double2(v[2], v[3]);
}

// dot[j] = z . x_n for the TM columns n = tile_idx(t, j) of a tile whose
// points are stored transposed in xT (D, BT); z is one point of D in shared
// memory.
template <typename T>
__device__ __forceinline__ void frag_dots(const T* z, const T* xT, int D, int t,
                                          T (&dot)[Tile<T>::TM]) {
  constexpr int TM = Tile<T>::TM, BT = 16 * TM;
#pragma unroll
  for (int j = 0; j < TM; ++j) dot[j] = T(0);
  for (int d = 0; d < D; ++d) {
    const T zd = z[d];
    T xv[TM];
    load_frag(xT + d * BT, t, xv);
#pragma unroll
    for (int j = 0; j < TM; ++j) dot[j] = fma(zd, xv[j], dot[j]);
  }
}

// acc += A^T B over one TK-deep chunk: As and Bs hold TK rows of LDS.
template <typename T, int LDS>
__device__ __forceinline__ void chunk_fma(const T* As, const T* Bs, int tx, int ty,
                                          T (&acc)[Tile<T>::TM][Tile<T>::TM]) {
  constexpr int TM = Tile<T>::TM;
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) {
    T a[TM], b[TM];
    load_frag(As + kk * LDS, ty, a);
    load_frag(Bs + kk * LDS, tx, b);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__global__ void sq_norms(const T* __restrict__ x, T* __restrict__ out, int n, int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = T(0);
  for (int d = 0; d < D; ++d) s = fma(x[(size_t)i * D + d], x[(size_t)i * D + d], s);
  out[i] = s;
}

// (2) Block (jt, at): T = Se[a0:a0+BT, :] K0[:, j0:j0+BT], then W and the
// partials.  px[(at (D + 1) + d) B + j]: d < D holds sum_a W[a, j] z_a[d],
// d = D the colsum.  pz[(jt (D + 2) + d) M + a]: d < D holds
// sum_j W[a, j] x_j[d], d = D the rowsum, d = D + 1 sum_j K0[a, j] dmu_j.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
w_tiles(const T* __restrict__ xs, const T* __restrict__ zs, const T* __restrict__ xn,
        const T* __restrict__ zn, const T* __restrict__ se, const T* __restrict__ ae,
        const T* __restrict__ dmu, const T* __restrict__ dvar, T* __restrict__ px,
        T* __restrict__ pz, int B, int M, int D, int kmap) {
  constexpr int TM = Tile<T>::TM, BT = 16 * TM;
  constexpr int LDS = BT + 4;                 // chunk rows: 16-byte aligned, few conflicts
  constexpr int LDW = BT + 1;                 // W rows
  constexpr int SE_PER = BT * TK / NT;        // Se chunk elements a thread loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // (TK, LDS): Se chunk, transposed
  T* Bs = As + TK * LDS;                   // (TK, LDS): K0 chunk
  T* Ws = Bs + TK * LDS;                   // (BT, LDW): W, then K0 o dmu
  T* xT = Ws + BT * LDW;                   // (D, BT): the tile's points, transposed
  T* zT = xT + D * BT;                     // (D, BT): the tile's inducing rows
  T* xx = zT + D * BT;                     // (BT,) their squared norms
  T* zz = xx + BT;                         // (BT,)
  T* zc = zz + BT;                         // (TK, D): the depth chunk's inducing points
  T* zcn = zc + TK * D;                    // (TK,)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int jt = blockIdx.x, at = blockIdx.y;
  const int j0 = jt * BT, a0 = at * BT;

  for (int e = tid; e < BT * D; e += NT) {
    const int n = e / D, d = e % D;
    xT[d * BT + n] = j0 + n < B ? xs[(size_t)(j0 + n) * D + d] : T(0);
    zT[d * BT + n] = a0 + n < M ? zs[(size_t)(a0 + n) * D + d] : T(0);
  }
  for (int n = tid; n < BT; n += NT) {
    xx[n] = j0 + n < B ? xn[j0 + n] : T(0);
    zz[n] = a0 + n < M ? zn[a0 + n] : T(0);
  }

  // the depth chunk's global loads, into registers one chunk ahead (the
  // first NT of the chunk's TK D inducing coordinates: all of them for
  // D <= 16; more are read when the chunk is stored)
  T se_r[SE_PER], z_r = T(0), zn_r = T(0);
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int q = 0; q < SE_PER; ++q) {
      const int e = tid + q * NT, r = e / TK, k = e % TK;
      se_r[q] = a0 + r < M && c0 + k < M ? se[(size_t)(a0 + r) * M + c0 + k] : T(0);
    }
    z_r = tid < TK * D && c0 + tid / D < M ? zs[(size_t)c0 * D + tid] : T(0);
    if (tid < TK) zn_r = c0 + tid < M ? zn[c0 + tid] : T(0);
  };

  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = T(0);

  load_chunk(0);
  for (int c0 = 0; c0 < M; c0 += TK) {
#pragma unroll
    for (int q = 0; q < SE_PER; ++q) {
      const int e = tid + q * NT;
      As[(e % TK) * LDS + e / TK] = se_r[q];
    }
    if (tid < TK * D) zc[tid] = z_r;
    for (int e = tid + NT; e < TK * D; e += NT)
      zc[e] = c0 + e / D < M ? zs[(size_t)c0 * D + e] : T(0);
    if (tid < TK) zcn[tid] = zn_r;
    __syncthreads();
    if (c0 + TK < M) load_chunk(c0 + TK);
    // the K0 chunk K0[c0 + k, j0 + n], zero past M and B: row k = ty, this
    // thread's TM columns
    {
      const int k = ty;
      T v[TM];
      frag_dots<T>(zc + k * D, xT, D, tx, v);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int n = tile_idx<T>(tx, j);
        const T r2 = zcn[k] + xx[n] - T(2) * v[j];
        v[j] = c0 + k < M && j0 + n < B ? agp::kernel_map(kmap, r2 > T(0) ? r2 : T(0)) : T(0);
      }
      store_frag(Bs + k * LDS, tx, v);
    }
    __syncthreads();
    chunk_fma<T, LDS>(As, Bs, tx, ty, acc);
    __syncthreads();
  }

  // W on this thread's entries; acc then keeps K0 o dmu for the last pass
  T dv[TM], dm[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int col = j0 + tile_idx<T>(tx, j);
    dv[j] = col < B ? dvar[col] : T(0);
    dm[j] = col < B ? dmu[col] : T(0);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = tile_idx<T>(ty, i);
    const T aa = a0 + r < M ? ae[a0 + r] : T(0);
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int n = tile_idx<T>(tx, j);
      T dot = T(0);
      for (int d = 0; d < D; ++d) dot = fma(zT[d * BT + r], xT[d * BT + n], dot);
      T r2 = zz[r] + xx[n] - T(2) * dot;
      r2 = r2 > T(0) ? r2 : T(0);
      Ws[r * LDW + n] =
          (T(2) * acc[i][j] * dv[j] + aa * dm[j]) * agp::kernel_map_dr2(kmap, r2);
      acc[i][j] = agp::kernel_map(kmap, r2) * dm[j];
    }
  }
  __syncthreads();
  // per point: sum_a W[a, j] z_a and colsum
  for (int o = tid; o < BT * (D + 1); o += NT) {
    const int n = o % BT, d = o / BT;
    T s = T(0);
    if (d < D) {
      for (int r = 0; r < BT; ++r) s = fma(Ws[r * LDW + n], zT[d * BT + r], s);
    } else {
      for (int r = 0; r < BT; ++r) s += Ws[r * LDW + n];
    }
    if (j0 + n < B) px[((size_t)at * (D + 1) + d) * B + j0 + n] = s;
  }
  // per inducing row: sum_j W[a, j] x_j and rowsum
  for (int o = tid; o < BT * (D + 1); o += NT) {
    const int r = o % BT, d = o / BT;
    T s = T(0);
    if (d < D) {
      for (int n = 0; n < BT; ++n) s = fma(Ws[r * LDW + n], xT[d * BT + n], s);
    } else {
      for (int n = 0; n < BT; ++n) s += Ws[r * LDW + n];
    }
    if (a0 + r < M) pz[((size_t)jt * (D + 2) + d) * M + a0 + r] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) Ws[tile_idx<T>(ty, i) * LDW + tile_idx<T>(tx, j)] = acc[i][j];
  __syncthreads();
  for (int r = tid; r < BT; r += NT) {
    T s = T(0);
    for (int n = 0; n < BT; ++n) s += Ws[r * LDW + n];
    if (a0 + r < M) pz[((size_t)jt * (D + 2) + D + 1) * M + a0 + r] = s;
  }
}

// (3) Block (pair, s): the partial over points [s len, (s + 1) len) of the
// Se_bar tile (ta, tb), ta <= tb, into part[(s npairs + pair) BT^2], in the
// tile's row-major order.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
se_bar_tiles(const T* __restrict__ xs, const T* __restrict__ zs, const T* __restrict__ xn,
             const T* __restrict__ zn, const T* __restrict__ dvar, T* __restrict__ part, int B,
             int M, int D, int nt, int len, int kmap) {
  constexpr int TM = Tile<T>::TM, BT = 16 * TM, LDS = BT + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // (TK, LDS): K0 o dvar, tile ta
  T* Bs = As + TK * LDS;                   // (TK, LDS): K0, tile tb
  T* zaT = Bs + TK * LDS;                  // (D, BT): rows of tile ta
  T* zbT = zaT + D * BT;                   // (D, BT): rows of tile tb
  T* za = zbT + D * BT;                    // (BT,) squared norms
  T* zb = za + BT;                         // (BT,)
  T* xc = zb + BT;                         // (TK, D): the chunk's points
  T* xcn = xc + TK * D;                    // (TK,)
  T* dvc = xcn + TK;                       // (TK,)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int pair = blockIdx.x, s = blockIdx.y, npairs = gridDim.x;
  int ta = 0, rem = pair;
  while (rem >= nt - ta) {
    rem -= nt - ta;
    ++ta;
  }
  const int tb = ta + rem;
  const bool diag = ta == tb;
  const int a0 = ta * BT, b0 = tb * BT;
  const int p0 = s * len, p1 = min(B, p0 + len);

  for (int e = tid; e < BT * D; e += NT) {
    const int n = e / D, d = e % D;
    zaT[d * BT + n] = a0 + n < M ? zs[(size_t)(a0 + n) * D + d] : T(0);
    zbT[d * BT + n] = b0 + n < M ? zs[(size_t)(b0 + n) * D + d] : T(0);
  }
  for (int n = tid; n < BT; n += NT) {
    za[n] = a0 + n < M ? zn[a0 + n] : T(0);
    zb[n] = b0 + n < M ? zn[b0 + n] : T(0);
  }

  // the chunk's global loads one chunk ahead, as in w_tiles
  T x_r = T(0), xn_r = T(0), dv_r = T(0);
  auto load_chunk = [&](int c0) {
    x_r = tid < TK * D && c0 + tid / D < p1 ? xs[(size_t)c0 * D + tid] : T(0);
    if (tid < TK) {
      const bool in = c0 + tid < p1;
      xn_r = in ? xn[c0 + tid] : T(0);
      dv_r = in ? dvar[c0 + tid] : T(0);
    }
  };

  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = T(0);

  if (p0 < p1) load_chunk(p0);
  for (int c0 = p0; c0 < p1; c0 += TK) {
    if (tid < TK * D) xc[tid] = x_r;
    for (int e = tid + NT; e < TK * D; e += NT)
      xc[e] = c0 + e / D < p1 ? xs[(size_t)c0 * D + e] : T(0);
    if (tid < TK) {
      xcn[tid] = xn_r;
      dvc[tid] = dv_r;
    }
    __syncthreads();
    if (c0 + TK < p1) load_chunk(c0 + TK);
    // the chunk's K0 rows for both tiles: point k = ty, this thread's TM
    // inducing rows of each; zero past M and the split's end
    {
      const int k = ty;
      const bool in = c0 + k < p1;
      T v[TM];
      frag_dots<T>(xc + k * D, zaT, D, tx, v);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int n = tile_idx<T>(tx, j);
        const T r2 = za[n] + xcn[k] - T(2) * v[j];
        v[j] = in && a0 + n < M ? agp::kernel_map(kmap, r2 > T(0) ? r2 : T(0)) : T(0);
      }
      if (diag) store_frag(Bs + k * LDS, tx, v);
#pragma unroll
      for (int j = 0; j < TM; ++j) v[j] *= dvc[k];
      store_frag(As + k * LDS, tx, v);
      if (!diag) {
        frag_dots<T>(xc + k * D, zbT, D, tx, v);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int n = tile_idx<T>(tx, j);
          const T r2 = zb[n] + xcn[k] - T(2) * v[j];
          v[j] = in && b0 + n < M ? agp::kernel_map(kmap, r2 > T(0) ? r2 : T(0)) : T(0);
        }
        store_frag(Bs + k * LDS, tx, v);
      }
    }
    __syncthreads();
    chunk_fma<T, LDS>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  T* out = part + ((size_t)s * npairs + pair) * BT * BT;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) out[tile_idx<T>(ty, i) * BT + tile_idx<T>(tx, j)] = acc[i][j];
}

// The sizes and scratch layout of one backward call.  The SYRK's depth is
// split into ns parts, ns chosen so that its blocks fill whole waves of the
// card: the least ceil(npairs ns / slots) / ns for ns <= 8, slots the
// blocks that run at once (more parts cost finish_se a pass over M^2 each).
template <typename T>
struct Plan {
  static constexpr int BT = 16 * Tile<T>::TM, LDS = BT + 4;
  int nJ, nA, nt, npairs, ns, len;
  size_t xn, zn, px, pz, part, total;  // scratch offsets and size, in elements
  static size_t w_smem(int D) {
    return ((size_t)2 * TK * LDS + BT * (BT + 1) + 2 * D * BT + 2 * BT + TK * D + TK) * sizeof(T);
  }
  static size_t se_smem(int D) {
    return ((size_t)2 * TK * LDS + 2 * D * BT + 2 * BT + TK * D + 2 * TK) * sizeof(T);
  }
  Plan(int B, int M, int D) {
    nJ = (B + BT - 1) / BT;
    nA = (M + BT - 1) / BT;
    nt = nA;
    npairs = nt * (nt + 1) / 2;
    const int chunks = (B + TK - 1) / TK;
    int dev = 0, sms = 132, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(se_bar_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)se_smem(D));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, se_bar_tiles<T>, NT, se_smem(D));
    const long long slots = (long long)sms * max(per_sm, 1);
    ns = 1;
    double best = 0;
    for (int n = 1; n <= min(8, chunks); ++n) {
      const double cost = (double)((npairs * (long long)n + slots - 1) / slots) / n;
      if (n == 1 || cost < best) best = cost, ns = n;
    }
    len = (chunks + ns - 1) / ns * TK;  // points a split covers
    ns = (B + len - 1) / len;
    xn = 0;
    zn = xn + B;
    px = zn + M;
    pz = px + (size_t)nA * (D + 1) * B;
    part = pz + (size_t)nJ * (D + 2) * M;
    total = part + (size_t)ns * npairs * BT * BT;
  }
};

// (4) Xs_bar[j, d] = 2 (x_j[d] colsum_j - sum_a W[a, j] z_a[d]), the partials
// summed over the nA row tiles in order.
template <typename T>
__global__ void finish_x(const T* __restrict__ xs, const T* __restrict__ px, T* __restrict__ xbar,
                         int B, int D, int nA) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  T cs = T(0);
  for (int t = 0; t < nA; ++t) cs += px[((size_t)t * (D + 1) + D) * B + j];
  for (int d = 0; d < D; ++d) {
    T wz = T(0);
    for (int t = 0; t < nA; ++t) wz += px[((size_t)t * (D + 1) + d) * B + j];
    xbar[(size_t)j * D + d] = T(2) * (xs[(size_t)j * D + d] * cs - wz);
  }
}

// One thread per (a, d), d <= D, summing over the nJ point tiles in order:
// Zs_bar[a, d] = 2 (z_a[d] rowsum_a - sum_j W[a, j] x_j[d]) for d < D, and
// ae_bar[a] = sum_j K0[a, j] dmu_j for d = D.
template <typename T>
__global__ void finish_z(const T* __restrict__ zs, const T* __restrict__ pz, T* __restrict__ zbar,
                         T* __restrict__ aebar, int M, int D, int nJ) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * (D + 1)) return;
  const int a = idx % M, d = idx / M;
  if (d == D) {
    T kd = T(0);
    for (int t = 0; t < nJ; ++t) kd += pz[((size_t)t * (D + 2) + D + 1) * M + a];
    aebar[a] = kd;
    return;
  }
  T rs = T(0), wx = T(0);
  for (int t = 0; t < nJ; ++t) {
    rs += pz[((size_t)t * (D + 2) + D) * M + a];
    wx += pz[((size_t)t * (D + 2) + d) * M + a];
  }
  zbar[(size_t)a * D + d] = T(2) * (zs[(size_t)a * D + d] * rs - wx);
}

// Se_bar[a, b] from the upper tile of (min(a, b), max(a, b)), summed over
// the ns depth splits in order; exactly symmetric.
template <typename T>
__global__ void finish_se(const T* __restrict__ part, T* __restrict__ sebar, int M, int nt,
                          int npairs, int ns) {
  constexpr int BT = 16 * Tile<T>::TM;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * M) return;
  const int a = (int)(idx / M), b = (int)(idx % M);
  const int p = min(a, b), q = max(a, b);
  const int tp = p / BT, tq = q / BT;
  const int pair = tp * nt - tp * (tp - 1) / 2 + (tq - tp);
  const size_t off = (size_t)(p % BT) * BT + q % BT;
  T s = T(0);
  for (int t = 0; t < ns; ++t) s += part[((size_t)t * npairs + pair) * BT * BT + off];
  sebar[idx] = s;
}

template <typename T>
int epilogue_bwd(const T* xs, const T* zs, const T* se, const T* ae, const T* dmu, const T* dvar,
                 T* xbar, T* zbar, T* sebar, T* aebar, T* scratch, int B, int M, int D, int kmap,
                 cudaStream_t s) {
  if (B < 1 || M < 1 || D < 1 || D > 64 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const Plan<T> pl(B, M, D);
  T* xn = scratch + pl.xn;
  T* zn = scratch + pl.zn;
  T* px = scratch + pl.px;
  T* pz = scratch + pl.pz;
  T* part = scratch + pl.part;
  const size_t w_smem = Plan<T>::w_smem(D), se_smem = Plan<T>::se_smem(D);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(w_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)w_smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(se_bar_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)se_smem)) != cudaSuccess)
    return err;
  sq_norms<T><<<(B + FIN - 1) / FIN, FIN, 0, s>>>(xs, xn, B, D);
  sq_norms<T><<<(M + FIN - 1) / FIN, FIN, 0, s>>>(zs, zn, M, D);
  w_tiles<T><<<dim3(pl.nJ, pl.nA), NT, w_smem, s>>>(xs, zs, xn, zn, se, ae, dmu, dvar, px, pz,
                                                     B, M, D, kmap);
  se_bar_tiles<T><<<dim3(pl.npairs, pl.ns), NT, se_smem, s>>>(xs, zs, xn, zn, dvar, part, B, M,
                                                             D, pl.nt, pl.len, kmap);
  finish_x<T><<<(B + FIN - 1) / FIN, FIN, 0, s>>>(xs, px, xbar, B, D, pl.nA);
  finish_z<T><<<(M * (D + 1) + FIN - 1) / FIN, FIN, 0, s>>>(zs, pz, zbar, aebar, M, D, pl.nJ);
  const size_t mm = (size_t)M * M;
  finish_se<T><<<(unsigned)((mm + FIN - 1) / FIN), FIN, 0, s>>>(part, sebar, M, pl.nt,
                                                               pl.npairs, pl.ns);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the scratch buffer the backward needs at (B, M, D).
long long agp_svgp_epilogue_bwd_scratch_f32(int B, int M, int D) {
  return (long long)Plan<float>(B, M, D).total;
}

long long agp_svgp_epilogue_bwd_scratch_f64(int B, int M, int D) {
  return (long long)Plan<double>(B, M, D).total;
}

// xs: (B, D), zs: (M, D) jointly centred; se: (M, M) symmetric; ae: (M,);
// dmu, dvar: (B,); outputs xbar (B, D), zbar (M, D), sebar (M, M), aebar
// (M,); scratch of agp_svgp_epilogue_bwd_scratch_*(B, M, D) elements.  All
// row-major, one dtype.  Returns a cudaError_t.
int agp_svgp_epilogue_bwd_f32(const void* xs, const void* zs, const void* se, const void* ae,
                              const void* dmu, const void* dvar, void* xbar, void* zbar,
                              void* sebar, void* aebar, void* scratch, int B, int M, int D,
                              int kmap, void* stream) {
  using T = float;
  return epilogue_bwd<T>(static_cast<const T*>(xs), static_cast<const T*>(zs),
                         static_cast<const T*>(se), static_cast<const T*>(ae),
                         static_cast<const T*>(dmu), static_cast<const T*>(dvar),
                         static_cast<T*>(xbar), static_cast<T*>(zbar), static_cast<T*>(sebar),
                         static_cast<T*>(aebar), static_cast<T*>(scratch), B, M, D, kmap,
                         static_cast<cudaStream_t>(stream));
}

int agp_svgp_epilogue_bwd_f64(const void* xs, const void* zs, const void* se, const void* ae,
                              const void* dmu, const void* dvar, void* xbar, void* zbar,
                              void* sebar, void* aebar, void* scratch, int B, int M, int D,
                              int kmap, void* stream) {
  using T = double;
  return epilogue_bwd<T>(static_cast<const T*>(xs), static_cast<const T*>(zs),
                         static_cast<const T*>(se), static_cast<const T*>(ae),
                         static_cast<const T*>(dmu), static_cast<const T*>(dvar),
                         static_cast<T*>(xbar), static_cast<T*>(zbar), static_cast<T*>(sebar),
                         static_cast<T*>(aebar), static_cast<T*>(scratch), B, M, D, kmap,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
