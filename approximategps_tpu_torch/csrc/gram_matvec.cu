// Fused stationary Gram matvec, the narrow pass: out = K(Xq, Zk) V with K
// never stored, on the SIMT units.
//
// Replaces approximategps_tpu/ops/gram_matvec.py::pallas_gram_matvec
// (_forward_multi, _gmv_kernel), forward and the passes of its pullback
// (_coord_cotangent, _gmv_bwd), together with gram_matvec_mma.cu (the wide
// pass) and gram_matvec_self_bwd.cu (the self-Gram's one-pass pullback):
//
//     out[i, r] = sum_j h(|xq_i - zk_j|^2) V[j, r],   h = g, or g' in
//     derivative mode, or r^2 g'(r^2) in the lengthscale's mode,
//
// for Xq (N, D), Zk (M, D), V (M, R), out (N, R), any N and M, 1 <= D <= 8,
// 1 <= R <= 128, f32 or f64 (accumulated in the input type), and the four
// maps.  r^2 is summed from exact differences, so a point paired with itself
// gives r^2 = 0 exactly and g'(0) takes the JAX package's value.  f32 takes
// the fast maps of fast_maps.cuh (one ex2.approx an entry); f64, the
// correctness reference on the card, the full-precision kernel_maps.cuh.
//
// Which pass runs is decided in Python (ops/gram_matvec.py::pass_part) by R
// alone: f32 takes this one for R below the crossover measured on the card,
// and gram_matvec_mma.cu from it; f64 always takes this one.
//
// What bounds it on the H100: operations.  At N = M = 10^5, D = 2 there are
// 10^10 entries and under 15 MB to move; each entry costs one exp on the
// special-function units (16 a clock an SM: 2.39 ms for 10^10), 2D
// subtract/FMA and R FMAs.  At R = 1 an entry is about seven instructions,
// so the instruction rate and the exp units set the pace together.  A thread
// owns QR query rows (4 for the narrowest widths), so each broadcast shared
// load of z_j and v_j feeds QR entries and their QR independent exps hide the
// unit's latency; the SE map's exponent scale is folded into the coordinates
// (fast_maps.cuh), one multiply an entry fewer.  The key tiles (TJ keys:
// coordinates and V's rows for the block's columns) are staged with
// cp.async, double-buffered, so the next tile arrives while this one is
// consumed.  Zk and V are under 15 MB and stay in L2; at tiles of 1-8 KB TMA
// would save no instructions worth having.
//
// The TPU kernel carries the sum over the key axis in VMEM scratch from one
// grid step to the next.  Hopper blocks run in no order, so one block owns
// 32 QR query rows and loops over all of Zk inside.  Its NW warps own the
// same rows and take a quarter of every key tile each (N / (32 QR) blocks of
// one warp would leave the card a few warps an SM); their sums are added in
// warp order at the end.  A tile's products are summed apart and then added
// to the running total (two-level summation: a sum over 10^5 keys in f32
// carries about TJ + M / TJ roundings rather than M).  Each block writes its
// rows once: no atomics, a fixed order of summation, results that repeat
// bitwise.  R > 32 runs chunks of 32 columns over the grid's second
// dimension, in the same launch, recomputing h for each chunk (the wide pass
// does not).
//
// ptxas -v (sm_90a; the build log), D = 2: f32 48, 62, 80, 122, 124 and 128
// registers for 1, 2, 4, 8, 16 and 32 columns, no spills; f64 96-250, with
// spills of 4-144 bytes in some of the wide and the D = 8 instances.

#include <cuda_runtime.h>

#include <type_traits>

#include "fast_maps.cuh"
#include "kernel_maps.cuh"

namespace {

constexpr int NW = 4;        // warps a block: each takes a quarter of every key tile
constexpr int NT = 32 * NW;  // threads a block

// Coordinates are multiplied by this as they are read: the SE map's exponent
// folded into them in f32 (fast_maps.cuh); 1 for the Matern maps and f64.
template <typename T, int MAP>
__host__ __device__ constexpr T coord_scale() {
  if constexpr (std::is_same_v<T, float>) return agp::coord_scale<MAP & 3>();
  return T(1);
}

// MAP < 4: the map g; 4 <= MAP < 8: its derivative g'; MAP >= 8: r^2 g'(r^2)
// (the lengthscale's cotangent, formed from r^2 itself and not from the
// coordinates' cotangents, which cancel); of r^2 from scaled coordinates.
template <typename T, int MAP>
__device__ __forceinline__ T entry(T r2) {
  if constexpr (std::is_same_v<T, float>) {
    return agp::fast_entry_scaled<MAP>(r2);
  } else if constexpr (MAP < 4) {
    return agp::kernel_map<T>(MAP, r2);
  } else if constexpr (MAP < 8) {
    return agp::kernel_map_dr2<T>(MAP - 4, r2);
  } else {
    return agp::kernel_map_dr2<T>(MAP - 8, r2) * r2;
  }
}

// One element global -> shared without a register round trip; zero-filled
// where !valid (the source is then not read).
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
               "n"(sizeof(T)), "r"(valid ? int(sizeof(T)) : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows a thread owns for RB columns: enough to feed the exp unit, few enough
// that QR * RB running and tile sums stay in registers.
template <typename T, int RB>
__host__ __device__ constexpr int rows_per_thread() {
  constexpr int words = RB * int(sizeof(T) / 4);
  return words <= 8 ? 4 : words <= 16 ? 2 : 1;
}

// Keys staged a tile: two buffers of TJ * (DP + RB) entries stay under 48 KB.
template <typename T, int RB>
__host__ __device__ constexpr int tile_keys() {
  return RB * int(sizeof(T)) >= 128 ? 64 : 128;
}

template <typename T, int DP, int RB>
struct Smem {
  static constexpr int QR = rows_per_thread<T, RB>();
  static constexpr int TJ = tile_keys<T, RB>();
  static constexpr int tiles = 2 * TJ * (DP + RB);  // two buffers of z and v
  static constexpr int sums = NW * 32 * QR * RB;    // each warp's sums of the rows
  static constexpr int elems = tiles > sums ? tiles : sums;
};

// DP: D padded to 1, 2, 4 or 8 (the padding coordinates are 0 on both sides,
// so r^2 is unchanged to the bit); RB: the block's columns.  The block's NW
// warps own the same 32 * QR rows and split each key tile into quarters;
// their sums are added in warp order at the end.
template <typename T, int DP, int RB, int MAP>
__global__ void __launch_bounds__(NT)
    gram_matvec_kernel(const T* __restrict__ xq, const T* __restrict__ zk,
                       const T* __restrict__ v, T* __restrict__ out, int N, int M, int D,
                       int R) {
  using S = Smem<T, DP, RB>;
  constexpr int QR = S::QR, TJ = S::TJ, TW = TJ / NW;
  constexpr T CS = coord_scale<T, MAP>();
  __shared__ __align__(16) T smem[S::elems];
  T* const zs = smem;                  // [2][TJ * DP]
  T* const vs = smem + 2 * TJ * DP;    // [2][TJ * RB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * 32 * QR + lane;  // rows i0 + 32 q
  const int cb = blockIdx.y * RB;              // first column of this block

  T x[QR][DP];
#pragma unroll
  for (int q = 0; q < QR; ++q) {
    const int i = i0 + 32 * q;
#pragma unroll
    for (int d = 0; d < DP; ++d) x[q][d] = i < N && d < D ? CS * xq[(size_t)i * D + d] : T(0);
  }
  T acc[QR][RB];
#pragma unroll
  for (int q = 0; q < QR; ++q)
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[q][c] = T(0);

  auto stage = [&](int tile, int buf) {
    const int j0 = tile * TJ;
    for (int e = tid; e < TJ * DP; e += NT) {
      const int j = j0 + e / DP, d = e % DP;
      const bool ok = j < M && d < D;
      cp_async(zs + buf * TJ * DP + e, ok ? zk + (size_t)j * D + d : zk, ok);
    }
    for (int e = tid; e < TJ * RB; e += NT) {
      const int j = j0 + e / RB, col = cb + e % RB;
      const bool ok = j < M && col < R;
      cp_async(vs + buf * TJ * RB + e, ok ? v + (size_t)j * R + col : v, ok);
    }
    cp_async_commit();
  };

  const int tiles = (M + TJ - 1) / TJ;
  stage(0, 0);
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      stage(tile + 1, (tile + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (CS != T(1)) {  // scale the coordinates this thread copied
      T* z = zs + (tile & 1) * TJ * DP;
      for (int e = tid; e < TJ * DP; e += NT) z[e] *= CS;
    }
    __syncthreads();  // this tile has landed for every thread
    const int jb = warp * TW;  // this warp's quarter of the tile
    const T* z = zs + (tile & 1) * TJ * DP + jb * DP;
    const T* vv = vs + (tile & 1) * TJ * RB + jb * RB;
    const int jn = min(TW, M - tile * TJ - jb);
    T part[QR][RB];  // this tile's sums, added to acc once: two-level summation
#pragma unroll
    for (int q = 0; q < QR; ++q)
#pragma unroll
      for (int c = 0; c < RB; ++c) part[q][c] = T(0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      T zj[DP], vj[RB];
#pragma unroll
      for (int d = 0; d < DP; ++d) zj[d] = z[jj * DP + d];
#pragma unroll
      for (int c = 0; c < RB; ++c) vj[c] = vv[jj * RB + c];
#pragma unroll
      for (int q = 0; q < QR; ++q) {
        T r2 = T(0);
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          const T diff = x[q][d] - zj[d];
          r2 = fma(diff, diff, r2);
        }
        const T h = entry<T, MAP>(r2);
#pragma unroll
        for (int c = 0; c < RB; ++c) part[q][c] = fma(h, vj[c], part[q][c]);
      }
    }
#pragma unroll
    for (int q = 0; q < QR; ++q)
#pragma unroll
      for (int c = 0; c < RB; ++c) acc[q][c] += part[q][c];
    __syncthreads();  // the buffer is consumed before the next stage refills it
  }
  // the warps' sums of the same rows, added in warp order (the tile buffers
  // are free now)
  T* const sums = smem;  // [NW][QR][RB][32]
#pragma unroll
  for (int q = 0; q < QR; ++q)
#pragma unroll
    for (int c = 0; c < RB; ++c) sums[((warp * QR + q) * RB + c) * 32 + lane] = acc[q][c];
  __syncthreads();
  for (int e = tid; e < 32 * QR * RB; e += NT) {
    const int l = e % 32, qc = e / 32, q = qc / RB, c = qc % RB;
    const int i = i0 - lane + l + 32 * q;
    T total = sums[qc * 32 + l];
#pragma unroll
    for (int w = 1; w < NW; ++w) total += sums[(w * QR * RB + qc) * 32 + l];
    if (i < N && cb + c < R) out[(size_t)i * R + cb + c] = total;
  }
}

template <typename T, int DP, int RB, int MAP>
cudaError_t launch(const T* xq, const T* zk, const T* v, T* out, int N, int M, int D, int R,
                   cudaStream_t s) {
  constexpr int rows = 32 * rows_per_thread<T, RB>();
  const dim3 grid((N + rows - 1) / rows, (R + RB - 1) / RB);
  gram_matvec_kernel<T, DP, RB, MAP><<<grid, NT, 0, s>>>(xq, zk, v, out, N, M, D, R);
  return cudaGetLastError();
}

// The narrowest block of columns that holds R (32 and chunks above it).
template <typename T, int DP, int MAP>
cudaError_t by_columns(const T* xq, const T* zk, const T* v, T* out, int N, int M, int D, int R,
                       cudaStream_t s) {
  if (R == 1) return launch<T, DP, 1, MAP>(xq, zk, v, out, N, M, D, R, s);
  if (R <= 2) return launch<T, DP, 2, MAP>(xq, zk, v, out, N, M, D, R, s);
  if (R <= 4) return launch<T, DP, 4, MAP>(xq, zk, v, out, N, M, D, R, s);
  if (R <= 8) return launch<T, DP, 8, MAP>(xq, zk, v, out, N, M, D, R, s);
  if (R <= 16) return launch<T, DP, 16, MAP>(xq, zk, v, out, N, M, D, R, s);
  return launch<T, DP, 32, MAP>(xq, zk, v, out, N, M, D, R, s);
}

template <typename T, int DP>
cudaError_t by_map(int map, const T* xq, const T* zk, const T* v, T* out, int N, int M, int D,
                   int R, cudaStream_t s) {
  switch (map) {
    case 0: return by_columns<T, DP, 0>(xq, zk, v, out, N, M, D, R, s);
    case 1: return by_columns<T, DP, 1>(xq, zk, v, out, N, M, D, R, s);
    case 2: return by_columns<T, DP, 2>(xq, zk, v, out, N, M, D, R, s);
    case 3: return by_columns<T, DP, 3>(xq, zk, v, out, N, M, D, R, s);
    case 4: return by_columns<T, DP, 4>(xq, zk, v, out, N, M, D, R, s);
    case 5: return by_columns<T, DP, 5>(xq, zk, v, out, N, M, D, R, s);
    case 6: return by_columns<T, DP, 6>(xq, zk, v, out, N, M, D, R, s);
    case 7: return by_columns<T, DP, 7>(xq, zk, v, out, N, M, D, R, s);
    case 8: return by_columns<T, DP, 8>(xq, zk, v, out, N, M, D, R, s);
    case 9: return by_columns<T, DP, 9>(xq, zk, v, out, N, M, D, R, s);
    case 10: return by_columns<T, DP, 10>(xq, zk, v, out, N, M, D, R, s);
    case 11: return by_columns<T, DP, 11>(xq, zk, v, out, N, M, D, R, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int gram_matvec(const void* xq_, const void* zk_, const void* v_, void* out_, int N, int M,
                int D, int R, int kmap, int deriv, void* stream) {
  if (N < 1 || M < 1 || D < 1 || D > 8 || R < 1 || R > 128 || !agp::valid_kernel_map(kmap) ||
      deriv < 0 || deriv > 2)
    return cudaErrorInvalidValue;
  const T* xq = static_cast<const T*>(xq_);
  const T* zk = static_cast<const T*>(zk_);
  const T* v = static_cast<const T*>(v_);
  T* out = static_cast<T*>(out_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int map = kmap + 4 * deriv;
  if (D == 1) return by_map<T, 1>(map, xq, zk, v, out, N, M, D, R, s);
  if (D == 2) return by_map<T, 2>(map, xq, zk, v, out, N, M, D, R, s);
  if (D <= 4) return by_map<T, 4>(map, xq, zk, v, out, N, M, D, R, s);
  return by_map<T, 8>(map, xq, zk, v, out, N, M, D, R, s);
}

}  // namespace

// This file builds the f32 entry point; gram_matvec_f64.cu includes it with
// the two macros set for f64, so that the two sets of template instances
// compile in parallel.
#ifndef AGP_GRAM_MATVEC_T
#define AGP_GRAM_MATVEC_T float
#define AGP_GRAM_MATVEC_ENTRY agp_gram_matvec_f32
#endif

extern "C" {

// xq: (N, D), zk: (M, D), v: (M, R), out: (N, R); all row-major, one dtype.
// deriv = 1 takes g' in place of g, deriv = 2 r^2 g'(r^2).  Returns a
// cudaError_t.
int AGP_GRAM_MATVEC_ENTRY(const void* xq, const void* zk, const void* v, void* out, int N,
                          int M, int D, int R, int kmap, int deriv, void* stream) {
  return gram_matvec<AGP_GRAM_MATVEC_T>(xq, zk, v, out, N, M, D, R, kmap, deriv, stream);
}

}  // extern "C"
