// The self-Gram's pullback in one pass: the cotangents of out = K(X, X) V,
// K = g(r^2) never stored, for the output's cotangent O (f32).
//
// Replaces, for the self-Gram (query = key = X), the passes of
// approximategps_tpu/ops/gram_matvec.py::_gmv_bwd (the transposed pass and
// two _coord_cotangent calls, each (1 + D) R columns wide), which gram_matvec.cu
// and gram_matvec_mma.cu still run for the general Function:
//
//     Vbar = K O                                  (K is symmetric),
//     Xbar_i = 2 sum_j g'_ij c_ij (x_i - x_j),    c_ij = [O_i | V_i] . [V_j | O_j],
//
// which is Xqbar + Zkbar of _gmv_bwd (the query and the key role of x_i).  r^2
// is computed once a pair from exact differences, g and g' from one
// special-function result (fast_maps.cuh: SE g' = -g / 2; the Matern maps
// share sqrt(r^2) and exp(-t)), and the differences that formed r^2 weight
// g' c directly, so nothing cancels as in 2 (s_i x_i - U_i).  The SE map's
// coordinates are scaled as they are read (fast_maps.cuh), so Xbar is
// divided by the scale once at the end.
//
// Layout (tf32_mma.cuh): a warp owns 16 rows of X and walks the keys 8 at a
// time; lane (g, t) computes the four pairs (g | g + 8, 2t | 2t + 1).  Those
// are its A fragment of Vbar's product (A's columns t and t + 4 mapped to
// keys 2t and 2t + 1, B's rows the same keys of O) and exactly its C
// fragment of c's product, an m16n8k8 mma over depth 2R whose A operand is
// the warp's rows of [O | V] (split into TF32 halves once, in registers) and
// whose B operand is the keys' [V | O] from shared memory.  So every lane
// holds g', c and the differences of the same four pairs: (1 + D) FMAs a
// pair after one mma a depth step, no shuffle until the end, where the four
// lanes of a quad add their Xbar in a fixed order.  Products in 3xTF32 as in
// the wide pass; two-level summation; each block writes its rows once.
//
// R > 32 runs chunks of 32 columns over the grid's second dimension (c_ij is
// a sum over columns, so each chunk's Xbar is a partial one, written to its
// own slice and added in a fixed order by the caller); the exps are then
// recomputed for each chunk.  The exact-GP path runs R = 1 and R = 16.
//
// What bounds it on the H100: the tensor cores.  At N = 10^5, R = 16: 10^10
// pairs, one exp each (2.39 ms), and 16 (Vbar) + 32 (c's depth) = 48 FMAs a
// pair, x3 for the split, at 495 TFLOP/s: 5.82 ms.  It runs at about a
// quarter of that (PERF.md): the SIMT work of a pair and the instructions
// of the mma.sync products and their shared loads hold it back.
//
// ptxas -v (sm_90a; the build log), D = 2: 101, 128 and 214 registers for chunks
// of 8, 16 and 32 columns, a 4-byte spill at 16.

#include <cuda_runtime.h>

#include "fast_maps.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int BM = 16 * WARPS;  // rows a block
constexpr int TJ = 64;          // keys a shared tile
constexpr int CHUNK = 32;       // columns a chunk

// DP: D padded to 1, 2, 4 or 8; NTMAX: 8-column n-tiles a chunk holds
// accumulators for (1, 2 or 4), of which the first ceil(w / 8) run, w the
// chunk's columns.  c's depth is [O | V]'s 2 CW columns (CW = 8 NTMAX; zero
// past w), of which the depth steps with a column below w run.
template <int DP, int NTMAX, int MAP>
__global__ void __launch_bounds__(32 * WARPS)
    self_bwd_kernel(const float* __restrict__ x, const float* __restrict__ v,
                    const float* __restrict__ o, float* __restrict__ vbar,
                    float* __restrict__ xbar, int N, int D, int R) {
  constexpr int CW = 8 * NTMAX;                  // a chunk's columns, staged
  constexpr int KS = 2 * NTMAX;                  // c's depth steps of 8
  constexpr int P = agp::mma_pitch(2 * CW);
  constexpr int NTH = 32 * WARPS;
  constexpr int PER = TJ * CW / NTH;               // (V, O) entries a thread stages a tile
  constexpr int ZPER = (TJ * DP + NTH - 1) / NTH;  // and coordinates
  constexpr float CS = agp::coord_scale<MAP>();
  __shared__ __align__(16) float zs[TJ * DP];
  __shared__ __align__(16) unsigned khi[TJ * P];  // keys' [V | O], TF32 halves
  __shared__ __align__(16) unsigned klo[TJ * P];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.y * CHUNK;
  const int w = min(CHUNK, R - c0);  // this chunk's columns
  const int nt = (w + 7) >> 3;       // their n-tiles
  const int ra = blockIdx.x * BM + warp * 16 + g, rb = ra + 8;

  float xa[DP], xb[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    xa[d] = ra < N && d < D ? CS * x[(size_t)ra * D + d] : 0.f;
    xb[d] = rb < N && d < D ? CS * x[(size_t)rb * D + d] : 0.f;
  }
  // [O_i | V_i] of the warp's rows at depth q: O's column c0 + q below CW,
  // V's column c0 + q - CW above; zero past w
  auto qside = [&](int row, int q) {
    const int c = q % CW;
    if (row >= N || c >= w) return 0.f;
    return (q < CW ? o : v)[(size_t)row * R + c0 + c];
  };
  unsigned qhi[KS][4], qlo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int q0 = 8 * kk + t, q1 = q0 + 4;
    agp::tf32_split(qside(ra, q0), qhi[kk][0], qlo[kk][0]);
    agp::tf32_split(qside(rb, q0), qhi[kk][1], qlo[kk][1]);
    agp::tf32_split(qside(ra, q1), qhi[kk][2], qlo[kk][2]);
    agp::tf32_split(qside(rb, q1), qhi[kk][3], qlo[kk][3]);
  }
  float vacc[NTMAX][4], xacc[2][DP];
#pragma unroll
  for (int n = 0; n < NTMAX; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) vacc[n][k] = 0.f;
#pragma unroll
  for (int d = 0; d < DP; ++d) xacc[0][d] = xacc[1][d] = 0.f;

  // the next tile's entries, loaded while this one is consumed
  float vn[PER], on[PER], zn[ZPER];
  auto load = [&](int j0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NTH, j = j0 + e / CW, c = e % CW;
      const bool ok = j < N && c < w;
      vn[k] = ok ? v[(size_t)j * R + c0 + c] : 0.f;
      on[k] = ok ? o[(size_t)j * R + c0 + c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < ZPER; ++k) {
      const int e = tid + k * NTH, j = j0 + e / DP, d = e % DP;
      zn[k] = e < TJ * DP && j < N && d < D ? CS * x[(size_t)j * D + d] : 0.f;
    }
  };
  load(0);
  for (int j0 = 0; j0 < N; j0 += TJ) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * NTH, off = (e / CW) * P + e % CW;
      agp::tf32_split(vn[k], khi[off], klo[off]);
      agp::tf32_split(on[k], khi[off + CW], klo[off + CW]);
    }
#pragma unroll
    for (int k = 0; k < ZPER; ++k) {
      const int e = tid + k * NTH;
      if (e < TJ * DP) zs[e] = zn[k];
    }
    __syncthreads();
    if (j0 + TJ < N) load(j0 + TJ);
    // this tile's sums (two-level summation), Vbar's big and small products apart
    float vb[NTMAX][4], vs[NTMAX][4], xpart[2][DP];
#pragma unroll
    for (int n = 0; n < NTMAX; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) vb[n][k] = vs[n][k] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) xpart[0][d] = xpart[1][d] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < TJ; k0 += 8) {
      const int j = k0 + 2 * t;  // this lane's keys j and j + 1
      // pairs p = 0..3: (ra, j), (rb, j), (ra, j + 1), (rb, j + 1)
      float diff[4][DP], gg[4], dg[4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* z = zs + (j + s) * DP;
        float r2a = 0.f, r2b = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          diff[2 * s][d] = xa[d] - z[d];
          diff[2 * s + 1][d] = xb[d] - z[d];
          r2a = fmaf(diff[2 * s][d], diff[2 * s][d], r2a);
          r2b = fmaf(diff[2 * s + 1][d], diff[2 * s + 1][d], r2b);
        }
        agp::fast_map_both_scaled<MAP>(r2a, gg[2 * s], dg[2 * s]);
        agp::fast_map_both_scaled<MAP>(r2b, gg[2 * s + 1], dg[2 * s + 1]);
      }
      // c = [O_i | V_i] . [V_j | O_j] for keys k0 + 0..7: C fragment
      // (ra, j), (ra, j + 1), (rb, j), (rb, j + 1)
      float cb[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk % NTMAX < nt) {
          const int off = (k0 + g) * P + 8 * kk + t;
          agp::mma_3xtf32(cb, cs, qhi[kk], qlo[kk], khi, klo, off, off + 4);
        }
      }
      // Vbar += G O: A = g in the permuted-key layout, B = the keys' O rows
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) agp::tf32_split(gg[k], ahi[k], alo[k]);
#pragma unroll
      for (int n = 0; n < NTMAX; ++n) {
        if (n < nt) {
          const int off = j * P + CW + 8 * n + g;
          agp::mma_3xtf32(vb[n], vs[n], ahi, alo, khi, klo, off, off + P);
        }
      }
      const float wt[4] = {dg[0] * (cb[0] + cs[0]), dg[1] * (cb[2] + cs[2]),
                           dg[2] * (cb[1] + cs[1]), dg[3] * (cb[3] + cs[3])};
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        xpart[0][d] = fmaf(wt[0], diff[0][d], fmaf(wt[2], diff[2][d], xpart[0][d]));
        xpart[1][d] = fmaf(wt[1], diff[1][d], fmaf(wt[3], diff[3][d], xpart[1][d]));
      }
    }
#pragma unroll
    for (int n = 0; n < NTMAX; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) vacc[n][k] += vb[n][k] + vs[n][k];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      xacc[0][d] += xpart[0][d];
      xacc[1][d] += xpart[1][d];
    }
  }
  // Vbar's C fragment: (ra, 8n + 2t), (ra, 8n + 2t + 1), (rb, ...), (rb, ...)
#pragma unroll
  for (int n = 0; n < NTMAX; ++n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = k < 2 ? ra : rb, col = 8 * n + 2 * t + (k & 1);
      if (n < nt && row < N && col < w) vbar[(size_t)row * R + c0 + col] = vacc[n][k];
    }
  }
  // each row's Xbar is spread over the four lanes t of its quad: add them in
  // a fixed order, then lane t = 0 writes this chunk's slice
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      float val = xacc[s][d];
      val += __shfl_xor_sync(0xffffffffu, val, 1);
      val += __shfl_xor_sync(0xffffffffu, val, 2);
      xacc[s][d] = val;
    }
  }
  float* xb_out = xbar + (size_t)blockIdx.y * N * D;
  if (t == 0) {
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < D && ra < N) xb_out[(size_t)ra * D + d] = (2.f / CS) * xacc[0][d];
      if (d < D && rb < N) xb_out[(size_t)rb * D + d] = (2.f / CS) * xacc[1][d];
    }
  }
}

template <int DP, int NTMAX, int MAP>
cudaError_t launch(const float* x, const float* v, const float* o, float* vbar, float* xbar,
                   int N, int D, int R, cudaStream_t s) {
  const dim3 grid((N + BM - 1) / BM, (R + CHUNK - 1) / CHUNK);
  self_bwd_kernel<DP, NTMAX, MAP><<<grid, 32 * WARPS, 0, s>>>(x, v, o, vbar, xbar, N, D, R);
  return cudaGetLastError();
}

template <int DP, int MAP>
cudaError_t by_columns(const float* x, const float* v, const float* o, float* vbar, float* xbar,
                       int N, int D, int R, cudaStream_t s) {
  if (R <= 8) return launch<DP, 1, MAP>(x, v, o, vbar, xbar, N, D, R, s);
  if (R <= 16) return launch<DP, 2, MAP>(x, v, o, vbar, xbar, N, D, R, s);
  return launch<DP, 4, MAP>(x, v, o, vbar, xbar, N, D, R, s);
}

template <int DP>
cudaError_t by_map(int kmap, const float* x, const float* v, const float* o, float* vbar,
                   float* xbar, int N, int D, int R, cudaStream_t s) {
  switch (kmap) {
    case 0: return by_columns<DP, 0>(x, v, o, vbar, xbar, N, D, R, s);
    case 1: return by_columns<DP, 1>(x, v, o, vbar, xbar, N, D, R, s);
    case 2: return by_columns<DP, 2>(x, v, o, vbar, xbar, N, D, R, s);
    case 3: return by_columns<DP, 3>(x, v, o, vbar, xbar, N, D, R, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (N, D), v and o: (N, R), vbar: (N, R), xbar: (ceil(R / 32), N, D), each
// chunk's share of Xbar; all row-major f32.  Returns a cudaError_t.
int agp_gram_matvec_self_bwd_f32(const void* x_, const void* v_, const void* o_, void* vbar_,
                                 void* xbar_, int N, int D, int R, int kmap, void* stream) {
  if (N < 1 || D < 1 || D > 8 || R < 1 || R > 128 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(x_);
  const float* v = static_cast<const float*>(v_);
  const float* o = static_cast<const float*>(o_);
  float* vbar = static_cast<float*>(vbar_);
  float* xbar = static_cast<float*>(xbar_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 1) return by_map<1>(kmap, x, v, o, vbar, xbar, N, D, R, s);
  if (D == 2) return by_map<2>(kmap, x, v, o, vbar, xbar, N, D, R, s);
  if (D <= 4) return by_map<4>(kmap, x, v, o, vbar, xbar, N, D, R, s);
  return by_map<8>(kmap, x, v, o, vbar, xbar, N, D, R, s);
}

}  // extern "C"
