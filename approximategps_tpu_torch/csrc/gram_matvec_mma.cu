// Fused stationary Gram matvec, the wide pass: out = K(Xq, Zk) V with K
// never stored, the product on the tensor cores.
//
// Replaces, with gram_matvec.cu (the narrow pass; its note gives the
// contract), approximategps_tpu/ops/gram_matvec.py::pallas_gram_matvec
// (_forward_multi, _gmv_kernel) for f32 and R from the crossover that
// ops/gram_matvec.py::pass_part holds up to 128.  Same contract: exact-
// difference r^2; g, g' or r^2 g'; the fast maps of fast_maps.cuh; each block writes
// its rows once in a fixed order of summation.
//
// The tile of h(r^2) a warp computes in registers is the A operand of a
// product, as P is in attention.  A warpgroup (four warps) owns 64 query
// rows and walks the keys 8 at a time; lane (g, t) of a warp computes h for
// exactly the four (row, key) entries it holds in the A fragment
// (tf32_mma.cuh): rows g and g + 8 of its warp's 16 and, with A's columns t
// and t + 4 mapped to keys 2t and 2t + 1 of the step (the product does not
// care which key a column is, as long as B's row is the same key), two
// neighbouring keys, whose coordinates are one shared load.  One exp an
// entry, no shuffle and no redundancy.  The product is wgmma m64nNk8 with A
// from those registers and B, V's key tile, from shared memory (N = 8 to 128
// columns: all of R <= 128 in one pass, h never recomputed), asynchronous:
// the next step's h is computed while the tensor cores multiply, with A's
// registers double-buffered.  V's tiles are split into TF32 hi and lo halves
// once a block as they are staged (the next tile's loads in flight while
// this one is consumed); 3xTF32 (A_hi B_hi + A_hi B_lo + A_lo B_hi) keeps
// the product at f32 accuracy, where plain TF32 keeps three digits (A is
// split in the inner loop by truncation, one integer operation an entry).
// From 16 columns on the products of two steps go out as one batch.  Each
// key tile's products are summed apart and then added to the running total
// (two-level summation, as in the narrow pass).
//
// What bounds it on the H100: at R = 16 the exps (10^10 at N = M = 10^5:
// 2.39 ms) against 1.94 ms of 3xTF32 products (3 R FMAs an entry at 495
// TFLOP/s); from R = 21 on the tensor cores (R = 32: 3.88 ms).  What holds
// it back is the SIMT work of an entry (about eight instructions: the
// differences, r^2, the exp and the split) and not the products.  An
// earlier version with mma.sync m16n8k8 and staging in step with the
// compute took 11.7 ms at R = 16 and 16.9 ms at R = 32; this one 7.6 and
// 9.7 ms (chip_smoke.py phase 3; PERF.md).
//
// ptxas -v (sm_90a; the build log), D = 2: 53, 93, 128, 198 and 243
// registers for N = 8, 16, 32, 64 and 128, no spills; 84-88 bytes spill at
// D = 8, N = 32 (512 threads leave 128 registers a thread).

#include <cuda_runtime.h>

#include "fast_maps.cuh"
#include "tf32_mma.cuh"

namespace {

// warps a block (16 query rows each, four to a warpgroup) and keys a tile:
// the split tiles of V stay under 48 KB, the accumulators in registers
template <int NTMAX>
__host__ __device__ constexpr int block_warps() {
  return NTMAX <= 4 ? 16 : 8;
}
template <int NTMAX>
__host__ __device__ constexpr int tile_keys() {
  return NTMAX <= 4 ? 128 : 512 / NTMAX;
}

// DP: D padded to 1, 2, 4 or 8; NTMAX: 8-column tiles of the product (its N
// is 8 NTMAX, the columns past R zero).
template <int DP, int NTMAX, int MAP>
__global__ void __launch_bounds__(32 * block_warps<NTMAX>())
    gram_matvec_mma_kernel(const float* __restrict__ xq, const float* __restrict__ zk,
                           const float* __restrict__ v, float* __restrict__ out, int N, int M,
                           int D, int R) {
  constexpr int NTH = 32 * block_warps<NTMAX>();
  constexpr int TJ = tile_keys<NTMAX>();
  constexpr int NC = 8 * NTMAX;                   // the product's N: V's columns staged
  constexpr int STEP = 8 * NC;                    // words of B a step of 8 keys
  constexpr int VPER = TJ * NC / NTH;             // V entries a thread stages a tile
  constexpr int ZPER = (TJ * DP + NTH - 1) / NTH;  // and coordinates
  constexpr int SB = NTMAX >= 2 ? 2 : 1;          // steps of 8 keys a batch of products
  constexpr float CS = agp::coord_scale<MAP & 3>();
  __shared__ __align__(128) unsigned bhi[TJ / 8 * STEP];
  __shared__ __align__(128) unsigned blo[TJ / 8 * STEP];
  __shared__ __align__(16) float zs[TJ * DP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = blockIdx.x * (NTH / 2) + warp * 16 + g, rb = ra + 8;

  float xa[DP], xb[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    xa[d] = ra < N && d < D ? CS * xq[(size_t)ra * D + d] : 0.f;
    xb[d] = rb < N && d < D ? CS * xq[(size_t)rb * D + d] : 0.f;
  }
  float acc[NC / 2], part[NC / 2];  // part: this tile's products, then added to acc
#pragma unroll
  for (int k = 0; k < NC / 2; ++k) acc[k] = part[k] = 0.f;

  // the next tile's entries, loaded while this one is consumed
  float vn[VPER], zn[ZPER];
  auto load = [&](int j0) {
#pragma unroll
    for (int k = 0; k < VPER; ++k) {
      const int e = tid + k * NTH, j = j0 + e / NC, c = e % NC;
      vn[k] = j < M && c < R ? v[(size_t)j * R + c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < ZPER; ++k) {
      const int e = tid + k * NTH, j = j0 + e / DP, d = e % DP;
      zn[k] = e < TJ * DP && j < M && d < D ? CS * zk[(size_t)j * D + d] : 0.f;
    }
  };
  load(0);
  for (int j0 = 0; j0 < M; j0 += TJ) {
    __syncthreads();  // every warp's products of the previous tile are done
#pragma unroll
    for (int k = 0; k < VPER; ++k) {
      // key jj of the tile is row kr of its step's B (keys 2t, 2t + 1 -> rows t, t + 4)
      const int e = tid + k * NTH, jj = e / NC, c = e % NC, kk = jj & 7;
      const int kr = (kk & 1) ? (kk >> 1) + 4 : (kk >> 1);
      const int o = (jj >> 3) * STEP + agp::wgmma_b_offset(kr, c);
      agp::tf32_split(vn[k], bhi[o], blo[o]);
    }
#pragma unroll
    for (int k = 0; k < ZPER; ++k) {
      const int e = tid + k * NTH;
      if (e < TJ * DP) zs[e] = zn[k];
    }
    __syncthreads();
    if (j0 + TJ < M) load(j0 + TJ);
    // A, double-buffered by batches of SB steps: one batch is written while
    // the previous batch's products read the other
    unsigned ahi[2][SB][4], alo[2][SB][4];
#pragma unroll
    for (int s0 = 0; s0 < TJ / 8; s0 += SB) {
      const int bb = (s0 / SB) & 1;
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int j = 8 * (s0 + u) + 2 * t;  // this lane's keys j and j + 1
        float h[4];  // A fragment: (ra, j), (rb, j), (ra, j + 1), (rb, j + 1)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* z = zs + (j + q) * DP;
          float r2a = 0.f, r2b = 0.f;
#pragma unroll
          for (int d = 0; d < DP; ++d) {
            const float da = xa[d] - z[d], db = xb[d] - z[d];
            r2a = fmaf(da, da, r2a);
            r2b = fmaf(db, db, r2b);
          }
          h[2 * q] = agp::fast_entry_scaled<MAP>(r2a);
          h[2 * q + 1] = agp::fast_entry_scaled<MAP>(r2b);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          agp::tf32_split_trunc(h[k], ahi[bb][u][k], alo[bb][u][k]);
          agp::reg_fence(ahi[bb][u][k]);
          agp::reg_fence(alo[bb][u][k]);
        }
      }
      agp::wgmma_fence();
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int s = s0 + u;
        const unsigned long long dh = agp::wgmma_desc(bhi + s * STEP);
        const unsigned long long dl = agp::wgmma_desc(blo + s * STEP);
        agp::wgmma_tf32<NC>(part, alo[bb][u], dh, s > 0);  // the tile's first product overwrites
        agp::wgmma_tf32<NC>(part, ahi[bb][u], dl, 1);
        agp::wgmma_tf32<NC>(part, ahi[bb][u], dh, 1);
      }
      agp::wgmma_commit();
      agp::wgmma_wait<1>();  // the previous batch's products are done: its A buffer is free
    }
    agp::wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < NC / 2; ++k) {
      agp::reg_fence(part[k]);
      acc[k] += part[k];
    }
  }
  // D fragment: (ra, 8n + 2t), (ra, 8n + 2t + 1), (rb, 8n + 2t), (rb, 8n + 2t + 1)
#pragma unroll
  for (int n = 0; n < NTMAX; ++n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = k < 2 ? ra : rb, col = 8 * n + 2 * t + (k & 1);
      if (row < N && col < R) out[(size_t)row * R + col] = acc[4 * n + k];
    }
  }
}

template <int DP, int NTMAX, int MAP>
cudaError_t launch(const float* xq, const float* zk, const float* v, float* out, int N, int M,
                   int D, int R, cudaStream_t s) {
  constexpr int rows = 16 * block_warps<NTMAX>();
  gram_matvec_mma_kernel<DP, NTMAX, MAP>
      <<<(N + rows - 1) / rows, 32 * block_warps<NTMAX>(), 0, s>>>(xq, zk, v, out, N, M, D, R);
  return cudaGetLastError();
}

template <int DP, int MAP>
cudaError_t by_columns(const float* xq, const float* zk, const float* v, float* out, int N,
                       int M, int D, int R, cudaStream_t s) {
  if (R <= 8) return launch<DP, 1, MAP>(xq, zk, v, out, N, M, D, R, s);
  if (R <= 16) return launch<DP, 2, MAP>(xq, zk, v, out, N, M, D, R, s);
  if (R <= 32) return launch<DP, 4, MAP>(xq, zk, v, out, N, M, D, R, s);
  if (R <= 64) return launch<DP, 8, MAP>(xq, zk, v, out, N, M, D, R, s);
  return launch<DP, 16, MAP>(xq, zk, v, out, N, M, D, R, s);
}

template <int DP>
cudaError_t by_map(int map, const float* xq, const float* zk, const float* v, float* out, int N,
                   int M, int D, int R, cudaStream_t s) {
  switch (map) {
    case 0: return by_columns<DP, 0>(xq, zk, v, out, N, M, D, R, s);
    case 1: return by_columns<DP, 1>(xq, zk, v, out, N, M, D, R, s);
    case 2: return by_columns<DP, 2>(xq, zk, v, out, N, M, D, R, s);
    case 3: return by_columns<DP, 3>(xq, zk, v, out, N, M, D, R, s);
    case 4: return by_columns<DP, 4>(xq, zk, v, out, N, M, D, R, s);
    case 5: return by_columns<DP, 5>(xq, zk, v, out, N, M, D, R, s);
    case 6: return by_columns<DP, 6>(xq, zk, v, out, N, M, D, R, s);
    case 7: return by_columns<DP, 7>(xq, zk, v, out, N, M, D, R, s);
    case 8: return by_columns<DP, 8>(xq, zk, v, out, N, M, D, R, s);
    case 9: return by_columns<DP, 9>(xq, zk, v, out, N, M, D, R, s);
    case 10: return by_columns<DP, 10>(xq, zk, v, out, N, M, D, R, s);
    case 11: return by_columns<DP, 11>(xq, zk, v, out, N, M, D, R, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// xq: (N, D), zk: (M, D), v: (M, R), out: (N, R); all row-major f32.
// deriv = 1 takes g' in place of g, deriv = 2 r^2 g'(r^2).  Returns a
// cudaError_t.
int agp_gram_matvec_mma_f32(const void* xq_, const void* zk_, const void* v_, void* out_, int N,
                            int M, int D, int R, int kmap, int deriv, void* stream) {
  if (N < 1 || M < 1 || D < 1 || D > 8 || R < 1 || R > 128 || !agp::valid_kernel_map(kmap) ||
      deriv < 0 || deriv > 2)
    return cudaErrorInvalidValue;
  const float* xq = static_cast<const float*>(xq_);
  const float* zk = static_cast<const float*>(zk_);
  const float* v = static_cast<const float*>(v_);
  float* out = static_cast<float*>(out_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int map = kmap + 4 * deriv;
  if (D == 1) return by_map<1>(map, xq, zk, v, out, N, M, D, R, s);
  if (D == 2) return by_map<2>(map, xq, zk, v, out, N, M, D, R, s);
  if (D <= 4) return by_map<4>(map, xq, zk, v, out, N, M, D, R, s);
  return by_map<8>(map, xq, zk, v, out, N, M, D, R, s);
}

}  // extern "C"
