// The tensor-core product that rows 2 and 3 share in f32: D = K0^T B over
// one tile of NA = 128 inducing columns a, with K0 = g(r2(Zs, Xs)) computed
// in registers straight into wgmma's A fragment, as row 5's wide pass
// (gram_matvec_mma.cu) computes h(r2).
//
// A block of two warpgroups owns ROWS = 128 test points; lane (g, t) of a
// warp holds rows g and g + 8 of its warp's 16 and, with A's columns t and
// t + 4 mapped to keys 2t and 2t + 1 of a step of 8 (B's rows permuted to
// match), two neighbouring keys c.  The keys run in stages of TJ = 32.  Se
// is split into TF32 hi and lo halves once a call (split_se), already in
// wgmma's layout and in the order the stages are read, so that a stage's B
// tile (the keys' rows of Se, its 128 columns: 16 KB each half) and its
// keys' coordinates reach shared memory by cp.async, two stages ahead in a
// ring of RING, with one barrier a stage and the products of consecutive
// stages in flight together; A is split by truncation in the inner loop.
// D (64 x 128 a warpgroup) stays in registers, in mma's C layout: lane (g, t) holds (g, 8n + 2t + j) and
// (g + 8, 8n + 2t + j), n < 16, j < 2 (tf32_mma.cuh).
//
// SYM (row 2): B[c, a] = w Se[c, a] with w = 2 for c > a, 1 for c = a and 0
// for c < a, over the keys from the tile's first column on: the quadratic
// form sum_a K0[a] sum_c Se[a, c] K0[c] read from one triangle of the
// exactly symmetric Se (doubling is exact, and so is the split of 2x).
// Without SYM (row 3): B = Se over every key, so D = (Se K0)^T on the tile.
//
// Two-level summation: the tensor cores' f32 accumulation loses precision
// along a long chain of products (with one chain over all M keys of a tile
// the error from f64 grew with M, to many times the SIMT kernels'), so each
// group of GROUP stages (128 keys, 48 products) is summed apart on the
// tensor cores and added to the tile's total on the SIMT units, in shared
// memory (each lane's own slots: the registers hold one accumulator), in a
// fixed order.
#pragma once

#include <cuda_runtime.h>

#include "fast_maps.cuh"
#include "tf32_mma.cuh"

namespace agp {
namespace epi {

constexpr int NWARPS = 8;
constexpr int NTH = 32 * NWARPS;       // threads a block
constexpr int ROWS = NTH / 2;          // test points a block: 16 a warp
constexpr int NA = 128;                // inducing columns a tile: wgmma's N
constexpr int TJ = 32;                 // keys a stage
constexpr int STEP = 8 * NA;           // words of B a step of 8 keys
constexpr int SB = 2;                  // steps a batch of products
constexpr int GROUP = 4;               // stages a group of products summed apart
constexpr int HOLD = NA / 2 * NTH;     // floats of the groups' running totals
constexpr int RING = 4;                // stages in shared memory at once
static_assert(NA % TJ == 0, "a tile's first key starts a stage");

// Keys padded to whole stages, tiles of inducing columns, and the words of
// each half of split_se's output.
__host__ __device__ constexpr int padded_keys(int M) { return (M + TJ - 1) / TJ * TJ; }
__host__ __device__ constexpr int col_tiles(int M) { return (M + NA - 1) / NA; }
__host__ __device__ constexpr long long split_words(int M) {
  return (long long)col_tiles(M) * (padded_keys(M) / 8) * STEP;
}
// Floats of scratch the sweep needs: both halves of the split Se and the
// keys' coordinates, (padded_keys(M), DP).
__host__ __device__ constexpr long long sweep_scratch(int M, int DP) {
  return 2 * split_words(M) + (long long)padded_keys(M) * DP;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's shared-memory writes visible to wgmma's (async proxy)
// reads; a barrier then publishes them to the block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One stage's split B tile and its keys' coordinates (scaled).
template <int DP>
struct Stage {
  unsigned bhi[TJ / 8 * STEP];
  unsigned blo[TJ / 8 * STEP];
  float zk[TJ * DP];
};

// A of one step: h[0..3] = g at (ra, c), (rb, c), (ra, c + 1), (rb, c + 1),
// c = 8 s + 2t, from the stage's key coordinates; times dv[c] where dv is
// given (the A of the S_bar product carries dvar on its keys).
template <int DP, int MAP>
__device__ __forceinline__ void a_fragment(const float* zk, const float (&xa)[DP],
                                           const float (&xb)[DP], int s, int t, unsigned (&hi)[4],
                                           unsigned (&lo)[4], const float* dv = nullptr) {
  const int j = 8 * s + 2 * t;
  float h[4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* z = zk + (j + q) * DP;
    float r2a = 0.f, r2b = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const float da = xa[d] - z[d], db = xb[d] - z[d];
      r2a = fmaf(da, da, r2a);
      r2b = fmaf(db, db, r2b);
    }
    const float w = dv ? dv[j + q] : 1.f;
    h[2 * q] = w * fast_map_scaled<MAP, false>(r2a);
    h[2 * q + 1] = w * fast_map_scaled<MAP, false>(r2b);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    tf32_split_trunc(h[k], hi[k], lo[k]);
    reg_fence(hi[k]);
    reg_fence(lo[k]);
  }
}

// The products of one stage (TJ / 8 steps), A from a_fragment, double-
// buffered by batches of SB steps: each A_lo B_hi + A_hi B_lo + A_hi B_hi
// into acc, in that order.  Returns with the last batch still in flight
// (the next stage's first batch waits for it before its A buffer is written
// again).
template <int DP, int MAP>
__device__ __forceinline__ void stage_products(float (&acc)[NA / 2], const Stage<DP>& st,
                                               const float (&xa)[DP], const float (&xb)[DP],
                                               int t) {
  unsigned ahi[2][SB][4], alo[2][SB][4];
#pragma unroll
  for (int s0 = 0; s0 < TJ / 8; s0 += SB) {
    const int bb = (s0 / SB) & 1;
#pragma unroll
    for (int u = 0; u < SB; ++u)
      a_fragment<DP, MAP>(st.zk, xa, xb, s0 + u, t, ahi[bb][u], alo[bb][u]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int s = s0 + u;
      const unsigned long long dh = wgmma_desc(st.bhi + s * STEP);
      const unsigned long long dl = wgmma_desc(st.blo + s * STEP);
      wgmma_tf32<NA>(acc, alo[bb][u], dh, 1);
      wgmma_tf32<NA>(acc, ahi[bb][u], dl, 1);
      wgmma_tf32<NA>(acc, ahi[bb][u], dh, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous batch is done: its A buffer is free
  }
}

// The split Se of one call, for the sweep: for column tile ta and key step
// ks (8 keys), the (8, NA) block B[c, a] in wgmma's layout at word
// (ta nks + ks) STEP, hi and lo apart (with SYM the weights of the header's
// note); and the keys' coordinates scaled by cs, (padded_keys(M), DP), zero
// past M and D.  Word idx of a grid of split_words(M) threads (each kernel
// file launches it from its own __global__ wrapper).
template <int DP, bool SYM>
__device__ __forceinline__ void split_se(long long idx, const float* __restrict__ se,
                                         const float* __restrict__ zs, unsigned* __restrict__ bhi,
                                         unsigned* __restrict__ blo, float* __restrict__ zsp,
                                         int M, int D, float cs) {
  const int nks = padded_keys(M) / 8;
  if (idx < (long long)padded_keys(M) * DP) {
    const int c = (int)(idx / DP), d = (int)(idx % DP);
    zsp[idx] = c < M && d < D ? cs * zs[(size_t)c * D + d] : 0.f;
  }
  if (idx >= split_words(M)) return;
  const int o = (int)(idx % STEP);
  const long long blk = idx / STEP;
  const int ks = (int)(blk % nks), ta = (int)(blk / nks);
  // the inverse of wgmma_b_offset and of the key order (keys 2t, 2t + 1 of
  // a step on B's rows t, t + 4)
  const int col = 8 * (o / 64) + (o % 32) / 4, kr = 4 * ((o % 64) / 32) + o % 4;
  const int c = 8 * ks + (kr < 4 ? 2 * kr : 2 * (kr - 4) + 1), a = ta * NA + col;
  float v = c < M && a < M ? se[(size_t)c * M + a] : 0.f;
  if (SYM) v = c > a ? 2.f * v : (c == a ? v : 0.f);
  tf32_split(v, bhi[idx], blo[idx]);
}

// acc = K0^T B over the a tile [a0, a0 + NA) and the keys [a0 (SYM) or 0,
// M), from split_se's output; xa, xb: this lane's two points (scaled, zero
// past B); ring: RING stages and hold: HOLD floats of shared memory.  Every
// thread of the block calls it; it starts and ends with no copy in flight
// and no product pending.
template <int DP, int MAP, bool SYM>
__device__ __forceinline__ void se_k0_tile(float (&acc)[NA / 2], Stage<DP>* ring, float* hold,
                                           const unsigned* __restrict__ bhi,
                                           const unsigned* __restrict__ blo,
                                           const float* __restrict__ zsp, int M, int a0,
                                           const float (&xa)[DP], const float (&xb)[DP]) {
  const int tid = threadIdx.x, t = tid & 3;
  const int nks = padded_keys(M) / 8, ta = a0 / NA;
  const int c_begin = SYM ? a0 : 0;
  const int nst = (padded_keys(M) - c_begin) / TJ;
#pragma unroll
  for (int k = 0; k < NA / 2; ++k) acc[k] = 0.f;
  // stage i of the tile into ring[i % RING]; a group is committed either way
  auto copy_stage = [&](int i) {
    if (i < nst) {
      Stage<DP>& st = ring[i % RING];
      const size_t g0 = ((size_t)ta * nks + (c_begin + i * TJ) / 8) * STEP;
      for (int q = tid; q < TJ / 8 * STEP / 4; q += NTH) {
        cp_async16(st.bhi + 4 * q, bhi + g0 + 4 * q);
        cp_async16(st.blo + 4 * q, blo + g0 + 4 * q);
      }
      const float* gz = zsp + (size_t)(c_begin + i * TJ) * DP;
      for (int q = tid; q < TJ * DP / 4; q += NTH) cp_async16(st.zk + 4 * q, gz + 4 * q);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < RING - 2; ++i) copy_stage(i);
  int groups = 0;  // groups already added to hold
  for (int k = 0; k < nst; ++k) {
    cp_async_wait<RING - 3>();  // this thread's copies of stage k have landed
    fence_proxy_async();
    // every thread's copies of stage k are visible, and every warp's
    // products of stage k - 2 are done: its buffer takes stage k + RING - 2
    __syncthreads();
    copy_stage(k + RING - 2);
    stage_products<DP, MAP>(acc, ring[k % RING], xa, xb, t);
    if (k % GROUP == GROUP - 1 && k + 1 < nst) {
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < NA / 2; ++q) {
        reg_fence(acc[q]);
        float* h = hold + q * NTH + tid;
        *h = groups ? *h + acc[q] : acc[q];
        acc[q] = 0.f;
      }
      ++groups;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < NA / 2; ++q) {
    reg_fence(acc[q]);
    if (groups) acc[q] += hold[q * NTH + tid];
  }
}

// A point's coordinates, scaled, zero past n.
template <int DP, int MAP>
__device__ __forceinline__ void load_point(const float* __restrict__ x, int i, int n, int D,
                                           float (&out)[DP]) {
  constexpr float CS = coord_scale<MAP>();
#pragma unroll
  for (int d = 0; d < DP; ++d) out[d] = i < n && d < D ? CS * x[(size_t)i * D + d] : 0.f;
}

// r'^2 between a point in registers and one in shared memory.
template <int DP>
__device__ __forceinline__ float sq_dist(const float (&x)[DP], const float* z) {
  float r2 = 0.f;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const float dd = x[d] - z[d];
    r2 = fmaf(dd, dd, r2);
  }
  return r2;
}

}  // namespace epi
}  // namespace agp
