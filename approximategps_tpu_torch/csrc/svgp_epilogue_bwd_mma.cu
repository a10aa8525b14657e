// Fused SVGP data-term epilogue, backward, f32 on the tensor cores.
//
// Replaces approximategps_tpu/ops/svgp_epilogue.py::_bwd_fused (:271) for f32
// and 1 <= D <= 8 (ops/svgp_epilogue.py::epilogue_part; svgp_epilogue_bwd.cu
// keeps f64 and the f32 SIMT kernels).  The same function and notation as
// there: with K0 = g(r2(Zs, Xs)) (M, B), Se exactly symmetric and the
// cotangents dmu, dvar (B,),
//
//     Se_bar = (K0 o dvar) K0^T,   ae_bar = K0 dmu,
//     W      = (2 (Se K0) o dvar + ae (x) dmu) o g'(r2),
//     Xs_bar = 2 (xs o colsum W - W^T Zs),   Zs_bar = 2 (zs o rowsum W - W Xs).
//
// What bounds it on the H100: T = Se K0 is M^2 B FMAs (W needs every entry)
// and the symmetric Se_bar M^2 B / 2, 3x each in 3xTF32: at (M, B, D) =
// (2048, 16384, 8), 3.09e11 FMAs, 1.249 ms at 495 TFLOP/s (the SIMT count,
// 1.5 M^2 B FMAs at 67 TFLOP/s: 3.090 ms).  Bytes are far below (Se read,
// Se_bar written: 32 MB, 0.01 ms).
//
// The design, in the structure of the SIMT kernels (scratch partials and
// fixed-order finish kernels, no atomics: results repeat bitwise):
//   1. split_se (svgp_epilogue_mma.cuh): Se into TF32 halves in wgmma's
//      layout, once a call; w_tiles_mma, a block of 128 points: for each
//      128-wide tile of inducing columns, T^T on the tile by wgmma over all M
//      keys (A = K0^T in registers, B = Se's split stages copied into a ring
//      in shared memory), then on the accumulators W (g and g' from one exp), and from
//      W on the SIMT units: per point colsum and W^T Zs, kept in registers
//      over all tiles, so the block writes Xs_bar itself; per inducing row
//      rowsum, W Xs and K0 dmu over the block's 128 points (a shuffle sum over
//      a warp's 16 points, then the 8 warps in order through shared memory),
//      into scratch.
//   2. se_bar_mma, a block per upper tile pair (ta <= tb) of 128 x 128 and
//      depth part: A = (K0 o dvar) of tile ta in registers, B = K0 of tile tb
//      generated into shared memory (each lane writes the entries of its
//      wgmma core-matrix slot, so the stores do not conflict), keys = the
//      part's points (scaled and padded once a call by pad_points, copied
//      by cp.async two stages ahead).  B is double-buffered: the next
//      stage's is generated while this stage's products run.  The depth is
//      split into parts so that the blocks fill whole waves of the card
//      (Plan).
//   3. finish_z (Zs_bar, ae_bar over the point blocks in order) and
//      finish_se (the depth parts in order, mirrored from the upper tile:
//      Se_bar is exactly symmetric).
// The coordinates are scaled by coord_scale (the SE exponent folded in);
// the sums that carry a coordinate are scaled back by its inverse.
//
// Limits of the checks (tests/test_torch_cuda.py, chip_smoke.py phase 3):
// 1e-3 of each cotangent's max|plain| in f32, two runs equal bitwise.

#include <cuda_runtime.h>

#include "svgp_epilogue_mma.cuh"

namespace {

using namespace agp::epi;

template <int DP>
__global__ void split_se_kernel(const float* __restrict__ se, const float* __restrict__ zs,
                                unsigned* __restrict__ bhi, unsigned* __restrict__ blo,
                                float* __restrict__ zsp, int M, int D, float cs) {
  split_se<DP, false>((long long)blockIdx.x * blockDim.x + threadIdx.x, se, zs, bhi, blo, zsp, M,
                      D, cs);
}

constexpr int FIN = 256;  // threads a block of the finish kernels

// Shared memory of a w_tiles_mma block (dynamic: 200.5 KB at DP = 8).
template <int DP>
struct WSmem {
  Stage<DP> ring[RING];  // after a tile's products, the warps' column sums
  float hold[HOLD];      // the groups' totals
  float za[NA * DP];     // the tile's inducing points (scaled)
  float aa[NA];          // and their ae
};

// (1) pz[((blockIdx.x (D + 2) + d) M + a]: d < D holds sum_j W[a, j] x_j[d]
// (scaled), d = D the rowsum, d = D + 1 sum_j K0[a, j] dmu_j, over the
// block's points; xbar written whole.
template <int DP, int MAP>
__global__ void __launch_bounds__(NTH, 1)
    w_tiles_mma(const float* __restrict__ xs, const float* __restrict__ zs,
                const float* __restrict__ ae, const unsigned* __restrict__ bhi,
                const unsigned* __restrict__ blo, const float* __restrict__ zsp,
                const float* __restrict__ dmu, const float* __restrict__ dvar,
                float* __restrict__ xbar, float* __restrict__ pz, int B, int M, int D) {
  constexpr int NV = DP + 2;
  static_assert(NWARPS * NV * NA * sizeof(float) <= sizeof(Stage<DP>[RING]), "red fits the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WSmem<DP>& sm = *reinterpret_cast<WSmem<DP>*>(smem_raw);
  float* za = sm.za;
  float* aa = sm.aa;
  float* red = reinterpret_cast<float*>(sm.ring);  // (NWARPS, DP + 2, NA)
  constexpr float CS = agp::coord_scale<MAP>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = blockIdx.x * ROWS + warp * 16 + g, rb = ra + 8;
  float xa[DP], xb[DP];
  load_point<DP, MAP>(xs, ra, B, D, xa);
  load_point<DP, MAP>(xs, rb, B, D, xb);
  // zero past B: such points' W and K0 dmu vanish
  const float dva = ra < B ? dvar[ra] : 0.f, dvb = rb < B ? dvar[rb] : 0.f;
  const float dma = ra < B ? dmu[ra] : 0.f, dmb = rb < B ? dmu[rb] : 0.f;
  float pa[DP + 1], pb[DP + 1];  // per point: sum_a W z_a (scaled), then colsum
#pragma unroll
  for (int d = 0; d <= DP; ++d) pa[d] = pb[d] = 0.f;
  for (int a0 = 0; a0 < M; a0 += NA) {
    __syncthreads();  // the previous tile's epilogue has read za, aa and red
    for (int e = tid; e < NA * DP; e += NTH) {
      const int a = a0 + e / DP, d = e % DP;
      za[e] = a < M && d < D ? CS * zs[(size_t)a * D + d] : 0.f;
    }
    for (int e = tid; e < NA; e += NTH) aa[e] = a0 + e < M ? ae[a0 + e] : 0.f;
    float acc[NA / 2];
    se_k0_tile<DP, MAP, false>(acc, sm.ring, sm.hold, bhi, blo, zsp, M, a0, xa, xb);
    __syncthreads();  // every warp's products are done: red may take the ring
#pragma unroll
    for (int n = 0; n < NA / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        const float* z = za + col * DP;
        float ka, kb, dga, dgb;
        agp::fast_map_both_scaled<MAP>(sq_dist<DP>(xa, z), ka, dga);
        agp::fast_map_both_scaled<MAP>(sq_dist<DP>(xb, z), kb, dgb);
        // past M: T = 0 and ae = 0, so W = 0 (K0 dmu there is never written)
        const float wa = (2.f * acc[4 * n + j] * dva + aa[col] * dma) * dga;
        const float wb = (2.f * acc[4 * n + 2 + j] * dvb + aa[col] * dmb) * dgb;
        float cv[NV];
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          pa[d] = fmaf(wa, z[d], pa[d]);
          pb[d] = fmaf(wb, z[d], pb[d]);
          cv[d] = fmaf(wa, xa[d], wb * xb[d]);
        }
        pa[DP] += wa;
        pb[DP] += wb;
        cv[DP] = wa + wb;
        cv[DP + 1] = fmaf(ka, dma, kb * dmb);
        // the warp's 16 points: the 8 lanes of one t, in a fixed order
#pragma unroll
        for (int v = 0; v < NV; ++v) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) cv[v] += __shfl_xor_sync(0xffffffffu, cv[v], off);
        }
        if (g == 0) {
#pragma unroll
          for (int v = 0; v < NV; ++v) red[(warp * NV + v) * NA + col] = cv[v];
        }
      }
    }
    __syncthreads();
    // the block's column sums, warps in order
    for (int o = tid; o < NV * NA; o += NTH) {
      const int v = o / NA, col = o % NA, a = a0 + col;
      if (a >= M || (v >= D && v < DP)) continue;
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += red[(w * NV + v) * NA + col];
      const int slot = v < D ? v : D + (v - DP);
      pz[((size_t)blockIdx.x * (D + 2) + slot) * M + a] = s;
    }
  }
  // the four lanes of a point, in a fixed order
#pragma unroll
  for (int d = 0; d <= DP; ++d) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      pa[d] += __shfl_xor_sync(0xffffffffu, pa[d], off);
      pb[d] += __shfl_xor_sync(0xffffffffu, pb[d], off);
    }
  }
  if (t == 0) {
    // Xs_bar = 2 (x colsum - W^T Zs) = (2 / CS) (x' colsum - W^T Zs')
    constexpr float k2 = 2.f / CS;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d >= D) break;
      if (ra < B) xbar[(size_t)ra * D + d] = k2 * fmaf(xa[d], pa[DP], -pa[d]);
      if (rb < B) xbar[(size_t)rb * D + d] = k2 * fmaf(xb[d], pb[DP], -pb[d]);
    }
  }
}

// Shared memory of a se_bar_mma block (dynamic: 67 KB at DP = 8): B of two
// stages (one multiplied while the next is generated) and the points of
// three (copied two stages ahead).
template <int DP>
struct SeSmem {
  unsigned bhi[2][TJ / 8 * STEP];
  unsigned blo[2][TJ / 8 * STEP];
  float xk[3][TJ * DP];  // the stages' points (scaled)
  float dv[3][TJ];       // and their dvar, 0 past B
};

// (2) Block (pair, s): the part over points [s len, (s + 1) len) of the
// Se_bar tile (ta, tb), ta <= tb, into part[((s npairs + pair) NA + r) NA + c].
// xsp, dvp: the points (scaled) and dvar, zero-padded to the parts' end.
template <int DP, int MAP>
__global__ void __launch_bounds__(NTH, 1)
    se_bar_mma(const float* __restrict__ zs, const float* __restrict__ xsp,
               const float* __restrict__ dvp, float* __restrict__ part, int M, int D, int nt,
               int len) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SeSmem<DP>& sm = *reinterpret_cast<SeSmem<DP>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = blockIdx.x, s = blockIdx.y, npairs = gridDim.x;
  int ta = 0, rem = pair;
  while (rem >= nt - ta) {
    rem -= nt - ta;
    ++ta;
  }
  const int tb = ta + rem;
  const int a0 = ta * NA, b0 = tb * NA;
  const int p0 = s * len, nst = len / TJ;
  // A's rows: inducing points ra, rb of tile ta; B's columns this lane
  // generates: c = 8 (2 warp + i) + g of tile tb, i < 2
  const int ra = a0 + warp * 16 + g, rb = ra + 8;
  float za[DP], zb[DP], zc[2][DP];
  load_point<DP, MAP>(zs, ra, M, D, za);
  load_point<DP, MAP>(zs, rb, M, D, zb);
  load_point<DP, MAP>(zs, b0 + 16 * warp + g, M, D, zc[0]);
  load_point<DP, MAP>(zs, b0 + 16 * warp + 8 + g, M, D, zc[1]);

  // stage i's points into slot i % 3; a group is committed either way
  auto copy_stage = [&](int i) {
    if (i < nst) {
      const float* gx = xsp + (size_t)(p0 + i * TJ) * DP;
      for (int q = tid; q < TJ * DP / 4; q += NTH) cp_async16(sm.xk[i % 3] + 4 * q, gx + 4 * q);
      for (int q = tid; q < TJ / 4; q += NTH)
        cp_async16(sm.dv[i % 3] + 4 * q, dvp + p0 + i * TJ + 4 * q);
    }
    cp_async_commit();
  };
  // step u of stage i's B = K0 of tile tb on the stage's points: lane (g, t)
  // fills column slot g and key rows t, t + 4 (points 2t, 2t + 1), so a
  // warp's 32 stores are 32 consecutive words.  Padded points carry dvar = 0
  // in A, so their B rows need no mask.
  auto gen_b = [&](int i, int u) {
    unsigned* bh = sm.bhi[i & 1];
    unsigned* bl = sm.blo[i & 1];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* x = sm.xk[i % 3] + (8 * u + 2 * t + q) * DP;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float k = agp::fast_map_scaled<MAP, false>(sq_dist<DP>(zc[j], x));
        const int o = u * STEP + agp::wgmma_b_offset(t + 4 * q, 8 * (2 * warp + j) + g);
        agp::tf32_split(k, bh[o], bl[o]);
      }
    }
  };

  // two-level summation (svgp_epilogue_mma.cuh), the totals in registers
  float acc[NA / 2], tot[NA / 2];
#pragma unroll
  for (int k = 0; k < NA / 2; ++k) acc[k] = tot[k] = 0.f;
  copy_stage(0);
  copy_stage(1);
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int u = 0; u < TJ / 8; ++u) gen_b(0, u);
  for (int k = 0; k < nst; ++k) {
    cp_async_wait<0>();  // this thread's copies of stage k + 1's points
    fence_proxy_async();  // this thread's B of stage k, for wgmma
    // B of stage k and the points of stage k + 1 are visible, and every
    // warp's products of stage k - 1 are done: their B buffer takes stage
    // k + 1, and the points of stage k - 1 take stage k + 2
    __syncthreads();
    copy_stage(k + 2);
    const bool next = k + 1 < nst;
    // two batches of two steps, A double-buffered; B of stage k + 1 is
    // generated while each batch runs on the tensor cores
    unsigned ahi[2][2][4], alo[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
        a_fragment<DP, MAP>(sm.xk[k % 3], za, zb, 2 * h + u, t, ahi[h][u], alo[h][u],
                            sm.dv[k % 3]);
      agp::wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const unsigned long long dh = agp::wgmma_desc(sm.bhi[k & 1] + (2 * h + u) * STEP);
        const unsigned long long dl = agp::wgmma_desc(sm.blo[k & 1] + (2 * h + u) * STEP);
        agp::wgmma_tf32<NA>(acc, alo[h][u], dh, 1);
        agp::wgmma_tf32<NA>(acc, ahi[h][u], dl, 1);
        agp::wgmma_tf32<NA>(acc, ahi[h][u], dh, 1);
      }
      agp::wgmma_commit();
      if (next) {
        gen_b(k + 1, 2 * h);
        gen_b(k + 1, 2 * h + 1);
      }
    }
    agp::wgmma_wait<0>();
    if (k % GROUP == GROUP - 1 || k + 1 == nst) {
#pragma unroll
      for (int q = 0; q < NA / 2; ++q) {
        agp::reg_fence(acc[q]);
        tot[q] += acc[q];
        acc[q] = 0.f;
      }
    }
  }
  float* out = part + ((size_t)s * npairs + pair) * NA * NA;
  const int r = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NA / 8; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(out + (size_t)r * NA + c) = make_float2(tot[4 * n], tot[4 * n + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(r + 8) * NA + c) =
        make_float2(tot[4 * n + 2], tot[4 * n + 3]);
  }
}

// The points scaled and padded to (np, DP), dvar padded to np, for se_bar_mma.
template <int DP>
__global__ void pad_points(const float* __restrict__ xs, const float* __restrict__ dvar,
                           float* __restrict__ xsp, float* __restrict__ dvp, int B, int D, int np,
                           float cs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
#pragma unroll
  for (int d = 0; d < DP; ++d) xsp[(size_t)i * DP + d] = i < B && d < D ? cs * xs[(size_t)i * D + d] : 0.f;
  dvp[i] = i < B ? dvar[i] : 0.f;
}

// The sizes and scratch layout of one call.  Se_bar's depth is split into
// ns parts, ns chosen so that its blocks fill whole waves of the card: the
// least ceil(npairs ns / slots) / ns for ns <= 8, slots the blocks that run
// at once (more parts cost finish_se a pass over M^2 each).
struct Plan {
  int nJ, nt, npairs, ns, len;
  size_t pz, part, split, points, total;  // scratch offsets and size, in floats
  Plan(int B, int M, int D, int DP, int slots) {
    nJ = (B + ROWS - 1) / ROWS;
    nt = (M + NA - 1) / NA;
    npairs = nt * (nt + 1) / 2;
    const int stages = (B + TJ - 1) / TJ;
    ns = 1;
    double best = 0;
    for (int n = 1; n <= min(8, stages); ++n) {
      const double cost = (double)((npairs * (long long)n + slots - 1) / slots) / n;
      if (n == 1 || cost < best) best = cost, ns = n;
    }
    len = (stages + ns - 1) / ns * TJ;  // points a part covers
    ns = (B + len - 1) / len;
    // each region 128-byte aligned: float2 stores, cp.async's 16-byte copies
    auto up = [](size_t v) { return (v + 31) / 32 * 32; };
    pz = 0;
    part = up(pz + (size_t)nJ * (D + 2) * M);
    split = up(part + (size_t)ns * npairs * NA * NA);
    points = up(split + sweep_scratch(M, DP));
    total = points + (size_t)ns * len * (DP + 1);
  }
};

template <int DP>
int slots() {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(se_bar_mma<DP, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sizeof(SeSmem<DP>));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, se_bar_mma<DP, 0>, NTH,
                                                sizeof(SeSmem<DP>));
  return sms * max(per_sm, 1);
}

int dp_of(int D) { return D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8; }

int slots_for(int D) {
  switch (dp_of(D)) {
    case 1: return slots<1>();
    case 2: return slots<2>();
    case 4: return slots<4>();
    default: return slots<8>();
  }
}

// (3) Zs_bar[a, d] = 2 (z_a[d] rowsum_a - inv_cs sum_j W[a, j] x'_j[d]) for
// d < D and ae_bar[a] = sum_j K0[a, j] dmu_j, the point blocks in order.
__global__ void finish_z(const float* __restrict__ zs, const float* __restrict__ pz,
                         float* __restrict__ zbar, float* __restrict__ aebar, int M, int D,
                         int nJ, float inv_cs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * (D + 1)) return;
  const int a = idx % M, d = idx / M;
  if (d == D) {
    float kd = 0.f;
    for (int b = 0; b < nJ; ++b) kd += pz[((size_t)b * (D + 2) + D + 1) * M + a];
    aebar[a] = kd;
    return;
  }
  float rs = 0.f, wx = 0.f;
  for (int b = 0; b < nJ; ++b) {
    rs += pz[((size_t)b * (D + 2) + D) * M + a];
    wx += pz[((size_t)b * (D + 2) + d) * M + a];
  }
  zbar[(size_t)a * D + d] = 2.f * fmaf(zs[(size_t)a * D + d], rs, -inv_cs * wx);
}

// Se_bar[a, b] from the upper tile of (min(a, b), max(a, b)), the depth
// parts in order; exactly symmetric.
__global__ void finish_se(const float* __restrict__ part, float* __restrict__ sebar, int M,
                          int nt, int npairs, int ns) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * M) return;
  const int a = (int)(idx / M), b = (int)(idx % M);
  const int p = min(a, b), q = max(a, b);
  const int tp = p / NA, tq = q / NA;
  const int pair = tp * nt - tp * (tp - 1) / 2 + (tq - tp);
  const size_t off = (size_t)(p % NA) * NA + q % NA;
  float s = 0.f;
  for (int k = 0; k < ns; ++k) s += part[((size_t)k * npairs + pair) * NA * NA + off];
  sebar[idx] = s;
}

template <int DP, int MAP>
cudaError_t launch(const float* xs, const float* zs, const float* se, const float* ae,
                   const float* dmu, const float* dvar, float* xbar, float* zbar, float* sebar,
                   float* aebar, float* scratch, int B, int M, int D, cudaStream_t s) {
  const Plan pl(B, M, D, DP, slots<DP>());
  float* pz = scratch + pl.pz;
  float* part = scratch + pl.part;
  unsigned* bhi = reinterpret_cast<unsigned*>(scratch + pl.split);
  unsigned* blo = bhi + split_words(M);
  float* zsp = scratch + pl.split + 2 * split_words(M);
  const long long n = split_words(M);
  split_se_kernel<DP><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(se, zs, bhi, blo, zsp, M, D,
                                                                  agp::coord_scale<MAP>());
  constexpr int smem = sizeof(WSmem<DP>);
  cudaError_t err = cudaFuncSetAttribute(w_tiles_mma<DP, MAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  w_tiles_mma<DP, MAP><<<pl.nJ, NTH, smem, s>>>(xs, zs, ae, bhi, blo, zsp, dmu, dvar, xbar, pz,
                                                B, M, D);
  float* xsp = scratch + pl.points;
  float* dvp = xsp + (size_t)pl.ns * pl.len * DP;
  const int np = pl.ns * pl.len;
  pad_points<DP><<<(np + FIN - 1) / FIN, FIN, 0, s>>>(xs, dvar, xsp, dvp, B, D, np,
                                                     agp::coord_scale<MAP>());
  constexpr int se_smem = sizeof(SeSmem<DP>);
  if ((err = cudaFuncSetAttribute(se_bar_mma<DP, MAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  se_smem)) != cudaSuccess)
    return err;
  se_bar_mma<DP, MAP><<<dim3(pl.npairs, pl.ns), NTH, se_smem, s>>>(zs, xsp, dvp, part, M, D,
                                                                   pl.nt, pl.len);
  finish_z<<<(M * (D + 1) + FIN - 1) / FIN, FIN, 0, s>>>(zs, pz, zbar, aebar, M, D, pl.nJ,
                                                         1.f / agp::coord_scale<MAP>());
  const size_t mm = (size_t)M * M;
  finish_se<<<(unsigned)((mm + FIN - 1) / FIN), FIN, 0, s>>>(part, sebar, M, pl.nt, pl.npairs,
                                                            pl.ns);
  return cudaGetLastError();
}

template <int DP>
cudaError_t by_map(int kmap, const float* xs, const float* zs, const float* se, const float* ae,
                   const float* dmu, const float* dvar, float* xbar, float* zbar, float* sebar,
                   float* aebar, float* scratch, int B, int M, int D, cudaStream_t s) {
  switch (kmap) {
    case 0: return launch<DP, 0>(xs, zs, se, ae, dmu, dvar, xbar, zbar, sebar, aebar, scratch, B, M, D, s);
    case 1: return launch<DP, 1>(xs, zs, se, ae, dmu, dvar, xbar, zbar, sebar, aebar, scratch, B, M, D, s);
    case 2: return launch<DP, 2>(xs, zs, se, ae, dmu, dvar, xbar, zbar, sebar, aebar, scratch, B, M, D, s);
    case 3: return launch<DP, 3>(xs, zs, se, ae, dmu, dvar, xbar, zbar, sebar, aebar, scratch, B, M, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of the scratch buffer the backward needs at (B, M, D).
long long agp_svgp_epilogue_bwd_mma_scratch_f32(int B, int M, int D) {
  if (B < 1 || M < 1 || D < 1 || D > 8) return 0;
  return (long long)Plan(B, M, D, dp_of(D), slots_for(D)).total;
}

// xs: (B, D), zs: (M, D) jointly centred; se: (M, M) exactly symmetric; ae:
// (M,); dmu, dvar: (B,); outputs xbar (B, D), zbar (M, D), sebar (M, M),
// aebar (M,); scratch of agp_svgp_epilogue_bwd_mma_scratch_f32(B, M, D)
// floats.  All row-major f32, D <= 8.  Returns a cudaError_t.
int agp_svgp_epilogue_bwd_mma_f32(const void* xs, const void* zs, const void* se,
                                  const void* ae, const void* dmu, const void* dvar, void* xbar,
                                  void* zbar, void* sebar, void* aebar, void* scratch, int B,
                                  int M, int D, int kmap, void* stream) {
  if (B < 1 || M < 1 || D < 1 || D > 8 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  using F = float;
  const F* x = static_cast<const F*>(xs);
  const F* z = static_cast<const F*>(zs);
  const F* S = static_cast<const F*>(se);
  const F* a = static_cast<const F*>(ae);
  const F* dm = static_cast<const F*>(dmu);
  const F* dv = static_cast<const F*>(dvar);
  F* xb = static_cast<F*>(xbar);
  F* zb = static_cast<F*>(zbar);
  F* sb = static_cast<F*>(sebar);
  F* ab = static_cast<F*>(aebar);
  F* sc = static_cast<F*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp_of(D)) {
    case 1: return by_map<1>(kmap, x, z, S, a, dm, dv, xb, zb, sb, ab, sc, B, M, D, s);
    case 2: return by_map<2>(kmap, x, z, S, a, dm, dv, xb, zb, sb, ab, sc, B, M, D, s);
    case 4: return by_map<4>(kmap, x, z, S, a, dm, dv, xb, zb, sb, ab, sc, B, M, D, s);
    default: return by_map<8>(kmap, x, z, S, a, dm, dv, xb, zb, sb, ab, sc, B, M, D, s);
  }
}

}  // extern "C"
