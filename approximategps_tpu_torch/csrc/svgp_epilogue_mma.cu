// Fused SVGP data-term epilogue, forward, f32 on the tensor cores.
//
// Replaces the forward of approximategps_tpu/ops/svgp_epilogue.py::
// svgp_data_epilogue (_epilogue_fwd_impl :201, _fwd_kernel :98) for f32 and
// 1 <= D <= 8 (ops/svgp_epilogue.py::epilogue_part; svgp_epilogue.cu keeps
// f64 and the f32 SIMT kernel):
//
//     K0 = g(r2(Zs, Xs))   (M, B),   mu = K0^T ae,   var = diag(K0^T Se K0),
//
// with K0 and Se K0 never written to device memory.
//
// What bounds it on the H100: the quadratic form over Se's upper triangle is
// M^2 B / 2 FMAs, 3x that in 3xTF32 on the tensor cores: at (M, B, D) =
// (2048, 16384, 8), 1.03e11 FMAs, 0.417 ms at 495 TFLOP/s (the SIMT count,
// M^2 B / 2 FMAs at 67 TFLOP/s: 1.039 ms).  The bytes (Se once, 16 MB) are
// 0.005 ms.
//
// The design (svgp_epilogue_mma.cuh): a small pass splits Se's weighted
// triangle into TF32 halves in wgmma's layout (split_se, 48 MB of traffic at
// M = 2048); then a block owns 128 points and loops over
// the 128-wide tiles of inducing columns a, so var and mu need no atomics and
// are summed in a fixed order.  For a tile, D[p, a] = sum_c K0[c, p] w Se[c, a]
// runs over the keys c from the tile's first column on, w = 2 below the
// diagonal, 1 on it, 0 above: one triangle of Se, half the products.  A
// (K0^T) is computed in registers straight into wgmma's A fragment (exact
// differences, the SE exponent folded into the coordinates, one ex2.approx an
// entry: fast_maps.cuh); B, Se's stage, is copied into a ring in shared
// memory two stages ahead.  The 128-column tile amortises an A entry's SIMT work (about 20
// instructions at D = 8) over 3 x 128 products; each entry is regenerated
// once a tile it feeds (M / 256 times on average).  Then, on the
// accumulators, var[p] += sum_a D[p, a] K0[a, p] and mu[p] += K0[a, p] ae[a],
// K0[a, p] recomputed in the accumulator's layout; the four lanes that share
// a point add their sums in a fixed order at the end.  Each block streams
// Se's triangle (8 MB at M = 2048) from L2.
//
// Limits of the checks (tests/test_torch_cuda.py, chip_smoke.py phase 3):
// 1e-4 of max|plain| for mu and var in f32, two runs equal bitwise.

#include <cuda_runtime.h>

#include "svgp_epilogue_mma.cuh"

namespace {

using namespace agp::epi;

template <int DP>
__global__ void split_se_kernel(const float* __restrict__ se, const float* __restrict__ zs,
                                unsigned* __restrict__ bhi, unsigned* __restrict__ blo,
                                float* __restrict__ zsp, int M, int D, float cs) {
  split_se<DP, true>((long long)blockIdx.x * blockDim.x + threadIdx.x, se, zs, bhi, blo, zsp, M,
                      D, cs);
}

// Shared memory of a block (dynamic: 200.5 KB at DP = 8).
template <int DP>
struct FwdSmem {
  Stage<DP> ring[RING];
  float hold[HOLD];    // the groups' totals
  float za[NA * DP];   // the tile's inducing points (scaled)
  float aa[NA];        // and their ae
};

template <int DP, int MAP>
__global__ void __launch_bounds__(NTH, 1)
    epilogue_fwd_mma(const float* __restrict__ xs, const float* __restrict__ zs,
                     const float* __restrict__ ae, const unsigned* __restrict__ bhi,
                     const unsigned* __restrict__ blo, const float* __restrict__ zsp,
                     float* __restrict__ mu, float* __restrict__ var, int B, int M, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<DP>& sm = *reinterpret_cast<FwdSmem<DP>*>(smem_raw);
  float* za = sm.za;
  float* aa = sm.aa;
  constexpr float CS = agp::coord_scale<MAP>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = blockIdx.x * ROWS + warp * 16 + g, rb = ra + 8;
  float xa[DP], xb[DP];
  load_point<DP, MAP>(xs, ra, B, D, xa);
  load_point<DP, MAP>(xs, rb, B, D, xb);
  float va = 0.f, vb = 0.f, ma = 0.f, mb = 0.f;
  for (int a0 = 0; a0 < M; a0 += NA) {
    __syncthreads();  // the previous tile's epilogue has read za and aa
    for (int e = tid; e < NA * DP; e += NTH) {
      const int a = a0 + e / DP, d = e % DP;
      za[e] = a < M && d < D ? CS * zs[(size_t)a * D + d] : 0.f;
    }
    for (int e = tid; e < NA; e += NTH) aa[e] = a0 + e < M ? ae[a0 + e] : 0.f;
    float acc[NA / 2];
    se_k0_tile<DP, MAP, true>(acc, sm.ring, sm.hold, bhi, blo, zsp, M, a0, xa, xb);
    // columns past M hold D = 0, ae = 0 and a finite K0: they add nothing
#pragma unroll
    for (int n = 0; n < NA / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t + j;
        const float* z = za + col * DP;
        const float ka = agp::fast_map_scaled<MAP, false>(sq_dist<DP>(xa, z));
        const float kb = agp::fast_map_scaled<MAP, false>(sq_dist<DP>(xb, z));
        va = fmaf(acc[4 * n + j], ka, va);
        vb = fmaf(acc[4 * n + 2 + j], kb, vb);
        ma = fmaf(ka, aa[col], ma);
        mb = fmaf(kb, aa[col], mb);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    va += __shfl_xor_sync(0xffffffffu, va, off);
    vb += __shfl_xor_sync(0xffffffffu, vb, off);
    ma += __shfl_xor_sync(0xffffffffu, ma, off);
    mb += __shfl_xor_sync(0xffffffffu, mb, off);
  }
  if (t == 0) {
    if (ra < B) var[ra] = va, mu[ra] = ma;
    if (rb < B) var[rb] = vb, mu[rb] = mb;
  }
}

template <int DP, int MAP>
cudaError_t launch(const float* xs, const float* zs, const float* se, const float* ae, float* mu,
                   float* var, float* scratch, int B, int M, int D, cudaStream_t s) {
  unsigned* bhi = reinterpret_cast<unsigned*>(scratch);
  unsigned* blo = bhi + split_words(M);
  float* zsp = scratch + 2 * split_words(M);
  const long long n = split_words(M);
  split_se_kernel<DP><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(se, zs, bhi, blo, zsp, M, D,
                                                                 agp::coord_scale<MAP>());
  constexpr int smem = sizeof(FwdSmem<DP>);
  const cudaError_t err = cudaFuncSetAttribute(
      epilogue_fwd_mma<DP, MAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  epilogue_fwd_mma<DP, MAP><<<(B + ROWS - 1) / ROWS, NTH, smem, s>>>(xs, zs, ae, bhi, blo, zsp,
                                                                     mu, var, B, M, D);
  return cudaGetLastError();
}

template <int DP>
cudaError_t by_map(int kmap, const float* xs, const float* zs, const float* se, const float* ae,
                   float* mu, float* var, float* scratch, int B, int M, int D, cudaStream_t s) {
  switch (kmap) {
    case 0: return launch<DP, 0>(xs, zs, se, ae, mu, var, scratch, B, M, D, s);
    case 1: return launch<DP, 1>(xs, zs, se, ae, mu, var, scratch, B, M, D, s);
    case 2: return launch<DP, 2>(xs, zs, se, ae, mu, var, scratch, B, M, D, s);
    case 3: return launch<DP, 3>(xs, zs, se, ae, mu, var, scratch, B, M, D, s);
    default: return cudaErrorInvalidValue;
  }
}

int dp_of(int D) { return D == 1 ? 1 : D == 2 ? 2 : D <= 4 ? 4 : 8; }

}  // namespace

extern "C" {

// Floats of the scratch buffer the forward needs at (M, D).
long long agp_svgp_epilogue_mma_scratch_f32(int M, int D) {
  return M < 1 || D < 1 || D > 8 ? 0 : sweep_scratch(M, dp_of(D));
}

// xs: (B, D), zs: (M, D) jointly centred; se: (M, M) exactly symmetric (one
// triangle is read); ae: (M,); mu, var: (B,) outputs; scratch of
// agp_svgp_epilogue_mma_scratch_f32(M, D) floats.  All row-major f32,
// D <= 8.  Returns a cudaError_t.
int agp_svgp_epilogue_mma_f32(const void* xs_, const void* zs_, const void* se_, const void* ae_,
                              void* mu_, void* var_, void* scratch_, int B, int M, int D,
                              int kmap, void* stream) {
  if (B < 1 || M < 1 || D < 1 || D > 8 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  const float* xs = static_cast<const float*>(xs_);
  const float* zs = static_cast<const float*>(zs_);
  const float* se = static_cast<const float*>(se_);
  const float* ae = static_cast<const float*>(ae_);
  float* mu = static_cast<float*>(mu_);
  float* var = static_cast<float*>(var_);
  float* sc = static_cast<float*>(scratch_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp_of(D)) {
    case 1: return by_map<1>(kmap, xs, zs, se, ae, mu, var, sc, B, M, D, s);
    case 2: return by_map<2>(kmap, xs, zs, se, ae, mu, var, sc, B, M, D, s);
    case 4: return by_map<4>(kmap, xs, zs, se, ae, mu, var, sc, B, M, D, s);
    default: return by_map<8>(kmap, xs, zs, se, ae, mu, var, sc, B, M, D, s);
  }
}

}  // extern "C"
