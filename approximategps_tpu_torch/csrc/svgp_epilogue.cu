// Fused SVGP data-term epilogue, forward.
//
// Replaces the forward of approximategps_tpu/ops/svgp_epilogue.py::
// svgp_data_epilogue (_epilogue_fwd_impl, _fwd_kernel, _k_tile):
//
//     K0 = g(r2(Zs, Xs))   (M, B),   mu = K0^T ae,   var = diag(K0^T Se K0),
//
// with the (M, B) Gram and Se K0 never written to device memory.
//
// What bounds it on the H100: M^2 FMAs per test point for Se K0 (8.4 TFLOP
// for 10^6 points at M = 2048), run on the SIMT FP32/FP64 units, and the Se
// reads: every block streams all of Se (16 MB f32 at M = 2048) from L2,
// which holds it whole, so the sweep reads M^2 / BB values of Se from L2
// per test point.  The design: one block of 512 threads owns BB test points
// (BB = 16, 8 or 4, the largest whose (BB, M) K0 tile fits shared memory,
// raised past 48 KB with cudaFuncAttributeMaxDynamicSharedMemorySize) and
// loops over all M rows, so var needs no atomics:
//   1. K0[b, a] for its BB points is computed into shared memory (b-major,
//      so a warp's lanes read consecutive a) by the centred matmul identity
//      r2 = |z|^2 + |x|^2 - 2 z.x of _k_tile; the caller centres Xs and Zs
//      jointly, as _pad_inputs does.
//   2. Each warp takes RA rows a of Se at a time; its lanes read the rows
//      coalesced and accumulate t[r][b] = sum_c Se[a0 + r, c] K0[b, c] for
//      all BB points (each shared-memory read of K0 feeds RA FMAs, so the
//      loop is not bound by shared-memory bandwidth), reduce across lanes
//      with shuffles, and lane b adds K0[b, a] t[r][b] to var and
//      K0[b, a] ae[a] to mu.  Only the upper triangle of the symmetric Se
//      is read, which halves both the FMAs and the L2 traffic.
//   3. A shared-memory reduction over warps writes mu and var.
// Larger tiles per block (fewer L2 passes over Se) and tensor-core products
// are later work.  Ragged B is masked in the kernel; M needs no padding.

#include <cuda_runtime.h>

#include "kernel_maps.cuh"

namespace {

constexpr int NT = 512;
constexpr int NWARPS = NT / 32;

template <typename T, int BB>
__global__ void __launch_bounds__(NT)
epilogue_fwd(const T* __restrict__ xs, const T* __restrict__ zs, const T* __restrict__ se,
             const T* __restrict__ ae, T* __restrict__ mu, T* __restrict__ var, int B, int M,
             int D, int kmap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // (BB, M), b-major
  T* xt = Ks + (size_t)BB * M;             // (BB, D)
  T* xx = xt + BB * D;                     // (BB,)
  T* red = xx + BB;                        // (2, NWARPS, BB)
  // rows of Se a warp takes at once: RA x BB accumulators stay within the
  // 128 registers a thread has at 512 threads a block
  constexpr int RA = sizeof(T) == 4 ? 4 : 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * BB;

  for (int e = tid; e < BB * D; e += NT) {
    const int b = e / D;
    xt[e] = b0 + b < B ? xs[(size_t)(b0 + b) * D + e % D] : T(0);
  }
  __syncthreads();
  if (tid < BB) {
    T s = T(0);
    for (int d = 0; d < D; ++d) s = fma(xt[tid * D + d], xt[tid * D + d], s);
    xx[tid] = s;
  }
  __syncthreads();

  // 1. the K0 tile; columns of points past B are zero and never written out
  for (int e = tid; e < BB * M; e += NT) {
    const int b = e / M, a = e % M;
    T k = T(0);
    if (b0 + b < B) {
      T zz = T(0), zx = T(0);
      for (int d = 0; d < D; ++d) {
        const T zd = zs[(size_t)a * D + d];
        zz = fma(zd, zd, zz);
        zx = fma(zd, xt[b * D + d], zx);
      }
      T r2 = zz + xx[b] - T(2) * zx;
      k = agp::kernel_map(kmap, r2 > T(0) ? r2 : T(0));
    }
    Ks[e] = k;
  }
  __syncthreads();

  // 2. rows of Se, RA at a time per warp (each K0 value read from shared
  //    memory feeds RA FMAs); lane b < BB keeps point b's partials.  Se is
  //    symmetric, so row a is read from its diagonal on: sum_c Se[a,c] K[c]
  //    over all c is replaced by Se[a,a] K[a] + 2 sum_{c>a} Se[a,c] K[c],
  //    whose sum over a weighted by K[a] is the same quadratic form.
  T vacc = T(0), macc = T(0);
  for (int a0 = warp * RA; a0 < M; a0 += NWARPS * RA) {
    T t[RA][BB];
#pragma unroll
    for (int r = 0; r < RA; ++r)
#pragma unroll
      for (int b = 0; b < BB; ++b) t[r][b] = T(0);
    // the first 32 columns from the aligned start hold the diagonal entries
    // of all RA rows: weight 1/2 on the diagonal, 0 left of it (the sum is
    // doubled below)
    const int cs = a0 & ~31;
    {
      const int c = cs + lane;
      T s[RA];
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const int a = a0 + r;
        s[r] = a < M && c < M && c >= a ? se[(size_t)a * M + c] * (c == a ? T(0.5) : T(1))
                                        : T(0);
      }
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const T k = c < M ? Ks[b * M + c] : T(0);
#pragma unroll
        for (int r = 0; r < RA; ++r) t[r][b] = fma(s[r], k, t[r][b]);
      }
    }
    // the rest, with the next 32 columns' loads issued before this step's FMAs
    T s[RA];
    int c = cs + 32 + lane;
#pragma unroll
    for (int r = 0; r < RA; ++r)
      s[r] = a0 + r < M && c < M ? se[(size_t)(a0 + r) * M + c] : T(0);
    for (; c < M; c += 32) {
      T sn[RA];
#pragma unroll
      for (int r = 0; r < RA; ++r)
        sn[r] = a0 + r < M && c + 32 < M ? se[(size_t)(a0 + r) * M + c + 32] : T(0);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const T k = Ks[b * M + c];
#pragma unroll
        for (int r = 0; r < RA; ++r) t[r][b] = fma(s[r], k, t[r][b]);
      }
#pragma unroll
      for (int r = 0; r < RA; ++r) s[r] = sn[r];
    }
#pragma unroll
    for (int r = 0; r < RA; ++r)
#pragma unroll
      for (int b = 0; b < BB; ++b)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          t[r][b] += __shfl_xor_sync(0xffffffffu, t[r][b], off);
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int a = a0 + r;
      if (a >= M) break;
      const T aa = ae[a];
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (lane == b) {
          const T kab = Ks[b * M + a];
          vacc = fma(kab, T(2) * t[r][b], vacc);
          macc = fma(kab, aa, macc);
        }
      }
    }
  }

  // 3. reduce over warps
  if (lane < BB) {
    red[warp * BB + lane] = vacc;
    red[(NWARPS + warp) * BB + lane] = macc;
  }
  __syncthreads();
  if (tid < BB && b0 + tid < B) {
    T v = T(0), m = T(0);
    for (int w = 0; w < NWARPS; ++w) {
      v += red[w * BB + tid];
      m += red[(NWARPS + w) * BB + tid];
    }
    var[b0 + tid] = v;
    mu[b0 + tid] = m;
  }
}

template <typename T, int BB>
int launch(const T* xs, const T* zs, const T* se, const T* ae, T* mu, T* var, int B, int M,
           int D, int kmap, cudaStream_t s) {
  // keep in step with ops/svgp_epilogue.py::_smem_bytes
  const size_t smem = ((size_t)BB * M + BB * D + BB + 2 * NWARPS * BB) * sizeof(T);
  cudaError_t err =
      cudaFuncSetAttribute(epilogue_fwd<T, BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return err;
  epilogue_fwd<T, BB><<<(B + BB - 1) / BB, NT, smem, s>>>(xs, zs, se, ae, mu, var, B, M, D,
                                                          kmap);
  return cudaGetLastError();
}

template <typename T>
int svgp_epilogue(const void* xs, const void* zs, const void* se, const void* ae, void* mu,
                  void* var, int B, int M, int D, int block_b, int kmap, void* stream) {
  if (B < 1 || M < 1 || D < 1 || !agp::valid_kernel_map(kmap)) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xs);
  const T* z = static_cast<const T*>(zs);
  const T* S = static_cast<const T*>(se);
  const T* a = static_cast<const T*>(ae);
  T* m = static_cast<T*>(mu);
  T* v = static_cast<T*>(var);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_b) {
    case 16:
      return launch<T, 16>(x, z, S, a, m, v, B, M, D, kmap, s);
    case 8:
      return launch<T, 8>(x, z, S, a, m, v, B, M, D, kmap, s);
    case 4:
      return launch<T, 4>(x, z, S, a, m, v, B, M, D, kmap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// xs: (B, D), zs: (M, D) jointly centred; se: (M, M); ae: (M,); mu, var:
// (B,) outputs.  All row-major, one dtype.  Returns a cudaError_t.
int agp_svgp_epilogue_f32(const void* xs, const void* zs, const void* se, const void* ae,
                          void* mu, void* var, int B, int M, int D, int block_b, int kmap,
                          void* stream) {
  return svgp_epilogue<float>(xs, zs, se, ae, mu, var, B, M, D, block_b, kmap, stream);
}

int agp_svgp_epilogue_f64(const void* xs, const void* zs, const void* se, const void* ae,
                          void* mu, void* var, int B, int M, int D, int block_b, int kmap,
                          void* stream) {
  return svgp_epilogue<double>(xs, zs, se, ae, mu, var, B, M, D, block_b, kmap, stream);
}

}  // extern "C"
