// The (L, L^-1) factorizations in f32 with one launch a panel step, a
// look-ahead diagonal step and the products on the tensor cores, for a Gram
// generated from points (row 1) and for a given matrix (row 4).
//
// Replaces, in f32, approximategps_tpu/ops/panel_chol.py::
// pallas_gram_chol_inv (_gram_chol_inv_kernel, _gram_panel, _chol_inv_rest,
// _fused_factor_inv) and ::pallas_chol_inv (_chol_inv_kernel), with
// gram_chol_inv.cu's host loop kept for f64:
//
//     K = sig2 * g(r2(Zs, Zs)) + jitter * I,   L = chol(K),   J = L^-1,
//     K = (A + A^T) / 2,                         L = chol(K),   J = L^-1,
//
// K never written whole to device memory, sig2 and jitter read from a
// two-element device array (the given matrix takes neither: the caller adds
// any jitter first), exact zeros above both diagonals, M padded to the panel
// with identity rows, results that repeat bitwise.  The two differ only in
// where K's tiles come from (tile_source): generated from the tile's points,
// or A's tile and the transposed one read and averaged.
//
// What bounds it on the H100: the chain of dependent panel steps.  Its
// operations, M^3/6 FMAs of the factor and as many of the inverse (at
// M = 2048 about 0.086 ms at f32's 67 TFLOP/s, 0.035 ms as 3xTF32 on the
// tensor cores), are small beside what the host loop of gram_chol_inv.cu spends at
// M = 2048 (2.7 ms): 32 panel steps of six dependent launches each, and in
// each step one block factoring the 64 x 64 diagonal block with one barrier
// a column (40 us a step, 1.28 ms of the 2.40 ms busy; PERF.md section 5).
//
// Design.  Panel step k (columns c0 = 64 k ..) is one launch, and the
// diagonal block of step k + 1 is factored inside launch k, so that launch
// k + 1 starts with its X = L_kk^-1 ready.  Launch k (k = -1 .. n) runs
// three kinds of blocks of one warpgroup each, chosen by blockIdx:
//   (A) tile i > k of panel k: C = K_ik - sum_{p<k} L_ip L_kp^T (the depth
//       split over blocks and one more block generating K_ik, each block's
//       partial tile written to scratch and the last to arrive summing them
//       in a fixed order), then
//       L_ik = C X_k^T.  The block that finishes tile k + 1 forms
//       T = L_{k+1,k} L_{k+1,k}^T for the look-ahead: C' = K_{k+1,k+1} -
//       (sum of (B)'s partials) - T, factored and inverted into
//       L_{k+1,k+1} and J_{k+1,k+1} = X_{k+1}.
//   (B) the partials of sum_{p<k} L_{k+1,p} L_{k+1,p}^T, the look-ahead's
//       depth; the last of them writes K_{k+1,k+1} minus their sum.  That
//       block and tile k + 1's finisher each leave their tile in scratch and
//       arrive at one counter: the second to arrive runs the look-ahead, so
//       no block waits for another and the launch needs no block resident
//       beside another.
//   (C) J's row block k - 1: J_{k-1,m} = -X_{k-1} sum_p L_{k-1,p} J_{p,m},
//       every m < k - 1, the depth split as in (A).
// Launch -1 only factors the first diagonal block, launch n only finishes
// J's last row block.  34 launches at M = 2048 in place of about 190.
// Partial sums are read back in split order and no value is summed by an
// atomic, so two runs give the same bits; the counters that tell the last
// block it is last are the only atomics.
//
// Products: 64 x 64 tiles, 64 keys a panel, as 3xTF32 wgmma m64n64k8
// (tf32_mma.cuh): A from registers (its rows from device memory, or the
// tile C itself: a D fragment is the A fragment of the next product with
// keys 2t, 2t + 1 in A's columns t, t + 4), B split once into TF32 hi and lo
// halves in shared memory, the next panel's B loaded while this one's
// products run.  K's tiles are generated from the tile's 128 points staged
// in shared memory (a thread's 32 entries share two rows and sixteen
// columns), or, for a given matrix, A's tile and its transposed partner are
// staged in shared memory by coalesced row reads and averaged there.  The diagonal step works on 16-wide sub-blocks: one warp
// factors each 16 x 16 block (the column through shared memory, one
// __syncwarp a column) and inverts it by columns while the other three
// update the rows below and form X's block rows; three barriers a sub-block
// (about 16 a step in place of 64).

#include <cuda_runtime.h>

#include <algorithm>

#include "kernel_maps.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int P = 64;        // panel width, tile edge
constexpr int NT = 128;      // threads a block: one warpgroup
constexpr int TILE = P * P;  // values of a partial tile
constexpr int STEP = 8 * P;  // words of B a step of 8 keys
constexpr int TARGET_BLOCKS = 264;  // blocks a launch aims for (two an SM)
constexpr int LDC = P + 1;   // the diagonal step's padded rows
constexpr int SB = 16;       // its sub-blocks
constexpr int LDY = SB + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// B row of key kk within a step of 8: A's columns t and t + 4 hold keys 2t and 2t + 1
__device__ __forceinline__ int key_row(int kk) { return (kk & 1) ? (kk >> 1) + 4 : (kk >> 1); }

__device__ __forceinline__ int b_offset(int key, int col) {
  return (key >> 3) * STEP + agp::wgmma_b_offset(key_row(key & 7), col);
}

struct Frag {
  unsigned hi[8][4], lo[8][4];
};

// B (64 keys x 64 columns) of one panel, 1024 vectors of four neighbours
// along its contiguous axis, eight a thread.  B(key, c) at B[c * ldb + key]
// (NT) or B[key * ldb + c] (NN).  Vector G (0 .. 31, warp-instruction index
// 8 w + q) of lane l takes, in NT, column (l & 7) + 8 (G & 7) and keys
// 4 L .. 4 L + 3 with L = 2 ((l >> 4) + 2 (G >> 3)) + ((l >> 3) & 1); in NN,
// key 16 (G >> 3) + (l >> 1) and columns from 4 (2 (G & 7) + (l & 1)): each warp
// instruction reads whole 32-byte sectors, and its stores to wgmma's layout
// (whose bank is (c & 7) 4 + (key row & 3)) meet at most two (NT) or four
// (NN) to a bank.
template <bool NN>
__device__ __forceinline__ void vec_coords(int q, int& key, int& col) {
  const int l = threadIdx.x & 31, G = 8 * (threadIdx.x >> 5) + q;
  if (NN) {
    key = 16 * (G >> 3) + (l >> 1);
    col = 4 * (2 * (G & 7) + (l & 1));
  } else {
    col = (l & 7) + 8 * (G & 7);
    key = 4 * (2 * ((l >> 4) + 2 * (G >> 3)) + ((l >> 3) & 1));
  }
}

template <bool NN>
__device__ __forceinline__ void load_b(const float* B, int ldb, float4 (&v)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int key, col;
    vec_coords<NN>(q, key, col);
    v[q] = *reinterpret_cast<const float4*>(NN ? B + (size_t)key * ldb + col
                                                : B + (size_t)col * ldb + key);
  }
}

template <bool NN>
__device__ __forceinline__ void store_b(const float4 (&v)[8], unsigned* bhi, unsigned* blo) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int key, col;
    vec_coords<NN>(q, key, col);
    const float x[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = NN ? b_offset(key, col + u) : b_offset(key + u, col);
      agp::tf32_split(x[u], bhi[o], blo[o]);
    }
  }
  fence_proxy_async();
}

// A fragments of one panel from row-major A (keys contiguous): rows ra, rb
__device__ __forceinline__ void a_from_global(const float* A, int lda, Frag& f) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* pa = A + (size_t)(16 * w + g) * lda + 2 * t;
  const float* pb = pa + (size_t)8 * lda;
  float2 x[8], y[8];  // every load in flight before the first split
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    x[s] = *reinterpret_cast<const float2*>(pa + 8 * s);
    y[s] = *reinterpret_cast<const float2*>(pb + 8 * s);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float h[4] = {x[s].x, y[s].x, x[s].y, y[s].y};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      agp::tf32_split_trunc(h[u], f.hi[s][u], f.lo[s][u]);
      agp::reg_fence(f.hi[s][u]);
      agp::reg_fence(f.lo[s][u]);
    }
  }
}

// A fragments of one panel from a tile held as D fragments
__device__ __forceinline__ void a_from_acc(const float (&c)[32], Frag& f) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float h[4] = {c[4 * s], c[4 * s + 2], c[4 * s + 1], c[4 * s + 3]};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      agp::tf32_split_trunc(h[u], f.hi[s][u], f.lo[s][u]);
      agp::reg_fence(f.hi[s][u]);
      agp::reg_fence(f.lo[s][u]);
    }
  }
}

// part = A B over one panel, 3xTF32 (A_lo B_hi + A_hi B_lo + A_hi B_hi a step)
__device__ __forceinline__ void panel_mma(float (&part)[32], const Frag& f, const unsigned* bhi,
                                          const unsigned* blo) {
  agp::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const unsigned long long dh = agp::wgmma_desc(bhi + s * STEP);
    const unsigned long long dl = agp::wgmma_desc(blo + s * STEP);
    agp::wgmma_tf32<64>(part, f.lo[s], dh, s > 0);
    agp::wgmma_tf32<64>(part, f.hi[s], dl, 1);
    agp::wgmma_tf32<64>(part, f.hi[s], dh, 1);
  }
  agp::wgmma_commit();
  agp::wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < 32; ++q) agp::reg_fence(part[q]);
}

// acc = sum over panels p0 .. p1-1 of A(rows, 64p ..) B(64p .., cols): A
// row-major with keys contiguous; B as load_b<NN> takes it.  A panel's
// products add into acc after it (two levels of summation).
template <bool NN>
__device__ void tile_product(const float* A, int lda, const float* B, int ldb, int p0, int p1,
                             float (&acc)[32], unsigned* bhi, unsigned* blo) {
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
  if (p0 >= p1) return;
  auto bptr = [&](int p) { return NN ? B + (size_t)p * P * ldb : B + (size_t)p * P; };
  float4 v[8];
  load_b<NN>(bptr(p0), ldb, v);
  for (int p = p0; p < p1; ++p) {
    __syncthreads();  // the previous panel's products are done with the staging
    store_b<NN>(v, bhi, blo);
    __syncthreads();
    if (p + 1 < p1) load_b<NN>(bptr(p + 1), ldb, v);
    Frag f;
    a_from_global(A + (size_t)p * P, lda, f);
    float part[32];
    panel_mma(part, f, bhi, blo);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] += part[q];
  }
}

// D fragment element q of this thread: row, column in the tile
__device__ __forceinline__ int frag_row(int q) {
  const int lane = threadIdx.x & 31;
  return 16 * (threadIdx.x >> 5) + (lane >> 2) + ((q & 2) ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int q) {
  return 8 * (q >> 2) + 2 * ((threadIdx.x & 31) & 3) + (q & 1);
}

__device__ __forceinline__ void store_tile(float* W, int ld, const float (&c)[32], float sign) {
#pragma unroll
  for (int q = 0; q < 32; q += 2)
    *reinterpret_cast<float2*>(W + (size_t)frag_row(q) * ld + frag_col(q)) =
        make_float2(sign * c[q], sign * c[q + 1]);
}

// acc = the sum of partial tiles W[0 .. parts-1] in that order (read past
// L1), the next two tiles' loads in flight while one is added
__device__ __forceinline__ void sum_parts(const float* W, int parts, float (&acc)[32]) {
  float2 x0[16], x1[16];
  auto load = [&](int s, float2(&x)[16]) {
    const float* w = W + (size_t)s * TILE;
#pragma unroll
    for (int q = 0; q < 16; ++q)
      x[q] = __ldcg(reinterpret_cast<const float2*>(w + frag_row(2 * q) * P + frag_col(2 * q)));
  };
  auto add = [&](const float2(&x)[16]) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      acc[2 * q] += x[q].x;
      acc[2 * q + 1] += x[q].y;
    }
  };
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
  if (parts > 0) load(0, x0);
  if (parts > 1) load(1, x1);
  for (int s = 0; s < parts; s += 2) {
    add(x0);
    if (s + 2 < parts) load(s + 2, x0);
    if (s + 1 < parts) {
      add(x1);
      if (s + 3 < parts) load(s + 3, x1);
    }
  }
}

// True in every thread of the block that is the last of `total` to arrive
// at *cnt; its partial tile is in device memory before it arrives.
__device__ __forceinline__ bool arrive_last(int* cnt, int total) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == total - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

struct Args {
  const float* z;     // the points (row 1), or
  const float* A;     // the given matrix (row 4)
  int avec;           // A's rows read as 16-byte vectors (M % 4 == 0, A aligned)
  const float* coef;
  float* L;
  float* J;
  float* W;
  int* counters;
  int M, Mp, D, kmap;
  int k, n, len, sA, sB, nA;  // panel step, panels, panels a split, splits of (A) and (B), (A) tiles
};

// K's 64 x 64 tile at (row0, col0) in this thread's D-fragment positions:
// the Gram from exact differences summed over d in order, identity in the
// padding.  The tile's 128 points go to shared memory zs first (128 D
// values at most), so that a thread's 32 entries take their coordinates
// from two rows and sixteen columns with every load independent.
__device__ void k_tile(const Args& a, int row0, int col0, float sig2, float jit, float* zs,
                       float (&kv)[32]) {
  const int D = a.D;
  __syncthreads();  // zs is free
  for (int e = threadIdx.x; e < 2 * P * D; e += NT) {
    const int pt = e / D, d = e - pt * D;
    const int g = pt < P ? row0 + pt : col0 + pt - P;
    zs[e] = g < a.M ? a.z[(size_t)g * D + d] : 0.f;
  }
  __syncthreads();
  float r2[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) r2[q] = 0.f;
  const int ra = frag_row(0), rb = frag_row(2);
  for (int d = 0; d < D; ++d) {
    const float xa = zs[ra * D + d], xb = zs[rb * D + d];
#pragma unroll
    for (int q = 0; q < 32; q += 4) {
      const float z0 = zs[(P + frag_col(q)) * D + d], z1 = zs[(P + frag_col(q + 1)) * D + d];
      const float d0 = xa - z0, d1 = xa - z1, d2 = xb - z0, d3 = xb - z1;
      r2[q] = fmaf(d0, d0, r2[q]);
      r2[q + 1] = fmaf(d1, d1, r2[q + 1]);
      r2[q + 2] = fmaf(d2, d2, r2[q + 2]);
      r2[q + 3] = fmaf(d3, d3, r2[q + 3]);
    }
  }
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int row = row0 + frag_row(q), col = col0 + frag_col(q);
    kv[q] = row < a.M && col < a.M
                ? sig2 * agp::kernel_map(a.kmap, r2[q]) + (row == col ? jit : 0.f)
                : (row == col ? 1.f : 0.f);
  }
  __syncthreads();  // zs may be reused
}

// A's symmetrized 64 x 64 tile at (row0, col0), (A_ik + A_ki^T) / 2, in this
// thread's D-fragment positions, with row 1's padding: identity past M,
// exact zeros elsewhere.  A_ik goes to Ds and A_ki to Ts as read, by
// coalesced row reads (16-byte vectors where A's rows allow them), so that
// the transposed half costs no scattered loads; Ts is then read by columns.
// The row pitches keep the fragment reads free of bank conflicts: 72 words
// for Ds (read as pairs), 68 for Ts (a lane's column t and row g fall in
// bank 8t + g).
constexpr int LDD = P + 8, LDT = P + 4;

__device__ void a_tile(const Args& a, int row0, int col0, float* smem, float (&kv)[32]) {
  float* const Ds = smem;            // Ds[r * LDD + c] = A[row0 + r][col0 + c]
  float* const Ts = smem + P * LDD;  // Ts[c * LDT + r] = A[col0 + c][row0 + r]
  const int M = a.M;
  __syncthreads();  // smem is free
  if (a.avec) {
    constexpr int NV = P * P / 4;  // vectors a tile
#pragma unroll 4
    for (int e = threadIdx.x; e < 2 * NV; e += NT) {
      const int t = e / NV, v = e % NV, r = v / (P / 4), c = 4 * (v % (P / 4));
      const int gr = (t ? col0 : row0) + r, gc = (t ? row0 : col0) + c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < M && gc < M) x = *reinterpret_cast<const float4*>(a.A + (size_t)gr * M + gc);
      *reinterpret_cast<float4*>((t ? Ts + r * LDT : Ds + r * LDD) + c) = x;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < 2 * P * P; e += NT) {
      const int t = e / (P * P), v = e % (P * P), r = v / P, c = v % P;
      const int gr = (t ? col0 : row0) + r, gc = (t ? row0 : col0) + c;
      (t ? Ts + r * LDT : Ds + r * LDD)[c] = gr < M && gc < M ? a.A[(size_t)gr * M + gc] : 0.f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 32; q += 2) {
    const int row = frag_row(q), col = frag_col(q), gr = row0 + row, gc = col0 + col;
    const float2 d = *reinterpret_cast<const float2*>(Ds + row * LDD + col);
    const float t0 = Ts[col * LDT + row], t1 = Ts[(col + 1) * LDT + row];
    kv[q] = gr < M && gc < M ? 0.5f * (d.x + t0) : (gr == gc ? 1.f : 0.f);
    kv[q + 1] = gr < M && gc + 1 < M ? 0.5f * (d.y + t1) : (gr == gc + 1 ? 1.f : 0.f);
  }
  __syncthreads();  // smem may be reused
}

// K's tile at (row0, col0): the Gram from the points, or A's symmetrized tile
template <bool FROM_A>
__device__ __forceinline__ void tile_source(const Args& a, int row0, int col0, float sig2,
                                            float jit, float* smem, float (&kv)[32]) {
  if (FROM_A)
    a_tile(a, row0, col0, smem, kv);
  else
    k_tile(a, row0, col0, sig2, jit, smem, kv);
}

// Warps 1-3 of the block (threads 32-127) meet here without warp 0.
__device__ __forceinline__ void sync_warps_1_3() { asm volatile("bar.sync 1, 96;\n" ::: "memory"); }

// X's block row b (rows o .. o + 15): -Y_b T_b left of the diagonal block,
// T_b = L_{b,<b} X_{<b,<b} already in those rows, and Y_b on it; threads
// t0 .. t0 + nt - 1 compute into registers, meet at sync(), then store.
template <typename Sync>
__device__ __forceinline__ void x_block_row(float* Xs, const float* Y, int o, int t, int nt,
                                            Sync sync) {
  constexpr int NX = SB * P / 96 + 1;  // 11: entries a thread at most
  float xr[NX];
#pragma unroll
  for (int q = 0; q < NX; ++q) {
    const int e = t + nt * q, i = e / (o + SB), j = e % (o + SB);
    xr[q] = 0.f;
    if (e < SB * (o + SB)) {
      if (j >= o) {
        xr[q] = Y[i * LDY + j - o];
      } else {
#pragma unroll
        for (int u = 0; u < SB; ++u) xr[q] = fmaf(-Y[i * LDY + u], Xs[(o + u) * LDC + j], xr[q]);
      }
    }
  }
  sync();
#pragma unroll
  for (int q = 0; q < NX; ++q) {
    const int e = t + nt * q, i = e / (o + SB), j = e % (o + SB);
    if (e < SB * (o + SB)) Xs[(o + i) * LDC + j] = xr[q];
  }
}

// The diagonal step: factor C (64 x 64 in shared memory, rows of LDC, its
// lower triangle) and invert the factor; L_kk and X = L_kk^-1 go to the
// device tiles Ld and Xd (row pitch ld), zeros above both diagonals.  Cs
// becomes L, Xs X; Ys (4 blocks of 16 x LDY) and Ws (two columns of 16, then
// 16 reciprocal pivots) are work space.  By 16-wide sub-blocks b, two
// phases each.  First, warp 0 brings the diagonal block up to date (the
// previous sub-block's update) and factors it right-looking, a lane a row
// (the pivot by one shuffle, the column through shared memory: one
// __syncwarp a column, read back as 16-byte broadcasts, so that no chain of
// shuffles waits on another), then inverts it by columns (Y_b, a lane a
// column); meanwhile warps 1-3 finish X's block row b - 1, apply the
// previous sub-block's update to the rows below block b, and form
// T_b = L_{b,<b} X_{<b,<b}.  Second, all four warps form the rows below,
// L_{>b,b} = C_{>b,b} Y_b^T.  So warp 0's chain of factors meets only the
// rows below between one block and the next.  Sums run over whole 16-wide
// blocks, compile-time bounds, with the zeros above the diagonals in place
// of bounds that vary.
__device__ void diag_factor_inv(float* Cs, float* Xs, float* Ys, float* Ws, float* Ld, float* Xd,
                                int ld) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < P * LDC; e += NT) Xs[e] = 0.f;
  __syncthreads();
#pragma unroll
  for (int b = 0; b < P / SB; ++b) {
    const int o = SB * b, op = o - SB;  // this sub-block and the one before
    float* Y = Ys + b * SB * LDY;
    if (warp == 0) {  // lanes 16-31 repeat lanes 0-15
      const int r = lane & 15;
      float d[SB];
#pragma unroll
      for (int c = 0; c < SB; ++c) d[c] = c <= r ? Cs[(o + r) * LDC + o + c] : 0.f;
      if (b > 0) {  // the previous sub-block's update of this diagonal block
#pragma unroll
        for (int c = 0; c < SB; ++c) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < SB; ++t)
            s = fmaf(Cs[(o + r) * LDC + op + t], Cs[(o + c) * LDC + op + t], s);
          d[c] -= s;
        }
      }
      float* const pinv = Ws + 2 * SB;
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        float* const col = Ws + (j & 1) * SB;
        // sqrt and 1/sqrt of the pivot: the hardware's reciprocal square root
        // and one Newton step (a few ulp), the chain a column waits on
        const float piv = __shfl_sync(kFull, d[j], j, SB);
        float inv = rsqrtf(piv);
        inv = inv * fmaf(-0.5f * piv * inv, inv, 1.5f);
        const float sq = piv * inv;
        const float l = r > j ? d[j] * inv : 0.f;
        d[j] = r > j ? l : (r == j ? sq : d[j]);
        if (lane < SB) {
          if (r > j) col[r] = l;
          if (r == j) pinv[j] = inv;
        }
        __syncwarp();
#pragma unroll
        for (int c4 = (j + 1) / 4 * 4; c4 < SB; c4 += 4) {
          const float4 v = *reinterpret_cast<const float4*>(col + c4);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c4 + u > j) d[c4 + u] = fmaf(-l, vv[u], d[c4 + u]);
        }
      }
      if (lane < SB) {
#pragma unroll
        for (int c = 0; c < SB; ++c) Cs[(o + r) * LDC + o + c] = c <= r ? d[c] : 0.f;
      }
      __syncwarp();
      // Y = L_bb^-1 by columns: lane c solves L_bb y = e_c
      float y[SB];
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        float s = i == r ? 1.f : 0.f;
#pragma unroll
        for (int t = 0; t < i; ++t) s = fmaf(-Cs[(o + i) * LDC + o + t], y[t], s);
        y[i] = s * pinv[i];
      }
      if (lane < SB) {
#pragma unroll
        for (int i = 0; i < SB; ++i) Y[i * LDY + r] = y[i];
      }
    } else if (b > 0) {
      const int t = tid - 32;
      // X's block row b - 1
      x_block_row(Xs, Ys + (b - 1) * SB * LDY, op, t, NT - 32, [] { sync_warps_1_3(); });
      // the previous sub-block's update of the rows below this one:
      // C[i][j] -= sum_u L[i][op + u] L[j][op + u], o + 16 <= i, o <= j <= i
      const int rows = P - o - SB;
      for (int e = t; e < rows * (P - o); e += NT - 32) {
        const int i = o + SB + e / (P - o), j = o + e % (P - o);
        if (j > i) continue;
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < SB; ++u) s = fmaf(Cs[i * LDC + op + u], Cs[j * LDC + op + u], s);
        Cs[i * LDC + j] -= s;
      }
      sync_warps_1_3();  // X's block row b - 1 is stored
      // T_b = L_{b,<b} X_{<b,<b} into X's block row b
      for (int e = t; e < SB * o; e += NT - 32) {
        const int i = e / o, j = e % o;
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < o; ++p) acc = fmaf(Cs[(o + i) * LDC + p], Xs[p * LDC + j], acc);
        Xs[(o + i) * LDC + j] = acc;
      }
    }
    __syncthreads();
    // the rows below: L[i][o + j] = sum_t C[i][o + t] Y[j][t] (Y zero above its diagonal)
    constexpr int NQ = (P - SB) * SB / NT;  // 6
    const int below = P - o - SB;
    float res[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = tid + NT * q, i = o + SB + e / SB, j = e % SB;
      res[q] = 0.f;
      if (e < below * SB) {
#pragma unroll
        for (int t = 0; t < SB; ++t) res[q] = fmaf(Cs[i * LDC + o + t], Y[j * LDY + t], res[q]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = tid + NT * q, i = o + SB + e / SB, j = e % SB;
      if (e < below * SB) Cs[i * LDC + o + j] = res[q];
    }
    __syncthreads();
  }
  // X's last block row, then both factors out
  x_block_row(Xs, Ys + (P / SB - 1) * SB * LDY, P - SB, tid, NT, [] { __syncthreads(); });
  __syncthreads();
  for (int e = tid; e < P * P; e += NT) {
    const int i = e / P, j = e % P;
    Ld[(size_t)i * ld + j] = j <= i ? Cs[i * LDC + j] : 0.f;
    Xd[(size_t)i * ld + j] = j <= i ? Xs[i * LDC + j] : 0.f;
  }
}

// shared memory: the staging of B (hi, lo), or the diagonal step's C, X and Y
constexpr int DIAG_WORDS = 2 * P * LDC + (P / SB) * SB * LDY + 3 * SB;
constexpr int SMEM_WORDS = DIAG_WORDS > 2 * 8 * STEP ? DIAG_WORDS : 2 * 8 * STEP;  // 37 KB
static_assert(P * (LDD + LDT) <= SMEM_WORDS, "a_tile's staging fits the block's smem");

template <bool FROM_A>
__global__ void __launch_bounds__(NT) step_kernel(const Args a) {
  __shared__ __align__(128) unsigned smem[SMEM_WORDS];
  unsigned* const bhi = smem;
  unsigned* const blo = smem + 8 * STEP;
  const int ld = a.Mp, k = a.k, n = a.n;
  const float sig2 = FROM_A ? 0.f : a.coef[0], jit = FROM_A ? 0.f : a.coef[1];
  int* const cnt = a.counters + (size_t)(k + 1) * (2 * n + 1);
  float* const Wb = a.W + (size_t)blockIdx.x * TILE;  // this block's partial tile
  int bid = blockIdx.x;
  float acc[32];

  // the look-ahead's two tiles: K_{k+1,k+1} - (B)'s sum in slot 0, T in
  // slot sB (tile k + 1's first partial, read by its finisher before)
  float* const Wt = a.W + (size_t)a.sB * TILE;
  float t[32];

  bool look_ahead = k == -1;
  // (B) a partial of the look-ahead's depth; the last to arrive writes
  // K_{k+1,k+1} - (their sum, in split order) to slot 0
  if (bid < a.sB) {
    const float* Lr = a.L + (size_t)(k + 1) * P * ld;
    tile_product<false>(Lr, ld, Lr, ld, bid * a.len, min(k, (bid + 1) * a.len), acc, bhi, blo);
    store_tile(Wb, P, acc, 1.f);
    if (!arrive_last(cnt + n, a.sB)) return;
    sum_parts(a.W, a.sB, t);  // each thread reads only the positions it writes
    tile_source<FROM_A>(a, (k + 1) * P, (k + 1) * P, sig2, jit, reinterpret_cast<float*>(smem),
                        acc);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] -= t[q];
    store_tile(a.W, P, acc, 1.f);
    if (!arrive_last(cnt + 2 * n, 2)) return;
    sum_parts(Wt, 1, t);
    look_ahead = true;
  }
  bid -= a.sB;

  if (look_ahead) {
    // launch -1's block, or (B)'s last block second at the counter
  } else if (bid < a.nA) {
    // (A) tile i of panel k: split 0 generates K_ik, split s > 0 the
    // product over its panels, negated; the last to arrive sums them in
    // split order into C
    const int i = k + 1 + bid / a.sA, s = bid % a.sA;
    if (s == 0) {
      tile_source<FROM_A>(a, i * P, k * P, sig2, jit, reinterpret_cast<float*>(smem), acc);
    } else {
      tile_product<false>(a.L + (size_t)i * P * ld, ld, a.L + (size_t)k * P * ld, ld,
                          (s - 1) * a.len, min(k, s * a.len), acc, bhi, blo);
    }
    if (a.sA > 1) {
      store_tile(Wb, P, acc, s == 0 ? 1.f : -1.f);
      if (!arrive_last(cnt + (i - k - 1), a.sA)) return;
      sum_parts(a.W + (size_t)(blockIdx.x - s) * TILE, a.sA, acc);
    }
    // L_ik = C X_k^T
    __syncthreads();
    float4 v[8];
    load_b<false>(a.J + (size_t)k * P * ld + k * P, ld, v);
    store_b<false>(v, bhi, blo);
    __syncthreads();
    Frag f;
    a_from_acc(acc, f);
    float out[32];
    panel_mma(out, f, bhi, blo);
    store_tile(a.L + (size_t)i * P * ld + k * P, ld, out, 1.f);
    if (i != k + 1) return;
    // T = L_{k+1,k} L_{k+1,k}^T; with (B)'s blocks, the second of the two
    // to arrive goes on, and K's tile minus their sum is in slot 0
    const float* Lr = a.L + (size_t)(k + 1) * P * ld + k * P;
    __syncthreads();  // every warp's rows of L_{k+1,k} are written
    tile_product<false>(Lr, ld, Lr, ld, 0, 1, t, bhi, blo);
    if (a.sB > 0) {
      store_tile(Wt, P, t, 1.f);
      if (!arrive_last(cnt + 2 * n, 2)) return;
      sum_parts(a.W, 1, acc);
    } else {
      tile_source<FROM_A>(a, (k + 1) * P, (k + 1) * P, sig2, jit, reinterpret_cast<float*>(smem),
                        acc);
    }
  } else {
    // (C) J's row block kr = k - 1, column tile m
    bid -= a.nA;
    const int kr = k - 1;
    int m = 0, parts = (kr + a.len - 1) / a.len;
    while (bid >= parts) {
      bid -= parts;
      ++m;
      parts = (kr - m + a.len - 1) / a.len;
    }
    const int s = bid, p0 = m + s * a.len, p1 = min(kr, p0 + a.len);
    tile_product<true>(a.L + (size_t)kr * P * ld, ld, a.J + (size_t)m * P, ld, p0, p1, acc, bhi,
                       blo);
    if (parts > 1) {
      store_tile(Wb, P, acc, 1.f);
      if (!arrive_last(cnt + n + 1 + m, parts)) return;
      sum_parts(a.W + (size_t)(blockIdx.x - s) * TILE, parts, acc);
    }
    // J_{kr,m} = -X_kr T: T staged as B, X_kr's rows as A
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int o = b_offset(frag_row(q), frag_col(q));
      agp::tf32_split(acc[q], bhi[o], blo[o]);
    }
    fence_proxy_async();
    __syncthreads();
    Frag f;
    a_from_global(a.J + (size_t)kr * P * ld + kr * P, ld, f);
    float out[32];
    panel_mma(out, f, bhi, blo);
    store_tile(a.J + (size_t)kr * P * ld + m * P, ld, out, -1.f);
    return;
  }

  // the look-ahead: factor and invert diagonal block k + 1, C' =
  // (K - (B)'s sum) - L_{k+1,k} L_{k+1,k}^T, acc and t
  const int d0 = (k + 1) * P;
  float* const Cs = reinterpret_cast<float*>(smem);
  if (k == -1) {
    tile_source<FROM_A>(a, d0, d0, sig2, jit, reinterpret_cast<float*>(smem), acc);
#pragma unroll
    for (int q = 0; q < 32; ++q) t[q] = 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 32; ++q) Cs[frag_row(q) * LDC + frag_col(q)] = acc[q] - t[q];
  __syncthreads();
  diag_factor_inv(Cs, Cs + P * LDC, Cs + 2 * P * LDC, Cs + 2 * P * LDC + (P / SB) * SB * LDY,
                  a.L + (size_t)d0 * ld + d0, a.J + (size_t)d0 * ld + d0, ld);
}

// The blocks of launch k: (B), (A), (C) (and the look-ahead's own block at
// k = -1), with the splits' panels a block.
struct Plan {
  int len, sA, sB, nA, blocks;
};

Plan plan(int k, int n) {
  const int nA = (k >= 0 && k <= n - 2) ? n - k - 1 : 0;
  const bool hasB = k >= 1 && k <= n - 2;
  const int kr = k - 1;
  long long work = (long long)nA * k + (hasB ? k : 0);
  if (kr >= 1) work += (long long)kr * (kr + 1) / 2;
  Plan p;
  p.len = (int)std::max<long long>(1, (work + TARGET_BLOCKS - 1) / TARGET_BLOCKS);
  p.sA = k > 0 ? (k + p.len - 1) / p.len + 1 : 1;  // split 0 generates K's tile
  p.sB = hasB ? p.sA - 1 : 0;
  p.nA = nA * p.sA;
  int nC = 0;
  for (int m = 0; m < kr; ++m) nC += (kr - m + p.len - 1) / p.len;
  p.blocks = p.sB + p.nA + nC + (k == -1 ? 1 : 0);
  return p;
}

// scratch: partial tiles (one a block of the largest launch), then the counters
long long scratch_words(int Mp) {
  const int n = Mp / P;
  long long most = 1;
  for (int k = -1; k <= n; ++k) most = std::max<long long>(most, plan(k, n).blocks);
  return most * TILE + (long long)(n + 2) * (2 * n + 1);
}

// Every launch of the factorization in order (K's tiles from tile_source<FROM_A>).
template <bool FROM_A>
int run_steps(Args a, cudaStream_t s) {
  const int n = a.Mp / P;
  const long long tiles_words = scratch_words(a.Mp) - (long long)(n + 2) * (2 * n + 1);
  a.counters = reinterpret_cast<int*>(a.W + tiles_words);
  cudaError_t err;
  const size_t bytes = (size_t)a.Mp * a.Mp * sizeof(float);
  if ((err = cudaMemsetAsync(a.L, 0, bytes, s)) != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(a.J, 0, bytes, s)) != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(a.counters, 0, sizeof(int) * (size_t)(n + 2) * (2 * n + 1), s)) !=
      cudaSuccess)
    return err;
  a.n = n;
  for (int k = -1; k <= n; ++k) {
    const Plan p = plan(k, n);
    if (p.blocks == 0) continue;
    a.k = k;
    a.len = p.len;
    a.sA = p.sA;
    a.sB = p.sB;
    a.nA = p.nA;
    step_kernel<FROM_A><<<p.blocks, NT, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Elements of the f32 scratch buffer at Mp (a multiple of 64), for either form.
long long agp_gram_chol_inv_mma_scratch(int Mp) { return scratch_words(Mp); }

// z: (M, D) row-major f32; coef: (sig2, jitter) on the device; L, J: (Mp, Mp)
// row-major outputs; scratch: agp_gram_chol_inv_mma_scratch(Mp) elements.
// Returns a cudaError_t (0 on success).
int agp_gram_chol_inv_mma_f32(const void* z, const void* coef, void* L, void* J, void* scratch,
                              int M, int Mp, int D, int kmap, void* stream) {
  if (M < 1 || Mp < M || Mp % P != 0 || D < 1 || D > 64 || !agp::valid_kernel_map(kmap))
    return cudaErrorInvalidValue;
  Args a{};
  a.z = static_cast<const float*>(z);
  a.coef = static_cast<const float*>(coef);
  a.L = static_cast<float*>(L);
  a.J = static_cast<float*>(J);
  a.W = static_cast<float*>(scratch);
  a.M = M;
  a.Mp = Mp;
  a.D = D;
  a.kmap = kmap;
  return run_steps<false>(a, static_cast<cudaStream_t>(stream));
}

// A: (M, M) row-major f32 SPD (its symmetric part is factored); L, J, scratch
// as above.  Returns a cudaError_t (0 on success).
int agp_chol_inv_mma_f32(const void* A, void* L, void* J, void* scratch, int M, int Mp,
                         void* stream) {
  if (M < 1 || Mp < M || Mp % P != 0) return cudaErrorInvalidValue;
  Args a{};
  a.A = static_cast<const float*>(A);
  a.avec = M % 4 == 0 && reinterpret_cast<size_t>(A) % 16 == 0;
  a.L = static_cast<float*>(L);
  a.J = static_cast<float*>(J);
  a.W = static_cast<float*>(scratch);
  a.M = M;
  a.Mp = Mp;
  return run_steps<true>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
