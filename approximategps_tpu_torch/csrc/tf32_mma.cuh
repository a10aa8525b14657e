// 3xTF32 products for row 5's tensor-core passes: wgmma for the wide pass
// (gram_matvec_mma.cu), mma.sync for the self-Gram's pullback
// (gram_matvec_self_bwd.cu).
//
// mma.sync.aligned.m16n8k8 with TF32 operands and f32 accumulators.  The
// fragments of lane l (g = l / 4, t = l % 4), as the PTX ISA lays them out:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// TF32 keeps 10 mantissa bits, so each f32 operand is split x = hi + lo
// (tf32_split, or tf32_split_trunc) and a product is A_hi B_hi + A_hi B_lo +
// A_lo B_hi: each term within about 2^-20 of the f32 product (the dropped
// A_lo B_lo is 2^-21 of it at most).
#pragma once

#include <cuda_runtime.h>

namespace agp {

// x = hi + lo: hi is x rounded to TF32 (half a TF32 ulp added, the 13 low
// bits cleared: two integer operations, where cvt.rna.tf32 costs four with
// its checks), lo = x - hi exactly in f32, handed to the mma as it is (the
// tensor cores read the top 10 mantissa bits of a TF32 operand, so lo keeps
// 2^-10 of itself: 2^-21 of x).
__device__ __forceinline__ void tf32_split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x = hi + lo with hi x truncated to TF32 (one operation): lo = x - hi keeps
// x's sign and is below 2^-10 of it, and the tensor cores' own truncation of
// lo loses under 2^-20 of x.  For an operand split in the inner loop, where
// an instruction an entry counts.
__device__ __forceinline__ void tf32_split_trunc(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B in 3xTF32, A split in registers, B's two entries split in shared
// memory (hi and lo arrays at the same offsets): big += A_hi B_hi and
// small += A_lo B_hi + A_hi B_lo, two chains of dependent mmas that the
// scheduler interleaves; the caller adds them in a fixed order.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const unsigned (&ahi)[4], const unsigned (&alo)[4],
                                           const unsigned* bhi, const unsigned* blo, int o0,
                                           int o1) {
  const unsigned h0 = bhi[o0], h1 = bhi[o1];
  mma_tf32(big, ahi, h0, h1);
  mma_tf32(small, alo, h0, h1);
  mma_tf32(small, ahi, blo[o0], blo[o1]);
}

// Warpgroup products (wgmma, sm_90a): D (64 x N, f32) += A (64 x 8, TF32 from
// registers: each warp's 16 rows in the mma.m16n8k8 A layout above) times B
// (8 x N, TF32 in shared memory, K-major without swizzle: core matrices of 8
// columns by 4 keys, 16 bytes a column; the two key halves 128 bytes apart,
// groups of 8 columns 256 bytes apart).  D's layout per warp is mma's C
// layout, one 8-column tile after the other.  scale_d = 0 overwrites D.
__device__ __forceinline__ unsigned long long wgmma_desc(const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | ((unsigned long long)(128 >> 4) << 16) |
         ((unsigned long long)(256 >> 4) << 32);
}

// Word offset of B's entry (key row k < 8, column c) in that layout.
__host__ __device__ constexpr int wgmma_b_offset(int k, int c) {
  return (c >> 3) * 64 + (k >> 2) * 32 + (c & 7) * 4 + (k & 3);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses to a register across the async products.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const unsigned (&a)[4],
                                           unsigned long long desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const unsigned (&a)[4],
                                             unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const unsigned (&a)[4],
                                             unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const unsigned (&a)[4],
                                             unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const unsigned (&a)[4],
                                             unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const unsigned (&a)[4],
                                             unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Row pitch (in 32-bit words) of a shared tile at least `cols` wide with
// pitch = 4 (mod 32): the lanes' B reads, 8 rows g by 4 columns t (or 4
// rows 2t by 8 columns g), then fall on 32 distinct banks.
__host__ __device__ constexpr int mma_pitch(int cols) { return (cols + 27) / 32 * 32 + 4; }

}  // namespace agp
