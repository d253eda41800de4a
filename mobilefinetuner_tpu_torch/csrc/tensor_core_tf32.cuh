// 3xTF32 building blocks for the port's f32 tensor-core kernels (sm_90a):
// f32 operands split into two TF32 halves, the m16n8k8 TF32 mma.sync, and
// a product of split operands that keeps f32 accuracy. Used by
// flash_attention_fwd_tf32.cu, flash_attention_bwd_merged_tf32.cu,
// fused_ce_dh_tf32.cu, fused_ce_dh_lora_tf32.cu, fused_ce_fwd_tf32.cu and
// fused_ce_dbt_tf32.cu.
//
// Split: hi = tf32(x) (cvt.rna: round to nearest, ties away from zero, at
// bit 13), lo = tf32(x - hi); x - hi is exact in f32, so x = hi + lo to
// within 2^-22 |x|. A product a b is taken as a_hi b_hi + a_hi b_lo +
// a_lo b_hi (the a_lo b_lo term, ~2^-22 of a b, is dropped), each TF32
// product exact in the f32 accumulators: about f32 accuracy at three
// times the TF32 work. One TF32 product alone would round each operand
// to 2^-11.
//
// Fragment layout of mma.m16n8k8 .tf32 (lane = 4 g + t, g = lane / 4,
// t = lane % 4), as the PTX ISA gives it:
//   A 16x8 (row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//   B 8x8:              b0 (k t, n g), b1 (k t+4, n g);
//   C 16x8 f32:         c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// ldmatrix (b16) of four 8x8 matrices reads f32 data as four 8x4 f32
// matrices: lane (g, t) receives element (g, t) of each, which is the A
// fragment of a row-major 16x8 tile and the B fragment of an [n][k] tile.
// A C fragment holds columns 2t and 2t + 1 where the A operand of the
// next product wants t and t + 4: a product that takes C as its A reads
// its k index kappa = t as column 2t and kappa = t + 4 as column 2t + 1,
// so its B operand is read with the same permutation (row 2t for b0, row
// 2t + 1 for b1; mft::pv_a below).

#pragma once

#include <stdint.h>

#include "tensor_core.cuh"

namespace mft {

// x rounded to TF32 (an f32 bit pattern whose low 13 bits are zero)
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x rounded to TF32 by integer arithmetic on its bits: + 0x1000 carries
// half an ulp of the 10-bit mantissa into the magnitude, then the low 13
// bits are cleared. The bits of tf32_round for every finite x and for
// Inf (a NaN may come out as another NaN or as -0, whose lo half is then
// NaN), in two integer operations: for kernels that split operands at
// every fragment load (fused_ce_dh_tf32.cu, fused_ce_dh_lora_tf32.cu).
__device__ __forceinline__ uint32_t tf32_round_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// split_tf32's hi and lo by tf32_round_bits
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = tf32_round_bits(x);
  lo = tf32_round_bits(x - __uint_as_float(hi));
}

// x = hi + lo for a tensor-core operand: hi as split_tf32_bits', lo = x -
// hi (exact in f32) passed as raw f32 bits, of which the TF32 mma.sync
// reads the top 19 (the low 13 are dropped): lo is then off by less than
// 2^-10 of itself, ~2^-21 of x, at one integer operation less than a
// rounded lo (fused_ce_fwd_tf32.cu, fused_ce_dbt_tf32.cu)
__device__ __forceinline__ void split_tf32_raw_lo(float x, uint32_t& hi,
                                                  uint32_t& lo) {
  hi = tf32_round_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(float4 x, float4& hi,
                                           float4& lo) {
  uint32_t h, l;
  split_tf32(x.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  split_tf32(x.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  split_tf32(x.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  split_tf32(x.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

// c += a . b for one m16n8k8 tile of TF32 operands
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32 for split operands: the two small terms first,
// then hi . hi; lo . lo dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_1688_tf32(c, al, bh0, bh1);
  mma_1688_tf32(c, ah, bl0, bl1);
  mma_1688_tf32(c, ah, bh0, bh1);
}

// The split A fragment of a product over the 8 columns of the C fragment
// c (kappa = t -> column 2t, kappa = t + 4 -> column 2t + 1)
__device__ __forceinline__ void pv_a(const float (&c)[4], uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);   // (g, 2t)
  split_tf32(c[2], hi[1], lo[1]);   // (g + 8, 2t)
  split_tf32(c[1], hi[2], lo[2]);   // (g, 2t + 1)
  split_tf32(c[3], hi[3], lo[3]);   // (g + 8, 2t + 1)
}

// rows [row0, row0 + n) of a [S, D] f32 slab into dst[n][D + 4], zero
// past S (16-byte cp.async; the stride of D + 4 floats keeps ldmatrix and
// the permuted column reads free of bank conflicts)
template <int D, int THREADS>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int row0, int n, int S) {
  constexpr int CH = D / 4;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4, g = row0 + r;
    cp_async_16(dst + r * (D + 4) + c, src + (size_t)min(g, S - 1) * D + c,
                g < S);
  }
}

// rows [0, n) of hi[n][D + 4], staged raw, split in place: hi keeps the
// TF32 high half, lo gets the low one (each element by one thread)
template <int D, int THREADS>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int n) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int o = (i / CH) * (D + 4) + (i % CH) * 4;
    float4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(hi + o), h, l);
    *reinterpret_cast<float4*>(hi + o) = h;
    *reinterpret_cast<float4*>(lo + o) = l;
  }
}

}  // namespace mft
