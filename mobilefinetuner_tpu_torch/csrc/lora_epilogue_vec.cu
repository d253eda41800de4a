// LoRA epilogue for Hopper (sm_90a), bf16 and f16, with the scale folded
// in: out = y + round(xa * scale) @ B in one pass over y.
//
// Replaces: mobilefinetuner_tpu/ops/lora_fused.py `_epilogue_kernel`
// (launched by `_call` <- `_epilogue2` <- `lora_epilogue_add`) for 16-bit
// operands: the rank-r adapter delta of a LoRA site added to the base
// projection's output without writing the [N, d_out] delta to device
// memory. The scale-folded bottleneck xs = round(f32(xa) * scale) to the
// storage dtype is formed here from the scale's device address (the JAX
// wrapper folds it outside the kernel, three elementwise passes here
// before); the product accumulates in f32 in rank order and the sum with
// y is rounded once, as csrc/lora_epilogue.cu does (which keeps f32).
//
// Bound on this card: bytes. The function reads y and B once and writes
// out once; at r = 8 its 2 N r d_out FLOPs are ~2 a byte of y, against the
// card's ~295: at the GPT-2 training shape (N 1024, bf16) ~9.5 MB, 2.8 us
// at 3.35 TB/s, for attn_qkv (d_out 2304) and ~3.2 MB, 0.95 us, for
// attn_proj (d_out 768). At Gemma's head-adapter decode site (N 4, d_out
// 262,144) B (4 MB) outweighs y (2 MB).
//
// Design: bytes in flight, no shared memory, no barrier. Each thread owns
// one column vector of VEC elements (16 bytes; 8 or 4 or 2 where d_out or
// an address does not allow 16) of one row, or, at N <= 4 where that
// still gives a CTA an SM (the head adapter's lm_head), of all ROWS = 4
// rows, so the 32 threads of a warp read
// and write 32 neighbouring vectors of one flat [N, d_out] array (y is
// contiguous). A thread first issues its y loads, then the scale, B's
// [8, VEC] slab of its columns straight into registers as the storage
// dtype (B lives in L2 after the first warps: 37 KB at attn_qkv) and xa's
// 8 rank values of each row (a broadcast, one 16-byte load where r % 8 ==
// 0); so nothing waits on anything before its loads are in flight. Ranks
// above 8 walk B in slabs of 8 (right at r 128, not tuned). One row a
// thread gives the most CTAs (768 of 128 threads at attn_proj, where the
// first version had 96; 80 registers, six CTAs an SM) and measured
// faster on an H100 at every training site than four rows a thread
// (attn_qkv 7.57 against 8.20 us, PERF.md); at the head adapter's decode
// site (N 4, d_out 262,144) four rows a thread read its 4 MB B once, not
// four times (4.92 against 5.52 us), but at N 4 and d_out 2,048 (two
// CTAs) they lose (3.89 against 2.82 us). A decode shape runs one pass
// whose only fixed cost is the launch. The thread of column vector 0
// also writes xs (the backward's dB = xs^T g needs it): 16 KB at N 1024,
// r 8.
//
// C interface (ctypes): mft_lora_epilogue_vec returns the CUDA error code
// of the launch. y/out [N, d_out], xa [N, r], B [r, d_out], xs [N, r],
// contiguous, one dtype (1 bf16, 2 f16); scale an f32 on the device; vec
// the vector width in elements (8, 4, 2 or 1: d_out and the addresses of
// y, out and B divisible by it), rows the rows a thread (4, with vec 8
// only, or 1); out may not alias y.

#include <limits.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using mft::from_f32;
using mft::to_f32;

constexpr int THREADS = 128;
constexpr int KC = 8;            // rank values a slab of B
constexpr int MAX_RANK = 128;

template <int BYTES> struct VecT;
template <> struct VecT<16> { using type = uint4; };
template <> struct VecT<8> { using type = uint2; };
template <> struct VecT<4> { using type = unsigned; };
template <> struct VecT<2> { using type = unsigned short; };

template <typename T, int VEC, int ROWS>
__global__ void __launch_bounds__(THREADS)
lora_epilogue_vec_kernel(const T* __restrict__ y, const T* __restrict__ xa,
                         const T* __restrict__ bm,
                         const float* __restrict__ scale,
                         T* __restrict__ out, T* __restrict__ xs, int N,
                         int ncv, int d_out, int r, int rs, int xa_vec) {
  using V = typename VecT<VEC * (int)sizeof(T)>::type;
  const int slot = blockIdx.x * THREADS + threadIdx.x;
  if (slot >= ncv * rs) return;
  const int cv = slot % ncv, n0 = slot / ncv;
  const int c0 = cv * VEC;

  // y first: its loads are the kernel's first instructions
  V yv[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int n = n0 + i * rs;
    if (n < N)
      yv[i] = *reinterpret_cast<const V*>(y + (size_t)n * d_out + c0);
  }
  const float s = __ldg(scale);

  float acc[ROWS][VEC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < r; k0 += KC) {
    const int kn = min(KC, r - k0);
    V bv[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      if (kk < kn)
        bv[kk] = __ldg(reinterpret_cast<const V*>(
            bm + (size_t)(k0 + kk) * d_out + c0));
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int n = n0 + i * rs;
      if (n >= N) continue;
      const T* xr = xa + (size_t)n * r + k0;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);   // KC values of T
      T* xe = reinterpret_cast<T*>(&raw);
      if (xa_vec) {
        raw = __ldg(reinterpret_cast<const uint4*>(xr));
      } else {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          if (kk < kn) xe[kk] = xr[kk];
      }
      float xv[KC];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const T rounded = from_f32<T>(to_f32(xe[kk]) * s);
        xv[kk] = to_f32(rounded);
        if (cv == 0 && kk < kn)
          xs[(size_t)n * r + k0 + kk] = rounded;
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk >= kn) break;
        const T* be = reinterpret_cast<const T*>(&bv[kk]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[i][e] = fmaf(xv[kk], to_f32(be[e]), acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int n = n0 + i * rs;
    if (n >= N) continue;
    const T* ye = reinterpret_cast<const T*>(&yv[i]);
    V ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      oe[e] = from_f32<T>(to_f32(ye[e]) + acc[i][e]);
    *reinterpret_cast<V*>(out + (size_t)n * d_out + c0) = ov;
  }
}

template <typename T, int VEC, int ROWS>
int launch(const void* y, const void* xa, const void* bm, const float* scale,
           void* out, void* xs, int N, int d_out, int r, cudaStream_t st) {
  const int ncv = d_out / VEC, rs = (N + ROWS - 1) / ROWS;
  const long long threads = (long long)ncv * rs;
  const int xa_vec =
      r % KC == 0 && reinterpret_cast<uintptr_t>(xa) % 16 == 0;
  lora_epilogue_vec_kernel<T, VEC, ROWS>
      <<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
          static_cast<const T*>(y), static_cast<const T*>(xa),
          static_cast<const T*>(bm), scale, static_cast<T*>(out),
          static_cast<T*>(xs), N, ncv, d_out, r, rs, xa_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int by_vec(int vec, int rows, const void* y, const void* xa, const void* bm,
           const float* scale, void* out, void* xs, int N, int d_out, int r,
           cudaStream_t st) {
  if (rows == 4 && vec == 8)
    return launch<T, 8, 4>(y, xa, bm, scale, out, xs, N, d_out, r, st);
  if (rows != 1) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 8:
      return launch<T, 8, 1>(y, xa, bm, scale, out, xs, N, d_out, r, st);
    case 4:
      return launch<T, 4, 1>(y, xa, bm, scale, out, xs, N, d_out, r, st);
    case 2:
      return launch<T, 2, 1>(y, xa, bm, scale, out, xs, N, d_out, r, st);
    case 1:
      return launch<T, 1, 1>(y, xa, bm, scale, out, xs, N, d_out, r, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_lora_epilogue_vec(const void* y, const void* xa,
                                     const void* bm, const void* scale,
                                     void* out, void* xs, int N, int d_out,
                                     int r, int vec, int rows, int dtype,
                                     void* stream) {
  if (scale == nullptr || xs == nullptr || N <= 0 || d_out <= 0 ||
      r <= 0 || r > MAX_RANK || vec <= 0 || d_out % vec != 0 ||
      (long long)N * (d_out / vec) + THREADS > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bytes = (uintptr_t)vec * 2;
  if (reinterpret_cast<uintptr_t>(y) % bytes ||
      reinterpret_cast<uintptr_t>(out) % bytes ||
      reinterpret_cast<uintptr_t>(bm) % bytes)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (dtype) {
    case 1:
      return by_vec<__nv_bfloat16>(vec, rows, y, xa, bm, sc, out, xs, N,
                                   d_out, r, st);
    case 2:
      return by_vec<__half>(vec, rows, y, xa, bm, sc, out, xs, N, d_out, r,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
