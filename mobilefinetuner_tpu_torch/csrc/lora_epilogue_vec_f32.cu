// LoRA epilogue for Hopper (sm_90a) in f32, the dtype every CLI defaults
// to, with the scale folded in: out = y + (xa * scale) @ B in one pass
// over y.
//
// Replaces: mobilefinetuner_tpu/ops/lora_fused.py `_epilogue_kernel`
// (launched by `_call` <- `_epilogue2` <- `lora_epilogue_add`) for f32
// operands: the rank-r adapter delta of a LoRA site added to the base
// projection's output without writing the [N, d_out] delta to device
// memory. The scale-folded bottleneck xs = xa * scale (one f32 product,
// no rounding beyond it) is formed here from the scale's device address;
// before, the wrapper formed it in elementwise launches of its own ahead
// of csrc/lora_epilogue.cu (its first version, kept, on no path). The
// product accumulates in f32 in rank order and the sum with y is taken
// once, as that first version does.
//
// Bound on this card: bytes. The function reads y and B once and writes
// out once; at r = 8 its 2 N r d_out FLOPs are ~1 a byte of y: at
// GPT-2's attn_qkv (N 1024, d_out 2304) ~19 MB, 5.67 us at 3.35 TB/s.
//
// Design: csrc/lora_epilogue_vec.cu's (bytes in flight, no shared memory,
// no barrier) in f32. Each thread owns one column vector of VEC floats
// (16 bytes; 2 or 1 where d_out or an address does not allow 4) of one
// row, or, at N <= 4 where that still gives a CTA an SM, of all ROWS = 4
// rows, so the 32 threads of a warp read and write 32 neighbouring
// vectors of the flat [N, d_out] array. A thread first issues its y
// loads, then the scale, B's [8, VEC] slab of its columns straight into
// registers (B lives in L2 after the first warps: 74 KB at attn_qkv) and
// xa's 8 rank values of each row (a broadcast, two 16-byte loads where r
// % 8 == 0 and xa is 16-byte aligned); ranks above 8 walk B in slabs of
// 8. The thread of column vector 0 also writes xs (the backward's dB =
// xs^T g needs it): 32 KB at N 1024, r 8.
//
// C interface (ctypes): mft_lora_epilogue_vec_f32 returns the CUDA error
// code of the launch. y/out [N, d_out], xa [N, r], B [r, d_out], xs [N,
// r], contiguous f32 (dtype 0; any other is refused); scale an f32 on the
// device; vec the vector width in floats (4, 2 or 1: d_out and the
// addresses of y, out and B divisible by it), rows the rows a thread (4,
// with vec 4 only, or 1); out may not alias y.

#include <limits.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int KC = 8;            // rank values a slab of B
constexpr int MAX_RANK = 128;

template <int VEC> struct VecT;
template <> struct VecT<4> { using type = float4; };
template <> struct VecT<2> { using type = float2; };
template <> struct VecT<1> { using type = float; };

template <int VEC, int ROWS>
__global__ void __launch_bounds__(THREADS)
lora_epilogue_vec_f32_kernel(const float* __restrict__ y,
                             const float* __restrict__ xa,
                             const float* __restrict__ bm,
                             const float* __restrict__ scale,
                             float* __restrict__ out, float* __restrict__ xs,
                             int N, int ncv, int d_out, int r, int rs,
                             int xa_vec) {
  using V = typename VecT<VEC>::type;
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
      const float* xr = xa + (size_t)n * r + k0;
      float xv[KC];
      if (xa_vec) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(xr));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(xr) + 1);
        xv[0] = lo.x, xv[1] = lo.y, xv[2] = lo.z, xv[3] = lo.w;
        xv[4] = hi.x, xv[5] = hi.y, xv[6] = hi.z, xv[7] = hi.w;
      } else {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) xv[kk] = kk < kn ? xr[kk] : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        xv[kk] *= s;
        if (cv == 0 && kk < kn) xs[(size_t)n * r + k0 + kk] = xv[kk];
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        if (kk >= kn) break;
        const float* be = reinterpret_cast<const float*>(&bv[kk]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[i][e] = fmaf(xv[kk], be[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int n = n0 + i * rs;
    if (n >= N) continue;
    const float* ye = reinterpret_cast<const float*>(&yv[i]);
    V ov;
    float* oe = reinterpret_cast<float*>(&ov);
#pragma unroll
    for (int e = 0; e < VEC; ++e) oe[e] = ye[e] + acc[i][e];
    *reinterpret_cast<V*>(out + (size_t)n * d_out + c0) = ov;
  }
}

template <int VEC, int ROWS>
int launch(const float* y, const float* xa, const float* bm,
           const float* scale, float* out, float* xs, int N, int d_out,
           int r, cudaStream_t st) {
  const int ncv = d_out / VEC, rs = (N + ROWS - 1) / ROWS;
  const long long threads = (long long)ncv * rs;
  const int xa_vec =
      r % KC == 0 && reinterpret_cast<uintptr_t>(xa) % 16 == 0;
  lora_epilogue_vec_f32_kernel<VEC, ROWS>
      <<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, st>>>(
          y, xa, bm, scale, out, xs, N, ncv, d_out, r, rs, xa_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mft_lora_epilogue_vec_f32(const void* y, const void* xa,
                                         const void* bm, const void* scale,
                                         void* out, void* xs, int N,
                                         int d_out, int r, int vec, int rows,
                                         int dtype, void* stream) {
  if (dtype != 0 || scale == nullptr || xs == nullptr || N <= 0 ||
      d_out <= 0 || r <= 0 || r > MAX_RANK || vec <= 0 ||
      d_out % vec != 0 || (long long)N * (d_out / vec) + THREADS > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bytes = (uintptr_t)vec * 4;
  if (reinterpret_cast<uintptr_t>(y) % bytes ||
      reinterpret_cast<uintptr_t>(out) % bytes ||
      reinterpret_cast<uintptr_t>(bm) % bytes)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* xf = static_cast<const float*>(xa);
  const float* bf = static_cast<const float*>(bm);
  const float* sc = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  float* xsf = static_cast<float*>(xs);
  if (rows == 4 && vec == 4)
    return launch<4, 4>(yf, xf, bf, sc, of, xsf, N, d_out, r, st);
  if (rows != 1) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 4:
      return launch<4, 1>(yf, xf, bf, sc, of, xsf, N, d_out, r, st);
    case 2:
      return launch<2, 1>(yf, xf, bf, sc, of, xsf, N, d_out, r, st);
    case 1:
      return launch<1, 1>(yf, xf, bf, sc, of, xsf, N, d_out, r, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
