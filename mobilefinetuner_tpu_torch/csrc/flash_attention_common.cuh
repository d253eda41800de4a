// Device helpers shared by the flash-attention kernels (forward, merged
// backward, split backward): dtype conversion, floor division, the
// attention mask of one (row, col) cell and the counter-hash dropout keep
// bit of mobilefinetuner_tpu/ops/flash_attention.py `_keep_mask`.
//
// The keep bit is a pure function of (seed, batch, q-head, global row,
// global col), in wrapping 32-bit arithmetic with the TPU kernel's
// constants, so every kernel regenerates the same mask whatever its tile
// shape or iteration order, and the plain PyTorch versions
// (ops/flash_attention.keep_mask) reproduce it bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mft {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch casts
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Train-mode probs dropout: keep iff the hash's high 24 bits fall below
// thresh = round((1 - p) * 2^24), computed by the wrapper.
__device__ __forceinline__ bool keep_bit(uint32_t seed, uint32_t b,
                                         uint32_t h, uint32_t row,
                                         uint32_t col, uint32_t thresh) {
  const uint32_t x = seed ^ (b * 0x9E3779B9u) ^ (h * 0x85EBCA6Bu);
  uint32_t z = x + row * 0xC2B2AE35u + col * 0x27D4EB2Fu;
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return ((z >> 8) & 0xFFFFFFu) < thresh;
}

// Dropout parameters as one value: `on` = 0 compiles nothing in.
struct Dropout {
  int on;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;
};

// The attention mask of one cell (as `_block_mask`): key padding, causal,
// sliding window. Rows past S are refused too (ragged edge).
__device__ __forceinline__ bool attend(int row, int col, int S, float pad,
                                       int causal, int has_window,
                                       int window) {
  bool ok = row < S && pad > 0.f;
  if (causal) ok = ok && col <= row;
  if (has_window) ok = ok && col > row - window;
  return ok;
}

// rows [row0, row0 + R) of a [S, D] slab into dst[R][D + 1] as f32, zero
// past S (the padded stride keeps column walks free of bank conflicts)
template <typename T, int D, int R, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int S) {
  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D, g = row0 + r;
    dst[r * (D + 1) + d] = g < S ? to_f32(src[(size_t)g * D + d]) : 0.f;
  }
}

}  // namespace mft
