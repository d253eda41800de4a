// LoRA epilogue for Hopper (sm_90a): out = y + xa @ B in one pass over y.
//
// Replaces: mobilefinetuner_tpu/ops/lora_fused.py `_epilogue_kernel`
// (launched by `_call` <- `_epilogue2` <- `lora_epilogue_add`): the rank-r
// adapter delta of a LoRA site added to the base projection's output
// without writing the [N, d_out] delta to device memory and reading it
// back. xa is the rank-r bottleneck with the LoRA scale already folded in
// (by the wrapper, as `lora_epilogue_add` folds it outside the kernel);
// the product accumulates in f32 and the sum is rounded once to y's dtype.
//
// Bound on this card: the function must read y and write out (2 N d_out
// elements) plus the small xa [N, r] and B [r, d_out]; its 2 N r d_out
// FLOPs at r = 8 are ~8 FLOP a byte, far below the card's balance, so
// bytes bound it: at the GPT-2 training shape, N = 1024 rows and bf16,
// ~9.5 MB (2.8 us at 3.35 TB/s) for attn_qkv (d_out 2304) and ~3.2 MB
// (0.94 us) for attn_proj (d_out 768).
// Design: the rank is 1-128, so the product is a short FMA loop rather
// than a tensor-core tile: one CTA of 256 threads per (32 rows, 256
// columns) tile stages B's [r, 256] slab and xa's [32, r] rows in shared
// memory as f32 once, then each thread walks the 32 rows of its own
// column, reading y and writing out with neighbouring threads on
// neighbouring addresses (coalesced), B from its own shared-memory column
// (conflict-free) and xa as a broadcast. The TPU kernel pads the rank to
// 128 lanes and needs N % 8 and d_out % 128; here the ragged row and
// column edges are masked, so any N and d_out are taken.
//
// bf16 and f16 run csrc/lora_epilogue_vec.cu, which folds the scale in
// and keeps 16-byte vectors in flight; this source keeps f32.
//
// C interface (ctypes): mft_lora_epilogue returns the CUDA error code of
// the launch. y/out [N, d_out], xa [N, r], B [r, d_out], contiguous, f32
// (dtype 0; any other is refused); out may not alias y.

#include "flash_attention_common.cuh"

namespace {

using mft::from_f32;
using mft::to_f32;

constexpr int BN = 32;         // rows a CTA
constexpr int BD = 256;        // columns a CTA, one per thread
constexpr int THREADS = BD;
constexpr int MAX_RANK = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
lora_epilogue_kernel(const T* __restrict__ y, const T* __restrict__ xa,
                     const T* __restrict__ bm, T* __restrict__ out, int N,
                     int d_out, int r) {
  extern __shared__ float smem[];
  float* b_s = smem;             // [r][BD]
  float* xa_s = b_s + r * BD;    // [BN][r]
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BD;
  const int tid = threadIdx.x, c = c0 + tid;
  for (int i = tid; i < r * BD; i += THREADS) {
    const int kk = i / BD, cc = c0 + i % BD;
    b_s[i] = cc < d_out ? to_f32(bm[(size_t)kk * d_out + cc]) : 0.f;
  }
  for (int i = tid; i < BN * r; i += THREADS) {
    const int nn = n0 + i / r;
    xa_s[i] = nn < N ? to_f32(xa[(size_t)nn * r + i % r]) : 0.f;
  }
  __syncthreads();
  if (c >= d_out) return;
  const int rows = min(BN, N - n0);
  for (int nn = 0; nn < rows; ++nn) {
    float acc = 0.f;
    for (int kk = 0; kk < r; ++kk)
      acc = fmaf(xa_s[nn * r + kk], b_s[kk * BD + tid], acc);
    const size_t o = (size_t)(n0 + nn) * d_out + c;
    out[o] = from_f32<T>(to_f32(y[o]) + acc);
  }
}

template <typename T>
int launch(const void* y, const void* xa, const void* bm, void* out, int N,
           int d_out, int r, cudaStream_t st) {
  const size_t smem = (size_t)(r * BD + BN * r) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lora_epilogue_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + BN - 1) / BN, (d_out + BD - 1) / BD);
  lora_epilogue_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(xa),
      static_cast<const T*>(bm), static_cast<T*>(out), N, d_out, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mft_lora_epilogue(const void* y, const void* xa,
                                 const void* bm, void* out, int N, int d_out,
                                 int r, int dtype, void* stream) {
  if (N <= 0 || d_out <= 0 || r <= 0 || r > MAX_RANK)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0) return (int)cudaErrorInvalidValue;   // 16-bit: _vec.cu
  return launch<float>(y, xa, bm, out, N, d_out, r,
                       static_cast<cudaStream_t>(stream));
}
