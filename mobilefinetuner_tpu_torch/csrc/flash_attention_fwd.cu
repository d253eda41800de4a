// Flash-attention forward for Hopper (sm_90a), f32 inputs: bf16 and f16
// run on the tensor-core kernel of flash_attention_fwd_mma.cu (the
// wrapper picks the library by dtype).
//
// Replaces: mobilefinetuner_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_fwd`): online-softmax attention over only the key blocks
// the mask can reach, with key-padding, causal and sliding-window masks,
// GQA (q-head h reads kv-head h / G), returning out and the per-row
// logsumexp.
//
// Arithmetic follows the TPU kernel: Q/K/V are upcast to f32 and every
// product and sum is f32; l_safe = max(l, 1e-30), out = acc / l_safe cast
// to q's dtype, lse = m + log(l_safe). Probabilities are re-masked after
// exp, so a key the mask refuses adds exactly 0. Train-mode dropout
// (HF probs-dropout semantics, as the TPU kernel): l sums the undropped
// probabilities, only P.V sees the kept ones scaled by 1/(1-p); the keep
// bit is `_keep_mask`'s hash of the global (b, h, row, col)
// (flash_attention_common.cuh), so the backward kernels regenerate it.
//
// Bound on this card: for the serving prefill (S = 128, D = 64, 12 heads)
// the work is ~24 MFLOP and ~0.8 MB a layer, which the H100 could do in
// under a microsecond (bytes bound it); this kernel is far from that:
// each FMA of its inner loops reads two shared-memory operands, so
// shared-memory load issue bounds it, after the launch itself.
// Design: one CTA of 256 threads per (q-block of 64 rows, q-head,
// batch), four threads per query row; K/V tiles of 64 keys are
// staged in shared memory as f32 with a padded row stride so the
// column walks are free of bank conflicts, and the k-loop visits only
// [lo, hi) as `_kv_block_bounds` does. The products run on the FMA
// units in f32 (the TPU kernel's precision; the f32 tensor-core rate,
// TF32, would round the inputs).
//
// C interface (ctypes): mft_flash_attention_fwd returns the CUDA error
// code of the launch (0 on success). Shapes: q [B, Hq, S, D], k/v
// [B, Hkv, S, D] contiguous f32 (dtype 0; any other code is refused);
// pad [B, S] f32 (> 0 = real key); out like q; lse [B, Hq, S] f32;
// dropout = 0 or 1, with seed, thresh = round((1 - p) * 2^24) and
// inv_keep = 1 / (1 - p) from the wrapper.

#include "flash_attention_common.cuh"

namespace {

using mft::Dropout;
using mft::floor_div;
using mft::from_f32;
using mft::keep_bit;
using mft::NEG_INF;
using mft::to_f32;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;   // four threads per query row

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  // q_s [BQ][D+1], k_s [BK][D+1], v_s [BK][D], p_s [BQ][BK+1], pad_s [BK]
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1) + BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ pad,
                 T* __restrict__ out, float* __restrict__ lse, int Hq,
                 int Hkv, int S, float scale, int causal, int has_window,
                 int window, Dropout drop) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int NS = BK / 4;   // scores per thread
  constexpr int ND = D / 4;    // output columns per thread
  float* q_s = smem;
  float* k_s = q_s + BQ * DP;
  float* v_s = k_s + BK * DP;
  float* p_s = v_s + BK * D;
  float* pad_s = p_s + BQ * PP;

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // local query row
  const int c4 = tid & 3;   // lane within the row's quad
  const int row = row0 + r;

  const T* qp = q + (size_t)(b * Hq + h) * S * D;
  const T* kp = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * S * D;
  const float* padp = pad + (size_t)b * S;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D, gr = row0 + rr;
    q_s[rr * DP + d] = gr < S ? to_f32(qp[(size_t)gr * D + d]) : 0.f;
  }

  // [lo, hi): the key blocks any row of this q-block can reach
  const int nK = (S + BK - 1) / BK;
  const int hi = causal ? min(nK, (row0 + BQ - 1) / BK + 1) : nK;
  const int lo = has_window ? max(0, floor_div(row0 - window + 1, BK)) : 0;

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int kb = lo; kb < hi; ++kb) {
    const int col0 = kb * BK;
    __syncthreads();   // the previous tile is consumed (and q_s staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int cc = i / D, d = i % D, gc = col0 + cc;
      const bool in = gc < S;
      k_s[cc * DP + d] = in ? to_f32(kp[(size_t)gc * D + d]) : 0.f;
      v_s[cc * D + d] = in ? to_f32(vp[(size_t)gc * D + d]) : 0.f;
    }
    if (tid < BK) {
      const int gc = col0 + tid;
      pad_s[tid] = gc < S ? padp[gc] : 0.f;   // the ragged edge is padding
    }
    __syncthreads();

    float s[NS];
    unsigned okbits = 0;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int cc = c4 + 4 * j, col = col0 + cc;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        dot = fmaf(q_s[r * DP + d], k_s[cc * DP + d], dot);
      bool ok = pad_s[cc] > 0.f;
      if (causal) ok = ok && col <= row;
      if (has_window) ok = ok && col > row - window;
      s[j] = ok ? dot * scale : NEG_INF;
      okbits |= (ok ? 1u : 0u) << j;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = ((okbits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += p;   // the denominator sums the undropped probabilities
      float pv = p;
      if (drop.on)
        pv = keep_bit(drop.seed, b, h, row, col0 + c4 + 4 * j, drop.thresh)
                 ? p * drop.inv_keep
                 : 0.f;
      p_s[r * PP + c4 + 4 * j] = pv;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();   // a row's probabilities come from its own quad
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= alpha;
    for (int cc = 0; cc < BK; ++cc) {
      const float p = p_s[r * PP + cc];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        acc[i] = fmaf(p, v_s[cc * D + c4 + 4 * i], acc[i]);
    }
  }

  if (row < S) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* op = out + ((size_t)(b * Hq + h) * S + row) * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) op[c4 + 4 * i] = from_f32<T>(acc[i] / l_safe);
    if (c4 == 0) lse[(size_t)(b * Hq + h) * S + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pad,
           void* out, void* lse, int B, int Hq, int Hkv, int S, float scale,
           int causal, int has_window, int window, Dropout drop,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<T*>(out), static_cast<float*>(lse), Hq, Hkv, S, scale,
      causal, has_window, window, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* pad, void* out, void* lse, int B, int Hq,
               int Hkv, int S, float scale, int causal, int has_window,
               int window, Dropout drop, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, pad, out, lse, B, Hq, Hkv, S, scale,
                           causal, has_window, window, drop, st);
    case 128:
      return launch<T, 128>(q, k, v, pad, out, lse, B, Hq, Hkv, S, scale,
                            causal, has_window, window, drop, st);
    case 256:
      return launch<T, 256>(q, k, v, pad, out, lse, B, Hq, Hkv, S, scale,
                            causal, has_window, window, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* pad,
                                       void* out, void* lse, int B, int Hq,
                                       int Hkv, int S, int D, int dtype,
                                       float scale, int causal,
                                       int has_window, int window,
                                       int dropout, unsigned int seed,
                                       unsigned int thresh, float inv_keep,
                                       void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  switch (dtype) {
    case 0:
      return dispatch_d<float>(D, q, k, v, pad, out, lse, B, Hq, Hkv, S,
                               scale, causal, has_window, window, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
