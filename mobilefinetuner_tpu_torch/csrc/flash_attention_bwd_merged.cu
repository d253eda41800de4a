// Flash-attention backward, merged one-pass kernel, for Hopper (sm_90a).
//
// Replaces: mobilefinetuner_tpu/ops/flash_attention.py `_dkvq_kernel`
// (launched by `_bwd_merged`): per key block, dK and dV AND the dQ
// contributions from ONE recomputation of (s, p, dp, ds) per tile, with
// the causal / window / key-padding masks and the dropout keep mask of the
// forward. Delta = rowsum(dO * O) comes in from the wrapper (one torch
// pass, as the JAX package computes it in XLA).
//
// What changes on this card, and why: the TPU kernel carries the dQ slab
// of one (b, h) in VMEM scratch across a SEQUENTIAL key-block grid axis.
// Here the key blocks of one head run as parallel blocks in no order, so
// nothing can be carried between them. This kernel adds each tile's dQ
// contribution with f32 atomicAdd into a zeroed [B, Hq, S, D] f32
// workspace, and the wrapper casts it to q's dtype: one pass, no second
// kernel, at the cost of S/BLK atomic adds per dQ element (2 at the
// GPT-2 training shape, S = 128) and a summation order that changes from
// run to run (the tests hold it to a tolerance, not to bits). A second
// pass that recomputes ds per q-block is what the split pair does.
// For GQA, dK/dV are written per q-head ([B, Hq, S, D] f32 partials) and
// the wrapper group-sums them in one torch reduction, as the JAX wrapper
// does.
//
// Bound on this card: at the GPT-2 training shape (B 8, 12 heads, S 128,
// D 64, bf16, causal) the function reads q, k, v, dO (1.57 MB each) plus
// lse and delta and writes dq, dk, dv: ~11 MB, 3.3 us at 3.35 TB/s; its
// ~0.5 GFLOP of tile products would take 0.5 us on the tensor cores, so
// bytes bound it. This first version is far from that: every product
// runs on the FMA units in f32 from shared memory (the TPU kernel's
// precision), so shared-memory load issue bounds it. Design: one CTA of
// 256 threads per (key block, q-head, batch); K/V of the key block and
// each visited q-block's Q/dO are staged in shared memory as f32 with a
// padded stride, dK/dV accumulate in registers, and the q-loop visits
// only the q-blocks that can see the key block (`_q_block_bounds`).
// bf16 and f16 run on the tensor cores in
// flash_attention_bwd_merged_mma.cu; this kernel keeps f32.
//
// C interface (ctypes): mft_flash_attention_bwd_merged returns the CUDA
// error code of the launch (0 on success). q/dO [B, Hq, S, D] and k/v
// [B, Hkv, S, D] contiguous f32 (dtype 0; 1 bf16 and 2 f16 refused); pad
// [B, S] f32; lse, delta [B, Hq, S] f32; dq_acc (zeroed by the caller),
// dk_p, dv_p [B, Hq, S, D] f32.

#include "flash_attention_bwd.cuh"

namespace {

using namespace mft;

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_merged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ pad,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const T* __restrict__ dout,
                        float* __restrict__ dq_acc,
                        float* __restrict__ dk_p, float* __restrict__ dv_p,
                        BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int BLK = BwdTile<D>::BLK;
  constexpr int NA = BLK * D / BWD_THREADS;
  BwdTile<D> t(smem);
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int S = a.S, col0 = kb * BLK;
  const size_t qh = (size_t)(b * a.Hq + h) * S;     // row offset of (b, h)
  const size_t kh = (size_t)(b * a.Hkv + hk) * S;   // row offset of (b, hk)

  load_kv<T, D>(t, k + kh * D, v + kh * D, pad + (size_t)b * S, col0, S);
  float dk[NA], dv[NA];
#pragma unroll
  for (int n = 0; n < NA; ++n) dk[n] = dv[n] = 0.f;

  int qlo, qhi;
  q_block_bounds(col0, BLK, (S + BLK - 1) / BLK, a, &qlo, &qhi);
  for (int qi = qlo; qi < qhi; ++qi) {
    const int row0 = qi * BLK;
    __syncthreads();   // the previous tile is consumed (and K/V staged)
    load_q<T, D>(t, q + qh * D, dout + qh * D, lse + qh, delta + qh, row0,
                 S);
    __syncthreads();
    tile_p_ds<D>(t, a, b, h, row0, col0);
    __syncthreads();
    accumulate_dkv<D>(t, dk, dv);
    float dq[NA];
#pragma unroll
    for (int n = 0; n < NA; ++n) dq[n] = 0.f;
    accumulate_dq<D>(t, dq);
#pragma unroll
    for (int n = 0; n < NA; ++n) {   // this tile's dQ rows, added in f32
      const int idx = threadIdx.x + n * BWD_THREADS;
      const int row = row0 + idx / D;
      if (row < S) atomicAdd(dq_acc + (qh + row) * D + idx % D, dq[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int idx = threadIdx.x + n * BWD_THREADS;
    const int col = col0 + idx / D;
    if (col < S) {
      const size_t o = (qh + col) * D + idx % D;
      dk_p[o] = dk[n];
      dv_p[o] = dv[n];
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pad,
           const void* lse, const void* delta, const void* dout,
           void* dq_acc, void* dk_p, void* dv_p, int B, const BwdArgs& a,
           cudaStream_t st) {
  constexpr int BLK = BwdTile<D>::BLK;
  const size_t smem = BwdTile<D>::smem_floats() * sizeof(float);
  int e = set_smem(flash_bwd_merged_kernel<T, D>, smem);
  if (e) return e;
  dim3 grid((a.S + BLK - 1) / BLK, a.Hq, B);
  flash_bwd_merged_kernel<T, D><<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const T*>(dout), static_cast<float*>(dq_acc),
      static_cast<float*>(dk_p), static_cast<float*>(dv_p), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* pad, const void* lse, const void* delta,
               const void* dout, void* dq_acc, void* dk_p, void* dv_p,
               int B, const BwdArgs& a, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, pad, lse, delta, dout, dq_acc, dk_p,
                           dv_p, B, a, st);
    case 128:
      return launch<T, 128>(q, k, v, pad, lse, delta, dout, dq_acc, dk_p,
                            dv_p, B, a, st);
    case 256:
      return launch<T, 256>(q, k, v, pad, lse, delta, dout, dq_acc, dk_p,
                            dv_p, B, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_flash_attention_bwd_merged(
    const void* q, const void* k, const void* v, const void* pad,
    const void* lse, const void* delta, const void* dout, void* dq_acc,
    void* dk_p, void* dv_p, int B, int Hq, int Hkv, int S, int D, int dtype,
    float scale, int causal, int has_window, int window, int dropout,
    unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{Hq, Hkv, S, scale, causal, has_window, window,
                  Dropout{dropout, seed, thresh, inv_keep}};
  // f32 only: bf16 and f16 run on flash_attention_bwd_merged_mma.cu
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return dispatch_d<float>(D, q, k, v, pad, lse, delta, dout, dq_acc, dk_p,
                           dv_p, B, a, static_cast<cudaStream_t>(stream));
}
