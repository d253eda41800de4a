// Flash-attention backward, split pair (FlashAttention-2 style), for
// Hopper (sm_90a). This one source holds TWO kernels, each with its own C
// entry point, bound and counted separately by the wrapper
// (ops/flash_attention.py): they are the two halves of one function and
// share all their tile code (flash_attention_bwd.cuh), which is why they
// are not one file each.
//
// Replaces: mobilefinetuner_tpu/ops/flash_attention.py
//   `_dq_kernel`  (launched by `_bwd`): dQ, one program per q-block with
//                 the forward's [lo, hi) key-block skipping;
//   `_dkv_kernel` (launched by `_bwd`): dK/dV per key block, the G q-heads
//                 of a kv-head summed.
// Each recomputes (s, p, dp, ds) for its tiles with the forward's masks
// and dropout keep bits; Delta = rowsum(dO * O) comes from the wrapper.
//
// What changes on this card: the TPU dK/dV kernel sums a kv-head's G
// q-heads over CONSECUTIVE steps of a sequential grid axis, accumulating
// into a resident output block. Here one CTA per (key block, kv-head,
// batch) loops over the G q-heads itself, so the sum needs no order
// between blocks and no atomics; dK/dV are written once, in f32, and the
// wrapper casts them. dQ needs no cross-block sum at all: each CTA owns
// its q-block's rows and writes dq in q's dtype. The price against the
// merged kernel is the one the TPU kernels pay too: (s, p, dp, ds) are
// recomputed in both kernels (7 tile products against 5) and K/V/dO/lse
// are read twice, over two launches.
//
// Bound on this card: the same function as the merged kernel, so the
// same bound (~11 MB at the GPT-2 training shape: 3.3 us at 3.35 TB/s,
// bytes-bound); both kernels run their products on the FMA units in f32
// from shared memory, which bounds them well above that. Design: 256
// threads a CTA, square tiles of 64 (32 at D = 256) staged as f32 with a
// padded stride, accumulators in registers.
//
// C interface (ctypes): mft_flash_attention_bwd_dq and
// mft_flash_attention_bwd_dkv return the CUDA error code of the launch.
// q/dO/dq [B, Hq, S, D] and k/v [B, Hkv, S, D] contiguous in one dtype
// (0 f32, 1 bf16, 2 f16); pad [B, S] f32; lse, delta [B, Hq, S] f32;
// dk, dv [B, Hkv, S, D] f32.

#include "flash_attention_bwd.cuh"

namespace {

using namespace mft;

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ pad,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int BLK = BwdTile<D>::BLK;
  constexpr int NA = BLK * D / BWD_THREADS;
  BwdTile<D> t(smem);
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int S = a.S, row0 = qi * BLK;
  const size_t qh = (size_t)(b * a.Hq + h) * S;
  const size_t kh = (size_t)(b * a.Hkv + hk) * S;

  load_q<T, D>(t, q + qh * D, dout + qh * D, lse + qh, delta + qh, row0, S);
  float acc[NA];
#pragma unroll
  for (int n = 0; n < NA; ++n) acc[n] = 0.f;
  int lo, hi;
  kv_block_bounds(row0, BLK, (S + BLK - 1) / BLK, a, &lo, &hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int col0 = kb * BLK;
    __syncthreads();   // the previous tile is consumed (and Q/dO staged)
    load_kv<T, D>(t, k + kh * D, v + kh * D, pad + (size_t)b * S, col0, S);
    __syncthreads();
    tile_p_ds<D>(t, a, b, h, row0, col0);
    __syncthreads();
    accumulate_dq<D>(t, acc);
  }
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int idx = threadIdx.x + n * BWD_THREADS;
    const int row = row0 + idx / D;
    if (row < S) dq[(qh + row) * D + idx % D] = from_f32<T>(acc[n]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ pad,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const T* __restrict__ dout, float* __restrict__ dk_out,
                     float* __restrict__ dv_out, BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int BLK = BwdTile<D>::BLK;
  constexpr int NA = BLK * D / BWD_THREADS;
  BwdTile<D> t(smem);
  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int S = a.S, col0 = kb * BLK;
  const size_t kh = (size_t)(b * a.Hkv + hk) * S;

  load_kv<T, D>(t, k + kh * D, v + kh * D, pad + (size_t)b * S, col0, S);
  float dk[NA], dv[NA];
#pragma unroll
  for (int n = 0; n < NA; ++n) dk[n] = dv[n] = 0.f;
  int qlo, qhi;
  q_block_bounds(col0, BLK, (S + BLK - 1) / BLK, a, &qlo, &qhi);
  for (int g = 0; g < G; ++g) {   // the kv-head's q-heads, summed here
    const int h = hk * G + g;
    const size_t qh = (size_t)(b * a.Hq + h) * S;
    for (int qi = qlo; qi < qhi; ++qi) {
      const int row0 = qi * BLK;
      __syncthreads();
      load_q<T, D>(t, q + qh * D, dout + qh * D, lse + qh, delta + qh,
                   row0, S);
      __syncthreads();
      tile_p_ds<D>(t, a, b, h, row0, col0);
      __syncthreads();
      accumulate_dkv<D>(t, dk, dv);
    }
  }
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int idx = threadIdx.x + n * BWD_THREADS;
    const int col = col0 + idx / D;
    if (col < S) {
      const size_t o = (kh + col) * D + idx % D;
      dk_out[o] = dk[n];
      dv_out[o] = dv[n];
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* pad,
              const void* lse, const void* delta, const void* dout,
              void* dq, int B, const BwdArgs& a, cudaStream_t st) {
  constexpr int BLK = BwdTile<D>::BLK;
  const size_t smem = BwdTile<D>::smem_floats() * sizeof(float);
  int e = set_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (e) return e;
  dim3 grid((a.S + BLK - 1) / BLK, a.Hq, B);
  flash_bwd_dq_kernel<T, D><<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const T*>(dout), static_cast<T*>(dq), a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* pad,
               const void* lse, const void* delta, const void* dout,
               void* dk, void* dv, int B, const BwdArgs& a,
               cudaStream_t st) {
  constexpr int BLK = BwdTile<D>::BLK;
  const size_t smem = BwdTile<D>::smem_floats() * sizeof(float);
  int e = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (e) return e;
  dim3 grid((a.S + BLK - 1) / BLK, a.Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const T*>(dout), static_cast<float*>(dk),
      static_cast<float*>(dv), a);
  return (int)cudaGetLastError();
}

// one switch over (dtype, D) for both entry points
template <bool DQ, typename T, int D>
int launch_one(const void* q, const void* k, const void* v, const void* pad,
               const void* lse, const void* delta, const void* dout,
               void* o1, void* o2, int B, const BwdArgs& a,
               cudaStream_t st) {
  if (DQ) return launch_dq<T, D>(q, k, v, pad, lse, delta, dout, o1, B, a,
                                 st);
  return launch_dkv<T, D>(q, k, v, pad, lse, delta, dout, o1, o2, B, a, st);
}

template <bool DQ, typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* pad, const void* lse, const void* delta,
               const void* dout, void* o1, void* o2, int B,
               const BwdArgs& a, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_one<DQ, T, 64>(q, k, v, pad, lse, delta, dout, o1, o2,
                                   B, a, st);
    case 128:
      return launch_one<DQ, T, 128>(q, k, v, pad, lse, delta, dout, o1, o2,
                                    B, a, st);
    case 256:
      return launch_one<DQ, T, 256>(q, k, v, pad, lse, delta, dout, o1, o2,
                                    B, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(const void* q, const void* k, const void* v, const void* pad,
             const void* lse, const void* delta, const void* dout, void* o1,
             void* o2, int B, int Hq, int Hkv, int S, int D, int dtype,
             float scale, int causal, int has_window, int window,
             int dropout, unsigned int seed, unsigned int thresh,
             float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{Hq, Hkv, S, scale, causal, has_window, window,
                  Dropout{dropout, seed, thresh, inv_keep}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<DQ, float>(D, q, k, v, pad, lse, delta, dout, o1, o2,
                                   B, a, st);
    case 1:
      return dispatch_d<DQ, __nv_bfloat16>(D, q, k, v, pad, lse, delta,
                                           dout, o1, o2, B, a, st);
    case 2:
      return dispatch_d<DQ, __half>(D, q, k, v, pad, lse, delta, dout, o1,
                                    o2, B, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* pad,
    const void* lse, const void* delta, const void* dout, void* dq, int B,
    int Hq, int Hkv, int S, int D, int dtype, float scale, int causal,
    int has_window, int window, int dropout, unsigned int seed,
    unsigned int thresh, float inv_keep, void* stream) {
  return dispatch<true>(q, k, v, pad, lse, delta, dout, dq, nullptr, B, Hq,
                        Hkv, S, D, dtype, scale, causal, has_window, window,
                        dropout, seed, thresh, inv_keep, stream);
}

extern "C" int mft_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* pad,
    const void* lse, const void* delta, const void* dout, void* dk,
    void* dv, int B, int Hq, int Hkv, int S, int D, int dtype, float scale,
    int causal, int has_window, int window, int dropout, unsigned int seed,
    unsigned int thresh, float inv_keep, void* stream) {
  return dispatch<false>(q, k, v, pad, lse, delta, dout, dk, dv, B, Hq, Hkv,
                         S, D, dtype, scale, causal, has_window, window,
                         dropout, seed, thresh, inv_keep, stream);
}
