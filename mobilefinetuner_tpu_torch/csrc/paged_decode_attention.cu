// Paged decode attention for Hopper (sm_90a), f32: the first version.
//
// Replaces: mobilefinetuner_tpu/ops/decode_attention.py `_paged_kernel`
// (launched by `paged_decode_attention`) for f32 pools: one query token
// per slot attends its pages of the shared block pool [NB, L, KV, bT, D],
// page tbl[s, m] of `layer`, with an online softmax across pages. bf16
// and f16 pools run csrc/paged_decode_attention_vec.cu.
//
// Rounding follows the TPU kernel: q is in the pool dtype (the wrapper
// refuses anything else), scores and the running sums are f32, the
// probabilities are re-masked after exp (a fully masked page adds
// exactly 0; a masked row of a live page is skipped in P.V, so a NaN or
// Inf there adds 0 too). ctx is f32.
//
// Bound on this card: memory. Each (slot, kv-head) reads its live K and V
// pages once, bT * D * 4 bytes each; the arithmetic is 4 * D flops a key.
// Design: the block reads its own table row (there is no scalar
// prefetch); one CTA of four warps per (kv-head x query group, slot); the
// warps take pages round robin and walk a page as rows of 16-byte vector
// loads (D / 4 lanes a row, at most 32: at D 256 two loads a lane),
// reduce each score over those lanes with shuffles, keep
// their own (m, l, acc) and merge them in shared memory at the end. A
// page with no attendable column is skipped before its K/V are read,
// which is exact because it would add 0; the `ok` mask stays an input,
// so per-layer sliding windows compose later. Table entries are clamped
// to [0, NB) as an XLA gather clamps.
//
// C interface (ctypes): mft_paged_decode_attention returns the CUDA error
// code of the launch (0 on success). Shapes: q [S, KV, G, D] and the
// pools [NB, L, KV, bT, D] contiguous in f32 (dtype 0); tbl [S, M] int32;
// ok [S, M * bT] bool; ctx [S, KV, G, D] f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int* __restrict__ tbl,
                    const unsigned char* __restrict__ ok,
                    float* __restrict__ ctx, int KV, int G, int NB, int L,
                    int layer, int bT, int M, float scale) {
  constexpr int VEC = 16 / sizeof(T);                  // one 16-byte load
  constexpr int LPR = D / VEC < 32 ? D / VEC : 32;     // lanes on a K row
  constexpr int EPL = D / LPR;                         // its elements a lane
  constexpr int LOADS = EPL / VEC;                     // its loads a lane
  constexpr int RPP = 32 / LPR;                        // K rows a warp reads
  constexpr int DPL = D / 32;                          // ctx columns a lane
  static_assert(LPR >= 1 && 32 % LPR == 0, "row split");
  static_assert(EPL % VEC == 0 && DPL >= 1, "D in {64, 128, 256}");

  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_w = sm + warp * bT;            // this warp's scores / probs
  float* m_sh = sm + WARPS * bT;
  float* l_sh = m_sh + WARPS;
  float* acc_sh = l_sh + WARPS;           // [WARPS][D]

  const int kvg = blockIdx.x, kv = kvg / G, s = blockIdx.y;
  const size_t qrow = ((size_t)s * KV * G + kvg) * D;
  const int d0 = (lane % LPR) * EPL;
  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = q[qrow + d0 + e];

  const int* trow = tbl + (size_t)s * M;
  const unsigned char* okrow = ok + (size_t)s * M * bT;
  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int pg = warp; pg < M; pg += WARPS) {
    const unsigned char* okp = okrow + (size_t)pg * bT;
    bool any = false;
    for (int t = lane; t < bT; t += 32) any |= okp[t] != 0;
    if (!__any_sync(FULL, any)) continue;   // adds exactly 0: skip it
    const int blk = min(max(trow[pg], 0), NB - 1);
    const size_t base = (((size_t)blk * L + layer) * KV + kv) * bT * D;
    const T* kpg = pool_k + base;
    const T* vpg = pool_v + base;

    for (int t0 = 0; t0 < bT; t0 += RPP) {
      const int t = t0 + lane / LPR;
      float part = 0.f;
      if (t < bT) {
#pragma unroll
        for (int ld = 0; ld < LOADS; ++ld) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              kpg + (size_t)t * D + d0 + ld * VEC);
          const T* kel = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part = fmaf(qv[ld * VEC + e], kel[e], part);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(FULL, part, off);
      if (t < bT && lane % LPR == 0)
        s_w[t] = okp[t] ? part * scale : NEG_INF;
    }
    __syncwarp();
    float mx = NEG_INF;
    for (int t = lane; t < bT; t += 32) mx = fmaxf(mx, s_w[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int t = lane; t < bT; t += 32) {
      const float p = okp[t] ? expf(s_w[t] - m_new) : 0.f;
      s_w[t] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(FULL, psum, off);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    for (int t = 0; t < bT; ++t) {
      if (!okp[t]) continue;   // p = 0: the row is not read
      const float p = s_w[t];
      const T* vr = vpg + (size_t)t * D + lane * DPL;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
    }
    __syncwarp();   // s_w is rewritten by the next page
  }

  if (lane == 0) {
    m_sh[warp] = m;
    l_sh[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc_sh[warp * D + lane * DPL + i] = acc[i];
  __syncthreads();
  float mmax = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mmax = fmaxf(mmax, m_sh[w]);
  for (int d = threadIdx.x; d < D; d += WARPS * 32) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_sh[w] - mmax);
      num += f * acc_sh[w * D + d];
      den += f * l_sh[w];
    }
    ctx[qrow + d] = num / den;   // the token's own column keeps den > 0
  }
}

template <typename T, int D>
int launch(const void* q, const void* pk, const void* pv, const void* tbl,
           const void* ok, void* ctx, int S, int KV, int G, int NB, int L,
           int layer, int bT, int M, float scale, cudaStream_t st) {
  const size_t smem = (size_t)(WARPS * bT + 2 * WARPS + WARPS * D) *
                      sizeof(float);
  dim3 grid(KV * G, S);
  paged_decode_kernel<T, D><<<grid, WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(tbl),
      static_cast<const unsigned char*>(ok), static_cast<float*>(ctx), KV,
      G, NB, L, layer, bT, M, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* pk, const void* pv,
               const void* tbl, const void* ok, void* ctx, int S, int KV,
               int G, int NB, int L, int layer, int bT, int M, float scale,
               cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, pk, pv, tbl, ok, ctx, S, KV, G, NB, L, layer,
                           bT, M, scale, st);
    case 128:
      return launch<T, 128>(q, pk, pv, tbl, ok, ctx, S, KV, G, NB, L, layer,
                            bT, M, scale, st);
    case 256:
      return launch<T, 256>(q, pk, pv, tbl, ok, ctx, S, KV, G, NB, L, layer,
                            bT, M, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_paged_decode_attention(const void* q, const void* pool_k,
                                          const void* pool_v, const void* tbl,
                                          const void* ok, void* ctx, int S,
                                          int KV, int G, int D, int NB, int L,
                                          int layer, int bT, int M,
                                          int dtype, float scale,
                                          void* stream) {
  if (S <= 0 || S > 65535 || KV <= 0 || G <= 0 || NB <= 0 || bT <= 0 ||
      M <= 0 || layer < 0 || layer >= L || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch_d<float>(D, q, pool_k, pool_v, tbl, ok, ctx, S, KV, G, NB,
                           L, layer, bT, M, scale,
                           static_cast<cudaStream_t>(stream));
}
