// Flash-attention forward on Hopper's tensor cores (sm_90a) for f32
// inputs, in 3xTF32.
//
// Replaces: mobilefinetuner_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_fwd`) for f32 q, k and v, the dtype every CLI defaults
// to: online-softmax attention over only the key tiles the mask can
// reach, with key-padding, causal and sliding-window masks, GQA (q-head h
// reads kv-head h / G) and HF probs-dropout, returning out (f32) and the
// per-row logsumexp lse = m + log(max(l, 1e-30)) in f32. bf16 and f16 run
// flash_attention_fwd_mma.cu; the FMA kernel of flash_attention_fwd.cu,
// which f32 ran before, is kept as this kernel's earlier version.
//
// Bound on this card: at eval_mmlu's GPT-2 bucket (q 16 x 12 x 512 x 64,
// causal) the function reads q, k, v once and writes out and lse once,
// ~101 MB, 30 us at 3.35 TB/s, while its 6.45 GFLOP of products are 19.4
// GFLOP in 3xTF32, 39 us at the 495 TFLOP/s TF32 rate: operations bound
// it. The FMA kernel ran every product on the FMA units from shared
// memory (its shared-memory loads bound it: 3.1x SDPA's time there).
//
// Design: flash_attention_fwd_mma.cu's, with f32 operands split into TF32
// halves (tensor_core_tf32.cuh) and every product in 3xTF32 (m16n8k8
// mma.sync, three a k-step), which holds the f32 tolerances of the plain
// version (out and lse 1e-4); one TF32 product would round each operand
// to 2^-11.
//   One CTA of 4 warps per (BQ-row query block, q-head, batch). Each warp
//   owns 16 query rows (BQ 64); at D = 256 two warps share each 16 rows,
//   both computing S and P, each O for half of D (BQ 32), so that O stays
//   64 registers a lane.
//   Operands are split once a CTA, in shared memory: Q on arrival, then
//   each K / V tile of BK keys (32; 16 at D = 256) when its 16-byte
//   cp.async copies have landed (zero past S: keys >= S count as
//   padding), in place: the raw tile's plane keeps the high halves and a
//   second plane takes the low ones. A ring of two tiles: the next tile's
//   copies run while this one is split and used. Rows are D + 4 floats
//   apart, so ldmatrix reads and the permuted V column reads below are
//   free of bank conflicts. Shared memory: 104,704 / 203,008 / 199,808
//   bytes at D 64 / 128 / 256.
//   S = Q K^T: Q's A and K's B fragments by ldmatrix (an 8x4 f32 matrix
//   is an 8x8 b16 one). Scale and mask are applied to the accumulator
//   fragments, each element by its own (row, col), and the online softmax
//   runs in registers with the row max and sum over the lane quad that
//   holds a row, as the bf16 kernel does.
//   O += P V takes P's C fragments as its A fragments in place, split at
//   use: in the TF32 layout a C fragment holds columns 2t, 2t + 1 and the
//   A fragment wants t, t + 4, so the product's k index t is key 2t and
//   t + 4 is key 2t + 1, and V's B fragments are read with the same
//   permutation (rows 2t and 2t + 1, column g: plain 32-bit loads, since
//   ldmatrix cannot transpose 32-bit elements).
//   Masked keys add exactly 0 (p is re-masked after exp). Dropout's keep
//   bit is mft::keep_bit of each element's global (b, h, row, col), the
//   other kernels' mask bit for bit; l sums the undropped probabilities
//   and P V sees the kept ones scaled by 1 / (1 - p).
//
// C interface (ctypes): mft_flash_attention_fwd_tf32, the arguments of
// mft_flash_attention_fwd (flash_attention_fwd.cu) with dtype 0 (f32;
// any other code is refused) and 16-byte aligned q, k and v; returns the
// CUDA error code of the launch (0 on success).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"
#include "tensor_core_tf32.cuh"

namespace {

using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::Dropout;
using mft::floor_div;
using mft::keep_bit;
using mft::ldmatrix_x4;
using mft::mma_3xtf32;
using mft::NEG_INF;
using mft::pv_a;
using mft::split_rows;
using mft::stage_rows_f32;

constexpr int THREADS = 128;   // 4 warps

template <int D>
struct Cfg {
  // at D = 256 two warps share a row group: each computes S and P for
  // its 16 rows and O for half of D
  static constexpr int DS = D == 256 ? 2 : 1;
  static constexpr int BQ = 16 * (4 / DS);        // query rows of a CTA
  static constexpr int BK = D == 256 ? 16 : 32;   // keys of a tile
  static constexpr int LD = D + 4;                // smem row stride (f32)
  static constexpr int NT = BK / 8;               // score n-tiles
  static constexpr int ND = D / 8 / DS;           // output n-tiles a warp
  static constexpr int KD = D / 8;                // k-steps of Q K^T
  static constexpr int STAGES = 2;                // K / V ring
  // q hi, q lo [BQ][LD]; k hi, k lo, v hi, v lo [STAGES][BK][LD];
  // pad [STAGES][BK]
  static constexpr size_t SMEM =
      ((size_t)2 * BQ * LD + (size_t)4 * STAGES * BK * LD + STAGES * BK) *
      sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ pad,
                      float* __restrict__ out, float* __restrict__ lse,
                      int Hq, int Hkv, int S, float scale, int causal,
                      int has_window, int window, Dropout drop) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::NT, ND = C::ND,
                KD = C::KD, STAGES = C::STAGES;
  constexpr int TILE = BK * LD;   // one plane of a K or V tile
  extern __shared__ __align__(16) float smem[];
  float* qh = smem;                        // [BQ][LD]
  float* ql = qh + BQ * LD;                // [BQ][LD]
  float* kv = ql + BQ * LD;                // [STAGES][k hi, k lo, v hi, v lo]
  float* pad_s = kv + STAGES * 4 * TILE;   // [STAGES][BK]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp % (4 / C::DS);        // row group
  const int d0 = warp / (4 / C::DS) * (D / C::DS);   // first O column
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane % 8, lm = lane / 8;   // ldmatrix row, matrix
  const float* qp = q + (size_t)(b * Hq + h) * S * D;
  const float* kp = k + (size_t)(b * Hkv + hk) * S * D;
  const float* vp = v + (size_t)(b * Hkv + hk) * S * D;
  const float* padp = pad + (size_t)b * S;

  // [lo, hi): the key tiles any row of this block can reach
  const int nK = (S + BK - 1) / BK;
  const int hi = causal ? min(nK, (row0 + BQ - 1) / BK + 1) : nK;
  const int lo = has_window ? max(0, floor_div(row0 - window + 1, BK)) : 0;

  auto stage = [&](int kb, int buf) {
    const int col0 = kb * BK;
    float* base = kv + buf * 4 * TILE;
    stage_rows_f32<D, THREADS>(base, kp, col0, BK, S);
    stage_rows_f32<D, THREADS>(base + 2 * TILE, vp, col0, BK, S);
    for (int i = tid; i < BK; i += THREADS)
      pad_s[buf * BK + i] = col0 + i < S ? padp[col0 + i] : 0.f;
  };
  stage_rows_f32<D, THREADS>(qh, qp, row0, BQ, S);   // with the first tile
  if (lo < hi) stage(lo, 0);
  cp_async_commit();

  // this lane's rows: rw[0] = g, rw[1] = g + 8 of the warp's 16
  int rw[2];
  rw[0] = row0 + rg * 16 + g;
  rw[1] = rw[0] + 8;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // lane ldmatrix offsets: Q's A fragments (rows of the warp, k-step 0),
  // K's B fragments (two n-tiles of keys, k-step 0)
  const int q_off = (rg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 4;
  const int k_off = (lr + (lm / 2) * 8) * LD + (lm % 2) * 4;
  // V's permuted B fragments: rows 2t, 2t + 1 of a key k-step, column g
  const int v_off = 2 * t * LD + d0 + g;

  for (int kb = lo, it = 0; kb < hi; ++kb, ++it) {
    const int buf = it % STAGES, col0 = kb * BK;
    cp_async_wait<0>();   // this tile (and, first, Q) has landed
    __syncthreads();      // for every thread; the other buffer is consumed
    if (kb + 1 < hi) stage(kb + 1, (it + 1) % STAGES);
    cp_async_commit();
    float* base = kv + buf * 4 * TILE;
    if (it == 0) split_rows<D, THREADS>(qh, ql, BQ);
    split_rows<D, THREADS>(base, base + TILE, BK);
    split_rows<D, THREADS>(base + 2 * TILE, base + 3 * TILE, BK);
    __syncthreads();
    const float* kh = base;
    const float* kl = base + TILE;
    const float* vh = base + 2 * TILE;
    const float* vl = base + 3 * TILE;

    // S = Q K^T, 8 dims a k-step; K's B fragments two n-tiles at a time
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, qh + q_off + kc * 8);
      ldmatrix_x4(al, ql + q_off + kc * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, kh + k_off + j * 8 * LD + kc * 8);
        ldmatrix_x4(bl, kl + k_off + j * 8 * LD + kc * 8);
        mma_3xtf32(s[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(s[j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // scale and mask each element by its own (row, col); row max
    uint32_t okbits = 0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + 2 * t + (e & 1), col = col0 + cl;
        const int row = rw[e >> 1];
        bool ok = pad_s[buf * BK + cl] > 0.f;
        if (causal) ok = ok && col <= row;
        if (has_window) ok = ok && col > row - window;
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
        okbits |= (ok ? 1u : 0u) << (j * 4 + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // p (re-masked after exp); the denominator sums the undropped p, P V
    // sees the kept ones scaled
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ((okbits >> (j * 4 + e)) & 1u)
                            ? expf(s[j][e] - m[e >> 1]) : 0.f;
        psum[e >> 1] += p;
        float pv = p;
        if (drop.on)
          pv = keep_bit(drop.seed, b, h, rw[e >> 1],
                        col0 + j * 8 + 2 * t + (e & 1), drop.thresh)
                   ? p * drop.inv_keep : 0.f;
        s[j][e] = pv;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = l[i] * alpha[i] + psum[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, 8 keys (one score n-tile) a k-step: P's A fragments from
    // its C fragments in place, V's rows permuted to match
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      pv_a(s[j], ph, pl);
      const int vo = v_off + j * 8 * LD;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int o_ = vo + n * 8;
        mma_3xtf32(o[n], ph, pl, __float_as_uint(vh[o_]),
                   __float_as_uint(vh[o_ + LD]), __float_as_uint(vl[o_]),
                   __float_as_uint(vl[o_ + LD]));
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw[i];
    if (row >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* op = out + ((size_t)(b * Hq + h) * S + row) * D + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(o[n][2 * i] / l_safe, o[n][2 * i + 1] / l_safe);
    if (t == 0 && d0 == 0)
      lse[(size_t)(b * Hq + h) * S + row] = m[i] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pad,
           void* out, void* lse, int B, int Hq, int Hkv, int S, float scale,
           int causal, int has_window, int window, Dropout drop,
           cudaStream_t stream) {
  const size_t smem = Cfg<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + Cfg<D>::BQ - 1) / Cfg<D>::BQ, Hq, B);
  flash_fwd_tf32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(pad),
      static_cast<float*>(out), static_cast<float*>(lse), Hq, Hkv, S, scale,
      causal, has_window, window, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mft_flash_attention_fwd_tf32(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    void* lse, int B, int Hq, int Hkv, int S, int D, int dtype, float scale,
    int causal, int has_window, int window, int dropout, unsigned int seed,
    unsigned int thresh, float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  switch (D) {
    case 64:
      return launch<64>(q, k, v, pad, out, lse, B, Hq, Hkv, S, scale, causal,
                        has_window, window, drop, st);
    case 128:
      return launch<128>(q, k, v, pad, out, lse, B, Hq, Hkv, S, scale,
                         causal, has_window, window, drop, st);
    case 256:
      return launch<256>(q, k, v, pad, out, lse, B, Hq, Hkv, S, scale,
                         causal, has_window, window, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
