// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 and f16.
//
// Replaces: mobilefinetuner_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_fwd`) for 16-bit inputs: online-softmax attention over
// only the key tiles the mask can reach, with key-padding, causal and
// sliding-window masks, GQA (q-head h reads kv-head h / G) and HF
// probs-dropout, returning out (q's dtype) and the per-row logsumexp
// lse = m + log(max(l, 1e-30)) in f32, the quantity the backward kernels
// read. f32 inputs stay on the FMA kernel of flash_attention_fwd.cu.
//
// Bound on this card: the work reads q, k, v once and writes out and lse
// once; at the Gemma-3 training shape (q 4 x 4 x 256 x 256, kv 4 x 1,
// causal) that is ~5.3 MB, 1.57 us at 3.35 TB/s, while its 4 D pairs =
// 0.54 GFLOP need 0.54 us at the bf16 tensor-core rate (the P_lo product
// below adds half again): bytes bound it, and in practice the launch and
// each CTA's serial key loop do.
//
// Design. One CTA per (32-row query block, q-head, batch): 32-row blocks
// give 128 CTAs at Gemma's B 4 x Hq 4 x S 256 (64-row blocks gave 64 on
// 132 SMs), and 384 at GPT-2's B 8 x 12 x 128. Each warp owns 16 query
// rows (two warps a CTA); at D = 256 two warps share each 16 rows, both
// computing S and P, each O for half of D (four warps a CTA: O stays 64
// registers a lane and twice the warps hide the latency).
//   S = Q K^T is an m16n8k16 mma.sync (bf16/f16 in, f32 accumulate). Q is
//   staged once in shared memory; at D <= 128 its A fragments are loaded
//   once into registers, at D = 256 they are re-read from shared memory
//   with ldmatrix at every key tile. K and V tiles stay in their storage
//   dtype, BK keys a tile (64; 32 at D = 256), in a ring of three tiles
//   filled by 16-byte cp.async copies that zero-fill the ragged edge
//   (keys >= S count as padding, as in the FMA kernel); rows are padded
//   by 16 bytes so ldmatrix reads are free of bank conflicts.
//   Scale and mask are applied to the accumulator fragments, each element
//   by its own (row, col); the online softmax runs in registers with the
//   row max and sum over the lane quad that holds a row.
//   O += P V is a second mma.sync, V's B fragments read by ldmatrix.trans.
//   P is repacked from the C fragments into A fragments in registers. To
//   keep P as faithful as the f32 kernel's, it is split P = P_hi + P_lo,
//   both in the input dtype, and each half is multiplied by V (two MMAs):
//   P's rounding error falls from 2^-9 to ~2^-17 of P.
//   The key loop visits [lo, hi) in BK-key tiles, the tiles any row of the
//   block can reach (causal: up to the block's last row; window: from
//   its first row's window); masked keys add exactly 0 (p is re-masked
//   after exp). Dropout's keep bit is mft::keep_bit of each element's
//   global (b, h, row, col), so the mask is the FMA kernel's bit for bit
//   and the backward kernels regenerate it; l sums the undropped
//   probabilities and P V sees the kept ones scaled by 1 / (1 - p).
//
// C interface (ctypes): mft_flash_attention_fwd_mma, the arguments of
// mft_flash_attention_fwd (flash_attention_fwd.cu) with dtype 1 (bf16)
// or 2 (f16); returns the CUDA error code of the launch (0 on success).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::Dropout;
using mft::floor_div;
using mft::from_f32;
using mft::keep_bit;
using mft::ldmatrix_x4;
using mft::ldmatrix_x4_trans;
using mft::mma_16816;
using mft::NEG_INF;
using mft::pack2;
using mft::round_to;

constexpr int WARPS = 2;                // row groups of 16 query rows
constexpr int BQ = 16 * WARPS;          // query rows of a CTA

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 32 : 64;   // keys of a tile
  static constexpr int LD = D + 8;                // smem row stride
  static constexpr bool Q_REGS = D <= 128;
  static constexpr int NT = BK / 8;               // score n-tiles
  // at D = 256 two warps share a row group: each computes S and P for
  // its 16 rows and O for half of D (O alone would be 128 registers)
  static constexpr int DS = D == 256 ? 2 : 1;
  static constexpr int THREADS = 32 * WARPS * DS;
  static constexpr int ND = D / 8 / DS;           // output n-tiles a warp
  static constexpr int KD = D / 16;               // k-steps of Q K^T
  // a ring of K/V tiles, the copies STAGES - 1 tiles ahead
  static constexpr int STAGES = 3;
  // q [BQ][LD], k and v [STAGES][BK][LD] in T; pad [STAGES][BK] f32
  static constexpr size_t smem_bytes(size_t elem) {
    return (size_t)(BQ + 2 * STAGES * BK) * LD * elem +
           STAGES * BK * sizeof(float);
  }
};

// rows [row0, row0 + n) of a [S, D] slab into dst[n][LD], zero past S
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int n, int S) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CH; i += Cfg<D>::THREADS) {
    const int r = i / CH, c = (i % CH) * 8, g = row0 + r;
    cp_async_16(dst + r * Cfg<D>::LD + c,
                src + (size_t)min(g, S - 1) * D + c, g < S);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ pad,
                     T* __restrict__ out, float* __restrict__ lse, int Hq,
                     int Hkv, int S, float scale, int causal,
                     int has_window, int window, Dropout drop) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, LD = C::LD, NT = C::NT, ND = C::ND,
                KD = C::KD, THREADS = C::THREADS, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + BQ * LD;
  T* v_s = k_s + STAGES * BK * LD;
  float* pad_s = reinterpret_cast<float*>(v_s + STAGES * BK * LD);

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = (tid / 32) % WARPS;      // row group
  const int d0 = (tid / 32) / WARPS * (D / C::DS);   // first O column
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane % 8, lm = lane / 8;   // ldmatrix row, matrix
  const T* qp = q + (size_t)(b * Hq + h) * S * D;
  const T* kp = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * S * D;
  const float* padp = pad + (size_t)b * S;

  // [lo, hi): the key tiles any row of this block can reach
  const int nK = (S + BK - 1) / BK;
  const int hi = causal ? min(nK, (row0 + BQ - 1) / BK + 1) : nK;
  const int lo = has_window ? max(0, floor_div(row0 - window + 1, BK)) : 0;

  auto stage = [&](int kb, int buf) {
    const int col0 = kb * BK;
    stage_rows<T, D>(k_s + buf * BK * LD, kp, col0, BK, S);
    stage_rows<T, D>(v_s + buf * BK * LD, vp, col0, BK, S);
    for (int i = tid; i < BK; i += THREADS)
      pad_s[buf * BK + i] = col0 + i < S ? padp[col0 + i] : 0.f;
  };
  stage_rows<T, D>(q_s, qp, row0, BQ, S);   // with the first group
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (lo + i < hi) stage(lo + i, i);
    cp_async_commit();
  }

  // this lane's rows: rw[0] = g, rw[1] = g + 8 of the warp's 16
  int rw[2];
  rw[0] = row0 + warp * 16 + g;
  rw[1] = rw[0] + 8;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[C::Q_REGS ? KD : 1][4];
  // lane's ldmatrix address in q_s for k-step kc: A of the warp's rows
  const T* q_lane = q_s + (warp * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;

  for (int kb = lo, it = 0; kb < hi; ++kb, ++it) {
    const int buf = it % STAGES, col0 = kb * BK;
    if (kb + STAGES - 1 < hi)
      stage(kb + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // this tile's group has landed
    __syncthreads();
    if constexpr (C::Q_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < KD; ++kc) ldmatrix_x4(qf[kc], q_lane + kc * 16);
      }
    }
    const T* kt = k_s + buf * BK * LD;
    const T* vt = v_s + buf * BK * LD;

    // S = Q K^T: per k-step one A fragment, K's B fragments two n-tiles
    // (16 keys) at a time
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const T* k_lane = kt + (lr + (lm / 2) * 8) * LD + (lm % 2) * 8;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t a[4];
      if constexpr (C::Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kc][i];
      } else {
        ldmatrix_x4(a, q_lane + kc * 16);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_lane + j * 8 * LD + kc * 16);
        mma_16816<T>(s[j], a, bk[0], bk[1]);
        mma_16816<T>(s[j + 1], a, bk[2], bk[3]);
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

    // O += (P_hi + P_lo) V, 16 keys a k-step; P's A fragments from the C
    // fragments of n-tiles 2 kk and 2 kk + 1
    const T* v_lane = vt + (lr + (lm % 2) * 8) * LD + d0 + (lm / 2) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a0: (g, keys 2t..), a1: (g+8, ..), a2/a3: the next n-tile
        const float* c = &s[2 * kk + (i >> 1)][(i & 1) * 2];
        const float h0 = round_to<T>(c[0]), h1 = round_to<T>(c[1]);
        ph[i] = pack2<T>(h0, h1);
        pl[i] = pack2<T>(c[0] - h0, c[1] - h1);
      }
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_lane + kk * 16 * LD + n * 8);
        mma_16816<T>(o[n], ph, bv[0], bv[1]);
        mma_16816<T>(o[n], pl, bv[0], bv[1]);
        mma_16816<T>(o[n + 1], ph, bv[2], bv[3]);
        mma_16816<T>(o[n + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this buffer is consumed before it is restaged
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw[i];
    if (row >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* op = out + ((size_t)(b * Hq + h) * S + row) * D + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const uint32_t packed =
          pack2<T>(o[n][2 * i] / l_safe, o[n][2 * i + 1] / l_safe);
      *reinterpret_cast<uint32_t*>(op + n * 8) = packed;
    }
    if (t == 0 && d0 == 0)
      lse[(size_t)(b * Hq + h) * S + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pad,
           void* out, void* lse, int B, int Hq, int Hkv, int S, float scale,
           int causal, int has_window, int window, Dropout drop,
           cudaStream_t stream) {
  const size_t smem = Cfg<D>::smem_bytes(sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_mma_kernel<T, D><<<grid, Cfg<D>::THREADS, smem, stream>>>(
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

extern "C" int mft_flash_attention_fwd_mma(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    void* lse, int B, int Hq, int Hkv, int S, int D, int dtype, float scale,
    int causal, int has_window, int window, int dropout, unsigned int seed,
    unsigned int thresh, float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  switch (dtype) {
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, pad, out, lse, B, Hq, Hkv,
                                       S, scale, causal, has_window, window,
                                       drop, st);
    case 2:
      return dispatch_d<__half>(D, q, k, v, pad, out, lse, B, Hq, Hkv, S,
                                scale, causal, has_window, window, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
