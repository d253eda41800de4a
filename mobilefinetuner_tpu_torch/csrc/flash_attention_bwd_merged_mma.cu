// Flash-attention backward, merged one-pass kernel, on Hopper's tensor
// cores (sm_90a), bf16 and f16.
//
// Replaces: mobilefinetuner_tpu/ops/flash_attention.py `_dkvq_kernel`
// (launched by `_bwd_merged`) for 16-bit q, k, v and dO: per key block,
// dK and dV and the key block's dQ contributions from ONE recomputation
// of (s, p, dp, ds) a tile, with the key-padding, causal and
// sliding-window masks, the forward's dropout keep bits
// (mft::keep_bit of the global (b, h, row, col)) and GQA (q-head h reads
// kv-head h / G). delta = rowsum(dO * O) and the forward's lse come in
// from the wrapper. f32 stays on the FMA kernel of
// flash_attention_bwd_merged.cu.
//
// Bound on this card: at the GPT-2 training shape (B 8, 12 heads, S 128,
// D 64, causal) the function reads q, k, v, dO, lse and delta and writes
// dq, dk and dv once: ~11 MB, 3.3 us at 3.35 TB/s; its 5 tile products
// (~0.5 GFLOP; ~1.35 GFLOP at Gemma's q 4 x 4 x 256 x 256, kv 4 x 1)
// need ~1 us on the tensor cores. Bytes bound it; in practice the launch,
// the wrapper's passes and each CTA's serial q-loop set the time.
//
// Design. One CTA per (key block of BK keys, q-head, batch); warp w holds
// the 16 keys kg = w % KG of the block and, of dK and dV, the D / DS
// columns ds = w / KG (at D >= 128 two warps share each 16 keys, so that
// the f32 dK / dV accumulators stay at most 128 registers a lane).
//   K and V of the key block are loaded once by cp.async, in their
//   storage dtype, into rows padded by 16 bytes (ldmatrix free of bank
//   conflicts). The q-loop walks [qlo, qhi), the q-blocks that can see
//   the key block, streaming Q, dO, lse and delta for each BQ-row q-block
//   through a ring of two stages (16-byte cp.async, zero past S).
//   The tile is computed transposed, with the key rows as the MMA's M:
//   S^T = K Q^T and dP^T = V dO^T (m16n8k16 mma.sync, K and V as A from
//   ldmatrix, Q and dO as the column-major B). So each C fragment element
//   holds (row = KEY g / g + 8, column = QUERY 2t / 2t + 1): the masks,
//   the keep bit, lse and delta are taken at that swapped (query, key).
//   P^T and dS^T = P (dP - delta) scale stay in those registers and
//   repack, rounded to the operand dtype, into the A fragments of
//   dV += P^T dO and dK += dS^T Q, whose B operands dO and Q are read by
//   ldmatrix.trans: no shared-memory round trip. dQ += dS K needs dS
//   un-transposed: one warp of each 16 keys writes its dS^T to shared
//   memory in the operand dtype, and every warp reads it back as the A
//   operand with ldmatrix.trans (an m-tile of 16 query rows and a
//   multiple of 64 columns of dQ a warp, K as the B operand by
//   ldmatrix.trans); the f32 tile is added to the dQ workspace by vector
//   atomics (f32x2, no return: red.global.add.v2.f32 on sm_90).
//   Masked pairs add exactly 0: p = 0 outside the mask (a fully masked
//   query row, whose lse comes from l_safe, has every p = 0).
//   Precision: p and ds are formed in f32, as the TPU kernel and the
//   plain version form them, and rounded once to the operand dtype for
//   their products, as SDPA does. Splitting them into hi + lo halves (two
//   MMAs each, as the forward does for P) cut the bf16 error of dq / dk /
//   dv at GPT-2's shape from 4.0e-3 / 6.9e-3 / 5.8e-3 to 1.0e-3 / 1.7e-3 /
//   2.9e-3 of max(1, |ref|) and cost 1-4 us on an H100; the single
//   rounding is well inside the 2e-2 tolerance (PERF.md).
//   Outputs: the launcher zeroes the f32 dQ workspace, the main kernel
//   writes dK and dV once an element (in the operand dtype when the
//   q-head is its kv-head's only one; else this q-head's f32 partials,
//   [B, Hq, S, D]), and a finish kernel casts dQ and sums a kv-head's G
//   partials in head order. One CTA for the G q-heads of a kv-head
//   (dK / dV summed in registers) left 32 CTAs at Gemma's shape and took
//   186 us against 70 (PERF.md).
//   Not deterministic: dQ's atomic sums change order from run to run (S /
//   BK adds an element), as the FMA kernel's did; dK and dV are.
// Tiles (Cfg): D 64: BK 32, BQ 32, 2 warps (384 CTAs at GPT-2's B 8 x 12
// heads x S 128); D 128: BK 64, BQ 64, 8 warps; D 256: BK 32, BQ 32, 4
// warps (128 CTAs at Gemma-3's B 4 x Hq 4 x S 256). 64-key blocks at
// D 64, 16-key blocks or 64-row q-blocks at D 256 were no faster.
// What holds it back: latency. Each CTA's q-loop is serial (key block 0
// of a causal head visits every q-block) and one or two CTAs an SM hide
// little of each step's ldmatrix -> mma -> exp chain; the two warps of a
// key group at D >= 128 each recompute all of S^T and dP^T; dQ's atomics
// cost 2-5 us.
//
// C interface (ctypes): mft_flash_attention_bwd_merged_mma returns the
// CUDA error code of its launches. q/dO [B, Hq, S, D] and k/v
// [B, Hkv, S, D] contiguous, 16-byte aligned, in one dtype (1 bf16,
// 2 f16); pad [B, S] f32; lse, delta [B, Hq, S] f32; dq_acc [B, Hq, S, D]
// f32 workspace; dk_p, dv_p [B, Hq, S, D] f32 workspaces (null when
// Hq == Hkv); dq [B, Hq, S, D] and dk, dv [B, Hkv, S, D] in the operand
// dtype; then the shape, mask and dropout arguments of
// mft_flash_attention_bwd_merged (flash_attention_bwd_merged.cu).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_4;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::Dropout;
using mft::floor_div;
using mft::keep_bit;
using mft::ldmatrix_x4;
using mft::ldmatrix_x4_trans;
using mft::mma_16816;
using mft::pack2;

template <int D>
struct Cfg {
  static constexpr int BK = D == 128 ? 64 : 32;   // keys of a CTA
  static constexpr int BQ = D == 128 ? 64 : 32;   // query rows a q-block
  static constexpr int KG = BK / 16;              // key groups of 16
  static constexpr int DS = D == 64 ? 1 : 2;      // warps a key group
  static constexpr int WARPS = KG * DS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 8;                // smem row stride (T)
  static constexpr int LDS = BQ + 8;              // dS^T row stride (T)
  static constexpr int NW = D / DS / 8;           // dK/dV n-tiles a warp
  static constexpr int NQ = BQ / 8;               // S^T n-tiles (queries)
  static constexpr int KD = D / 16;               // k-steps of S^T, dP^T
  static constexpr int MT = BQ / 16;              // dQ m-tiles
  static constexpr int DQC = D * MT / WARPS;      // dQ columns a warp
  static constexpr int STAGES = 2;                // Q/dO ring
  static_assert(WARPS % MT == 0 && DQC % 64 == 0, "dQ split");
  // k, v [BK][LD], q, dO [STAGES][BQ][LD], dS^T [BK][LDS] in T;
  // lse, delta [STAGES][BQ] and pad [BK] in f32
  static constexpr size_t smem_bytes(size_t elem) {
    return (size_t)(2 * BK * LD + 2 * STAGES * BQ * LD + BK * LDS) * elem +
           (2 * STAGES * BQ + BK) * sizeof(float);
  }
};

// rows [row0, row0 + n) of a [S, D] slab into dst[n][D + 8], zero past S
template <typename T, int D, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int n, int S) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8, g = row0 + r;
    cp_async_16(dst + r * (D + 8) + c, src + (size_t)min(g, S - 1) * D + c,
                g < S);
  }
}

// *p += (a, b) with no return (f32x2 atomics: sm_90)
__device__ __forceinline__ void red_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
bwd_merged_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ pad,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const T* __restrict__ dout,
                      float* __restrict__ dq_acc, float* __restrict__ dk_p,
                      float* __restrict__ dv_p, T* __restrict__ dk,
                      T* __restrict__ dv, int Hq, int Hkv, int S,
                      float scale, int causal, int has_window, int window,
                      Dropout drop) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, KG = C::KG, LD = C::LD,
                LDS = C::LDS, NW = C::NW, NQ = C::NQ, KD = C::KD,
                MT = C::MT, DQC = C::DQC, THREADS = C::THREADS,
                STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + BK * LD;
  T* q_s = v_s + BK * LD;                 // [STAGES][BQ][LD]
  T* do_s = q_s + STAGES * BQ * LD;       // [STAGES][BQ][LD]
  T* ds_s = do_s + STAGES * BQ * LD;      // [BK][LDS]: dS^T
  float* lse_s = reinterpret_cast<float*>(ds_s + BK * LDS);   // [STAGES][BQ]
  float* dl_s = lse_s + STAGES * BQ;                          // [STAGES][BQ]
  float* pad_s = dl_s + STAGES * BQ;                          // [BK]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int col0 = blockIdx.x * BK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane % 8, lm = lane / 8;   // ldmatrix row, matrix
  const int kg = warp % KG, dsi = warp / KG;
  const int kb0 = kg * 16;                  // the warp's keys in the block
  const int d0 = dsi * (D / C::DS);         // its dK/dV columns
  const size_t qh = (size_t)(b * Hq + h) * S;     // row offset of (b, h)
  const size_t kh = (size_t)(b * Hkv + hk) * S;   // row offset of (b, hk)
  const T* qp = q + qh * D;
  const T* dop = dout + qh * D;

  // [qlo, qhi): the q-blocks that can see this key block
  const int nQ = (S + BQ - 1) / BQ;
  const int qlo = causal ? col0 / BQ : 0;
  const int qhi = has_window
                      ? min(nQ, floor_div(col0 + BK + window - 2, BQ) + 1)
                      : nQ;

  stage_rows<T, D, THREADS>(k_s, k + kh * D, col0, BK, S);
  stage_rows<T, D, THREADS>(v_s, v + kh * D, col0, BK, S);
  for (int i = tid; i < BK; i += THREADS)
    pad_s[i] = col0 + i < S ? pad[(size_t)b * S + col0 + i] : 0.f;
  auto stage = [&](int qi, int buf) {
    const int row0 = qi * BQ;
    stage_rows<T, D, THREADS>(q_s + buf * BQ * LD, qp, row0, BQ, S);
    stage_rows<T, D, THREADS>(do_s + buf * BQ * LD, dop, row0, BQ, S);
    for (int i = tid; i < BQ; i += THREADS) {
      const int r = row0 + i, rc = min(r, S - 1);
      cp_async_4(lse_s + buf * BQ + i, lse + qh + rc, r < S);
      cp_async_4(dl_s + buf * BQ + i, delta + qh + rc, r < S);
    }
  };
  if (qlo < qhi) stage(qlo, 0);   // with K and V: one group
  cp_async_commit();

  float dka[NW][4], dva[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // lane addresses: K / V rows of the warp's keys as S^T's and dP^T's A;
  // Q / dO rows as their column-major B (offset in a stage); Q / dO as
  // the B of dK / dV (transposed, the warp's columns); dS^T as dQ's A
  // (transposed, m-tile mq) and K as its B (transposed, columns dq0..)
  const int a_off = (kb0 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
  const int b_off = (lr + (lm / 2) * 8) * LD + (lm % 2) * 8;
  const int bt_off = (lr + (lm % 2) * 8) * LD + d0 + (lm / 2) * 8;
  const int mq = warp % MT, dq0 = (warp / MT) * DQC;
  const T* ds_a = ds_s + (lr + (lm / 2) * 8) * LDS + mq * 16 + (lm % 2) * 8;
  const T* k_t = k_s + (lr + (lm % 2) * 8) * LD + dq0 + (lm / 2) * 8;

  for (int qi = qlo, it = 0; qi < qhi; ++qi, ++it) {
    const int buf = it % STAGES, row0 = qi * BQ;
    if (qi + 1 < qhi) stage(qi + 1, (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();   // this q-block's group has landed
    __syncthreads();
    const T* qt = q_s + buf * BQ * LD;
    const T* dot = do_s + buf * BQ * LD;
    const float* lq = lse_s + buf * BQ;
    const float* dlq = dl_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: [16 keys, BQ queries] a warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, k_s + a_off + kc * 16);
      ldmatrix_x4(av, v_s + a_off + kc * 16);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, qt + b_off + j * 8 * LD + kc * 16);
        ldmatrix_x4(bo, dot + b_off + j * 8 * LD + kc * 16);
        mma_16816<T>(s[j], ak, bq[0], bq[1]);
        mma_16816<T>(s[j + 1], ak, bq[2], bq[3]);
        mma_16816<T>(dp[j], av, bo[0], bo[1]);
        mma_16816<T>(dp[j + 1], av, bo[2], bo[3]);
      }
    }

    // p and ds of each element at its own (query, key): fragment
    // element (j, e) is key kb0 + g + 8 (e >> 1), query 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kb0 + g + 8 * (e >> 1), key = col0 + kl;
        const int ql = j * 8 + 2 * t + (e & 1), row = row0 + ql;
        bool ok = pad_s[kl] > 0.f && row < S;
        if (causal) ok = ok && key <= row;
        if (has_window) ok = ok && key > row - window;
        const float p = ok ? expf(s[j][e] * scale - lq[ql]) : 0.f;
        float pv = p, dpv = dp[j][e];
        if (drop.on) {
          const bool keep = keep_bit(drop.seed, b, h, row, key, drop.thresh);
          pv = keep ? p * drop.inv_keep : 0.f;
          dpv = keep ? dpv * drop.inv_keep : 0.f;
        }
        s[j][e] = pv;
        dp[j][e] = p * (dpv - dlq[ql]) * scale;
      }

    // dV += P^T dO and dK += dS^T Q, 16 queries a k-step: the A
    // fragments from the C fragments of n-tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* cp = &s[2 * kk + (i >> 1)][(i & 1) * 2];
        const float* cd = &dp[2 * kk + (i >> 1)][(i & 1) * 2];
        pa[i] = pack2<T>(cp[0], cp[1]);
        da[i] = pack2<T>(cd[0], cd[1]);
      }
#pragma unroll
      for (int n = 0; n < NW; n += 2) {
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, dot + bt_off + kk * 16 * LD + n * 8);
        ldmatrix_x4_trans(bq, qt + bt_off + kk * 16 * LD + n * 8);
        mma_16816<T>(dva[n], pa, bo[0], bo[1]);
        mma_16816<T>(dva[n + 1], pa, bo[2], bo[3]);
        mma_16816<T>(dka[n], da, bq[0], bq[1]);
        mma_16816<T>(dka[n + 1], da, bq[2], bq[3]);
      }
    }

    // dS^T to shared memory in T, by the first warp of each key group
    if (dsi == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(ds_s + (kb0 + g + 8 * i) * LDS +
                                       j * 8 + 2 * t) =
              pack2<T>(dp[j][2 * i], dp[j][2 * i + 1]);
    }
    __syncthreads();

    // dQ[16 queries of m-tile mq, DQC columns from dq0] += dS K over the
    // block's keys, 64 columns at a time, added to the f32 workspace
#pragma unroll 1
    for (int c0 = 0; c0 < DQC; c0 += 64) {
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, ds_a + kc * 16 * LDS);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, k_t + kc * 16 * LD + c0 + n * 8);
          mma_16816<T>(acc[n], a, bk[0], bk[1]);
          mma_16816<T>(acc[n + 1], a, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + mq * 16 + g + 8 * i;
        if (row >= S) continue;
        float* dst = dq_acc + (qh + row) * D + dq0 + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          red_add2(dst + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
    __syncthreads();   // dS^T and this buffer are consumed
  }
  cp_async_wait<0>();   // (a CTA with no q-block leaves K / V in flight)

  // the dK and dV rows of the warp's keys and columns: in T when the
  // q-head is its kv-head's only one, else this q-head's f32 partials
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = col0 + kb0 + g + 8 * i;
    if (key >= S) continue;
    if (Hq == Hkv) {
      const size_t o = (kh + key) * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        *reinterpret_cast<uint32_t*>(dk + o + n * 8) =
            pack2<T>(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + n * 8) =
            pack2<T>(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    } else {
      const size_t o = (qh + key) * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        *reinterpret_cast<float2*>(dk_p + o + n * 8) =
            make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<float2*>(dv_p + o + n * 8) =
            make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// dq = dq_acc in T and, with G > 1 q-heads a kv-head, dk / dv = the sum
// of the G heads' f32 partials in T (in head order), 4 elements a thread
template <typename T>
__global__ void bwd_finish_kernel(const float* __restrict__ dq_acc,
                                  const float* __restrict__ dk_p,
                                  const float* __restrict__ dv_p,
                                  T* __restrict__ dq, T* __restrict__ dk,
                                  T* __restrict__ dv, size_t n_q,
                                  size_t n_kv, int G, size_t SD) {
  const size_t stride = (size_t)gridDim.x * blockDim.x * 4;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n_q; i += stride) {
    const float4 x = *reinterpret_cast<const float4*>(dq_acc + i);
    uint2 o;
    o.x = pack2<T>(x.x, x.y);
    o.y = pack2<T>(x.z, x.w);
    *reinterpret_cast<uint2*>(dq + i) = o;
  }
  if (G == 1) return;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n_kv; i += stride) {
    // (b, hk) slab i / SD holds q-heads hk G .. hk G + G - 1 of batch b
    const size_t p = (i / SD) * G * SD + i % SD;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int gh = 0; gh < G; ++gh) {
      const float4 x = *reinterpret_cast<const float4*>(dk_p + p + gh * SD);
      const float4 y = *reinterpret_cast<const float4*>(dv_p + p + gh * SD);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    uint2 o;
    o.x = pack2<T>(a.x, a.y);
    o.y = pack2<T>(a.z, a.w);
    *reinterpret_cast<uint2*>(dk + i) = o;
    o.x = pack2<T>(c.x, c.y);
    o.y = pack2<T>(c.z, c.w);
    *reinterpret_cast<uint2*>(dv + i) = o;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pad,
           const void* lse, const void* delta, const void* dout,
           void* dq_acc, void* dk_p, void* dv_p, void* dq, void* dk,
           void* dv, int B, int Hq, int Hkv, int S, float scale, int causal,
           int has_window, int window, Dropout drop, cudaStream_t st) {
  using C = Cfg<D>;
  const size_t smem = C::smem_bytes(sizeof(T));
  const size_t n_q = (size_t)B * Hq * S * D, n_kv = (size_t)B * Hkv * S * D;
  cudaError_t e = cudaMemsetAsync(dq_acc, 0, n_q * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_merged_mma_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + C::BK - 1) / C::BK, Hq, B);
  bwd_merged_mma_kernel<T, D><<<grid, C::THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const T*>(dout), static_cast<float*>(dq_acc),
      static_cast<float*>(dk_p), static_cast<float*>(dv_p),
      static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, S, scale, causal,
      has_window, window, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n4 = (n_q > n_kv ? n_q : n_kv) / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256 < 1024
                                         ? (n4 + 255) / 256 : 1024);
  bwd_finish_kernel<T><<<blocks, 256, 0, st>>>(
      static_cast<const float*>(dq_acc), static_cast<const float*>(dk_p),
      static_cast<const float*>(dv_p), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_kv, Hq / Hkv,
      (size_t)S * D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* pad, const void* lse, const void* delta,
               const void* dout, void* dq_acc, void* dk_p, void* dv_p,
               void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int S,
               float scale, int causal, int has_window, int window,
               Dropout drop, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, pad, lse, delta, dout, dq_acc, dk_p,
                           dv_p, dq, dk, dv, B, Hq, Hkv, S, scale, causal,
                           has_window, window, drop, st);
    case 128:
      return launch<T, 128>(q, k, v, pad, lse, delta, dout, dq_acc, dk_p,
                            dv_p, dq, dk, dv, B, Hq, Hkv, S, scale, causal,
                            has_window, window, drop, st);
    case 256:
      return launch<T, 256>(q, k, v, pad, lse, delta, dout, dq_acc, dk_p,
                            dv_p, dq, dk, dv, B, Hq, Hkv, S, scale, causal,
                            has_window, window, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_flash_attention_bwd_merged_mma(
    const void* q, const void* k, const void* v, const void* pad,
    const void* lse, const void* delta, const void* dout, void* dq_acc,
    void* dk_p, void* dv_p, void* dq, void* dk, void* dv, int B, int Hq,
    int Hkv, int S, int D, int dtype, float scale, int causal,
    int has_window, int window, int dropout, unsigned int seed,
    unsigned int thresh, float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (Hq != Hkv && (dk_p == nullptr || dv_p == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  switch (dtype) {
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, pad, lse, delta, dout,
                                       dq_acc, dk_p, dv_p, dq, dk, dv, B, Hq,
                                       Hkv, S, scale, causal, has_window,
                                       window, drop, st);
    case 2:
      return dispatch_d<__half>(D, q, k, v, pad, lse, delta, dout, dq_acc,
                                dk_p, dv_p, dq, dk, dv, B, Hq, Hkv, S,
                                scale, causal, has_window, window, drop,
                                st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
