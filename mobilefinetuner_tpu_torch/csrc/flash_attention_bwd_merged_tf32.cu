// Flash-attention backward, merged one-pass kernel, on Hopper's tensor
// cores (sm_90a) for f32 inputs, in 3xTF32.
//
// Replaces: mobilefinetuner_tpu/ops/flash_attention.py `_dkvq_kernel`
// (launched by `_bwd_merged`) for f32 q, k, v and dO, the dtype every CLI
// defaults to: per key block, dK and dV and the key block's dQ
// contributions from ONE recomputation of (s, p, dp, ds) a tile, with the
// key-padding, causal and sliding-window masks, the forward's dropout keep
// bits (mft::keep_bit of the global (b, h, row, col)) and GQA (q-head h
// reads kv-head h / G). delta = rowsum(dO * O) and the forward's lse come
// in from the wrapper. bf16 and f16 run flash_attention_bwd_merged_mma.cu;
// the FMA kernel of flash_attention_bwd_merged.cu, which f32 ran before,
// is kept as this kernel's earlier version.
//
// Bound on this card: at the multi-tenant f32 shape (q 6 x 12 x 128 x 64,
// causal) the function reads q, k, v, dO, lse and delta and writes dq, dk
// and dv once: ~16.5 MB, 4.9 us at 3.35 TB/s; its 5 tile products (0.38
// GFLOP, 1.14 in 3xTF32) need 2.3 us at the 495 TFLOP/s TF32 rate: bytes
// bound it. In practice each CTA's serial q-loop, the launch and dQ's
// atomics do.
//
// Design: flash_attention_bwd_merged_mma.cu's, with f32 operands split
// into TF32 halves (tensor_core_tf32.cuh) and every product in 3xTF32
// (m16n8k8 mma.sync, three a k-step), which holds the plain version's f32
// tolerance (1e-5 of max(1, |ref|)); one TF32 product would not.
//   One CTA per (key block of BK keys, q-head, batch); warp w holds the
//   16 keys kg = w % KG of the block and, of dK and dV, the D / DS
//   columns w / KG (64 a warp: 2 x 32 f32 accumulators a lane).
//   K and V of the key block are loaded once by cp.async and split in
//   place (the raw plane keeps the TF32 high halves, a second one takes
//   the low ones). The q-loop walks [qlo, qhi), the q-blocks that can see
//   the key block, streaming Q, dO, lse and delta of each BQ-row q-block
//   through a ring of two stages (16-byte cp.async, zero past S); Q and
//   dO are split in place once they have landed, once a CTA. Rows are
//   D + 4 floats apart: ldmatrix and the permuted 32-bit column reads
//   are free of bank conflicts. Shared memory: 115,328 / 213,632 /
//   203,072 bytes at D 64 / 128 / 256.
//   The tile is computed transposed, with the key rows as the MMA's M:
//   S^T = K Q^T and dP^T = V dO^T (K and V as A, Q and dO as B, all by
//   ldmatrix). So each C fragment element holds (row = KEY g / g + 8,
//   column = QUERY 2t / 2t + 1): the masks, the keep bit, lse and delta
//   are taken at that swapped (query, key).
//   dV += P^T dO and dK += dS^T Q take P^T and dS^T from their C
//   fragments as A fragments in place, split at use: the TF32 C fragment
//   holds columns 2t, 2t + 1 where A wants t, t + 4, so the k index t is
//   query 2t and t + 4 is query 2t + 1, and dO's and Q's B fragments are
//   read with the same permutation (rows 2t, 2t + 1, column g).
//   dQ += dS K needs dS un-transposed: one warp of each 16 keys writes its
//   dS split into TF32 halves to shared memory as [query][key] rows (BK +
//   8 floats apart), and each warp reads an m-tile of 16 query rows as
//   the A operand with 64-bit loads (the pair (2t, 2t + 1) of keys, the
//   same permutation, K's B fragments at rows 2t, 2t + 1), for 64 columns
//   of dQ a pass; the f32 tile is added to dq by vector atomics (f32x2,
//   no return), which the launcher zeroes first. Atomics, not per-key-
//   block partials: at S / BK adds an element they cost less than a
//   second pass over S / BK partial slabs.
//   Masked pairs add exactly 0: p = 0 outside the mask (a fully masked
//   query row, whose lse comes from l_safe, has every p = 0).
//   Outputs: dK and dV are written once an element, into dk / dv when the
//   q-head is its kv-head's only one, else into this q-head's partials
//   ([B, Hq, S, D]) that a finish kernel sums in head order.
//   Not deterministic: dQ's atomic sums change order from run to run (S /
//   BK adds an element), as the FMA kernel's did; dK and dV are.
// Tiles (Cfg): D 64: BK 32, BQ 32, 2 warps; D 128: BK 32, BQ 32, 4 warps
// (two a key group); D 256: BK 16, BQ 16, 4 warps (all on one key group,
// each recomputing S^T and dP^T: the price of 64 dK / dV columns a warp).
//
// C interface (ctypes): mft_flash_attention_bwd_merged_tf32 returns the
// CUDA error code of its launches. q/dO [B, Hq, S, D] and k/v
// [B, Hkv, S, D] contiguous f32 (dtype 0; any other code is refused),
// 16-byte aligned; pad [B, S] f32; lse, delta [B, Hq, S] f32; dq
// [B, Hq, S, D] f32 (zeroed here); dk_p, dv_p [B, Hq, S, D] f32
// workspaces (null when Hq == Hkv); dk, dv [B, Hkv, S, D] f32; then the
// shape, mask and dropout arguments of mft_flash_attention_bwd_merged
// (flash_attention_bwd_merged.cu).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"
#include "tensor_core_tf32.cuh"

namespace {

using mft::cp_async_4;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::Dropout;
using mft::floor_div;
using mft::keep_bit;
using mft::ldmatrix_x4;
using mft::mma_3xtf32;
using mft::pv_a;
using mft::split_rows;
using mft::split_tf32;
using mft::stage_rows_f32;

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 16 : 32;   // keys of a CTA
  static constexpr int BQ = D == 256 ? 16 : 32;   // query rows a q-block
  static constexpr int KG = BK / 16;              // key groups of 16
  static constexpr int DS = D / 64;               // warps a key group
  static constexpr int WARPS = KG * DS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 4;                // smem row stride (f32)
  static constexpr int LDS = BK + 8;              // dS row stride (f32)
  static constexpr int NW = D / DS / 8;           // dK/dV n-tiles a warp
  static constexpr int NQ = BQ / 8;               // S^T n-tiles (queries)
  static constexpr int KD = D / 8;                // k-steps of S^T, dP^T
  static constexpr int MT = BQ / 16;              // dQ m-tiles
  static constexpr int DQC = D * MT / WARPS;      // dQ columns a warp
  static constexpr int STAGES = 2;                // Q / dO ring
  static_assert(WARPS % MT == 0 && DQC % 64 == 0, "dQ split");
  // k hi, k lo, v hi, v lo [BK][LD]; q hi, q lo, dO hi, dO lo
  // [STAGES][BQ][LD]; dS hi, lo [BQ][LDS]; lse, delta [STAGES][BQ];
  // pad [BK]
  static constexpr size_t SMEM =
      ((size_t)4 * BK * LD + (size_t)4 * STAGES * BQ * LD + 2 * BQ * LDS +
       2 * STAGES * BQ + BK) *
      sizeof(float);
};

// *p += (a, b) with no return (f32x2 atomics: sm_90)
__device__ __forceinline__ void red_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
bwd_merged_tf32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ pad,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ dout,
                       float* __restrict__ dq, float* __restrict__ dk_p,
                       float* __restrict__ dv_p, float* __restrict__ dk,
                       float* __restrict__ dv, int Hq, int Hkv, int S,
                       float scale, int causal, int has_window, int window,
                       Dropout drop) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, KG = C::KG, LD = C::LD,
                LDS = C::LDS, NW = C::NW, NQ = C::NQ, KD = C::KD,
                MT = C::MT, DQC = C::DQC, THREADS = C::THREADS,
                STAGES = C::STAGES;
  constexpr int KT = BK * LD, QT = BQ * LD;   // planes of K / V, Q / dO
  extern __shared__ __align__(16) float smem[];
  float* k_hi = smem;                 // [BK][LD] each
  float* k_lo = k_hi + KT;
  float* v_hi = k_lo + KT;
  float* v_lo = v_hi + KT;
  float* qs = v_lo + KT;              // [STAGES][q hi, q lo, dO hi, dO lo]
  float* dsh = qs + STAGES * 4 * QT;  // [BQ][LDS]: dS hi
  float* dsl = dsh + BQ * LDS;        // [BQ][LDS]: dS lo
  float* lse_s = dsl + BQ * LDS;      // [STAGES][BQ]
  float* dl_s = lse_s + STAGES * BQ;  // [STAGES][BQ]
  float* pad_s = dl_s + STAGES * BQ;  // [BK]

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
  const size_t kh = (size_t)(b * Hkv + hk) * S;  // row offset of (b, hk)
  const float* qp = q + qh * D;
  const float* dop = dout + qh * D;

  // [qlo, qhi): the q-blocks that can see this key block
  const int nQ = (S + BQ - 1) / BQ;
  const int qlo = causal ? col0 / BQ : 0;
  const int qhi = has_window
                      ? min(nQ, floor_div(col0 + BK + window - 2, BQ) + 1)
                      : nQ;

  stage_rows_f32<D, THREADS>(k_hi, k + kh * D, col0, BK, S);
  stage_rows_f32<D, THREADS>(v_hi, v + kh * D, col0, BK, S);
  for (int i = tid; i < BK; i += THREADS)
    pad_s[i] = col0 + i < S ? pad[(size_t)b * S + col0 + i] : 0.f;
  auto stage = [&](int qi, int buf) {
    const int row0 = qi * BQ;
    float* base = qs + buf * 4 * QT;
    stage_rows_f32<D, THREADS>(base, qp, row0, BQ, S);
    stage_rows_f32<D, THREADS>(base + 2 * QT, dop, row0, BQ, S);
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

  // lane offsets: K / V rows of the warp's keys as S^T's and dP^T's A
  // (ldmatrix); Q / dO rows as their B (ldmatrix, offset in a plane);
  // Q / dO at rows 2t, 2t + 1, column g as the permuted B of dK / dV;
  // dS rows of m-tile mq at keys (2t, 2t + 1) as dQ's A and K at rows 2t,
  // 2t + 1, column g as its B
  const int a_off = (kb0 + lr + (lm % 2) * 8) * LD + (lm / 2) * 4;
  const int b_off = (lr + (lm / 2) * 8) * LD + (lm % 2) * 4;
  const int bt_off = 2 * t * LD + d0 + g;
  const int mq = warp % MT, dq0 = (warp / MT) * DQC;
  const int ds_a = (mq * 16 + g) * LDS + 2 * t;
  const int k_t = 2 * t * LD + dq0 + g;

  for (int qi = qlo, it = 0; qi < qhi; ++qi, ++it) {
    const int buf = it % STAGES, row0 = qi * BQ;
    cp_async_wait<0>();   // this q-block (and, first, K and V) has landed
    __syncthreads();      // for every thread; the other stage is consumed
    if (qi + 1 < qhi) stage(qi + 1, (it + 1) % STAGES);
    cp_async_commit();
    float* base = qs + buf * 4 * QT;
    if (it == 0) {
      split_rows<D, THREADS>(k_hi, k_lo, BK);
      split_rows<D, THREADS>(v_hi, v_lo, BK);
    }
    split_rows<D, THREADS>(base, base + QT, BQ);
    split_rows<D, THREADS>(base + 2 * QT, base + 3 * QT, BQ);
    __syncthreads();
    const float* qth = base;
    const float* qtl = base + QT;
    const float* doh = base + 2 * QT;
    const float* dol = base + 3 * QT;
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
      uint32_t akh[4], akl[4], avh[4], avl[4];
      ldmatrix_x4(akh, k_hi + a_off + kc * 8);
      ldmatrix_x4(akl, k_lo + a_off + kc * 8);
      ldmatrix_x4(avh, v_hi + a_off + kc * 8);
      ldmatrix_x4(avl, v_lo + a_off + kc * 8);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        const int o_ = b_off + j * 8 * LD + kc * 8;
        uint32_t bqh[4], bql[4], boh[4], bol[4];
        ldmatrix_x4(bqh, qth + o_);
        ldmatrix_x4(bql, qtl + o_);
        ldmatrix_x4(boh, doh + o_);
        ldmatrix_x4(bol, dol + o_);
        mma_3xtf32(s[j], akh, akl, bqh[0], bqh[1], bql[0], bql[1]);
        mma_3xtf32(s[j + 1], akh, akl, bqh[2], bqh[3], bql[2], bql[3]);
        mma_3xtf32(dp[j], avh, avl, boh[0], boh[1], bol[0], bol[1]);
        mma_3xtf32(dp[j + 1], avh, avl, boh[2], boh[3], bol[2], bol[3]);
      }
    }

    // p and ds of each element at its own (query, key): fragment
    // element (j, e) is key kb0 + g + 8 (e >> 1), query 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl_ = kb0 + g + 8 * (e >> 1), key = col0 + kl_;
        const int ql = j * 8 + 2 * t + (e & 1), row = row0 + ql;
        bool ok = pad_s[kl_] > 0.f && row < S;
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

    // dV += P^T dO and dK += dS^T Q, 8 queries (one S^T n-tile) a
    // k-step: the A fragments from the C fragments in place, dO's and Q's
    // rows permuted to match
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t pah[4], pal[4], dah[4], dal[4];
      pv_a(s[j], pah, pal);
      pv_a(dp[j], dah, dal);
      const int o0 = bt_off + j * 8 * LD;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const int o_ = o0 + n * 8;
        mma_3xtf32(dva[n], pah, pal, __float_as_uint(doh[o_]),
                   __float_as_uint(doh[o_ + LD]), __float_as_uint(dol[o_]),
                   __float_as_uint(dol[o_ + LD]));
        mma_3xtf32(dka[n], dah, dal, __float_as_uint(qth[o_]),
                   __float_as_uint(qth[o_ + LD]), __float_as_uint(qtl[o_]),
                   __float_as_uint(qtl[o_ + LD]));
      }
    }

    // dS to shared memory as [query][key], split, by the first warp of
    // each key group
    if (dsi == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi_, lo_;
          split_tf32(dp[j][e], hi_, lo_);
          const int o_ = (j * 8 + 2 * t + (e & 1)) * LDS + kb0 + g +
                         8 * (e >> 1);
          dsh[o_] = __uint_as_float(hi_);
          dsl[o_] = __uint_as_float(lo_);
        }
    }
    __syncthreads();

    // dQ[16 queries of m-tile mq, DQC columns from dq0] += dS K over the
    // block's keys, 64 columns at a time, added to dq
#pragma unroll 1
    for (int c0 = 0; c0 < DQC; c0 += 64) {
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) {
        // A (g, t) = dS (g, key 2t), A (g, t + 4) = dS (g, key 2t + 1)
        const float2 h0 = *reinterpret_cast<const float2*>(dsh + ds_a +
                                                           kc * 8);
        const float2 h1 = *reinterpret_cast<const float2*>(
            dsh + ds_a + 8 * LDS + kc * 8);
        const float2 l0 = *reinterpret_cast<const float2*>(dsl + ds_a +
                                                           kc * 8);
        const float2 l1 = *reinterpret_cast<const float2*>(
            dsl + ds_a + 8 * LDS + kc * 8);
        const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                                __float_as_uint(h0.y), __float_as_uint(h1.y)};
        const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                                __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int o_ = k_t + kc * 8 * LD + c0 + n * 8;
          mma_3xtf32(acc[n], ah, al, __float_as_uint(k_hi[o_]),
                     __float_as_uint(k_hi[o_ + LD]), __float_as_uint(k_lo[o_]),
                     __float_as_uint(k_lo[o_ + LD]));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + mq * 16 + g + 8 * i;
        if (row >= S) continue;
        float* dst = dq + (qh + row) * D + dq0 + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          red_add2(dst + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
  cp_async_wait<0>();   // (a CTA with no q-block leaves K / V in flight)

  // the dK and dV rows of the warp's keys and columns: into dk / dv when
  // the q-head is its kv-head's only one, else this q-head's partials
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = col0 + kb0 + g + 8 * i;
    if (key >= S) continue;
    const size_t o = ((Hq == Hkv ? kh : qh) + key) * D + d0 + 2 * t;
    float* dko = Hq == Hkv ? dk : dk_p;
    float* dvo = Hq == Hkv ? dv : dv_p;
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      *reinterpret_cast<float2*>(dko + o + n * 8) =
          make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dvo + o + n * 8) =
          make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// with G > 1 q-heads a kv-head: dk / dv = the sum of the G heads' f32
// partials (in head order), 4 elements a thread
__global__ void bwd_finish_tf32_kernel(const float* __restrict__ dk_p,
                                       const float* __restrict__ dv_p,
                                       float* __restrict__ dk,
                                       float* __restrict__ dv, size_t n_kv,
                                       int G, size_t SD) {
  const size_t stride = (size_t)gridDim.x * blockDim.x * 4;
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
    *reinterpret_cast<float4*>(dk + i) = a;
    *reinterpret_cast<float4*>(dv + i) = c;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pad,
           const void* lse, const void* delta, const void* dout, void* dq,
           void* dk_p, void* dv_p, void* dk, void* dv, int B, int Hq,
           int Hkv, int S, float scale, int causal, int has_window,
           int window, Dropout drop, cudaStream_t st) {
  using C = Cfg<D>;
  const size_t smem = C::SMEM;
  const size_t n_q = (size_t)B * Hq * S * D, n_kv = (size_t)B * Hkv * S * D;
  cudaError_t e = cudaMemsetAsync(dq, 0, n_q * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_merged_tf32_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + C::BK - 1) / C::BK, Hq, B);
  bwd_merged_tf32_kernel<D><<<grid, C::THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(pad),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk_p), static_cast<float*>(dv_p),
      static_cast<float*>(dk), static_cast<float*>(dv), Hq, Hkv, S, scale,
      causal, has_window, window, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess || Hq == Hkv) return (int)e;
  const size_t n4 = n_kv / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256 < 1024
                                         ? (n4 + 255) / 256 : 1024);
  bwd_finish_tf32_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(dk_p), static_cast<const float*>(dv_p),
      static_cast<float*>(dk), static_cast<float*>(dv), n_kv, Hq / Hkv,
      (size_t)S * D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mft_flash_attention_bwd_merged_tf32(
    const void* q, const void* k, const void* v, const void* pad,
    const void* lse, const void* delta, const void* dout, void* dq,
    void* dk_p, void* dv_p, void* dk, void* dv, int B, int Hq, int Hkv,
    int S, int D, int dtype, float scale, int causal, int has_window,
    int window, int dropout, unsigned int seed, unsigned int thresh,
    float inv_keep, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dtype != 0 ||
      (Hq != Hkv && (dk_p == nullptr || dv_p == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  switch (D) {
    case 64:
      return launch<64>(q, k, v, pad, lse, delta, dout, dq, dk_p, dv_p, dk,
                        dv, B, Hq, Hkv, S, scale, causal, has_window, window,
                        drop, st);
    case 128:
      return launch<128>(q, k, v, pad, lse, delta, dout, dq, dk_p, dv_p, dk,
                         dv, B, Hq, Hkv, S, scale, causal, has_window,
                         window, drop, st);
    case 256:
      return launch<256>(q, k, v, pad, lse, delta, dout, dq, dk_p, dv_p, dk,
                         dv, B, Hq, Hkv, S, scale, causal, has_window,
                         window, drop, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
