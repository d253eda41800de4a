// The backward tile shared by the merged and the split flash-attention
// backward kernels (the counterpart of `_bwd_tile` in
// mobilefinetuner_tpu/ops/flash_attention.py): one recomputation of
// (s, p, dp, ds) for a (q-block, key-block) tile, with every product in
// f32 on the FMA units, staged in shared memory.
//
// Tiles are square, BLK rows by BLK keys: 64 for D <= 128 and 32 for
// D = 256, so four [BLK][D + 1] f32 slabs (q, dO, k, v) and the two
// [BLK][BLK + 1] tiles (p, ds) fit one block's shared memory (166 KB at
// D = 128, 140 KB at D = 256). The block size only moves the [lo, hi)
// bounds; every mask and keep bit is computed on global coordinates.

#pragma once

#include "flash_attention_common.cuh"

namespace mft {

constexpr int BWD_THREADS = 256;

template <int D> struct BwdTile {
  static constexpr int BLK = D > 128 ? 32 : 64;
  static constexpr int DP = D + 1;
  static constexpr int PP = BLK + 1;
  // q_s, do_s, k_s, v_s [BLK][DP]; p_s, ds_s [BLK][PP]; lse_s, dl_s,
  // pad_s [BLK]
  static constexpr size_t smem_floats() {
    return 4 * (size_t)BLK * DP + 2 * (size_t)BLK * PP + 3 * (size_t)BLK;
  }
  float* q_s;
  float* do_s;
  float* k_s;
  float* v_s;
  float* p_s;
  float* ds_s;
  float* lse_s;
  float* dl_s;
  float* pad_s;
  __device__ explicit BwdTile(float* smem) {
    q_s = smem;
    do_s = q_s + BLK * DP;
    k_s = do_s + BLK * DP;
    v_s = k_s + BLK * DP;
    p_s = v_s + BLK * DP;
    ds_s = p_s + BLK * PP;
    lse_s = ds_s + BLK * PP;
    dl_s = lse_s + BLK;
    pad_s = dl_s + BLK;
  }
};

struct BwdArgs {
  int Hq, Hkv, S;
  float scale;
  int causal, has_window, window;
  Dropout drop;
};

// k/v rows of key block col0 and its padding (0 past S)
template <typename T, int D>
__device__ __forceinline__ void load_kv(BwdTile<D>& t, const T* kp,
                                        const T* vp, const float* padp,
                                        int col0, int S) {
  constexpr int BLK = BwdTile<D>::BLK;
  load_rows<T, D, BLK, BWD_THREADS>(t.k_s, kp, col0, S);
  load_rows<T, D, BLK, BWD_THREADS>(t.v_s, vp, col0, S);
  for (int j = threadIdx.x; j < BLK; j += BWD_THREADS)
    t.pad_s[j] = col0 + j < S ? padp[col0 + j] : 0.f;
}

// q/dO rows of q-block row0 with their lse and delta
template <typename T, int D>
__device__ __forceinline__ void load_q(BwdTile<D>& t, const T* qp,
                                       const T* dop, const float* lsep,
                                       const float* dlp, int row0, int S) {
  constexpr int BLK = BwdTile<D>::BLK;
  load_rows<T, D, BLK, BWD_THREADS>(t.q_s, qp, row0, S);
  load_rows<T, D, BLK, BWD_THREADS>(t.do_s, dop, row0, S);
  for (int i = threadIdx.x; i < BLK; i += BWD_THREADS) {
    const bool in = row0 + i < S;
    t.lse_s[i] = in ? lsep[row0 + i] : 0.f;
    t.dl_s[i] = in ? dlp[row0 + i] : 0.f;
  }
}

// p_s <- the dropped and rescaled probabilities (feeding dV = p^T dO),
// ds_s <- p * (dp - delta) * scale (feeding dK = ds^T q and dQ = ds k),
// for the tile of q-block row0 against key block col0 of q-head h.
template <int D>
__device__ __forceinline__ void tile_p_ds(BwdTile<D>& t, const BwdArgs& a,
                                          int b, int h, int row0,
                                          int col0) {
  constexpr int BLK = BwdTile<D>::BLK;
  constexpr int DP = BwdTile<D>::DP;
  constexpr int PP = BwdTile<D>::PP;
  for (int idx = threadIdx.x; idx < BLK * BLK; idx += BWD_THREADS) {
    const int i = idx / BLK, j = idx % BLK;
    const int row = row0 + i, col = col0 + j;
    const float* qi = t.q_s + i * DP;
    const float* doi = t.do_s + i * DP;
    const float* kj = t.k_s + j * DP;
    const float* vj = t.v_s + j * DP;
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      s = fmaf(qi[d], kj[d], s);
      dp = fmaf(doi[d], vj[d], dp);
    }
    const bool ok = attend(row, col, a.S, t.pad_s[j], a.causal,
                           a.has_window, a.window);
    const float p = ok ? expf(s * a.scale - t.lse_s[i]) : 0.f;
    float pv = p;
    if (a.drop.on) {
      const bool keep = keep_bit(a.drop.seed, b, h, row, col, a.drop.thresh);
      pv = keep ? p * a.drop.inv_keep : 0.f;
      dp = keep ? dp * a.drop.inv_keep : 0.f;
    }
    t.p_s[i * PP + j] = pv;
    t.ds_s[i * PP + j] = p * (dp - t.dl_s[i]) * a.scale;
  }
}

// dk[j][d] += sum_i ds[i][j] q[i][d] and dv[j][d] += sum_i p[i][j] dO[i][d]
// for the (j, d) cells this thread owns: idx = tid + n * THREADS. The
// row loop is outermost and only lightly unrolled, the register loop
// innermost, so the code stays small (NA accumulators, 2 FMAs a cell).
template <int D>
__device__ __forceinline__ void accumulate_dkv(const BwdTile<D>& t,
                                               float* dk, float* dv) {
  constexpr int BLK = BwdTile<D>::BLK;
  constexpr int DP = BwdTile<D>::DP;
  constexpr int PP = BwdTile<D>::PP;
  constexpr int NA = BLK * D / BWD_THREADS;
#pragma unroll 2
  for (int i = 0; i < BLK; ++i) {
    const float* dsr = t.ds_s + i * PP;
    const float* pr = t.p_s + i * PP;
    const float* qr = t.q_s + i * DP;
    const float* dor = t.do_s + i * DP;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const int idx = threadIdx.x + n * BWD_THREADS;
      const int j = idx / D, d = idx % D;
      dk[n] = fmaf(dsr[j], qr[d], dk[n]);
      dv[n] = fmaf(pr[j], dor[d], dv[n]);
    }
  }
}

// acc[n] += (ds k)[i][d] for this thread's cells (i, d), idx = tid +
// n * THREADS: the tile's contribution to dQ
template <int D>
__device__ __forceinline__ void accumulate_dq(const BwdTile<D>& t,
                                              float* acc) {
  constexpr int BLK = BwdTile<D>::BLK;
  constexpr int DP = BwdTile<D>::DP;
  constexpr int PP = BwdTile<D>::PP;
  constexpr int NA = BLK * D / BWD_THREADS;
#pragma unroll 2
  for (int j = 0; j < BLK; ++j) {
    const float* kr = t.k_s + j * DP;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const int idx = threadIdx.x + n * BWD_THREADS;
      acc[n] = fmaf(t.ds_s[(idx / D) * PP + j], kr[idx % D], acc[n]);
    }
  }
}

// [qlo, qhi): the q-blocks that can see key block col0 (`_q_block_bounds`)
__device__ __forceinline__ void q_block_bounds(int col0, int blk, int nQ,
                                               const BwdArgs& a, int* qlo,
                                               int* qhi) {
  *qlo = a.causal ? col0 / blk : 0;
  *qhi = a.has_window
             ? min(nQ, floor_div(col0 + blk + a.window - 2, blk) + 1)
             : nQ;
}

// [lo, hi): the key blocks q-block row0 can reach (`_kv_block_bounds`)
__device__ __forceinline__ void kv_block_bounds(int row0, int blk, int nK,
                                                const BwdArgs& a, int* lo,
                                                int* hi) {
  *hi = a.causal ? min(nK, (row0 + blk - 1) / blk + 1) : nK;
  *lo = a.has_window ? max(0, floor_div(row0 - a.window + 1, blk)) : 0;
}

template <typename K>
inline int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mft
