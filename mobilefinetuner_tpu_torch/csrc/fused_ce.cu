// Fused cross-entropy head for Hopper (sm_90a): the [R, V] logits of a
// vocabulary head are computed tile by tile and never written to device
// memory.
//
// Replaces mobilefinetuner_tpu/ops/fused_ce.py
//   row 6  `_fwd_kernel` (launched by `_fwd`):   lse, gold [R] f32 of
//          logits = h @ W^T, h [R, H], W [V, H], for f32 inputs (bf16
//          and f16 run on fused_ce_fwd_mma.cu);
//   row 7  `_dh_kernel` (`_bwd_dh`):  dh [R, H] f32 = coef @ W, for f32
//          inputs (bf16 and f16 run on fused_ce_dh_mma.cu);
//   row 8  `_dw_kernel` (`_bwd_dw`):  dW [V, H] f32 = coef^T @ h, for
//          f32 inputs (bf16 and f16 run on fused_ce_dw_mma.cu);
// with coef = dlse * softmax(logits) + dgold * onehot(label), rounded to
// the storage dtype before its products as the TPU kernels round it;
// and their head-adapter variants (a LoRA on the tied lm_head), where
// logits = h @ W^T + xa @ bt^T with xa [R, r] the scale-folded rank-r
// bottleneck and bt = B^T [V, r]:
//   row 9  `_fwd_kernel_lora` (`_fwd_lora`): lse, gold, for f32 inputs
//          (bf16 and f16 run on fused_ce_fwd_lora_mma.cu);
//   row 10 `_dh_kernel_lora` (`_bwd_dh_lora`): dh and dxa [R, r] f32 =
//          coef @ bt, for f32 inputs (bf16 and f16 run on
//          fused_ce_dh_lora_mma.cu);
//   row 11 `_dw_kernel_lora` (`_bwd_dw_lora`): dbt [V, r] f32 =
//          coef^T @ xa, and dW only when the head itself trains; dbt
//          alone for f32 inputs (bf16 and f16 run on fused_ce_dbt_mma.cu),
//          dW + dbt for every dtype.
//
// Bound on this card, at the Gemma-3-270M training shape (R = 128 rows of
// one loss chunk, V = 262,144, H = 640, bf16): each kernel must read W
// once, 335.5 MB, ~100 us at 3.35 TB/s; the forward's 2 R V H = 42.9
// GFLOP need 43 us at the bf16 tensor-core rate, the dh and dW kernels'
// twice that, and dW also writes 671 MB of f32 (~300 us in all). Bytes
// bound all three. A rank-8 head adapter adds bt (4.2 MB) to each read
// and the 8.4 MB f32 dbt to row 11's writes; with the embedding frozen
// row 11 writes dbt alone (~104 us).
//
// Design. The TPU kernels walk the vocabulary as a SEQUENTIAL grid axis
// and carry running sums in VMEM scratch from one vocab tile to the next.
// Here the vocab tiles of a slab run inside one CTA's loop and the slabs
// are parallel CTAs:
//   forward  CTA (32-row tile, vocab slab): online max / sum-exp / gold
//            per row over the slab's 64-column tiles, a partial
//            (m, s, gold) per (slab, row) to a workspace; a merge kernel
//            forms lse = M + log(sum s exp(m - M)).
//   dh       CTA (32-row tile, vocab slab): per 64-column tile, the logits
//            tile, coef, then coef @ W_tile into a [32, H] f32 accumulator
//            in shared memory; one partial [32, H] per (slab, row tile),
//            summed over slabs by a reduce kernel. Chosen over f32 atomics
//            (deterministic, and contention-free) and over CTAs per
//            (row tile, H tile), which would recompute every logits tile
//            once per H tile.
//   dW       CTA (32-column vocab tile): loops over 64-row tiles, logits,
//            coef, then coef^T @ h_tile into a [32, H] f32 accumulator in
//            shared memory; naturally parallel over V, the contraction
//            over R inside the CTA; no reduction across CTAs.
// The head-adapter variants are the same kernels with the LORA template
// flag (dW: one kernel, rank 0 for row 8): the logits tile gains
// xa @ bt_tile^T as one more contraction (over r instead of H, staged
// the same way); dh also forms
// dxa = coef @ bt_tile into a [32, r] accumulator, with its own per-slab
// partials and the same reduce kernel (no atomics: deterministic); dW
// forms dbt = coef^T @ xa_tile into a [32, r] accumulator of the CTA's
// own vocab tile (no reduction), and skips its dW product and the
// [32, H] accumulator when the wrapper passes no dW buffer (a frozen
// embedding, the LoRA case). The rank is taken as it is (1-128), not
// padded to 128 lanes as on the TPU.
// Products are f32 FMAs from shared memory (each thread a small register
// tile), not tensor cores: a first, simple version, far from the bound
// (the 16-bit cases of rows 6, 7, 8, 9 and 10 and of row 11's dbt-only
// mode run on mma.sync in fused_ce_fwd_mma.cu, fused_ce_dh_mma.cu,
// fused_ce_dw_mma.cu, fused_ce_fwd_lora_mma.cu, fused_ce_dh_lora_mma.cu
// and fused_ce_dbt_mma.cu). Ragged R, V, H and r edges are
// masked, so any shape is taken (the TPU kernels need R % 8 and
// V % block == 0). The dh and dW kernels hold their f32 accumulators in
// shared memory: H + r <= 1,522 (MAX_HIDDEN in ops/fused_ce.py).
//
// C interface (ctypes), each returning the CUDA error code of its
// launches. h [R, H], W [V, H], xa [R, r] and bt [V, r] contiguous, one
// dtype (0 f32, 1 bf16, 2 f16); labels [R] int32 in [0, V); lse, dlse,
// dgold [R] f32; workspaces and outputs f32, allocated by the wrapper.

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using mft::from_f32;
using mft::to_f32;

constexpr int THREADS = 256;      // 16 x 16 threads: (ty, tx)
constexpr int KC = 32;            // contraction chunk of a logits tile
constexpr int HC = 64;            // column chunk of the dh / dW products
constexpr int FWD_TM = 32;        // forward and dh: rows of a tile
constexpr int FWD_TN = 64;        //                 vocab of a tile
constexpr int DW_TM = 64;         // dW: rows of a tile
constexpr int DW_TN = 32;         //     vocab of a CTA
constexpr int CK = 64;            // contraction of a coef product (dh:
constexpr int CM = 32;            // FWD_TN, dW: DW_TM) and its out rows
constexpr int MAX_RANK = 128;
constexpr int SMEM_MAX = 232448;  // shared memory a block may use
static_assert(CK == FWD_TN && CK == DW_TM && CM == FWD_TM && CM == DW_TN,
              "dh and dW share the coef product's tile");

// acc[i][j] += a[r0 + ty + 16 i] . b[v0 + tx + 16 j] over K, a [R, K] and
// b [V, K], staged through shared memory in KC-wide chunks (zero outside
// R, V, K).
template <typename T, int TM, int TN>
__device__ __forceinline__ void add_products(
    const T* __restrict__ a, const T* __restrict__ b, int R, int V, int K,
    int r0, int v0, float* hs, float* ws, float (&acc)[TM / 16][TN / 16]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();              // earlier reads of hs / ws are done
    for (int e = tid; e < TM * KC; e += THREADS) {
      const int m = e / KC, kk = e % KC, r = r0 + m, k = k0 + kk;
      hs[kk * (TM + 1) + m] =
          (r < R && k < K) ? to_f32(a[(size_t)r * K + k]) : 0.f;
    }
    for (int e = tid; e < TN * KC; e += THREADS) {
      const int n = e / KC, kk = e % KC, v = v0 + n, k = k0 + kk;
      ws[kk * (TN + 1) + n] =
          (v < V && k < K) ? to_f32(b[(size_t)v * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float x[TM / 16], y[TN / 16];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) x[i] = hs[kk * (TM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN / 16; ++j) y[j] = ws[kk * (TN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i)
#pragma unroll
        for (int j = 0; j < TN / 16; ++j)
          acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
}

// The logits tile acc[i][j] of rows r0 + ty + 16 i, vocab v0 + tx + 16 j:
// h @ W^T over H and, with LORA, + xa @ bt^T over the rank rk.
template <typename T, int TM, int TN, bool LORA>
__device__ __forceinline__ void logits_tile(
    const T* __restrict__ h, const T* __restrict__ w,
    const T* __restrict__ xa, const T* __restrict__ bt, int R, int V, int H,
    int rk, int r0, int v0, float* hs, float* ws,
    float (&acc)[TM / 16][TN / 16]) {
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) acc[i][j] = 0.f;
  add_products<T, TM, TN>(h, w, R, V, H, r0, v0, hs, ws, acc);
  if constexpr (LORA)
    add_products<T, TM, TN>(xa, bt, R, V, rk, r0, v0, hs, ws, acc);
}

// acc[m][c] += sum_k cs[k][m] * src[k0 + k][c] for a coef tile cs
// [CK][CM + 1] and the CK rows of src [n_src, ncols] from k0 (zero
// outside), in HC-wide column chunks staged through `stage`
// [CK][HC + 1]; acc [CM][ncols] f32 in shared memory. dh: src = W (or
// bt), k the tile's vocab; dW: src = h (or xa), k the tile's rows.
template <typename T>
__device__ __forceinline__ void coef_product(const T* __restrict__ src,
                                             int n_src, int ncols, int k0,
                                             const float* cs, float* stage,
                                             float* acc) {
  constexpr int NI = CM / 16, NC = HC / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int c0 = 0; c0 < ncols; c0 += HC) {
    __syncthreads();              // cs written, earlier stage reads done
    for (int e = tid; e < CK * HC; e += THREADS) {
      const int k = e / HC, cc = e % HC, row = k0 + k, col = c0 + cc;
      stage[k * (HC + 1) + cc] =
          (row < n_src && col < ncols)
              ? to_f32(src[(size_t)row * ncols + col]) : 0.f;
    }
    __syncthreads();
    float o[NI][NC];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) o[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < CK; ++k) {
      float a[NI], b[NC];
#pragma unroll
      for (int i = 0; i < NI; ++i) a[i] = cs[k * (CM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) b[j] = stage[k * (HC + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < ncols) acc[(ty + 16 * i) * ncols + col] += o[i][j];
      }
  }
}

// Sum / max over the 16 lanes that share a row (a half warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// coef of one logits cell, rounded to the storage dtype T (0 outside).
template <typename T>
__device__ __forceinline__ float coef_of(float logit, bool in, bool hit,
                                         float lse, float dlse,
                                         float dgold) {
  if (!in) return 0.f;
  const float c = dlse * expf(logit - lse) + (hit ? dgold : 0.f);
  return to_f32(from_f32<T>(c));
}

template <typename T, bool LORA>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
           const T* __restrict__ xa, const T* __restrict__ bt,
           const int* __restrict__ labels, float* __restrict__ part, int R,
           int V, int H, int rk, int tiles_per_slab) {
  __shared__ float hs[KC * (FWD_TM + 1)];
  __shared__ float ws[KC * (FWD_TN + 1)];
  constexpr int NI = FWD_TM / 16, NJ = FWD_TN / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * FWD_TM, slab = blockIdx.y;
  int lab[NI];
  float m[NI], s[NI], g[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = r0 + ty + 16 * i;
    lab[i] = r < R ? labels[r] : -1;
    m[i] = -INFINITY;
    s[i] = 0.f;
    g[i] = 0.f;
  }
  const int n_vt = (V + FWD_TN - 1) / FWD_TN;
  const int t_end = min(n_vt, (slab + 1) * tiles_per_slab);
  for (int t = slab * tiles_per_slab; t < t_end; ++t) {
    const int v0 = t * FWD_TN;
    float acc[NI][NJ];
    logits_tile<T, FWD_TM, FWD_TN, LORA>(h, w, xa, bt, R, V, H, rk, r0, v0,
                                         hs, ws, acc);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int v = v0 + tx + 16 * j;
        if (v < V) {
          tmax = fmaxf(tmax, acc[i][j]);
          if (v == lab[i]) g[i] += acc[i][j];
        }
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (v0 + tx + 16 * j < V) se += expf(acc[i][j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + row_sum(se);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float gi = row_sum(g[i]);
    const int r = r0 + ty + 16 * i;
    if (tx == 0 && r < R) {
      float* p = part + ((size_t)slab * R + r) * 3;
      p[0] = m[i];
      p[1] = s[i];
      p[2] = gi;
    }
  }
}

__global__ void fwd_merge_kernel(const float* __restrict__ part,
                                 float* __restrict__ lse,
                                 float* __restrict__ gold, int R,
                                 int n_slabs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float mx = -INFINITY;
  for (int k = 0; k < n_slabs; ++k)
    mx = fmaxf(mx, part[((size_t)k * R + r) * 3]);
  float sum = 0.f, g = 0.f;
  for (int k = 0; k < n_slabs; ++k) {
    const float* p = part + ((size_t)k * R + r) * 3;
    sum += p[1] * expf(p[0] - mx);
    g += p[2];
  }
  lse[r] = mx + logf(sum);
  gold[r] = g;
}

// Shared-memory floats of the dh and dW kernels besides their [32, cols]
// accumulators (both: 9,408).
constexpr int BWD_STAGE_FLOATS =
    KC * (FWD_TM + 1) + KC * (FWD_TN + 1) + CK * (CM + 1) + CK * (HC + 1);
static_assert(BWD_STAGE_FLOATS == KC * (DW_TM + 1) + KC * (DW_TN + 1) +
                                      CK * (CM + 1) + CK * (HC + 1),
              "dh and dW stage the same number of floats");

// dh partials [n_slabs, R, H] and, with LORA, dxa partials [n_slabs, R, rk].
template <typename T, bool LORA>
__global__ void __launch_bounds__(THREADS)
dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
          const T* __restrict__ xa, const T* __restrict__ bt,
          const int* __restrict__ labels, const float* __restrict__ lse,
          const float* __restrict__ dlse, const float* __restrict__ dgold,
          float* __restrict__ part, float* __restrict__ xpart, int R, int V,
          int H, int rk, int tiles_per_slab) {
  extern __shared__ float smem[];
  float* hs = smem;                              // [KC][TM + 1]
  float* ws = hs + KC * (FWD_TM + 1);            // [KC][TN + 1]
  float* cs = ws + KC * (FWD_TN + 1);            // [TN][TM + 1] coef
  float* wc = cs + CK * (CM + 1);                // [TN][HC + 1] stage
  float* acc_s = wc + CK * (HC + 1);             // [TM][H]
  float* xacc = acc_s + FWD_TM * H;              // [TM][rk] (LORA)
  constexpr int NI = FWD_TM / 16, NJ = FWD_TN / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * FWD_TM, slab = blockIdx.y;
  const int n_acc = FWD_TM * (H + (LORA ? rk : 0));
  for (int e = tid; e < n_acc; e += THREADS) acc_s[e] = 0.f;
  int lab[NI];
  float l_r[NI], dl_r[NI], dg_r[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = r0 + ty + 16 * i;
    const bool ok = r < R;
    lab[i] = ok ? labels[r] : -1;
    l_r[i] = ok ? lse[r] : 0.f;
    dl_r[i] = ok ? dlse[r] : 0.f;
    dg_r[i] = ok ? dgold[r] : 0.f;
  }
  const int n_vt = (V + FWD_TN - 1) / FWD_TN;
  const int t_end = min(n_vt, (slab + 1) * tiles_per_slab);
  for (int t = slab * tiles_per_slab; t < t_end; ++t) {
    const int v0 = t * FWD_TN;
    float acc[NI][NJ];
    logits_tile<T, FWD_TM, FWD_TN, LORA>(h, w, xa, bt, R, V, H, rk, r0, v0,
                                         hs, ws, acc);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = r0 + ty + 16 * i, v = v0 + tx + 16 * j;
        cs[(tx + 16 * j) * (CM + 1) + ty + 16 * i] = coef_of<T>(
            acc[i][j], r < R && v < V, v == lab[i], l_r[i], dl_r[i],
            dg_r[i]);
      }
    coef_product<T>(w, V, H, v0, cs, wc, acc_s);
    if constexpr (LORA) coef_product<T>(bt, V, rk, v0, cs, wc, xacc);
  }
  __syncthreads();
  for (int e = tid; e < FWD_TM * H; e += THREADS) {
    const int r = r0 + e / H;
    if (r < R) part[((size_t)slab * R + r) * H + e % H] = acc_s[e];
  }
  if constexpr (LORA)
    for (int e = tid; e < FWD_TM * rk; e += THREADS) {
      const int r = r0 + e / rk;
      if (r < R) xpart[((size_t)slab * R + r) * rk + e % rk] = xacc[e];
    }
}

__global__ void dh_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dh, size_t RH,
                                 int n_slabs) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= RH) return;
  float sum = 0.f;
  for (int k = 0; k < n_slabs; ++k) sum += part[(size_t)k * RH + e];
  dh[e] = sum;
}

// dW [V, H] (when dw is not null) and dbt [V, rk]. One kernel for rows 8
// and 11: rk = 0 (xa, bt, dbt null) is the base kernel, its rank loops
// empty. (A separate rank-free instantiation spilled registers and ran
// 1.6x slower on an H100.)
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
          const T* __restrict__ xa, const T* __restrict__ bt,
          const int* __restrict__ labels, const float* __restrict__ lse,
          const float* __restrict__ dlse, const float* __restrict__ dgold,
          float* __restrict__ dw, float* __restrict__ dbt, int R, int V,
          int H, int rk) {
  extern __shared__ float smem[];
  float* hs = smem;                              // [KC][TM + 1]
  float* ws = hs + KC * (DW_TM + 1);             // [KC][TN + 1]
  float* cs = ws + KC * (DW_TN + 1);             // [TM][TN + 1] coef
  float* hc = cs + CK * (CM + 1);                // [TM][HC + 1] stage
  const int dw_cols = dw != nullptr ? H : 0;
  float* acc_s = hc + CK * (HC + 1);             // [TN][H] (dW wanted)
  float* bacc = acc_s + DW_TN * dw_cols;         // [TN][rk]
  constexpr int NI = DW_TM / 16, NJ = DW_TN / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * DW_TN;
  const int n_acc = DW_TN * (dw_cols + rk);
  for (int e = tid; e < n_acc; e += THREADS) acc_s[e] = 0.f;
  for (int r0 = 0; r0 < R; r0 += DW_TM) {
    float acc[NI][NJ];
    logits_tile<T, DW_TM, DW_TN, true>(h, w, xa, bt, R, V, H, rk, r0, v0,
                                       hs, ws, acc);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = r0 + ty + 16 * i;
      const bool ok = r < R;
      const int lab = ok ? labels[r] : -1;
      const float l = ok ? lse[r] : 0.f, dl = ok ? dlse[r] : 0.f,
                  dg = ok ? dgold[r] : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int v = v0 + tx + 16 * j;
        cs[(ty + 16 * i) * (CM + 1) + tx + 16 * j] =
            coef_of<T>(acc[i][j], ok && v < V, v == lab, l, dl, dg);
      }
    }
    if (dw_cols) coef_product<T>(h, R, H, r0, cs, hc, acc_s);
    coef_product<T>(xa, R, rk, r0, cs, hc, bacc);
  }
  __syncthreads();
  for (int e = tid; e < DW_TN * dw_cols; e += THREADS) {
    const int v = v0 + e / H;
    if (v < V) dw[(size_t)v * H + e % H] = acc_s[e];
  }
  for (int e = tid; e < DW_TN * rk; e += THREADS) {
    const int v = v0 + e / rk;
    if (v < V) dbt[(size_t)v * rk + e % rk] = bacc[e];
  }
}

// Shared memory of a dh / dW CTA with `cols` accumulator columns.
size_t bwd_smem_bytes(int cols) {
  return (size_t)(BWD_STAGE_FLOATS + 32 * cols) * sizeof(float);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool LORA>
int launch_fwd(const void* h, const void* w, const void* xa, const void* bt,
               const int* labels, float* part, float* lse, float* gold,
               int R, int V, int H, int rk, int n_slabs, int tiles_per_slab,
               cudaStream_t st) {
  dim3 grid((R + FWD_TM - 1) / FWD_TM, n_slabs);
  fwd_kernel<T, LORA><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(xa), static_cast<const T*>(bt), labels, part, R,
      V, H, rk, tiles_per_slab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(part, lse, gold, R,
                                                    n_slabs);
  return (int)cudaGetLastError();
}

int launch_reduce(const float* part, float* out, size_t n, int n_slabs,
                  cudaStream_t st) {
  dh_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, out, n, n_slabs);
  return (int)cudaGetLastError();
}

template <typename T, bool LORA>
int launch_dh(const void* h, const void* w, const void* xa, const void* bt,
              const int* labels, const float* lse, const float* dlse,
              const float* dgold, float* part, float* dh, float* xpart,
              float* dxa, int R, int V, int H, int rk, int n_slabs,
              int tiles_per_slab, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(H + (LORA ? rk : 0));
  int e = allow_smem(dh_kernel<T, LORA>, smem);
  if (e) return e;
  dim3 grid((R + FWD_TM - 1) / FWD_TM, n_slabs);
  dh_kernel<T, LORA><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(xa), static_cast<const T*>(bt), labels, lse,
      dlse, dgold, part, xpart, R, V, H, rk, tiles_per_slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  e = launch_reduce(part, dh, (size_t)R * H, n_slabs, st);
  if (e || !LORA) return e;
  return launch_reduce(xpart, dxa, (size_t)R * rk, n_slabs, st);
}

template <typename T>
int launch_dw(const void* h, const void* w, const void* xa, const void* bt,
              const int* labels, const float* lse, const float* dlse,
              const float* dgold, float* dw, float* dbt, int R, int V, int H,
              int rk, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes((dw != nullptr ? H : 0) + rk);
  int e = allow_smem(dw_kernel<T>, smem);
  if (e) return e;
  dw_kernel<T><<<(V + DW_TN - 1) / DW_TN, THREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(xa), static_cast<const T*>(bt), labels, lse,
      dlse, dgold, dw, dbt, R, V, H, rk);
  return (int)cudaGetLastError();
}

// f(T*) with the element type of a dtype code, or an error.
template <typename F>
int by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(static_cast<float*>(nullptr));
    case 1:
      return f(static_cast<__nv_bfloat16*>(nullptr));
    case 2:
      return f(static_cast<__half*>(nullptr));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#define ELEM(tag) std::remove_pointer_t<decltype(tag)>

bool bad_shape(int R, int V, int H, int rk, int bwd_cols) {
  return R <= 0 || V <= 0 || H <= 0 || rk < 0 || rk > MAX_RANK ||
         bwd_smem_bytes(bwd_cols) > SMEM_MAX;
}

}  // namespace

extern "C" int mft_fused_ce_fwd(const void* h, const void* w,
                                const int* labels, float* part, float* lse,
                                float* gold, int R, int V, int H,
                                int n_slabs, int tiles_per_slab, int dtype,
                                void* stream) {
  // f32 only: bf16 and f16 run on fused_ce_fwd_mma.cu
  if (R <= 0 || V <= 0 || H <= 0 || n_slabs <= 0 || tiles_per_slab <= 0 ||
      dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch_fwd<float, false>(h, w, nullptr, nullptr, labels, part, lse,
                                  gold, R, V, H, 0, n_slabs, tiles_per_slab,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int mft_fused_ce_dh(const void* h, const void* w,
                               const int* labels, const float* lse,
                               const float* dlse, const float* dgold,
                               float* part, float* dh, int R, int V, int H,
                               int n_slabs, int tiles_per_slab, int dtype,
                               void* stream) {
  // f32 only: bf16 and f16 run on fused_ce_dh_mma.cu
  if (bad_shape(R, V, H, 0, H) || n_slabs <= 0 || tiles_per_slab <= 0 ||
      dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch_dh<float, false>(h, w, nullptr, nullptr, labels, lse, dlse,
                                 dgold, part, dh, nullptr, nullptr, R, V, H,
                                 0, n_slabs, tiles_per_slab,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int mft_fused_ce_dw(const void* h, const void* w,
                               const int* labels, const float* lse,
                               const float* dlse, const float* dgold,
                               float* dw, int R, int V, int H, int dtype,
                               void* stream) {
  // f32 only: bf16 and f16 run on fused_ce_dw_mma.cu
  if (bad_shape(R, V, H, 0, H) || dw == nullptr || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch_dw<float>(h, w, nullptr, nullptr, labels, lse, dlse, dgold,
                          dw, nullptr, R, V, H, 0,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int mft_fused_ce_fwd_lora(const void* h, const void* w,
                                     const void* xa, const void* bt,
                                     const int* labels, float* part,
                                     float* lse, float* gold, int R, int V,
                                     int H, int rk, int n_slabs,
                                     int tiles_per_slab, int dtype,
                                     void* stream) {
  // f32 only: bf16 and f16 run on fused_ce_fwd_lora_mma.cu
  if (bad_shape(R, V, H, rk, 0) || rk == 0 || n_slabs <= 0 ||
      tiles_per_slab <= 0 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch_fwd<float, true>(h, w, xa, bt, labels, part, lse, gold, R,
                                 V, H, rk, n_slabs, tiles_per_slab,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int mft_fused_ce_dh_lora(const void* h, const void* w,
                                    const void* xa, const void* bt,
                                    const int* labels, const float* lse,
                                    const float* dlse, const float* dgold,
                                    float* part, float* dh, float* xpart,
                                    float* dxa, int R, int V, int H, int rk,
                                    int n_slabs, int tiles_per_slab,
                                    int dtype, void* stream) {
  // f32 only: bf16 and f16 run on fused_ce_dh_lora_mma.cu
  if (bad_shape(R, V, H, rk, H + rk) || rk == 0 || n_slabs <= 0 ||
      tiles_per_slab <= 0 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch_dh<float, true>(h, w, xa, bt, labels, lse, dlse, dgold, part,
                                dh, xpart, dxa, R, V, H, rk, n_slabs,
                                tiles_per_slab,
                                static_cast<cudaStream_t>(stream));
}

// dw may be null: dbt only (the frozen-embedding case), f32 only there
// (bf16 and f16 dbt-only run on fused_ce_dbt_mma.cu); dW + dbt takes every
// dtype.
extern "C" int mft_fused_ce_dw_lora(const void* h, const void* w,
                                    const void* xa, const void* bt,
                                    const int* labels, const float* lse,
                                    const float* dlse, const float* dgold,
                                    float* dw, float* dbt, int R, int V,
                                    int H, int rk, int dtype, void* stream) {
  if (bad_shape(R, V, H, rk, (dw != nullptr ? H : 0) + rk) || rk == 0 ||
      (dw == nullptr && dtype != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    return launch_dw<ELEM(tag)>(h, w, xa, bt, labels, lse, dlse, dgold, dw,
                                dbt, R, V, H, rk, st);
  });
}
