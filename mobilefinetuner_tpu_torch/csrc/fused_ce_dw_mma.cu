// Fused cross-entropy dW on Hopper's tensor cores (sm_90a), bf16 and f16.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dw_kernel` (launched by
// `_bwd_dw`, row 8) for 16-bit h and W:
//   dW [V, H] f32 = coef^T @ h,
//   coef = dlse * exp(h W^T - lse) + dgold * onehot(label),
// coef rounded to h's dtype before the product, as the TPU kernel's
// `coef.astype(h.dtype)`. f32 stays on mft_fused_ce_dw (fused_ce.cu).
//
// Bound on this card, at the Gemma-3-270M training shape (R = 128 rows of
// a loss chunk, V = 262,144, H = 640, bf16): W must be read once (335.5
// MB) and dW written once in f32 (671 MB): ~300 us at 3.35 TB/s. The two
// products' 4 R V H = 86 GFLOP need ~87 us at the bf16 tensor-core rate.
// Bytes bound it, and two thirds of them are the write.
//
// Design. Unlike dh (fused_ce_dh_mma.cu), dW's product sums over the R
// rows, so one CTA that holds all of h owns whole dW rows: nothing is
// recomputed and nothing is reduced across CTAs.
//   Persistent CTAs (one an SM) walk the (32-row vocab tile, H part)
//   items with a grid stride. h [R, H] stays in shared memory for the
//   CTA's life (160 KB at the path's shape); only the W tile [32, H] is
//   streamed, by cp.async, its next tile issued as soon as the logits of
//   the current one are formed, so the load runs under the coef product
//   and the dW stores.
//   8 warps. The logits of a tile are formed transposed, W_tile h^T
//   [32 vocab, R], warp (vg, q) holding vocab rows 16 vg.. and rows of h
//   q R/4..: m16n8k16 mma.sync over k = H, W as the A operand and h as the
//   column-major B (both ldmatrix). coef, rounded to T, goes once to
//   shared memory as [32 vocab, R]; then dW_tile = coef_tile . h with
//   k = R: coef as A (ldmatrix), h as the row-major B (ldmatrix.trans),
//   each warp owning all 32 vocab rows and an eighth of the H part's
//   columns (at most WC_MAX: its f32 accumulators, 80 registers a lane),
//   so each B fragment of h feeds two products. (Tried on an H100 and
//   dropped, each slower: a [16 vocab, 160 column] product split; the
//   next W tile prefetched into registers; the logits' K split over warp
//   pairs that meet in shared memory. With neither the stores nor the W
//   loads the kernel keeps most of its time: mma.sync's ldmatrix
//   traffic, ~700 KB of shared-memory reads a tile, holds it back;
//   wgmma, reading h once a warpgroup, is the next step.)
//   Stores: the accumulators go straight to dW, two lanes of a quad
//   swapping halves (one shuffle) so that each lane writes 16 bytes and a
//   warp's store covers 64 contiguous bytes of 8 rows; streaming
//   (`st.global.cs`), so the 671 MB of output does not evict W from L2.
//   Each dW element is written once, with no atomics: deterministic.
//   Larger shapes: h is held in row chunks of RC = 128, 64 or 32 rows
//   (the plan takes the smallest chunk that holds all R rows, else the
//   largest that fits shared memory). With more than one chunk, each item
//   reloads h chunk by chunk (from L2) and the dW accumulators stay in
//   registers across the chunks; H > HP_MAX is cut into parts, each of
//   which recomputes the logits. Right, not fast: batch 8 (R 256) and
//   H 1,152 take these paths; the main path does not.
// Ragged R and V are masked (zero-filled rows, coef 0 past R and V); H
// must be a multiple of 8 (16-byte rows); columns [H, H16) are zero in
// shared memory so the last k-step of the logits adds nothing.
//
// C interface (ctypes): mft_fused_ce_dw_mma returns the CUDA error code
// of its launch. h [R, H], W [V, H] contiguous in one dtype (1 bf16, 2
// f16), 16-byte aligned; labels [R] int32 in [0, V); lse, dlse, dgold [R]
// f32; dW [V, H] f32. The launch plan (row chunk, hp, n_parts, CTAs)
// comes from the wrapper (ops/fused_ce.dw_mma_plan).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::from_f32;
using mft::ldmatrix_x2;
using mft::ldmatrix_x4;
using mft::ldmatrix_x4_trans;
using mft::mma_16816;
using mft::pack2;

constexpr int VT = 32;          // vocab rows of a W tile
constexpr int WARPS = 8;        // logits: 2 vocab groups x 4 quarters
constexpr int THREADS = WARPS * 32;
constexpr int WC_MAX = 80;      // dW columns of a warp (its accumulators)
constexpr int HP_MAX = 640;     // dW columns of a CTA: 8 x WC_MAX
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int h16_of(int H) { return (H + 15) / 16 * 16; }

// Shared memory of a CTA: the h chunk [RC][LD], the W tile [VT][LD] and
// coef [VT][RC + 8] in T, then lse, dlse, dgold and the labels of the
// chunk's rows (4 bytes each).
__host__ __device__ inline size_t smem_bytes(int RC, int H, size_t elem) {
  const size_t ld = (size_t)h16_of(H) + 8;
  return ((RC + VT) * ld + (size_t)VT * (RC + 8)) * elem + (size_t)RC * 16;
}

template <typename T, int RC>
__global__ void __launch_bounds__(THREADS, 1)
dw_mma_kernel(const T* __restrict__ h, const T* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ dlse,
              const float* __restrict__ dgold, float* __restrict__ dw,
              int R, int V, int H, int hp, int n_parts) {
  constexpr int RQ = RC / 4;        // logits columns (rows of h) of a warp
  constexpr int NR = RQ / 8;        // their n-tiles
  constexpr int NW = WC_MAX / 8;    // dW n-tiles of a warp
  constexpr int LDC = RC + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H16 = h16_of(H), LD = H16 + 8;
  T* h_s = reinterpret_cast<T*>(smem_raw);           // [RC][LD]
  T* w_s = h_s + RC * LD;                            // [VT][LD]
  T* c_s = w_s + VT * LD;                            // [VT][LDC]
  float* ls_s = reinterpret_cast<float*>(c_s + VT * LDC);
  float* dl_s = ls_s + RC;
  float* dg_s = dl_s + RC;
  int* lab_s = reinterpret_cast<int*>(dg_s + RC);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int vg = warp % 2, q = warp / 2;
  const int n_chunks = (R + RC - 1) / RC;
  const int n_items = (V + VT - 1) / VT * n_parts;
  const int wc = hp / 8;            // dW columns of a warp in this launch

  // columns [H, H16) of every staged row are zero (cp.async never
  // writes them): the last k-step of the logits adds 0
  if (H16 > H) {
    const int tail = H16 - H;
    for (int i = tid; i < (RC + VT) * tail; i += THREADS)
      h_s[(i / tail) * LD + H + i % tail] = from_f32<T>(0.f);
  }
  const int CH = H / 8;             // 16-byte chunks a row
  // h rows [chunk RC, +RC) (zeros past R) and their row data (coef 0)
  auto load_rows = [&](int chunk) {
    const int r0 = chunk * RC;
    for (int i = tid; i < RC * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8, gr = r0 + r;
      cp_async_16(h_s + r * LD + c, h + (size_t)min(gr, R - 1) * H + c,
                  gr < R);
    }
    for (int r = tid; r < RC; r += THREADS) {
      const int gr = r0 + r;
      const bool in = gr < R;
      ls_s[r] = in ? lse[gr] : 0.f;
      dl_s[r] = in ? dlse[gr] : 0.f;
      dg_s[r] = in ? dgold[gr] : 0.f;
      lab_s[r] = in ? labels[gr] : -1;
    }
  };
  // this thread's first 16-byte chunk of a W tile and the step between
  // its chunks as (row, chunk) pairs: no division in the tile loop
  const int r_first = tid / CH, c_first = tid % CH;
  const int r_step = THREADS / CH, c_step = THREADS % CH;
  auto load_w = [&](int tile) {
    const int v0 = tile * VT;
    for (int r = r_first, c = c_first; r < VT;) {
      const int gv = v0 + r;
      cp_async_16(w_s + r * LD + c * 8,
                  w + (size_t)min(gv, V - 1) * H + c * 8, gv < V);
      r += r_step;
      c += c_step;
      if (c >= CH) {
        c -= CH;
        ++r;
      }
    }
  };

  if (n_chunks == 1) load_rows(0);  // h stays for the CTA's life
  if (blockIdx.x < n_items) load_w(blockIdx.x / n_parts);
  cp_async_commit();

  // lane addresses. Logits: W rows of the warp's 16 vocab as A, h rows of
  // its quarter as B (non-transposed). Product: coef rows as A, h as B
  // (transposed), row kc + ... of the chunk.
  const T* wa_lane = w_s + (vg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
  const T* hb_lane = h_s + (q * RQ + lr + (lm / 2) * 8) * LD + (lm % 2) * 8;
  const T* ca_lane = c_s + (lr + (lm % 2) * 8) * LDC + (lm / 2) * 8;
  const T* ht_lane = h_s + (lr + (lm % 2) * 8) * LD + (lm / 2) * 8;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item / n_parts;
    const int cw = (item % n_parts) * hp + warp * wc;  // warp's first column
    const int ncols = min(wc, H - cw);              // may be <= 0
    float acc[2][NW][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch) {
      if (n_chunks > 1) {
        __syncthreads();            // the last chunk's product is done
        load_rows(ch);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();

      // logits^T: 16 vocab rows x RQ rows of h, over all of H
      float s[NR][4];
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
      for (int kc = 0; kc < H16; kc += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, wa_lane + kc);
#pragma unroll
        for (int j = 0; j + 1 < NR; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, hb_lane + j * 8 * LD + kc);
          mma_16816<T>(s[j], a, b[0], b[1]);
          mma_16816<T>(s[j + 1], a, b[2], b[3]);
        }
        if constexpr (NR % 2 == 1) {
          uint32_t b[2];
          ldmatrix_x2(b, hb_lane + (NR - 1) * 8 * LD + kc);
          mma_16816<T>(s[NR - 1], a, b[0], b[1]);
        }
      }
      __syncthreads();              // every warp is done with the W tile
      if (ch == n_chunks - 1 && item + (int)gridDim.x < n_items)
        load_w((item + gridDim.x) / n_parts);
      cp_async_commit();

      // coef, rounded to T, into shared memory as [vocab][row of h]
      const int vb = tile * VT + vg * 16 + g;
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const int rl = q * RQ + n * 8 + 2 * t;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int v = vb + 8 * hi;
          float c[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = rl + e;
            c[e] = v < V ? dl_s[r] * expf(s[n][2 * hi + e] - ls_s[r]) +
                               (v == lab_s[r] ? dg_s[r] : 0.f)
                         : 0.f;
          }
          *reinterpret_cast<uint32_t*>(
              c_s + (vg * 16 + g + 8 * hi) * LDC + rl) = pack2<T>(c[0], c[1]);
        }
      }
      __syncthreads();

      // dW[16 vocab, warp's columns] += coef [16, RC] . h [RC, columns].
      // Straight-line code: column pairs past the warp's read column 0
      // instead, and their sums are never stored.
#pragma unroll 1
      for (int kc = 0; kc < RC; kc += 16) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, ca_lane + kc);
        ldmatrix_x4(a1, ca_lane + 16 * LDC + kc);
        const T* hb = ht_lane + kc * LD;
#pragma unroll
        for (int n = 0; n < NW; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, hb + (n * 8 < ncols ? cw + n * 8 : 0));
          mma_16816<T>(acc[0][n], a0, b[0], b[1]);
          mma_16816<T>(acc[0][n + 1], a0, b[2], b[3]);
          mma_16816<T>(acc[1][n], a1, b[0], b[1]);
          mma_16816<T>(acc[1][n + 1], a1, b[2], b[3]);
        }
      }
    }

    // 16-byte streaming stores: in each quad, even lanes take columns
    // 2t..2t+3 of n-tile n, odd lanes 2t-2..2t+1 of n-tile n + 1
    const bool odd = t & 1;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NW; n += 2) {
      const int vrow = tile * VT + m * 16 + g;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float a0 = acc[m][n][2 * hi], a1 = acc[m][n][2 * hi + 1];
        const float b0 = acc[m][n + 1][2 * hi], b1 = acc[m][n + 1][2 * hi + 1];
        const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        const float4 out = odd ? make_float4(x0, x1, b0, b1)
                               : make_float4(a0, a1, x0, x1);
        const int col = odd ? (n + 1) * 8 + 2 * t - 2 : n * 8 + 2 * t;
        const int v = vrow + 8 * hi;
        if (v < V && col < ncols)
          __stcs(reinterpret_cast<float4*>(dw + (size_t)v * H + cw + col),
                 out);
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int RC>
int launch(const void* h, const void* w, const int* labels,
           const float* lse, const float* dlse, const float* dgold,
           float* dw, int R, int V, int H, int hp, int n_parts, int n_ctas,
           cudaStream_t st) {
  const size_t smem = smem_bytes(RC, H, sizeof(T));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dw_mma_kernel<T, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dw_mma_kernel<T, RC><<<n_ctas, THREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, dlse,
      dgold, dw, R, V, H, hp, n_parts);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rc(int rc, const void* h, const void* w, const int* labels,
                const float* lse, const float* dlse, const float* dgold,
                float* dw, int R, int V, int H, int hp, int n_parts,
                int n_ctas, cudaStream_t st) {
  switch (rc) {
    case 128:
      return launch<T, 128>(h, w, labels, lse, dlse, dgold, dw, R, V, H, hp,
                            n_parts, n_ctas, st);
    case 64:
      return launch<T, 64>(h, w, labels, lse, dlse, dgold, dw, R, V, H, hp,
                           n_parts, n_ctas, st);
    case 32:
      return launch<T, 32>(h, w, labels, lse, dlse, dgold, dw, R, V, H, hp,
                           n_parts, n_ctas, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_fused_ce_dw_mma(const void* h, const void* w,
                                   const int* labels, const float* lse,
                                   const float* dlse, const float* dgold,
                                   float* dw, int R, int V, int H,
                                   int row_chunk, int hp, int n_parts,
                                   int n_ctas, int dtype, void* stream) {
  if (R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || hp <= 0 ||
      hp % 128 != 0 || hp > HP_MAX || n_parts <= 0 ||
      (long long)hp * n_parts < H || (long long)hp * (n_parts - 1) >= H ||
      n_ctas <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_rc<__nv_bfloat16>(row_chunk, h, w, labels, lse, dlse,
                                        dgold, dw, R, V, H, hp, n_parts,
                                        n_ctas, st);
    case 2:
      return dispatch_rc<__half>(row_chunk, h, w, labels, lse, dlse, dgold,
                                 dw, R, V, H, hp, n_parts, n_ctas, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
