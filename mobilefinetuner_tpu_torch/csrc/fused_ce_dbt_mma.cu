// Head-adapter fused cross-entropy dbt (frozen tied head) on Hopper's
// tensor cores (sm_90a), bf16 and f16.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dw_kernel_lora`
// (launched by `_bwd_dw_lora`, row 11) in its dbt-only mode, the one the
// LoRA path runs (the tied embedding is frozen, so no dW), for 16-bit
// operands:
//   dbt [V, r] f32 = coef^T @ xa,
//   logits = h W^T + xa bt^T (xa [R, r] the scale-folded bottleneck of a
//   LoRA on the tied head, bt = B^T [V, r]),
//   coef = dlse * exp(logits - lse) + dgold * onehot(label),
// coef rounded to xa's dtype before the product, as the TPU kernel's
// `coef.astype(xa.dtype)`. f32, and the dW + dbt mode of every dtype,
// stay on mft_fused_ce_dw_lora (fused_ce.cu).
//
// Bound on this card, at the Gemma-3-270M training shape with a rank-8
// head adapter (R = 128, V = 262,144, H = 640, r = 8, bf16): W and bt must
// be read once and dbt written once, 348.1 MB, ~104 us at 3.35 TB/s; the
// logits' 2 R V (H + r) and the product's 2 R V r, 44.0 GFLOP, need ~45 us
// at the bf16 tensor-core rate. Bytes bound it.
//
// Design: row 9's logits loop (fused_ce_fwd_lora_mma.cu) with coef and a
// small product in place of the online logsumexp. A CTA owns (a 16 RG-row
// tile, a vocabulary slab); 2 RG warps, warp (rg, vg) forming rows 16 rg..
// x vocab columns 16 vg.. of each 32-column logits tile, h's A fragments
// in registers up to H = 640 (and xa's at r16 = 16); a W tile and its bt
// tile ride in one cp.async stage of a ring of up to three, refilled
// after the tile's sync (one sync a tile).
//   coef: formed on the logits' C fragments with the row's lse, dlse and
//   dgold, rounded to T and written to shared memory, where all warps
//   meet: a coef tile [16 RG rows, GT x 32 vocab] gathers GT = 4 W tiles,
//   so the product and its sync come once a group (at the Gemma shape the
//   tile fills the block's 227 KB to the byte).
//   dbt_group [128 vocab, r16] = coef^T xa_tile, k = the CTA's 16 RG rows:
//   coef^T as the A operand by ldmatrix.trans, xa from its staged row tile
//   as B by ldmatrix.trans, m16n8k16 mma.sync, f32 accumulate. The
//   (16-column m-tile, rank n-tile pair) items are dealt to the warps in
//   turn: at r16 = 16 each of the 8 warps takes one m-tile; at r16 = 128
//   each takes eight pairs. (A product a tile, split by vocab half over
//   two warps at r 8, ran 384.7 us against 369.8 at the Gemma shape;
//   float2 stores were 2% slower there, 9% faster at r 128, off the
//   paths: kernel_variants.py.)
//   The sum over R crosses row tiles: each CTA writes its [128, r] f32
//   partial per (row tile, group) to a workspace [row_tiles, V, r] and a
//   reduce kernel sums the row tiles in order (at the Gemma shape 2 x 8.4
//   MB, 11.5 us); one row tile writes dbt directly. No atomics, so two
//   calls give identical bits.
//   Rank rows are copied 16 bytes at a time (cp.async, zero-filled past an
//   edge) when r % 8 == 0 and xa, bt are 16-byte aligned, 4 bytes at a
//   time when r is even and they are 4-byte aligned, else element by
//   element without cp.async: r need not be a multiple of 8.
// Ragged R and V are masked (zero-filled rows of h and xa, coef 0 past R
// and V, partial rows past V not written); H must be a multiple of 8
// (16-byte rows); columns [H, H16) and [r, r16) are zero in shared memory.
//   The logits' MMA chains are cut every KP = 8 k-steps and summed in f32
//   by the FMA units: coef is rounded to bf16 and dbt sums it over only R
//   rows, so a logit a few 1e-6 off flips a dominant coef to its other
//   bf16 neighbour (2.2e-3 of max |dbt| at rank 128 with one chain; the
//   fold costs ~3% at the Gemma shape).
// What holds it back: the logits loop's, as row 9's (each warp's chain of
// ldmatrix -> mma, ~250 registers); coef and the product add ~68 us to
// row 9's ~300 at the Gemma shape, the group sync ~5 of that, the stores
// nothing (PERF.md).
//
// C interface (ctypes): mft_fused_ce_dbt_mma returns the CUDA error code
// of its launches. h [R, H], W [V, H], xa [R, r], bt [V, r] contiguous in
// one dtype (1 bf16, 2 f16), h and W 16-byte aligned; labels [R] int32 in
// [0, V); lse, dlse, dgold [R] f32; part [row_tiles, V, r] f32 (unused,
// may be null, for one row tile) and dbt [V, r] f32. The launch plan (row
// groups, stages, n_slabs, tiles_per_slab) comes from the wrapper
// (ops/fused_ce.dbt_mma_plan).

#include <stdint.h>

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_4;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::from_f32;
using mft::ldmatrix_x4;
using mft::ldmatrix_x4_trans;
using mft::mma_16816;
using mft::pack2;

constexpr int VT = 32;          // vocab columns of a tile
constexpr int VG = 2;           // warps of a row group: vocab halves
constexpr int GT = 4;           // W tiles a coef group (dbt product)
constexpr int KR = 40;          // k-steps of h a lane holds (H16 <= 640)
constexpr int KP = 8;           // k-steps an MMA chain sums before a fold
constexpr int MAX_RANK = 128;
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int h16_of(int H) { return (H + 15) / 16 * 16; }

// Whether a lane holds its rows' A fragments of h (and, at r16 = 16, of
// xa) for the whole slab.
__host__ __device__ inline bool h_in_regs(int H) {
  return h16_of(H) <= 16 * KR;
}
__host__ __device__ inline bool xa_in_regs(int H, int rk) {
  return h_in_regs(H) && h16_of(rk) == 16;
}

// Shared memory of a CTA: h [16 RG][LD], W [stages][VT][LD], xa [16 RG]
// [LDR], bt [stages][VT][LDR] and coef [16 RG][GT VT + 8] in T.
__host__ __device__ inline size_t smem_bytes(int RG, int stages, int H,
                                             int r, size_t elem) {
  const size_t ld = (size_t)h16_of(H) + 8, ldr = (size_t)h16_of(r) + 8;
  return ((16 * RG + stages * VT) * (ld + ldr) + 16 * RG * (GT * VT + 8)) *
         elem;
}

template <typename T, int RG, bool AREG, bool XREG>
__global__ void __launch_bounds__(RG * VG * 32, 1)
dbt_mma_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const T* __restrict__ xa, const T* __restrict__ bt,
               const int* __restrict__ labels, const float* __restrict__ lse,
               const float* __restrict__ dlse,
               const float* __restrict__ dgold, float* __restrict__ out,
               int R, int V, int H, int rk, int tiles_per_slab, int stages) {
  constexpr int RT = 16 * RG;
  constexpr int THREADS = RG * VG * 32;
  constexpr int LDC = GT * VT + 8;
  constexpr int WARPS = RG * VG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H16 = h16_of(H), LD = H16 + 8;
  const int R16 = h16_of(rk), LDR = R16 + 8, NP = R16 / 16;
  T* h_s = reinterpret_cast<T*>(smem_raw);
  T* w_s = h_s + RT * LD;                 // [stages][VT][LD]
  T* xa_s = w_s + stages * VT * LD;       // [RT][LDR]
  T* bt_s = xa_s + RT * LDR;              // [stages][VT][LDR]
  T* c_s = bt_s + stages * VT * LDR;      // [RT][LDC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int rg = warp % RG, vg = warp / RG;
  const int row0 = blockIdx.x * RT;
  const int slab = blockIdx.y;
  const int n_vt = (V + VT - 1) / VT;
  const int t0 = slab * tiles_per_slab;
  const int t_end = min(n_vt, t0 + tiles_per_slab);
  // this CTA's [V, rk] block of the workspace (or dbt itself)
  float* dst = out + (size_t)blockIdx.x * V * rk;

  // columns [H, H16) of every staged h / W row and [rk, R16) of every xa
  // / bt row are zero (the copies never write them)
  if (H16 > H) {
    const int tail = H16 - H;
    for (int i = tid; i < (RT + stages * VT) * tail; i += THREADS)
      h_s[(i / tail) * LD + H + i % tail] = from_f32<T>(0.f);
  }
  {
    const int tail = R16 - rk;
    for (int i = tid; i < (RT + stages * VT) * tail; i += THREADS)
      xa_s[(i / tail) * LDR + rk + i % tail] = from_f32<T>(0.f);
  }
  const int CH = H / 8;                   // 16-byte chunks a row
  for (int i = tid; i < RT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8, gr = row0 + r;
    cp_async_16(h_s + r * LD + c, h + (size_t)min(gr, R - 1) * H + c,
                gr < R);
  }
  // rank rows [first, first + n) of src [n_src, rk] into dst [n][LDR]: in
  // 16-byte chunks by cp.async where r % 8 == 0 and both bases 16-byte
  // aligned, in 4-byte pairs where r is even and they are 4-byte aligned,
  // else element by element (zeros past n_src)
  const uintptr_t base = reinterpret_cast<uintptr_t>(xa) |
                         reinterpret_cast<uintptr_t>(bt);
  const int E = rk % 8 == 0 && (base & 15) == 0   ? 8
                : rk % 2 == 0 && (base & 3) == 0 ? 2
                                                 : 1;
  const int RP = rk / E;
  auto load_rank = [&](T* d, const T* src, int n, int first, int n_src) {
    for (int i = tid; i < n * RP; i += THREADS) {
      const int r = i / RP, c = (i % RP) * E, gr = first + r;
      const T* from = src + (size_t)min(gr, n_src - 1) * rk + c;
      if (E == 8)
        cp_async_16(d + r * LDR + c, from, gr < n_src);
      else if (E == 2)
        cp_async_4(d + r * LDR + c, from, gr < n_src);
      else
        d[r * LDR + c] = gr < n_src ? *from : from_f32<T>(0.f);
    }
  };
  load_rank(xa_s, xa, RT, row0, R);
  // this thread's first 16-byte chunk of a W tile and the step between
  // its chunks as (row, chunk) pairs: no division in the tile loop
  const int r_first = tid / CH, c_first = tid % CH;
  const int r_step = THREADS / CH, c_step = THREADS % CH;
  auto stage = [&](int tile, int buf) {
    T* d = w_s + buf * VT * LD;
    const int v0 = tile * VT;
    for (int r = r_first, c = c_first; r < VT;) {
      const int gv = v0 + r;
      cp_async_16(d + r * LD + c * 8,
                  w + (size_t)min(gv, V - 1) * H + c * 8, gv < V);
      r += r_step;
      c += c_step;
      if (c >= CH) {
        c -= CH;
        ++r;
      }
    }
    load_rank(bt_s + buf * VT * LDR, bt, VT, v0, V);
  };
  // a ring of `stages` W (+ bt) buffers, `stages` - 1 tiles ahead (one
  // group each; the first also carries h and xa), refilled after the
  // tile's sync; a single buffer is refilled in turn
  for (int i = 0; i < max(1, stages - 1); ++i) {
    if (t0 + i < t_end) stage(t0 + i, i);
    cp_async_commit();
  }

  // this lane's rows g and g + 8 of the warp's 16
  int lab[2];
  float ls[2], dl[2], dg[2];
  bool rin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + rg * 16 + g + 8 * i;
    rin[i] = r < R;
    lab[i] = rin[i] ? labels[r] : -1;
    ls[i] = rin[i] ? lse[r] : 0.f;
    dl[i] = rin[i] ? dlse[r] : 0.f;
    dg[i] = rin[i] ? dgold[r] : 0.f;
  }

  // lane addresses: A of the warp's rows in h_s and xa_s; W's (bt's) 16
  // vocab rows of this warp as the logits' B (non-transposed); coef^T of
  // a group's 16 vocab columns as the product's A (trans, [rows][vocab]
  // in c_s); xa's rows as its B (trans)
  const T* h_lane = h_s + (rg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
  const T* xa_lane =
      xa_s + (rg * 16 + lr + (lm % 2) * 8) * LDR + (lm / 2) * 8;
  const int wl_row = vg * 16 + lr + (lm / 2) * 8, wl_col = (lm % 2) * 8;
  const T* ct_lane = c_s + (lr + (lm / 2) * 8) * LDC + (lm % 2) * 8;
  const T* xt_lane = xa_s + (lr + (lm % 2) * 8) * LDR + (lm / 2) * 8;

  const int KD = H16 / 16;
  uint32_t af[AREG ? KR : 1][4];   // h's A fragments (AREG)
  uint32_t xf[4];                  // xa's A fragment (XREG)
  for (int tile = t0, it = 0; tile < t_end; ++tile, ++it) {
    const int buf = it % stages;
    if (stages > 1) {
      // this tile's group is the oldest in flight; after the sync every
      // warp is done with the last tile, whose buffer is refilled
      if (stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (tile + stages - 1 < t_end)
        stage(tile + stages - 1, (it + stages - 1) % stages);
      cp_async_commit();
    } else {
      if (it > 0) {
        __syncthreads();   // every warp is done with the one buffer
        stage(tile, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
    }
    const T* wt = w_s + buf * VT * LD;
    const T* bts = bt_s + buf * VT * LDR;

    // logits of 16 rows x 16 vocab columns: over H, then over the rank.
    // The MMAs sum KP k-steps at a time into y, which the FMA units add
    // into x rounding to nearest (fold), so the tensor cores' sums never
    // grow long: one MMA chain over all k-steps left the logits ~3e-6 off
    // (gold 2.6e-6 from f64 at the Gemma chunk on an H100, 4.6e-7 with
    // the fold), enough to round a coef to the other bf16 neighbour of
    // the plain version's.
    float x[2][4], y[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
    auto fold = [&]() {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[j][e] += y[j][e];
          y[j][e] = 0.f;
        }
    };
    const T* wl = wt + wl_row * LD + wl_col;
    if constexpr (AREG) {   // h's A fragments: loaded once, kept
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < KR; ++kc)
          if (kc < KD) ldmatrix_x4(af[kc], h_lane + kc * 16);
      }
#pragma unroll
      for (int kc = 0; kc < KR; ++kc) {
        if (kc < KD) {
          uint32_t bw[4];
          ldmatrix_x4(bw, wl + kc * 16);
          mma_16816<T>(y[0], af[kc], bw[0], bw[1]);
          mma_16816<T>(y[1], af[kc], bw[2], bw[3]);
        }
        if (kc % KP == KP - 1) fold();   // (y is 0 past KD)
      }
    } else {   // h's A fragments from shared memory, every tile
#pragma unroll 4
      for (int kc = 0; kc < H16; kc += 16) {
        uint32_t a[4], bw[4];
        ldmatrix_x4(a, h_lane + kc);
        ldmatrix_x4(bw, wl + kc);
        mma_16816<T>(y[0], a, bw[0], bw[1]);
        mma_16816<T>(y[1], a, bw[2], bw[3]);
        if ((kc / 16) % KP == KP - 1) fold();
      }
    }
    fold();   // h W_tile^T's last chunk; the rank term sums on its own
    const T* bl = bts + wl_row * LDR + wl_col;
    if constexpr (XREG) {   // r16 = 16: one rank k-step, xa's kept
      if (it == 0) ldmatrix_x4(xf, xa_lane);
      uint32_t bb[4];
      ldmatrix_x4(bb, bl);
      mma_16816<T>(y[0], xf, bb[0], bb[1]);
      mma_16816<T>(y[1], xf, bb[2], bb[3]);
    } else {
#pragma unroll 1
      for (int kc = 0; kc < R16; kc += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, xa_lane + kc);
        ldmatrix_x4(bb, bl + kc);
        mma_16816<T>(y[0], a, bb[0], bb[1]);
        mma_16816<T>(y[1], a, bb[2], bb[3]);
        if ((kc / 16) % KP == KP - 1) fold();
      }
    }
    fold();

    // coef of rows g (rr = 0) and g + 8 (rr = 1) x this lane's columns
    // v0 + 8 j + 2 t + e, rounded to T, into the group's column block of
    // c_s [rows][GT x 32 vocab]
    const int v0 = tile * VT + vg * 16;
    const int gi = it % GT;   // this tile's place in its group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1, rr = i & 1;   // n-tile, row g or g + 8
      float c[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + j * 8 + 2 * t + e;
        const float xv = x[j][rr * 2 + e];
        c[e] = (rin[rr] && v < V)
                   ? dl[rr] * expf(xv - ls[rr]) + (v == lab[rr] ? dg[rr] : 0.f)
                   : 0.f;
      }
      *reinterpret_cast<uint32_t*>(c_s + (rg * 16 + g + 8 * rr) * LDC +
                                   gi * VT + vg * 16 + j * 8 + 2 * t) =
          pack2<T>(c[0], c[1]);
    }
    if (gi != GT - 1 && tile + 1 != t_end) continue;
    __syncthreads();   // the group's coef is whole in c_s

    // dbt[16 vocab columns m of the group, rank pair p] = coef^T [16, RT]
    // . xa [RT, 16], k over the tile's rows: the (m, p) items dealt to
    // the warps in turn; rows past V are not written
    const int n_m = (gi + 1) * 2, gv0 = (tile - gi) * VT;
#pragma unroll 1
    for (int item = warp; item < n_m * NP; item += WARPS) {
      const int mt = item % n_m, p = item / n_m;
      float d[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < RG; ++kk) {
        uint32_t a[4], b[4];
        ldmatrix_x4_trans(a, ct_lane + kk * 16 * LDC + mt * 16);
        ldmatrix_x4_trans(b, xt_lane + kk * 16 * LDR + p * 16);
        mma_16816<T>(d[0], a, b[0], b[1]);
        mma_16816<T>(d[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = gv0 + mt * 16 + g + 8 * (e >> 1);
        if (v >= V) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = p * 16 + j * 8 + 2 * t + (e & 1);
          if (col < rk) dst[(size_t)v * rk + col] = d[j][e];
        }
      }
    }
  }
  cp_async_wait<0>();   // (an empty slab leaves h's copy in flight)
}

__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ out, size_t n,
                              int n_parts) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int k = 0; k < n_parts; ++k) sum += part[(size_t)k * n + e];
  out[e] = sum;
}

template <typename T, int RG, bool AREG, bool XREG>
int launch(const void* h, const void* w, const void* xa, const void* bt,
           const int* labels, const float* lse, const float* dlse,
           const float* dgold, float* part, float* dbt, int R, int V, int H,
           int rk, int n_slabs, int tiles_per_slab, int stages,
           cudaStream_t st) {
  const size_t smem = smem_bytes(RG, stages, H, rk, sizeof(T));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int row_tiles = (R + 16 * RG - 1) / (16 * RG);
  if (row_tiles > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dbt_mma_kernel<T, RG, AREG, XREG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(row_tiles, n_slabs);
  dbt_mma_kernel<T, RG, AREG, XREG><<<grid, RG * VG * 32, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(xa), static_cast<const T*>(bt), labels, lse,
      dlse, dgold, row_tiles > 1 ? part : dbt, R, V, H, rk, tiles_per_slab,
      stages);
  e = cudaGetLastError();
  if (e != cudaSuccess || row_tiles == 1) return (int)e;
  const size_t n = (size_t)V * rk;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dbt, n,
                                                             row_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rg(int rg, const void* h, const void* w, const void* xa,
                const void* bt, const int* labels, const float* lse,
                const float* dlse, const float* dgold, float* part,
                float* dbt, int R, int V, int H, int rk, int n_slabs,
                int tiles_per_slab, int stages, cudaStream_t st) {
  if (h_in_regs(H)) {   // the plan takes 64-row tiles up to H 640
    if (rg != 4) return (int)cudaErrorInvalidValue;
    if (xa_in_regs(H, rk))
      return launch<T, 4, true, true>(h, w, xa, bt, labels, lse, dlse, dgold,
                                      part, dbt, R, V, H, rk, n_slabs,
                                      tiles_per_slab, stages, st);
    return launch<T, 4, true, false>(h, w, xa, bt, labels, lse, dlse, dgold,
                                     part, dbt, R, V, H, rk, n_slabs,
                                     tiles_per_slab, stages, st);
  }
  switch (rg) {
    case 4:
      return launch<T, 4, false, false>(h, w, xa, bt, labels, lse, dlse,
                                        dgold, part, dbt, R, V, H, rk,
                                        n_slabs, tiles_per_slab, stages, st);
    case 2:
      return launch<T, 2, false, false>(h, w, xa, bt, labels, lse, dlse,
                                        dgold, part, dbt, R, V, H, rk,
                                        n_slabs, tiles_per_slab, stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_fused_ce_dbt_mma(
    const void* h, const void* w, const void* xa, const void* bt,
    const int* labels, const float* lse, const float* dlse,
    const float* dgold, float* part, float* dbt, int R, int V, int H, int rk,
    int row_groups, int stages, int n_slabs, int tiles_per_slab, int dtype,
    void* stream) {
  if (R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || rk <= 0 ||
      rk > MAX_RANK || stages < 1 || stages > 3 || n_slabs <= 0 ||
      tiles_per_slab <= 0 ||
      (long long)n_slabs * tiles_per_slab * VT < V ||
      (long long)(n_slabs - 1) * tiles_per_slab * VT >= V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_rg<__nv_bfloat16>(row_groups, h, w, xa, bt, labels,
                                        lse, dlse, dgold, part, dbt, R, V, H,
                                        rk, n_slabs, tiles_per_slab, stages,
                                        st);
    case 2:
      return dispatch_rg<__half>(row_groups, h, w, xa, bt, labels, lse, dlse,
                                 dgold, part, dbt, R, V, H, rk, n_slabs,
                                 tiles_per_slab, stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
