// Head-adapter fused cross-entropy forward on Hopper's tensor cores
// (sm_90a), bf16 and f16.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_fwd_kernel_lora`
// (launched by `_fwd_lora`, row 9) for 16-bit operands:
//   lse [R] f32  = logsumexp over V of logits = h W^T + xa bt^T,
//   gold [R] f32 = the logit at the row's label,
// xa [R, r] the scale-folded bottleneck of a LoRA on the tied head and
// bt = B^T [V, r]; the logits accumulated in f32 from operands in their
// storage dtype and never written to device memory. f32 stays on
// mft_fused_ce_fwd_lora (fused_ce.cu).
//
// Bound on this card, at the Gemma-3-270M training shape with a rank-8
// head adapter (R = 128 rows of a loss chunk, V = 262,144, H = 640, r = 8,
// bf16): W and bt must be read once, 339.7 MB, ~101 us at 3.35 TB/s; the
// 2 R V (H + r) = 43.5 GFLOP need ~44 us at the bf16 tensor-core rate.
// Bytes bound it.
//
// Design: row 6's (fused_ce_fwd_mma.cu) with the rank-r term as more
// k-steps. A CTA owns (a 16 RG-row tile, a vocabulary slab); 2 RG warps,
// warp (rg, vg) holding rows 16 rg.. of the tile and vocab columns 16 vg..
// of each 32-column W tile.
//   h's row tile [16 RG, H] and xa's [16 RG, r16] (r rounded up to 16)
//   are staged in shared memory once a slab; up to H = 640 (KR = 40
//   k-steps) each lane keeps its rows' A fragments of h in registers for
//   the whole slab (160 registers), and at r16 = 16 its xa fragment too
//   (4 more), so a k-step reads only W's (or bt's) B fragment from shared
//   memory. A wider H, or a rank past 16, reads those fragments from
//   shared memory every tile.
//   A W tile [32, H] and its bt tile [32, r16] ride in one cp.async stage
//   of a ring of up to three buffers (loads two tiles ahead), refilled
//   after the tile's sync: one sync a tile, where row 6 has two. The logits
//   are m16n8k16 mma.sync, f32 accumulate: h W_tile^T over k = H, then
//   xa bt_tile^T over k = r16, the columns past r zero in shared memory so
//   they add nothing.
//   The online max, sum-exp and gold run on the C fragments: each lane
//   keeps (m, s, gold) for its two rows over its own columns, rescaled
//   once a tile; at the end of the slab the four lanes of a quad merge by
//   xor shuffles, and the vg = 1 warps hand their rows to the vg = 0 warps
//   through shared memory, merged in that fixed order.
//   W reaches device memory about once: the grid's x index runs over the
//   row tiles of one slab, so the CTAs that read the same W tiles are
//   launched together and the second finds them in L2; slabs are sized so
//   that the grid is one wave of CTAs (ops/fused_ce.fwd_lora_mma_plan). A
//   large rank takes fewer W buffers, never a narrower tile.
//   Deterministic: each CTA writes a (m, s, gold) partial per (slab, row)
//   and a merge kernel folds the slabs in order; no atomics, so two calls
//   give identical bits.
//   Rank rows are copied 16 bytes at a time (cp.async, zero-filled past an
//   edge) when r % 8 == 0 and xa, bt are 16-byte aligned, 4 bytes at a
//   time when r is even and they are 4-byte aligned, else element by
//   element without cp.async (slower, right): r need not be a multiple
//   of 8. (The first version, 4-byte copies and row 6's two syncs a tile,
//   ran 294.4 against 294.5 us at the Gemma shape and 95.3 against 87.0 at
//   r 128: kernel_variants.py on an H100.)
// Ragged R and V are masked (rows past R are zero-filled and not written,
// columns past V add nothing to the max, the sum or gold); H must be a
// multiple of 8 (16-byte rows); columns [H, H16) are zero in shared
// memory so the last k-step adds nothing.
// The logits run one MMA chain over all k-steps, as row 6's: lse and gold
// come out ~2e-6 from an f64 sum at the Gemma chunk. Cutting the chain
// every 8 k-steps (row 11 does, since it rounds coef to bf16) brought that
// to ~5e-7 for 2.4% more time and a 12-byte spill; the loss does not need
// it.
// What holds it back: row 6's limit, each warp's chain of ldmatrix -> mma
// a k-step with no registers left to load W's fragments further ahead;
// the rank term adds one k-step in 41 at r 8, and its bt tile a copy, ~10%
// over row 6 at the Gemma shape (PERF.md).
//
// C interface (ctypes): mft_fused_ce_fwd_lora_mma returns the CUDA error
// code of its launches. h [R, H], W [V, H], xa [R, r], bt [V, r]
// contiguous in one dtype (1 bf16, 2 f16), h and W 16-byte aligned;
// labels [R] int32 in [0, V); part [n_slabs, R, 3], lse and gold [R] f32.
// The launch plan (row groups, stages, n_slabs, tiles_per_slab) comes from
// the wrapper (ops/fused_ce.fwd_lora_mma_plan).

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
using mft::mma_16816;
using mft::NEG_INF;

constexpr int VT = 32;          // vocab columns of a tile
constexpr int VG = 2;           // vocab groups (warps) of 16 columns
constexpr int KR = 40;          // k-steps of h a lane holds (H16 <= 640)
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
// [LDR] and bt [stages][VT][LDR] in T (after the loop its first bytes
// hold the vg = 1 warps' [16 RG][3]).
__host__ __device__ inline size_t smem_bytes(int RG, int stages, int H,
                                             int r, size_t elem) {
  const size_t ld = (size_t)h16_of(H) + 8, ldr = (size_t)h16_of(r) + 8;
  return (16 * RG + stages * VT) * (ld + ldr) * elem;
}

// (m, s) <- the logsumexp state of (m, s) and (mo, so) together
__device__ __forceinline__ void merge(float& m, float& s, float mo,
                                      float so) {
  const float mx = fmaxf(m, mo);
  s = s * expf(m - mx) + so * expf(mo - mx);
  m = mx;
}

template <typename T, int RG, bool AREG, bool XREG>
__global__ void __launch_bounds__(RG * VG * 32, 1)
fwd_lora_mma_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const T* __restrict__ xa, const T* __restrict__ bt,
                    const int* __restrict__ labels, float* __restrict__ part,
                    int R, int V, int H, int rk, int tiles_per_slab,
                    int stages) {
  constexpr int RT = 16 * RG;
  constexpr int THREADS = RG * VG * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H16 = h16_of(H), LD = H16 + 8;
  const int R16 = h16_of(rk), LDR = R16 + 8;
  T* h_s = reinterpret_cast<T*>(smem_raw);
  T* w_s = h_s + RT * LD;                 // [stages][VT][LD]
  T* xa_s = w_s + stages * VT * LD;       // [RT][LDR]
  T* bt_s = xa_s + RT * LDR;              // [stages][VT][LDR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int rg = warp % RG, vg = warp / RG;
  const int row0 = blockIdx.x * RT;
  const int slab = blockIdx.y;
  const int n_vt = (V + VT - 1) / VT;
  const int t0 = slab * tiles_per_slab;
  const int t_end = min(n_vt, t0 + tiles_per_slab);

  // columns [H, H16) of every staged h / W row and [rk, R16) of every xa
  // / bt row are zero (the copies never write them): the last k-steps of
  // the logits add 0
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
  auto load_rank = [&](T* dst, const T* src, int n, int first, int n_src) {
    for (int i = tid; i < n * RP; i += THREADS) {
      const int r = i / RP, c = (i % RP) * E, gr = first + r;
      const T* from = src + (size_t)min(gr, n_src - 1) * rk + c;
      if (E == 8)
        cp_async_16(dst + r * LDR + c, from, gr < n_src);
      else if (E == 2)
        cp_async_4(dst + r * LDR + c, from, gr < n_src);
      else
        dst[r * LDR + c] = gr < n_src ? *from : from_f32<T>(0.f);
    }
  };
  load_rank(xa_s, xa, RT, row0, R);
  // this thread's first 16-byte chunk of a W tile and the step between
  // its chunks as (row, chunk) pairs: no division in the tile loop
  const int r_first = tid / CH, c_first = tid % CH;
  const int r_step = THREADS / CH, c_step = THREADS % CH;
  auto stage = [&](int tile, int buf) {
    T* dst = w_s + buf * VT * LD;
    const int v0 = tile * VT;
    for (int r = r_first, c = c_first; r < VT;) {
      const int gv = v0 + r;
      cp_async_16(dst + r * LD + c * 8,
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

  // this lane's rows g and g + 8 of the warp's 16: label, running max,
  // sum of exp and gold over the lane's columns
  int lab[2];
  float m[2], s[2], gl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + rg * 16 + g + 8 * i;
    lab[i] = r < R ? labels[r] : -1;
    m[i] = NEG_INF;
    s[i] = 0.f;
    gl[i] = 0.f;
  }

  // lane addresses: A of the warp's rows in h_s and xa_s; W's (bt's) 16
  // vocab rows of this warp as the logits' B (non-transposed)
  const T* h_lane = h_s + (rg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
  const T* xa_lane =
      xa_s + (rg * 16 + lr + (lm % 2) * 8) * LDR + (lm / 2) * 8;
  const int wl_row = vg * 16 + lr + (lm / 2) * 8, wl_col = (lm % 2) * 8;

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

    // logits of 16 rows x 16 vocab columns: over H, then over the rank
    float x[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
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
          mma_16816<T>(x[0], af[kc], bw[0], bw[1]);
          mma_16816<T>(x[1], af[kc], bw[2], bw[3]);
        }
      }
    } else {   // h's A fragments from shared memory, every tile
#pragma unroll 4
      for (int kc = 0; kc < H16; kc += 16) {
        uint32_t a[4], bw[4];
        ldmatrix_x4(a, h_lane + kc);
        ldmatrix_x4(bw, wl + kc);
        mma_16816<T>(x[0], a, bw[0], bw[1]);
        mma_16816<T>(x[1], a, bw[2], bw[3]);
      }
    }
    const T* bl = bts + wl_row * LDR + wl_col;
    if constexpr (XREG) {   // r16 = 16: one rank k-step, xa's kept
      if (it == 0) ldmatrix_x4(xf, xa_lane);
      uint32_t bb[4];
      ldmatrix_x4(bb, bl);
      mma_16816<T>(x[0], xf, bb[0], bb[1]);
      mma_16816<T>(x[1], xf, bb[2], bb[3]);
    } else {
#pragma unroll 1
      for (int kc = 0; kc < R16; kc += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, xa_lane + kc);
        ldmatrix_x4(bb, bl + kc);
        mma_16816<T>(x[0], a, bb[0], bb[1]);
        mma_16816<T>(x[1], a, bb[2], bb[3]);
      }
    }

    // online max / sum-exp / gold of rows g (i = 0) and g + 8 (i = 1)
    // over this lane's 4 columns of the tile: (j, e) -> column
    // v0 + 8 j + 2 t + e, fragment element x[j][2 i + e]
    const int v0 = tile * VT + vg * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + j * 8 + 2 * t + e;
          const float xv = x[j][2 * i + e];
          if (v < V) {
            mx = fmaxf(mx, xv);
            if (v == lab[i]) gl[i] += xv;
          }
        }
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (v0 + j * 8 + 2 * t + e < V) se += expf(x[j][2 * i + e] - mx);
      s[i] = s[i] * expf(m[i] - mx) + se;
      m[i] = mx;
    }
  }

  // the four lanes of a quad hold the same rows: merge them (xor
  // shuffles; a + b == b + a, so all four agree bit for bit)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off);
      gl[i] += __shfl_xor_sync(0xffffffffu, gl[i], off);
      merge(m[i], s[i], mo, so);
    }

  // the vg = 1 warps' rows through shared memory, merged in order
  cp_async_wait<0>();   // (an empty slab leaves h's copy in flight)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);   // [RT][3]
  if (vg == 1 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* p = red + (rg * 16 + g + 8 * i) * 3;
      p[0] = m[i];
      p[1] = s[i];
      p[2] = gl[i];
    }
  }
  __syncthreads();
  if (vg == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = rg * 16 + g + 8 * i, r = row0 + rl;
      if (r >= R) continue;
      const float* o = red + rl * 3;
      merge(m[i], s[i], o[0], o[1]);
      float* p = part + ((size_t)slab * R + r) * 3;
      p[0] = m[i];
      p[1] = s[i];
      p[2] = gl[i] + o[2];
    }
  }
}

// lse = M + log(sum_k s_k exp(m_k - M)) and gold = sum_k gold_k over the
// slabs, in slab order
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

template <typename T, int RG, bool AREG, bool XREG>
int launch(const void* h, const void* w, const void* xa, const void* bt,
           const int* labels, float* part, float* lse, float* gold, int R,
           int V, int H, int rk, int n_slabs, int tiles_per_slab, int stages,
           cudaStream_t st) {
  const size_t smem = smem_bytes(RG, stages, H, rk, sizeof(T));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_lora_mma_kernel<T, RG, AREG, XREG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (R + 16 * RG - 1) / (16 * RG);
  dim3 grid(row_tiles, n_slabs);
  fwd_lora_mma_kernel<T, RG, AREG, XREG><<<grid, RG * VG * 32, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(xa), static_cast<const T*>(bt), labels, part, R,
      V, H, rk, tiles_per_slab, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(part, lse, gold, R,
                                                    n_slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rg(int rg, const void* h, const void* w, const void* xa,
                const void* bt, const int* labels, float* part, float* lse,
                float* gold, int R, int V, int H, int rk, int n_slabs,
                int tiles_per_slab, int stages, cudaStream_t st) {
  if (h_in_regs(H)) {   // the plan takes 64-row tiles up to H 640
    if (rg != 4) return (int)cudaErrorInvalidValue;
    if (xa_in_regs(H, rk))
      return launch<T, 4, true, true>(h, w, xa, bt, labels, part, lse, gold,
                                      R, V, H, rk, n_slabs, tiles_per_slab,
                                      stages, st);
    return launch<T, 4, true, false>(h, w, xa, bt, labels, part, lse, gold,
                                     R, V, H, rk, n_slabs, tiles_per_slab,
                                     stages, st);
  }
  switch (rg) {
    case 4:
      return launch<T, 4, false, false>(h, w, xa, bt, labels, part, lse,
                                        gold, R, V, H, rk, n_slabs,
                                        tiles_per_slab, stages, st);
    case 2:
      return launch<T, 2, false, false>(h, w, xa, bt, labels, part, lse,
                                        gold, R, V, H, rk, n_slabs,
                                        tiles_per_slab, stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_fused_ce_fwd_lora_mma(
    const void* h, const void* w, const void* xa, const void* bt,
    const int* labels, float* part, float* lse, float* gold, int R, int V,
    int H, int rk, int row_groups, int stages, int n_slabs,
    int tiles_per_slab, int dtype, void* stream) {
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
                                        part, lse, gold, R, V, H, rk,
                                        n_slabs, tiles_per_slab, stages, st);
    case 2:
      return dispatch_rg<__half>(row_groups, h, w, xa, bt, labels, part, lse,
                                 gold, R, V, H, rk, n_slabs, tiles_per_slab,
                                 stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
