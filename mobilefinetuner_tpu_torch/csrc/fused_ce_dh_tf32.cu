// Fused cross-entropy dh on Hopper's tensor cores (sm_90a) for f32 h and
// W, the dtype every CLI defaults to, in 3xTF32.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dh_kernel` (launched by
// `_bwd_dh`, row 7) for f32 operands:
//   dh [R, H] f32 = coef @ W,
//   coef = dlse * exp(h W^T - lse) + dgold * onehot(label).
// In f32 the TPU kernel's `coef.astype(w.dtype)` rounds nothing, so coef
// enters the product split into TF32 halves like every other operand.
// bf16 and f16 run fused_ce_dh_mma.cu; fused_ce.cu's FMA kernel
// (mft_fused_ce_dh), which f32 ran before, is kept as this kernel's
// earlier version, on no path.
//
// Bound on this card, at the Gemma-3-270M training shape (R = 128 rows of
// a loss chunk, V = 262,144, H = 640): W must be read once, 671 MB, ~200
// us at 3.35 TB/s; the two products' 4 R V H = 85.9 GFLOP are 257.7
// GFLOP of TF32 in 3xTF32, ~521 us at the 495 TFLOP/s TF32 rate.
// Operations bound it.
//
// Design: the layout of fused_ce_dh_lora_mma.cu (coef through shared
// memory, dh's columns dealt to the warps), so each logits tile is formed
// once for all of H; every product is an m16n8k8 TF32 mma.sync on
// operands split into hi + lo halves (tensor_core_tf32.cuh), three
// products a k-step (one TF32 product would move exp(logit - lse) by
// ~2^-11 |logit|, which the f32 checks see).
//   A CTA owns (a 16 RG-row tile, a vocabulary slab); RG row groups of
//   WG = 8 warps. h's row tile [16 RG, H] stays in shared memory for the
//   slab, raw; a W tile [VT = 16, H] rides in a ring of up to three
//   cp.async stages. Rows are H + 4 floats apart, so ldmatrix rows and
//   the transposed 32-bit reads below are free of bank conflicts.
//   Shared memory decides the layout: f32 operands are twice bf16's,
//   and h's 32-row tile (82,432 bytes at H 640) with three W tiles of 16
//   rows (41,216 each) take 206,080 of the 232,448 bytes a block may
//   use, so h and W are kept raw and split at fragment load; stored
//   split, either would take twice the room and leave one W buffer or a
//   16-row h tile (twice the L2 reads of W). The split is integer
//   arithmetic on the bits (split_tf32_bits: cvt.rna's result in two
//   integer operations a half). coef, formed once a tile, is stored
//   split.
//   Logits [16 RG, 16] of a tile: warp (rg, wg) takes k-steps
//   [wg KS / WG, (wg + 1) KS / WG) of the KS = H / 8, h and W by
//   ldmatrix (a [n][k] f32 tile is the B fragment), the three products
//   of a k-step into two accumulators an n-tile (lo.hi + hi.lo; hi.hi),
//   issued term by term so that no mma.sync waits on the one before, and
//   writes its two C fragments to shared memory in fragment order (a
//   float4 a lane an n-tile); each thread adds one element's WG partials
//   in warp order, forms its coef and stores it split, [16 RG][VT + 8]
//   hi and lo.
//   dh [16 RG, H] += coef [16 RG, 16] W_tile [16, H]: each of the 8 RG
//   warps owns nt n-tiles of 8 columns (nt = ceil(H / 8 / (8 RG)): 5 at
//   H 640) for every row of the tile, so each B fragment is loaded and
//   split once for all RG m-tiles; 4 RG nt f32 accumulators a lane (40).
//   Straight-line code (a branch around an mma.sync costs a warp
//   convergence barrier each): an n-tile past the warp's own reads column
//   0's and is never stored, and the template's NT is nt itself on the
//   Gemma path. No ldmatrix.trans for 32-bit data: W's B fragment (k =
//   vocab) is two 32-bit loads, and coef's A fragment takes the
//   C-fragment permutation of tensor_core_tf32.cuh (k index t -> vocab
//   2t, t + 4 -> 2t + 1), so W is read at rows 2t and 2t + 1: banks 8t +
//   g, no conflict; coef's pairs are one 64-bit load each.
//   Grid (row tiles, slabs): the CTAs of a slab read the same W tiles at
//   about the same time, so all but the first find them in L2; slabs are
//   sized so that the grid is one wave.
//   Deterministic: partials in a fixed order, a [rows, H] partial per
//   slab, and a reduce kernel in the same launch sums the slabs in
//   order; no atomics, so two calls give identical bits.
// Ragged R and V are masked (zero-filled rows; coef 0 past R and V); H
// must be a multiple of 8 (16-byte rows, whole k-steps).
//
// C interface (ctypes): mft_fused_ce_dh_tf32 returns the CUDA error code
// of its launches. h [R, H] and W [V, H] contiguous f32 (dtype 0; any
// other code is refused), 16-byte aligned; labels [R] int32 in [0, V);
// lse, dlse, dgold [R] f32; part [n_slabs, R, H] and dh [R, H] f32. The
// launch plan (row groups, stages, n_slabs, tiles_per_slab) comes from
// the wrapper (ops/fused_ce.dh_tf32_plan).

#include "tensor_core.cuh"
#include "tensor_core_tf32.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::ldmatrix_x4;
using mft::mma_1688_tf32;
using mft::mma_3xtf32;
using mft::split_tf32_bits;

constexpr int VT = 16;          // vocab rows of a W tile
constexpr int WG = 8;           // warps of a row group
constexpr int LDC = VT + 8;     // coef row stride (floats)
constexpr int SMEM_MAX = 232448;

// n-tiles of dh a warp holds, for every row of the tile: ceil(H / 8 /
// (RG WG))
__host__ __device__ inline int nt_of(int H, int RG) {
  return (H / 8 + RG * WG - 1) / (RG * WG);
}

// Shared memory of a CTA: h [16 RG][H + 4] and W [stages][VT][H + 4],
// the logits partials [RG][WG][2 n-tiles][32 lanes] float4 and coef hi,
// lo [16 RG][LDC], all f32.
__host__ __device__ inline size_t smem_bytes(int RG, int stages, int H) {
  return ((size_t)(16 * RG + stages * VT) * (H + 4) + 2 * 16 * RG * LDC) *
             sizeof(float) +
         (size_t)RG * WG * 2 * 32 * 16;
}

// x split into TF32 halves, as the fragment registers take them
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32_bits(__uint_as_float(x[i]), hi[i], lo[i]);
}

template <int RG, int NT>
__global__ void __launch_bounds__(RG * WG * 32, 1)
dh_tf32_kernel(const float* __restrict__ h, const float* __restrict__ w,
               const int* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ dlse,
               const float* __restrict__ dgold, float* __restrict__ part,
               int R, int V, int H, int tiles_per_slab, int stages) {
  constexpr int RT = 16 * RG;
  constexpr int THREADS = RG * WG * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = H + 4;
  float* h_s = reinterpret_cast<float*>(smem_raw);
  float* w_s = h_s + RT * LD;                        // [stages][VT][LD]
  float4* red = reinterpret_cast<float4*>(w_s + stages * VT * LD);
  float* ch_s = reinterpret_cast<float*>(red + RG * WG * 64);  // [RT][LDC]
  float* cl_s = ch_s + RT * LDC;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int rg = warp / WG, wg = warp % WG;
  const int row0 = blockIdx.x * RT;
  const int slab = blockIdx.y;
  const int n_vt = (V + VT - 1) / VT;
  const int t0 = slab * tiles_per_slab;
  const int t_end = min(n_vt, t0 + tiles_per_slab);

  const int CH = H / 4;                   // 16-byte chunks a row
  for (int i = tid; i < RT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4, gr = row0 + r;
    cp_async_16(h_s + r * LD + c, h + (size_t)min(gr, R - 1) * H + c,
                gr < R);
  }
  // this thread's first 16-byte chunk of a W tile and the step between
  // its chunks as (row, chunk) pairs: no division in the tile loop
  const int r_first = tid / CH, c_first = tid % CH;
  const int r_step = THREADS / CH, c_step = THREADS % CH;
  auto stage = [&](int tile, int buf) {
    float* dst = w_s + buf * VT * LD;
    const int v0 = tile * VT;
    for (int r = r_first, c = c_first; r < VT;) {
      const int gv = v0 + r;
      cp_async_16(dst + r * LD + c * 4,
                  w + (size_t)min(gv, V - 1) * H + c * 4, gv < V);
      r += r_step;
      c += c_step;
      if (c >= CH) {
        c -= CH;
        ++r;
      }
    }
  };
  // a ring of `stages` W buffers, `stages` - 1 tiles ahead (one group
  // each; the first also carries h); a single buffer is refilled in turn
  for (int i = 0; i < max(1, stages - 1); ++i) {
    if (t0 + i < t_end) stage(t0 + i, i);
    cp_async_commit();
  }

  // coef: thread tid forms one element of the tile, element e of the C
  // fragment (row group cg, n-tile cj, lane cl) of every warp's partial,
  // so the threads read the partials in order, 16 RG x 16 a tile
  const int cg = tid / 256, cj = (tid / 128) % 2, cl = (tid / 4) % 32,
            ce = tid % 4;
  const int c_row = cg * 16 + cl / 4 + 8 * (ce >> 1);
  const int c_col = cj * 8 + 2 * (cl % 4) + (ce & 1);
  const bool rin = row0 + c_row < R;
  const int lab = rin ? labels[row0 + c_row] : -1;
  const float ls = rin ? lse[row0 + c_row] : 0.f;
  const float dl = rin ? dlse[row0 + c_row] : 0.f;
  const float dg = rin ? dgold[row0 + c_row] : 0.f;

  const int KS = H / 8;                   // k-steps of the logits
  const int ks0 = wg * KS / WG, ks1 = (wg + 1) * KS / WG;
  const int nt = nt_of(H, RG);
  const int n_own = min(nt, KS - warp * nt);   // this warp's n-tiles (<= 0:
                                               // none)
  float acc[RG][NT][4];
#pragma unroll
  for (int m = 0; m < RG; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // lane addresses: A (h rows of the warp) and B (W's 16 vocab rows as
  // [n][k]) of the logits by ldmatrix; coef's pairs and W's rows 2t,
  // 2t + 1 of dh
  const float* a_lane = h_s + (rg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 4;
  const int b_off = (lr + (lm / 2) * 8) * LD + (lm % 2) * 4;
  const int c_off = g * LDC + 2 * t;
  // (a warp with no n-tile of its own reads column 0's)
  const int wd_off = 2 * t * LD + (n_own > 0 ? warp * nt * 8 : 0) + g;
  float4* red_w = red + (rg * WG + wg) * 64 + lane;

  for (int tile = t0, it = 0; tile < t_end; ++tile, ++it) {
    const int buf = it % stages;
    if (stages > 1) {
      if (stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();   // tile `it` landed; buffer (it - 1) consumed
      if (tile + stages - 1 < t_end)
        stage(tile + stages - 1, (it + stages - 1) % stages);
      cp_async_commit();
    } else {
      if (it > 0) {
        __syncthreads();   // the buffer is consumed before it is restaged
        stage(tile, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
    }
    const float* wt = w_s + buf * VT * LD;

    // this warp's k-slice of the logits, 16 rows x 16 vocab: the three
    // products of a k-step into two accumulators (lo.hi + hi.lo; hi.hi)
    // an n-tile, issued term by term, so no mma.sync waits on the one
    // before it
    float sm[2][4], hh[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[j][e] = hh[j][e] = 0.f;
#pragma unroll 2
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t a[4], b[4], ah[4], al[4], bh[4], bl[4];
      ldmatrix_x4(a, a_lane + ks * 8);
      ldmatrix_x4(b, wt + b_off + ks * 8);
      split4(a, ah, al);
      split4(b, bh, bl);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_1688_tf32(sm[j], al, bh[2 * j], bh[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_1688_tf32(hh[j], ah, bh[2 * j], bh[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_1688_tf32(sm[j], ah, bl[2 * j], bl[2 * j + 1]);
    }
    red_w[0] = make_float4(hh[0][0] + sm[0][0], hh[0][1] + sm[0][1],
                           hh[0][2] + sm[0][2], hh[0][3] + sm[0][3]);
    red_w[32] = make_float4(hh[1][0] + sm[1][0], hh[1][1] + sm[1][1],
                            hh[1][2] + sm[1][2], hh[1][3] + sm[1][3]);
    __syncthreads();   // every warp's partial is in red

    // this thread's coef element: the WG partials added in warp order
    {
      const float* p = reinterpret_cast<const float*>(red) +
                       cg * WG * 256 + tid % 256;
      float x = p[0];
#pragma unroll
      for (int k = 1; k < WG; ++k) x += p[k * 256];
      const int v = tile * VT + c_col;
      const float c = (rin && v < V)
                          ? dl * expf(x - ls) + (v == lab ? dg : 0.f)
                          : 0.f;
      uint32_t hi, lo;
      split_tf32_bits(c, hi, lo);
      ch_s[c_row * LDC + c_col] = __uint_as_float(hi);
      cl_s[c_row * LDC + c_col] = __uint_as_float(lo);
    }
    __syncthreads();   // coef is in shared memory

    // dh[16 RG, this warp's columns] += coef [16 RG, 16] W_tile [16,
    // columns]: two k-steps of 8 vocab rows, A from coef's pairs (vocab
    // 2t, 2t + 1) of every m-tile, each B fragment split once for all
#pragma unroll
    for (int kk = 0; kk < VT; kk += 8) {
      uint32_t ah[RG][4], al[RG][4];
#pragma unroll
      for (int m = 0; m < RG; ++m) {
        const int o = c_off + m * 16 * LDC + kk;
        const float2 h0 = *reinterpret_cast<const float2*>(ch_s + o);
        const float2 h1 = *reinterpret_cast<const float2*>(ch_s + o + 8 * LDC);
        const float2 l0 = *reinterpret_cast<const float2*>(cl_s + o);
        const float2 l1 = *reinterpret_cast<const float2*>(cl_s + o + 8 * LDC);
        ah[m][0] = __float_as_uint(h0.x);
        ah[m][1] = __float_as_uint(h1.x);
        ah[m][2] = __float_as_uint(h0.y);
        ah[m][3] = __float_as_uint(h1.y);
        al[m][0] = __float_as_uint(l0.x);
        al[m][1] = __float_as_uint(l1.x);
        al[m][2] = __float_as_uint(l0.y);
        al[m][3] = __float_as_uint(l1.y);
      }
      // straight-line (a branch around an mma.sync costs a warp
      // convergence barrier): an n-tile past the warp's own reads column
      // 0's and is never stored
      const float* wd = wt + kk * LD + wd_off;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int o = n < n_own ? n * 8 : 0;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_bits(wd[o], bh0, bl0);
        split_tf32_bits(wd[LD + o], bh1, bl1);
#pragma unroll
        for (int m = 0; m < RG; ++m)
          mma_3xtf32(acc[m][n], ah[m], al[m], bh0, bh1, bl0, bl1);
      }
    }
  }

  cp_async_wait<0>();   // no copy left in flight at exit
  // each warp owns its [16 RG, columns] block of the slab's partial
#pragma unroll
  for (int m = 0; m < RG; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + m * 16 + g + 8 * i;
      if (r >= R) continue;
      float* dst = part + ((size_t)slab * R + r) * H + warp * nt * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < n_own)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(acc[m][n][2 * i], acc[m][n][2 * i + 1]);
    }
}

__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ out, size_t n,
                              int n_slabs) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int k = 0; k < n_slabs; ++k) sum += part[(size_t)k * n + e];
  out[e] = sum;
}

template <int RG, int NT>
int launch(const float* h, const float* w, const int* labels,
           const float* lse, const float* dlse, const float* dgold,
           float* part, float* dh, int R, int V, int H, int n_slabs,
           int tiles_per_slab, int stages, cudaStream_t st) {
  const size_t smem = smem_bytes(RG, stages, H);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dh_tf32_kernel<RG, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + 16 * RG - 1) / (16 * RG), n_slabs);
  dh_tf32_kernel<RG, NT><<<grid, RG * WG * 32, smem, st>>>(
      h, w, labels, lse, dlse, dgold, part, R, V, H, tiles_per_slab, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)R * H;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dh, n,
                                                             n_slabs);
  return (int)cudaGetLastError();
}

// the smallest NT of (2, 5, 6, 12, 28) that holds nt_of(H, RG); 32-row
// tiles (512 threads, at most 128 registers a thread) up to NT 6
int dispatch(int rg, const float* h, const float* w, const int* labels,
             const float* lse, const float* dlse, const float* dgold,
             float* part, float* dh, int R, int V, int H, int n_slabs,
             int tiles_per_slab, int stages, cudaStream_t st) {
  const int nt = nt_of(H, rg);
#define MFT_LAUNCH(RG, NT)                                                  \
  return launch<RG, NT>(h, w, labels, lse, dlse, dgold, part, dh, R, V, H, \
                        n_slabs, tiles_per_slab, stages, st)
  if (rg == 2 && nt <= 2) MFT_LAUNCH(2, 2);
  if (rg == 2 && nt <= 5) MFT_LAUNCH(2, 5);
  if (rg == 2 && nt <= 6) MFT_LAUNCH(2, 6);
  if (rg == 1 && nt <= 2) MFT_LAUNCH(1, 2);
  if (rg == 1 && nt <= 6) MFT_LAUNCH(1, 6);
  if (rg == 1 && nt <= 12) MFT_LAUNCH(1, 12);
  if (rg == 1 && nt <= 28) MFT_LAUNCH(1, 28);
#undef MFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mft_fused_ce_dh_tf32(const void* h, const void* w,
                                    const int* labels, const float* lse,
                                    const float* dlse, const float* dgold,
                                    float* part, float* dh, int R, int V,
                                    int H, int row_groups, int stages,
                                    int n_slabs, int tiles_per_slab,
                                    int dtype, void* stream) {
  if (dtype != 0 || R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 ||
      stages < 1 || stages > 3 || n_slabs <= 0 || tiles_per_slab <= 0 ||
      (long long)n_slabs * tiles_per_slab * VT < V ||
      (long long)(n_slabs - 1) * tiles_per_slab * VT >= V)
    return (int)cudaErrorInvalidValue;
  return dispatch(row_groups, static_cast<const float*>(h),
                  static_cast<const float*>(w), labels, lse, dlse, dgold,
                  part, dh, R, V, H, n_slabs, tiles_per_slab, stages,
                  static_cast<cudaStream_t>(stream));
}
