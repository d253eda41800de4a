// Head-adapter fused cross-entropy dh + dxa on Hopper's tensor cores
// (sm_90a) for f32 operands, the dtype every CLI defaults to, in 3xTF32.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dh_kernel_lora`
// (launched by `_bwd_dh_lora`, row 10) for f32 operands:
//   dh [R, H] f32 = coef @ W and dxa [R, r] f32 = coef @ bt,
//   logits = h W^T + xa bt^T (xa [R, r] the scale-folded bottleneck of a
//   LoRA on the tied head, bt = B^T [V, r]),
//   coef = dlse * exp(logits - lse) + dgold * onehot(label).
// In f32 the TPU kernel's `coef_s` rounds nothing, so coef enters the
// products split into TF32 halves like every other operand. bf16 and f16
// run fused_ce_dh_lora_mma.cu; fused_ce.cu's FMA kernel
// (mft_fused_ce_dh_lora), which f32 ran before, is kept as this kernel's
// earlier version, on no path.
//
// Bound on this card, at the Gemma-3-270M training shape with a rank-8
// head adapter (R = 128, V = 262,144, H = 640, r = 8): W and bt must be
// read once, 679 MB, ~203 us at 3.35 TB/s; the products' 4 R V (H + r) =
// 87 GFLOP are 261 GFLOP of TF32 in 3xTF32, ~527 us at the 495 TFLOP/s
// TF32 rate. Operations bound it.
//
// Design: row 7's f32 kernel (fused_ce_dh_tf32.cu, whose note gives the
// layout and why: every product an m16n8k8 TF32 mma.sync in 3xTF32) on a
// widened row. The rank term is one more
// contraction of the logits and dxa one more block of dh's columns, so
// both ride the same loops: h's row tile in shared memory is [h | xa |
// 0] and each W tile row [W | bt | 0], HX = H + r8 columns (r rounded up
// to 8, the columns past r zero), and the product coef @ [W | bt] gives
// [dh | dxa]. The logits' k-steps run over all HX columns (split across
// the WG warps of a row group), and the n-tiles of 8 output columns are
// dealt to all 8 RG warps, nt = ceil(HX / 8 / (8 RG)) each for every row
// of the tile: at H 640 that is 6 for every rank from 1 to 128, so the
// accumulators (48 f32 a lane) do not grow with r. Each dxa column is
// formed by one warp, once per (row tile, slab): nothing is counted
// twice. Rows are HX + 4 floats apart (bank-conflict-free ldmatrix and
// transposed reads, as in row 7); the rank columns are copied 4 bytes
// at a time (cp.async, zero-filled past an edge), so r need not be a
// multiple of 4. A large r costs W buffers: at H 640, r above 8 takes
// two (dh_lora_tf32_plan).
// Deterministic: per-slab partials of dh and dxa, reduced in order in the
// same launch; no atomics, so two calls give identical bits.
// Ragged R and V are masked (zero-filled rows; coef 0 past R and V); H
// must be a multiple of 8.
//
// C interface (ctypes): mft_fused_ce_dh_lora_tf32 returns the CUDA error
// code of its launches. h [R, H], W [V, H], xa [R, r], bt [V, r]
// contiguous f32 (dtype 0; any other code is refused), h and W 16-byte
// aligned; labels [R] int32 in [0, V); lse, dlse, dgold [R] f32; part
// [n_slabs, R, H], dh [R, H], xpart [n_slabs, R, r] and dxa [R, r] f32.
// The launch plan (row groups, stages, n_slabs, tiles_per_slab) comes
// from the wrapper (ops/fused_ce.dh_lora_tf32_plan).

#include "tensor_core.cuh"
#include "tensor_core_tf32.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_4;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::ldmatrix_x4;
using mft::mma_1688_tf32;
using mft::mma_3xtf32;
using mft::split_tf32_bits;

constexpr int VT = 16;          // vocab rows of a W tile
constexpr int WG = 8;           // warps of a row group
constexpr int LDC = VT + 8;     // coef row stride (floats)
constexpr int MAX_RANK = 128;
constexpr int SMEM_MAX = 232448;

// the widened row: H columns of h (W), then r of xa (bt), zero to a
// multiple of 8
__host__ __device__ inline int hx_of(int H, int r) {
  return H + (r + 7) / 8 * 8;
}

// n-tiles of [dh | dxa] a warp holds, for every row of the tile:
// ceil(HX / 8 / (RG WG))
__host__ __device__ inline int nt_of(int HX, int RG) {
  return (HX / 8 + RG * WG - 1) / (RG * WG);
}

// Shared memory of a CTA: [h | xa] [16 RG][HX + 4] and [W | bt]
// [stages][VT][HX + 4], the logits partials [RG][WG][2 n-tiles][32 lanes]
// float4 and coef hi, lo [16 RG][LDC], all f32.
__host__ __device__ inline size_t smem_bytes(int RG, int stages, int HX) {
  return ((size_t)(16 * RG + stages * VT) * (HX + 4) + 2 * 16 * RG * LDC) *
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
dh_lora_tf32_kernel(const float* __restrict__ h,
                    const float* __restrict__ w,
                    const float* __restrict__ xa,
                    const float* __restrict__ bt,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlse,
                    const float* __restrict__ dgold,
                    float* __restrict__ part, float* __restrict__ xpart,
                    int R, int V, int H, int rk, int tiles_per_slab,
                    int stages) {
  constexpr int RT = 16 * RG;
  constexpr int THREADS = RG * WG * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HX = hx_of(H, rk), LD = HX + 4;
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

  // columns [H + r, HX) of every staged row are zero (the copies never
  // write them): the last k-step of the logits adds 0 and the dxa
  // columns past r are never stored
  {
    const int tail = HX - H - rk;
    for (int i = tid; i < (RT + stages * VT) * tail; i += THREADS)
      h_s[(i / tail) * LD + H + rk + i % tail] = 0.f;
  }
  const int CH = H / 4;                   // 16-byte chunks a row
  for (int i = tid; i < RT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4, gr = row0 + r;
    cp_async_16(h_s + r * LD + c, h + (size_t)min(gr, R - 1) * H + c,
                gr < R);
  }
  // rank rows [first, first + n) of src [n_src, rk] into columns
  // [H, H + rk) of dst's rows, 4 bytes at a time (zeros past n_src)
  auto load_rank = [&](float* dst, const float* src, int n, int first,
                       int n_src) {
    for (int i = tid; i < n * rk; i += THREADS) {
      const int r = i / rk, c = i % rk, gr = first + r;
      cp_async_4(dst + r * LD + H + c,
                 src + (size_t)min(gr, n_src - 1) * rk + c, gr < n_src);
    }
  };
  load_rank(h_s, xa, RT, row0, R);
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
    load_rank(dst, bt, VT, v0, V);
  };
  // a ring of `stages` W (+ bt) buffers, `stages` - 1 tiles ahead (one
  // group each; the first also carries h and xa); a single buffer is
  // refilled in turn
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

  const int KS = HX / 8;                  // k-steps of the logits
  const int ks0 = wg * KS / WG, ks1 = (wg + 1) * KS / WG;
  const int nt = nt_of(HX, RG);
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

    // [dh | dxa][16 RG, this warp's columns] += coef [16 RG, 16] [W |
    // bt]_tile [16, columns]: two k-steps of 8 vocab rows, A from coef's pairs (vocab
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
  // each warp owns its [16 RG, columns] block of the slab's partials:
  // dh's columns below H, dxa's from H (a pair never straddles H, a
  // multiple of 8)
#pragma unroll
  for (int m = 0; m < RG; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + m * 16 + g + 8 * i;
      if (r >= R) continue;
      float* dst = part + ((size_t)slab * R + r) * H;
      float* xdst = xpart + ((size_t)slab * R + r) * rk - H;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = (warp * nt + n) * 8 + 2 * t;
        if (n >= n_own) continue;
        const float a = acc[m][n][2 * i], b = acc[m][n][2 * i + 1];
        if (col < H) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(a, b);
        } else {
          if (col < H + rk) xdst[col] = a;
          if (col + 1 < H + rk) xdst[col + 1] = b;
        }
      }
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

int launch_reduce(const float* part, float* out, size_t n, int n_slabs,
                  cudaStream_t st) {
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, out, n,
                                                             n_slabs);
  return (int)cudaGetLastError();
}

template <int RG, int NT>
int launch(const float* h, const float* w, const float* xa,
           const float* bt, const int* labels, const float* lse,
           const float* dlse, const float* dgold, float* part, float* dh,
           float* xpart, float* dxa, int R, int V, int H, int rk,
           int n_slabs, int tiles_per_slab, int stages, cudaStream_t st) {
  const size_t smem = smem_bytes(RG, stages, hx_of(H, rk));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dh_lora_tf32_kernel<RG, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + 16 * RG - 1) / (16 * RG), n_slabs);
  dh_lora_tf32_kernel<RG, NT><<<grid, RG * WG * 32, smem, st>>>(
      h, w, xa, bt, labels, lse, dlse, dgold, part, xpart, R, V, H, rk,
      tiles_per_slab, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int code = launch_reduce(part, dh, (size_t)R * H, n_slabs, st);
  if (code) return code;
  return launch_reduce(xpart, dxa, (size_t)R * rk, n_slabs, st);
}

// the smallest NT of (2, 5, 6, 12, 28) that holds nt_of(HX, RG); 32-row
// tiles (512 threads, at most 128 registers a thread) up to NT 6
int dispatch(int rg, const float* h, const float* w, const float* xa,
             const float* bt, const int* labels, const float* lse,
             const float* dlse, const float* dgold, float* part, float* dh,
             float* xpart, float* dxa, int R, int V, int H, int rk,
             int n_slabs, int tiles_per_slab, int stages, cudaStream_t st) {
  const int nt = nt_of(hx_of(H, rk), rg);
#define MFT_LAUNCH(RG, NT)                                                  \
  return launch<RG, NT>(h, w, xa, bt, labels, lse, dlse, dgold, part, dh,  \
                        xpart, dxa, R, V, H, rk, n_slabs, tiles_per_slab,  \
                        stages, st)
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

extern "C" int mft_fused_ce_dh_lora_tf32(
    const void* h, const void* w, const void* xa, const void* bt,
    const int* labels, const float* lse, const float* dlse,
    const float* dgold, float* part, float* dh, float* xpart, float* dxa,
    int R, int V, int H, int rk, int row_groups, int stages, int n_slabs,
    int tiles_per_slab, int dtype, void* stream) {
  if (dtype != 0 || R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || rk <= 0 ||
      rk > MAX_RANK || stages < 1 || stages > 3 || n_slabs <= 0 ||
      tiles_per_slab <= 0 || (long long)n_slabs * tiles_per_slab * VT < V ||
      (long long)(n_slabs - 1) * tiles_per_slab * VT >= V)
    return (int)cudaErrorInvalidValue;
  return dispatch(row_groups, static_cast<const float*>(h),
                  static_cast<const float*>(w),
                  static_cast<const float*>(xa),
                  static_cast<const float*>(bt), labels, lse, dlse, dgold,
                  part, dh, xpart, dxa, R, V, H, rk, n_slabs,
                  tiles_per_slab, stages, static_cast<cudaStream_t>(stream));
}
