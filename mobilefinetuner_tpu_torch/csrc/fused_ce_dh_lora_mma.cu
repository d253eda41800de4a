// Head-adapter fused cross-entropy dh + dxa on Hopper's tensor cores
// (sm_90a), bf16 and f16.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dh_kernel_lora`
// (launched by `_bwd_dh_lora`, row 10) for 16-bit operands:
//   dh [R, H] f32 = coef @ W and dxa [R, r] f32 = coef @ bt,
//   logits = h W^T + xa bt^T (xa [R, r] the scale-folded bottleneck of a
//   LoRA on the tied head, bt = B^T [V, r]),
//   coef = dlse * exp(logits - lse) + dgold * onehot(label),
// coef rounded to W's dtype before the products, as the TPU kernel's
// `coef_s`. f32 stays on mft_fused_ce_dh_lora (fused_ce.cu).
//
// Bound on this card, at the Gemma-3-270M training shape with a rank-8
// head adapter (R = 128, V = 262,144, H = 640, r = 8, bf16): W and bt
// must be read once, 339.7 MB, ~101 us at 3.35 TB/s; the products'
// 4 R V (H + r) = 87 GFLOP need ~88 us at the bf16 tensor-core rate.
// Bytes bound it, barely.
//
// Design: row 7's (fused_ce_dh_mma.cu) with the rank-r term added, and
// each logits tile formed once for all of a CTA's dh columns. A CTA owns
// (a 16 RG-row tile, an H part of at most HP_MAX columns, a vocabulary
// slab); 2 RG warps. h's and xa's row tiles stay in shared memory for the
// slab; a W tile [32, H] and its bt tile [32, r16] ride in one cp.async
// stage of a ring of up to three.
//   Logits: warp (rg, vg) forms rows 16 rg.. x vocab columns 16 vg.. of
//   the tile, h W_tile^T over k = H, then xa bt_tile^T over k = r16 (r
//   rounded up to 16, the columns past r zero in shared memory): m16n8k16
//   mma.sync, f32 accumulate, W and bt as column-major B (ldmatrix).
//   coef: formed from the logits' C fragments, rounded to T, packed as an
//   A fragment (16 rows x 16 vocab) and written to shared memory, where
//   the row group's two warps meet: [16 RG, 32 vocab], one sync a tile.
//   dh += coef W_tile[32 vocab, columns] (coef by ldmatrix, W by
//   ldmatrix.trans, two k-steps), warp (rg, vg) owning rows 16 rg.. and
//   the vg-th half of the part's columns (at most HW_MAX: its [16, 320]
//   f32 accumulators, 160 registers a lane). Row 7 splits the vocab, not
//   the columns, between the two warps, so each H part of 320 forms the
//   logits again; here H = 640 is one part and the logits' mma.sync and
//   ldmatrix work is halved.
//   dxa += coef bt_tile[16 vocab, r16] (ldmatrix.trans), each warp from
//   its own coef fragment, formed only by the H-part-0 CTAs, so nothing
//   is counted twice. Its accumulators live in shared memory in fragment
//   order (a float4 a lane an n-tile: one 16-byte load and store each, no
//   bank conflict), so the registers do not grow with r; a large r costs
//   shared memory instead (the plan then takes fewer W buffers or row
//   groups: r 128 runs 32-row tiles with two buffers).
//   Deterministic: each warp writes its own dh block of the CTA's slab
//   partial, the two warps' dxa partials are added in a fixed order, and
//   a reduce kernel sums the slabs in order; no atomics.
//   Rank rows are copied 4 bytes at a time (cp.async, zero-filled past
//   an edge) when r is even and xa, bt are 4-byte aligned, else element
//   by element without cp.async (slower, right): r need not be a
//   multiple of 8.
// Ragged R and V are masked (zero-filled rows, coef 0 past V); H must be
// a multiple of 8 (16-byte rows); columns [H, H16) are zero in shared
// memory so the last k-step adds nothing.
//
// C interface (ctypes): mft_fused_ce_dh_lora_mma returns the CUDA error
// code of its launches. h [R, H], W [V, H], xa [R, r], bt [V, r]
// contiguous in one dtype (1 bf16, 2 f16), h and W 16-byte aligned;
// labels [R] int32 in [0, V); lse, dlse, dgold [R] f32; part
// [n_slabs, R, H], dh [R, H], xpart [n_slabs, R, r] and dxa [R, r] f32.
// The launch plan (row groups, stages, hp, n_parts, n_slabs,
// tiles_per_slab) comes from the wrapper (ops/fused_ce.dh_lora_mma_plan).

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
constexpr int VG = 2;           // warps of a row group: vocab halves of
                                // the logits, column halves of dh
constexpr int HW_MAX = 320;     // dh columns of a warp (its accumulators)
constexpr int HP_MAX = 640;     // dh columns of a CTA: VG x HW_MAX
constexpr int MAX_RANK = 128;
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int h16_of(int H) { return (H + 15) / 16 * 16; }

// Shared memory of a CTA: the dxa accumulators of its 2 RG warps (r16 / 8
// n-tiles x 32 lanes x float4 each), then h [16 RG][LD], W [stages][VT]
// [LD], xa [16 RG][LDR], bt [stages][VT][LDR] and coef [16 RG][VT + 8]
// in T.
__host__ __device__ inline size_t dxa_bytes(int RG, int r) {
  return (size_t)RG * VG * h16_of(r) * 64;
}
__host__ __device__ inline size_t smem_bytes(int RG, int stages, int H,
                                             int r, size_t elem) {
  const size_t ld = (size_t)h16_of(H) + 8, ldr = (size_t)h16_of(r) + 8;
  return dxa_bytes(RG, r) +
         ((16 * RG + stages * VT) * (ld + ldr) + 16 * RG * (VT + 8)) * elem;
}

template <typename T, int RG>
__global__ void __launch_bounds__(RG * VG * 32, 1)
dh_lora_mma_kernel(const T* __restrict__ h, const T* __restrict__ w,
                   const T* __restrict__ xa, const T* __restrict__ bt,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ dlse,
                   const float* __restrict__ dgold, float* __restrict__ part,
                   float* __restrict__ xpart, int R, int V, int H, int rk,
                   int hp, int n_parts, int tiles_per_slab, int stages) {
  constexpr int RT = 16 * RG;
  constexpr int THREADS = RG * VG * 32;
  constexpr int NH = HW_MAX / 8;          // dh n-tiles of a warp
  constexpr int LDC = VT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H16 = h16_of(H), LD = H16 + 8;
  const int R16 = h16_of(rk), LDR = R16 + 8, NX = R16 / 8;
  float4* dxa_s = reinterpret_cast<float4*>(smem_raw);
  T* h_s = reinterpret_cast<T*>(smem_raw + dxa_bytes(RG, rk));
  T* w_s = h_s + RT * LD;                 // [stages][VT][LD]
  T* xa_s = w_s + stages * VT * LD;       // [RT][LDR]
  T* bt_s = xa_s + RT * LDR;              // [stages][VT][LDR]
  T* c_s = bt_s + stages * VT * LDR;      // [RT][LDC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int rg = warp % RG, vg = warp / RG;
  const int row0 = (blockIdx.x / n_parts) * RT;
  const int c0 = (blockIdx.x % n_parts) * hp;
  const int cw = c0 + vg * (hp / 2);      // this warp's first dh column
  const int ncols = min(hp / 2, H - cw);  // may be <= 0
  const bool with_dxa = c0 == 0;
  const int slab = blockIdx.y;
  const int n_vt = (V + VT - 1) / VT;
  const int t0 = slab * tiles_per_slab;
  const int t_end = min(n_vt, t0 + tiles_per_slab);

  for (int i = tid; i < RG * VG * NX * 32; i += THREADS)
    dxa_s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
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
  // rank rows [row0, row0 + n) of src [n_src, rk] into dst [n][LDR]: in
  // 4-byte pairs by cp.async where r is even and both bases 4-byte
  // aligned, else element by element (zeros past n_src)
  const bool pairs = rk % 2 == 0 &&
                     ((reinterpret_cast<uintptr_t>(xa) |
                       reinterpret_cast<uintptr_t>(bt)) & 3) == 0;
  const int RP = pairs ? rk / 2 : rk;
  auto load_rank = [&](T* dst, const T* src, int n, int first, int n_src) {
    for (int i = tid; i < n * RP; i += THREADS) {
      const int r = i / RP, c = i % RP, gr = first + r;
      if (pairs)
        cp_async_4(dst + r * LDR + 2 * c,
                   src + (size_t)min(gr, n_src - 1) * rk + 2 * c,
                   gr < n_src);
      else
        dst[r * LDR + c] = gr < n_src ? src[(size_t)gr * rk + c]
                                      : from_f32<T>(0.f);
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
  // group each; the first also carries h and xa); a single buffer is
  // refilled in turn
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
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // lane addresses: A of the warp's rows in h_s, xa_s and c_s; W's (bt's)
  // 16 vocab rows of this warp as the logits' B (non-transposed), and
  // as dxa's B (trans); W's vocab rows kk * 16.. as dh's B (trans)
  const T* h_lane = h_s + (rg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
  const T* xa_lane =
      xa_s + (rg * 16 + lr + (lm % 2) * 8) * LDR + (lm / 2) * 8;
  const T* c_lane = c_s + (rg * 16 + lr + (lm % 2) * 8) * LDC + (lm / 2) * 8;
  const int wl_row = vg * 16 + lr + (lm / 2) * 8, wl_col = (lm % 2) * 8;
  const int wt_row = vg * 16 + lr + (lm % 2) * 8;
  const int wd_row = lr + (lm % 2) * 8;
  float4* dx_lane = dxa_s + warp * NX * 32 + lane;

  for (int tile = t0, it = 0; tile < t_end; ++tile, ++it) {
    const int buf = it % stages;
    if (stages > 1) {
      if (tile + stages - 1 < t_end)
        stage(tile + stages - 1, (it + stages - 1) % stages);
      cp_async_commit();
      if (stages == 3)
        cp_async_wait<2>();
      else
        cp_async_wait<1>();
    } else {
      if (it > 0) {
        stage(tile, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* wt = w_s + buf * VT * LD;
    const T* bts = bt_s + buf * VT * LDR;

    // logits of 16 rows x 16 vocab columns: over H, then over the rank
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const T* wl = wt + wl_row * LD + wl_col;
#pragma unroll 4
    for (int kc = 0; kc < H16; kc += 16) {
      uint32_t a[4], bw[4];
      ldmatrix_x4(a, h_lane + kc);
      ldmatrix_x4(bw, wl + kc);
      mma_16816<T>(s[0], a, bw[0], bw[1]);
      mma_16816<T>(s[1], a, bw[2], bw[3]);
    }
    const T* bl = bts + wl_row * LDR + wl_col;
#pragma unroll 1
    for (int kc = 0; kc < R16; kc += 16) {
      uint32_t a[4], bb[4];
      ldmatrix_x4(a, xa_lane + kc);
      ldmatrix_x4(bb, bl + kc);
      mma_16816<T>(s[0], a, bb[0], bb[1]);
      mma_16816<T>(s[1], a, bb[2], bb[3]);
    }

    // coef, rounded to T, packed as the A fragment of dxa's k-step and
    // shared through c_s for dh's, whose k runs over the whole tile
    const int v0 = tile * VT + vg * 16;
    uint32_t cf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1, rr = i & 1;   // n-tile, row g or g + 8
      float c[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + j * 8 + 2 * t + e;
        const float x = s[j][rr * 2 + e];
        c[e] = (rin[rr] && v < V)
                   ? dl[rr] * expf(x - ls[rr]) + (v == lab[rr] ? dg[rr] : 0.f)
                   : 0.f;
      }
      cf[i] = pack2<T>(c[0], c[1]);
      *reinterpret_cast<uint32_t*>(
          c_s + (rg * 16 + g + 8 * rr) * LDC + vg * 16 + j * 8 + 2 * t) =
          cf[i];
    }

    // dxa[16, r16] += coef [16, 16] . bt_tile[16 vocab, r16], the
    // accumulators read from and written back to shared memory
    if (with_dxa) {
      const T* btr = bts + wt_row * LDR + (lm / 2) * 8;
#pragma unroll 1
      for (int n = 0; n < NX; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, btr + n * 8);
        const float4 x0 = dx_lane[n * 32], x1 = dx_lane[(n + 1) * 32];
        float d0[4] = {x0.x, x0.y, x0.z, x0.w};
        float d1[4] = {x1.x, x1.y, x1.z, x1.w};
        mma_16816<T>(d0, cf, bb[0], bb[1]);
        mma_16816<T>(d1, cf, bb[2], bb[3]);
        dx_lane[n * 32] = make_float4(d0[0], d0[1], d0[2], d0[3]);
        dx_lane[(n + 1) * 32] = make_float4(d1[0], d1[1], d1[2], d1[3]);
      }
    }

    __syncthreads();   // both vocab halves of coef are in c_s

    // dh[16, warp's columns] += coef [16, 32] . W_tile[32 vocab, columns]
    // Straight-line code, so the loads are issued ahead of the products:
    // column pairs past the warp's read column 0 instead, and their sums
    // are never stored.
#pragma unroll 1
    for (int kk = 0; kk < VT; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, c_lane + kk);
      const T* wtr = wt + (kk + wd_row) * LD + (lm / 2) * 8;
#pragma unroll
      for (int n = 0; n < NH; n += 2) {
        uint32_t bw[4];
        ldmatrix_x4_trans(bw, wtr + (n * 8 < ncols ? cw + n * 8 : 0));
        mma_16816<T>(acc[n], a, bw[0], bw[1]);
        mma_16816<T>(acc[n + 1], a, bw[2], bw[3]);
      }
    }
    __syncthreads();   // this buffer and c_s are consumed before reuse
  }

  cp_async_wait<0>();   // (an empty slab leaves h's copy in flight)
  __syncthreads();
  // each warp owns its [16, columns] block of the slab's partial
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rin[i]) continue;
    float* dst = part + ((size_t)slab * R + row0 + rg * 16 + g + 8 * i) * H +
                 cw;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < ncols)
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
  if (vg == 0) {
    // dxa: this warp's accumulators plus its vg = 1 partner's, in order
    if (with_dxa) {
      const float4* other = dxa_s + (RG + rg) * NX * 32 + lane;
      for (int n = 0; n < NX; ++n) {
        const float4 a = dx_lane[n * 32], b = other[n * 32];
        const float v[4] = {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = n * 8 + 2 * t + (e & 1);
          if (rin[i] && col < rk)
            xpart[((size_t)slab * R + row0 + rg * 16 + g + 8 * i) * rk +
                  col] = v[e];
        }
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

template <typename T, int RG>
int launch(const void* h, const void* w, const void* xa, const void* bt,
           const int* labels, const float* lse, const float* dlse,
           const float* dgold, float* part, float* dh, float* xpart,
           float* dxa, int R, int V, int H, int rk, int hp, int n_parts,
           int n_slabs, int tiles_per_slab, int stages, cudaStream_t st) {
  const size_t smem = smem_bytes(RG, stages, H, rk, sizeof(T));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dh_lora_mma_kernel<T, RG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (R + 16 * RG - 1) / (16 * RG);
  dim3 grid(row_tiles * n_parts, n_slabs);
  dh_lora_mma_kernel<T, RG><<<grid, RG * VG * 32, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(xa), static_cast<const T*>(bt), labels, lse,
      dlse, dgold, part, xpart, R, V, H, rk, hp, n_parts, tiles_per_slab,
      stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int code = launch_reduce(part, dh, (size_t)R * H, n_slabs, st);
  if (code) return code;
  return launch_reduce(xpart, dxa, (size_t)R * rk, n_slabs, st);
}

template <typename T>
int dispatch_rg(int rg, const void* h, const void* w, const void* xa,
                const void* bt, const int* labels, const float* lse,
                const float* dlse, const float* dgold, float* part,
                float* dh, float* xpart, float* dxa, int R, int V, int H,
                int rk, int hp, int n_parts, int n_slabs, int tiles_per_slab,
                int stages, cudaStream_t st) {
  switch (rg) {
    case 4:
      return launch<T, 4>(h, w, xa, bt, labels, lse, dlse, dgold, part, dh,
                          xpart, dxa, R, V, H, rk, hp, n_parts, n_slabs,
                          tiles_per_slab, stages, st);
    case 2:
      return launch<T, 2>(h, w, xa, bt, labels, lse, dlse, dgold, part, dh,
                          xpart, dxa, R, V, H, rk, hp, n_parts, n_slabs,
                          tiles_per_slab, stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_fused_ce_dh_lora_mma(
    const void* h, const void* w, const void* xa, const void* bt,
    const int* labels, const float* lse, const float* dlse,
    const float* dgold, float* part, float* dh, float* xpart, float* dxa,
    int R, int V, int H, int rk, int row_groups, int stages, int hp,
    int n_parts, int n_slabs, int tiles_per_slab, int dtype, void* stream) {
  if (R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || rk <= 0 ||
      rk > MAX_RANK || hp <= 0 || hp % 32 != 0 || hp > HP_MAX ||
      n_parts <= 0 || (long long)hp * n_parts < H ||
      (long long)hp * (n_parts - 1) >= H || stages < 1 || stages > 3 ||
      n_slabs <= 0 || tiles_per_slab <= 0 ||
      (long long)n_slabs * tiles_per_slab * VT < V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_rg<__nv_bfloat16>(
          row_groups, h, w, xa, bt, labels, lse, dlse, dgold, part, dh,
          xpart, dxa, R, V, H, rk, hp, n_parts, n_slabs, tiles_per_slab,
          stages, st);
    case 2:
      return dispatch_rg<__half>(row_groups, h, w, xa, bt, labels, lse, dlse,
                                 dgold, part, dh, xpart, dxa, R, V, H, rk,
                                 hp, n_parts, n_slabs, tiles_per_slab,
                                 stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
