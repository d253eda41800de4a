// Head-adapter fused cross-entropy dbt (frozen tied head) on Hopper's
// tensor cores (sm_90a) for f32 operands, the dtype every CLI defaults
// to, in 3xTF32.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dw_kernel_lora`
// (launched by `_bwd_dw_lora`, row 11) in its dbt-only mode, the one the
// LoRA path runs (the tied embedding is frozen, so no dW), for f32
// operands:
//   dbt [V, r] f32 = coef^T @ xa,
//   logits = h W^T + xa bt^T (xa [R, r] the scale-folded bottleneck of a
//   LoRA on the tied head, bt = B^T [V, r]),
//   coef = dlse * exp(logits - lse) + dgold * onehot(label).
// In f32 the TPU kernel's `coef.astype(xa.dtype)` rounds nothing, so coef
// enters the product split into TF32 halves like every other operand.
// bf16 and f16 run fused_ce_dbt_mma.cu; fused_ce.cu's FMA kernel
// (mft_fused_ce_dw_lora with no dW), which f32 ran before, is kept as
// this kernel's earlier version, on no path, and still runs the dW + dbt
// mode of every dtype.
//
// Bound on this card, at the Gemma-3-270M training shape with a rank-8
// head adapter (R = 128, V = 262,144, H = 640, r = 8): W and bt must be
// read once and dbt written once, 688 MB, ~205 us at 3.35 TB/s; the
// logits' 2 R V (H + r) and the product's 2 R V r, 44.0 GFLOP, are 132.1
// GFLOP of TF32 in 3xTF32, ~267 us at the 495 TFLOP/s TF32 rate.
// Operations bound it.
//
// Design: fused_ce_fwd_tf32.cu's logits loop (whose note gives the layout
// and why: W the A operand, a warp owning [16 vocab, RT rows] logits over
// the whole row, h's row tile raw in shared memory, each warp's W rows in
// chunks through its own cp.async ring, the split with a raw lo) on row
// 10's widened row (fused_ce_dh_lora_tf32.cu): the rank term is one more
// contraction of the logits, so h's tile is [h | xa | 0] and each W chunk
// row [W | bt | 0] over HX = H + r8 columns (r rounded up to 8, the
// columns past r zero). Then coef and the small product in place of the
// online logsumexp, each warp on its own vocab rows, so no warp waits on
// another:
//   coef^T [16 vocab, RT rows] is formed on the logits' C fragments with
//   each row's lse, dlse, dgold and label, split into TF32 halves in
//   registers: a C fragment holds rows 2t and 2t + 1 where the A operand
//   of the next product wants k = t and t + 4, so the product takes k = t
//   as row 2t and k = t + 4 as row 2t + 1 and reads its B operand with
//   the same permutation (tensor_core_tf32.cuh, mft::pv_a).
//   dbt_tile [16 vocab, r8] = coef^T xa_tile, k = the CTA's RT rows: B is
//   xa's columns of h's tile in shared memory, split at load (rows 2t,
//   2t + 1: banks free of conflicts, as in row 7), 3 m16n8k8 mma.sync a
//   k-step and rank n-tile; each warp writes its [16, r] block of the
//   vocab tile.
//   The sum over R crosses row tiles: each CTA writes its f32 partial to a
//   workspace [row_tiles, V, r] and a reduce kernel sums the row tiles in
//   order (at the Gemma shape 2 x 8.4 MB); one row tile writes dbt
//   directly. No atomics, so two calls give identical bits.
//   The rank columns of h's tile and of W's chunks are copied 4 bytes at
//   a time (cp.async, zero-filled past r and past an edge), so r need not
//   be a multiple of 4; rank columns past r give dbt columns that are
//   never stored. A large r takes narrower row tiles
//   (ops/fused_ce.dbt_tf32_plan).
// Ragged R and V are masked (zero-filled rows of h, xa, W and bt, coef 0
// past R and V, partial rows past V not written); H must be a multiple of
// 8 (16-byte rows, whole k-steps).
//
// C interface (ctypes): mft_fused_ce_dbt_tf32 returns the CUDA error code
// of its launches. h [R, H], W [V, H], xa [R, r], bt [V, r] contiguous f32
// (dtype 0; any other code is refused), h and W 16-byte aligned; labels
// [R] int32 in [0, V); lse, dlse, dgold [R] f32; part [row_tiles, V, r]
// f32 (unused, may be null, for one row tile) and dbt [V, r] f32. The
// launch plan (row tile, chunk, stages, n_slabs, tiles_per_slab) comes
// from the wrapper (ops/fused_ce.dbt_tf32_plan).

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
using mft::split_tf32_raw_lo;

constexpr int VT = 128;         // vocab rows of a tile, 16 a warp
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_STAGES = 4;
constexpr int MAX_RANK = 128;
constexpr int SMEM_MAX = 232448;

// the widened row: H columns of h (W), then r of xa (bt), zero to a
// multiple of 8
__host__ __device__ inline int hx_of(int H, int r) {
  return H + (r + 7) / 8 * 8;
}

// Shared memory of a CTA: [h | xa] [RT][HX + 4] and [W | bt]
// [stages][VT][KC + 4], all f32.
__host__ __device__ inline size_t smem_bytes(int RT, int stages, int HX,
                                             int KC) {
  return ((size_t)RT * (HX + 4) + (size_t)stages * VT * (KC + 4)) *
         sizeof(float);
}

// x split into hi + lo halves, as the fragment registers take them
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32_raw_lo(__uint_as_float(x[i]), hi[i], lo[i]);
}

// cp.async groups left in flight: at most `n` (0..MAX_STAGES - 1)
__device__ __forceinline__ void wait_groups(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// NKS k-steps of a warp's logits [16 vocab, 8 NJ rows] over one W chunk:
// W's A fragments (ldmatrix at wa) and h's B fragments (at hb, n-tiles
// 2 p and 2 p + 1 16 p rows apart), each split here; the three products
// into two accumulators an n-tile (lo.hi + hi.lo; hi.hi), issued term by
// term, so no mma.sync waits on the one before it. The next k-step's
// fragments are loaded before this one's products: ldmatrix and mma.sync
// are volatile asm, issued in source order, so a load placed after the
// products would wait for them and leave the tensor cores idle while it
// lands.
template <int NJ, int NKS>
__device__ __forceinline__ void logits_chunk(float (&sm)[NJ][4],
                                             float (&hh)[NJ][4],
                                             const float* wa,
                                             const float* hb, int LDH) {
  uint32_t a[2][4], b[2][NJ / 2][4];
  ldmatrix_x4(a[0], wa);
#pragma unroll
  for (int p = 0; p < NJ / 2; ++p) ldmatrix_x4(b[0][p], hb + p * 16 * LDH);
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int cur = ks & 1, nxt = cur ^ 1;
    if (ks + 1 < NKS) {
      ldmatrix_x4(a[nxt], wa + (ks + 1) * 8);
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p)
        ldmatrix_x4(b[nxt][p], hb + p * 16 * LDH + (ks + 1) * 8);
    }
    uint32_t ah[4], al[4], bh[NJ / 2][4], bl[NJ / 2][4];
    split4(a[cur], ah, al);
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) split4(b[cur][p], bh[p], bl[p]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_1688_tf32(sm[j], al, bh[j / 2][2 * (j % 2)],
                    bh[j / 2][2 * (j % 2) + 1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_1688_tf32(hh[j], ah, bh[j / 2][2 * (j % 2)],
                    bh[j / 2][2 * (j % 2) + 1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_1688_tf32(sm[j], ah, bl[j / 2][2 * (j % 2)],
                    bl[j / 2][2 * (j % 2) + 1]);
  }
}

// NJ n-tiles of 8 rows: RT = 8 NJ rows a CTA; `out` is this launch's
// [row_tiles, V, rk] partials (or dbt itself for one row tile)
template <int NJ, int KC>
__global__ void __launch_bounds__(THREADS, 1)
dbt_tf32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ xa, const float* __restrict__ bt,
                const int* __restrict__ labels,
                const float* __restrict__ lse,
                const float* __restrict__ dlse,
                const float* __restrict__ dgold, float* __restrict__ out,
                int R, int V, int H, int rk, int tiles_per_slab,
                int stages) {
  constexpr int RT = 8 * NJ;
  constexpr int NI = 2 * NJ;             // rows a lane holds
  constexpr int LDW = KC + 4;            // W chunk row stride (floats)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HX = hx_of(H, rk), LDH = HX + 4;
  float* h_s = reinterpret_cast<float*>(smem_raw);    // [RT][LDH]
  float* w_s = h_s + RT * LDH;   // [WARPS][stages][16][LDW], a ring a warp

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int row0 = blockIdx.x * RT;
  const int slab = blockIdx.y;
  const int n_vt = (V + VT - 1) / VT;
  const int t0 = slab * tiles_per_slab;
  const int t_end = min(n_vt, t0 + tiles_per_slab);
  const int n_kc = (HX + KC - 1) / KC;   // chunks a vocab tile
  const int n_q = max(0, t_end - t0) * n_kc;
  float* w_w = w_s + warp * stages * 16 * LDW;   // this warp's ring

  // [h | xa | 0] of the row tile (zeros past R and past r): its own
  // group, the oldest
  const int CH = H / 4;                  // 16-byte chunks of h a row
  for (int i = tid; i < RT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4, gr = row0 + r;
    cp_async_16(h_s + r * LDH + c, h + (size_t)min(gr, R - 1) * H + c,
                gr < R);
  }
  const int RX = HX - H;                 // rank columns, r rounded up to 8
  for (int i = tid; i < RT * RX; i += THREADS) {
    const int r = i / RX, c = i % RX, gr = row0 + r;
    cp_async_4(h_s + r * LDH + H + c,
               xa + (size_t)min(gr, R - 1) * rk + min(c, rk - 1),
               gr < R && c < rk);
  }
  cp_async_commit();
  // chunk q of the slab for this warp: its 16 vocab rows of tile t0 + q /
  // n_kc, columns [k0, k0 + KC) of [W | bt | 0] (fewer in the last chunk
  // of a row: those are never read); W's columns 16 bytes at a time, bt's
  // 4
  auto stage = [&](int q, int buf) {
    const int tile = t0 + q / n_kc, k0 = (q % n_kc) * KC;
    const int nc = min(KC, HX - k0) / 4;  // 4-column groups a row
    float* dst = w_w + buf * 16 * LDW;
    for (int i = lane; i < 16 * (KC / 4); i += 32) {
      const int r = i / (KC / 4), c = i % (KC / 4);
      const int gv = tile * VT + warp * 16 + r;
      const int col = k0 + c * 4;
      const size_t vr = (size_t)min(gv, V - 1);
      if (c >= nc) continue;
      if (col < H) {
        cp_async_16(dst + r * LDW + c * 4, w + vr * H + col, gv < V);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rc = col - H + e;
          cp_async_4(dst + r * LDW + c * 4 + e,
                     bt + vr * rk + min(rc, rk - 1), gv < V && rc < rk);
        }
      }
    }
  };
  // each warp's ring of `stages` buffers of its W rows, `stages` - 1
  // chunks ahead (one group each); a single buffer is refilled in turn.
  // No warp waits on another for W: a chunk is the warp's own rows, so a
  // __syncwarp orders its copies and reads
  for (int i = 0; i < max(1, stages - 1); ++i) {
    if (i < n_q) stage(i, i);
    cp_async_commit();
  }
  wait_groups(max(1, stages - 1));   // h's group, the oldest, landed
  __syncthreads();                   // every thread's rows of h
  // this lane's rows i = 2 j + e (local row 8 j + 2 t + e): label, lse,
  // dlse, dgold (dlse = dgold = 0 past R: coef 0)
  int lab[NI];
  float ls[NI], dl[NI], dg[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = row0 + 8 * (i / 2) + 2 * t + (i % 2);
    const bool in = r < R;
    lab[i] = in ? labels[r] : -1;
    ls[i] = in ? lse[r] : 0.f;
    dl[i] = in ? dlse[r] : 0.f;
    dg[i] = in ? dgold[r] : 0.f;
  }

  // lane addresses: W's A fragment (vocab rows of the warp, row-major
  // [16][8]) and h's B fragments ([n][k]: n-tiles 2 p, 2 p + 1 of rows
  // 16 p..) by ldmatrix; xa's B fragments of the dbt product (rows 2t and
  // 2t + 1 of each 8, rank column g of each n-tile)
  const int a_off = (lr + (lm % 2) * 8) * LDW + (lm / 2) * 4;
  const int b_off = (lr + (lm / 2) * 8) * LDH + (lm % 2) * 4;
  const int x_off = 2 * t * LDH + H + g;
  const size_t plane = (size_t)blockIdx.x * V * rk;   // this row tile's
  const int n_rank = RX / 8;             // rank n-tiles

  float sm[NJ][4], hh[NJ][4];   // lo.hi + hi.lo; hi.hi
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm[j][e] = hh[j][e] = 0.f;

  for (int q = 0, tile = t0, kc = 0, buf = 0; q < n_q; ++q) {
    if (stages > 1) {
      wait_groups(stages - 2);
      __syncwarp();   // chunk q landed; buffer (q - 1) consumed
      if (q + stages - 1 < n_q)
        stage(q + stages - 1, (buf + stages - 1) % stages);
      cp_async_commit();
    } else {
      if (q > 0) {
        __syncwarp();   // the buffer is consumed before it is restaged
        stage(q, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncwarp();
    }
    const float* wa = w_w + buf * 16 * LDW + a_off;
    const int k0 = kc * KC;
    const float* hb = h_s + b_off + k0;
    const int nks = min(KC, HX - k0) / 8;
    if (nks == KC / 8) {
      logits_chunk<NJ, KC / 8>(sm, hh, wa, hb, LDH);
    } else {   // the row's last chunk, narrower
      for (int ks = 0; ks < nks; ++ks)
        logits_chunk<NJ, 1>(sm, hh, wa + ks * 8, hb + ks * 8, LDH);
    }

    if (kc == n_kc - 1) {
      // the tile's logits are whole: coef of this lane's vocab rows (by
      // the hardware exp, ex2.approx, within ~2^-21 of exp(logit - lse)
      // and cheaper than expf)
      // v0 (fragment elements e) and v0 + 8 (2 + e) and rows i = 2 j + e,
      // split, as the A fragments of the k-steps j of the dbt product:
      // a[2 e] = (vocab v0, row 8 j + 2 t + e), a[2 e + 1] = (v0 + 8, ..)
      const int v0 = tile * VT + warp * 16 + g;
      const bool ok0 = v0 < V, ok1 = v0 + 8 < V;
      uint32_t ch[NJ][4], cl[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          const float x0 = hh[j][e] + sm[j][e];
          const float x1 = hh[j][2 + e] + sm[j][2 + e];
          const float c0 =
              ok0 ? dl[i] * __expf(x0 - ls[i]) + (v0 == lab[i] ? dg[i] : 0.f)
                  : 0.f;
          const float c1 = ok1 ? dl[i] * __expf(x1 - ls[i]) +
                                     (v0 + 8 == lab[i] ? dg[i] : 0.f)
                               : 0.f;
          split_tf32_raw_lo(c0, ch[j][2 * e], cl[j][2 * e]);
          split_tf32_raw_lo(c1, ch[j][2 * e + 1], cl[j][2 * e + 1]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm[j][e] = hh[j][e] = 0.f;
      // dbt [16 vocab, 8 ranks] of each rank n-tile over the RT rows
      float* dst = out + plane + (size_t)v0 * rk + 2 * t;
      for (int n = 0; n < n_rank; ++n) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float* xr = h_s + x_off + n * 8;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32_raw_lo(xr[8 * j * LDH], b0h, b0l);
          split_tf32_raw_lo(xr[(8 * j + 1) * LDH], b1h, b1l);
          mma_3xtf32(acc, ch[j], cl[j], b0h, b1h, b0l, b1l);
        }
        // c0, c1: (vocab v0, ranks 8 n + 2t, + 1); c2, c3: vocab v0 + 8
        const int rc = n * 8 + 2 * t;
        if (ok0 && rc < rk) dst[n * 8] = acc[0];
        if (ok0 && rc + 1 < rk) dst[n * 8 + 1] = acc[1];
        if (ok1 && rc < rk) dst[8 * rk + n * 8] = acc[2];
        if (ok1 && rc + 1 < rk) dst[8 * rk + n * 8 + 1] = acc[3];
      }
      kc = 0;
      ++tile;
    } else {
      ++kc;
    }
    buf = buf + 1 == stages ? 0 : buf + 1;
  }
  cp_async_wait<0>();   // no copy left in flight at exit
}

// dbt = the row tiles' partials summed in order
__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ dbt, size_t n,
                              int row_tiles) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int k = 0; k < row_tiles; ++k) sum += part[(size_t)k * n + e];
  dbt[e] = sum;
}

template <int NJ, int KC>
int launch(const float* h, const float* w, const float* xa, const float* bt,
           const int* labels, const float* lse, const float* dlse,
           const float* dgold, float* part, float* dbt, int R, int V, int H,
           int rk, int n_slabs, int tiles_per_slab, int stages,
           cudaStream_t st) {
  const size_t smem = smem_bytes(8 * NJ, stages, hx_of(H, rk), KC);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int row_tiles = (R + 8 * NJ - 1) / (8 * NJ);
  if (row_tiles > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dbt_tf32_kernel<NJ, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(row_tiles, n_slabs);
  dbt_tf32_kernel<NJ, KC><<<grid, THREADS, smem, st>>>(
      h, w, xa, bt, labels, lse, dlse, dgold, row_tiles > 1 ? part : dbt,
      R, V, H, rk, tiles_per_slab, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess || row_tiles == 1) return (int)e;
  const size_t n = (size_t)V * rk;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dbt, n,
                                                             row_tiles);
  return (int)cudaGetLastError();
}

// the instantiation of (row tile, chunk): those of LOGITS_PLANS
// (ops/fused_ce.py) and 32 rows of 32 columns, kernel_variants.py's
// comparison for the chunk width
int dispatch(int row_tile, int chunk, const float* h, const float* w,
             const float* xa, const float* bt, const int* labels,
             const float* lse, const float* dlse, const float* dgold,
             float* part, float* dbt, int R, int V, int H, int rk,
             int n_slabs, int tiles_per_slab, int stages, cudaStream_t st) {
#define MFT_LAUNCH(NJ, KC)                                                 \
  return launch<NJ, KC>(h, w, xa, bt, labels, lse, dlse, dgold, part, dbt, \
                        R, V, H, rk, n_slabs, tiles_per_slab, stages, st)
  if (row_tile == 64 && chunk == 32) MFT_LAUNCH(8, 32);
  if (row_tile == 32 && chunk == 64) MFT_LAUNCH(4, 64);
  if (row_tile == 32 && chunk == 32) MFT_LAUNCH(4, 32);
  if (row_tile == 16 && chunk == 64) MFT_LAUNCH(2, 64);
#undef MFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mft_fused_ce_dbt_tf32(
    const void* h, const void* w, const void* xa, const void* bt,
    const int* labels, const float* lse, const float* dlse,
    const float* dgold, float* part, float* dbt, int R, int V, int H, int rk,
    int row_tile, int chunk, int stages, int n_slabs, int tiles_per_slab,
    int dtype, void* stream) {
  if (dtype != 0 || R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || rk <= 0 ||
      rk > MAX_RANK || stages < 1 || stages > MAX_STAGES || n_slabs <= 0 ||
      tiles_per_slab <= 0 || (long long)n_slabs * tiles_per_slab * VT < V ||
      (long long)(n_slabs - 1) * tiles_per_slab * VT >= V)
    return (int)cudaErrorInvalidValue;
  return dispatch(row_tile, chunk, static_cast<const float*>(h),
                  static_cast<const float*>(w),
                  static_cast<const float*>(xa),
                  static_cast<const float*>(bt), labels, lse, dlse, dgold,
                  part, dbt, R, V, H, rk, n_slabs, tiles_per_slab, stages,
                  static_cast<cudaStream_t>(stream));
}
