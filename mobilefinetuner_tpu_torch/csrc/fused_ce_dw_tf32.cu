// Fused cross-entropy dW on Hopper's tensor cores (sm_90a) for f32 h and
// W, the dtype every CLI defaults to, in 3xTF32.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dw_kernel` (launched by
// `_bwd_dw`, row 8) for f32 operands:
//   dW [V, H] f32 = coef^T @ h,
//   coef = dlse * exp(h W^T - lse) + dgold * onehot(label).
// In f32 the TPU kernel's `coef.astype(h.dtype)` rounds nothing, so coef
// enters the product split into TF32 halves like every other operand.
// bf16 and f16 run fused_ce_dw_mma.cu; fused_ce.cu's FMA kernel
// (mft_fused_ce_dw), which f32 ran before, is kept as this kernel's
// earlier version, on no path.
//
// Bound on this card, at the Gemma-3-270M training shape (R = 128 rows of
// a loss chunk, V = 262,144, H = 640): W must be read once and dW written
// once, 1.34 GB, ~401 us at 3.35 TB/s; the two products' 4 R V H = 85.9
// GFLOP are 257.7 GFLOP of TF32 in 3xTF32, ~521 us at the 495 TFLOP/s
// TF32 rate. Operations bound it, the bytes close behind.
//
// Design. dW's product sums over the R rows, so the CTA that forms a
// vocab tile's coef for all R rows owns whole dW rows and nothing is
// reduced in device memory. In f32, h at the path's shape [128, 640]
// (327,680 bytes) does not fit the 232,448 bytes of shared memory a block
// may use, so h is cut by columns over a thread-block cluster:
//   A cluster of P CTAs (P = 2 at H 640; 1, 2, 4 or 8: the fewest that
//   keep a part at most HP_MAX = 320 columns) walks the vocab tiles of
//   VT = 64 rows with a grid stride; CTA `part` of the cluster holds
//   h[:, part hp .. +hp] for all R rows raw in shared memory for its life
//   (165,888 bytes at the path's shape), streams W's rows of the tile,
//   columns of its part only, in chunks of KC = 32 columns through a ring
//   of three cp.async stages, and forms the partial logits of the
//   tile [64 vocab, R] over its own columns. The partials meet through
//   distributed shared memory: each CTA writes its partial (C fragments,
//   a float4 a lane an n-tile) to its own x_s, a cluster barrier, then
//   every CTA reads all P partials and adds them in part order 0..P-1, so
//   every CTA of the cluster holds the same full logits, bit for bit.
//   Each CTA then forms coef [64, R] and dW [64 vocab, its hp columns] =
//   coef^T h[:, its columns], k = R, all local. W is read once from
//   device memory and once into shared memory; the exchange is [64, R]
//   floats a tile a CTA, a fifth of dW's own columns.
//   Warps: 8 = VG vocab groups x RS row splits (4 x 2). Warp (vg, rs)
//   forms the logits of vocab rows 16 vg.. and rows rs R/2..: W's A
//   fragments and h's B fragments by ldmatrix (a [n][k] f32 tile is the B
//   fragment), the three m16n8k8 TF32 mma.sync of a k-step into two
//   accumulators an n-tile (lo.hi + hi.lo; hi.hi), term by term, the next
//   k-step's fragments loaded first (fused_ce_dbt_tf32.cu's logits loop,
//   every operand split into hi + lo: tensor_core_tf32.cuh). coef is
//   formed on the C fragments (row data from shared memory) and written
//   back to x_s as the dW product's A fragments (a C fragment holds rows
//   2t and 2t + 1 where the A operand wants k = t and t + 4: k = t is
//   taken as row 2t, k = t + 4 as row 2t + 1, and h's B operand is read
//   with the same permutation; tensor_core_tf32.cuh). Warp (vg, rs) then
//   owns dW's vocab rows 16 vg.. and columns rs hp/2..: NT = 20 n-tiles
//   of 8 columns (all its own at the path's shape; in a narrower part the
//   rest read column 0's and are never stored), f32 accumulators in
//   registers, over every k-step of R; h's B fragments are two 32-bit loads (rows 2t and
//   2t + 1, banks 8t + g: no conflict), split once for their three
//   products, which are issued term by term over groups of NG n-tiles.
//   Stores: two lanes of a quad swap halves (one shuffle) so each lane
//   writes 16 bytes; streaming (`st.global.cs`), so the 671 MB of output
//   does not evict W from L2. Each dW element is written once, with no
//   atomics: two calls give identical bits.
//   Why not the 16-bit kernel's layout (h held whole for the CTA's life,
//   fused_ce_dw_mma.cu): in f32 it does not fit. Why not wgmma: TF32
//   wgmma takes K-major operands only, and dW's B operand, h with k = R,
//   would need a second, transposed copy of h that does not fit either.
//   The layout chosen against the other that fits, timed in turns by
//   `kernel_variants.py --f32_ce_plans` at the Gemma chunk on an H100
//   80GB HBM3 at 700 W: this one 1,903.55 / 1,904.55 us, against
//   3,247.66 / 3,270.30 for one CTA, VG = 2 (32 vocab rows a tile, 4 row
//   splits), h's 640
//   columns in two 64-row chunks reloaded from L2 for every tile (2.7 GB
//   of L2 reads in all) and the dW accumulators kept in registers across
//   the chunks (vocab_groups 2, row chunk 64, one part), which stays
//   instantiated for that comparison.
//   Other R: up to 64 rows are held as one 64-row chunk; more than 128
//   rows take 64-row chunks, each reloaded from L2 for every tile
//   (synchronously), with the dW accumulators in registers across the
//   chunks and the logits exchanged a chunk; right, not fast (batch 8
//   takes it; the path does not).
// Ragged R and V are masked (zero-filled rows of h and W, coef 0 past R
// and V, dW rows past V not written); H must be a multiple of 8 (16-byte
// rows, whole k-steps); the columns of the last part past H are zero in
// shared memory, their dW never stored.
//
// C interface (ctypes): mft_fused_ce_dw_tf32 returns the CUDA error code
// of its launch. h [R, H] and W [V, H] contiguous f32 (dtype 0; any other
// code is refused), 16-byte aligned; labels [R] int32 in [0, V); lse,
// dlse, dgold [R] f32; dW [V, H] f32. The launch plan (vocab groups, row
// chunk, hp, n_parts, clusters) comes from the wrapper
// (ops/fused_ce.dw_tf32_plan); the clusters are cut to those the card
// can hold at once (cudaOccupancyMaxActiveClusters), so the grid is one
// wave whatever the multiprocessors of a GPC.

#include <cooperative_groups.h>

#include "tensor_core.cuh"
#include "tensor_core_tf32.cuh"

namespace {

namespace cg = cooperative_groups;

using mft::cp_async_16;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::ldmatrix_x4;
using mft::mma_1688_tf32;
using mft::split_tf32_raw_lo;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;          // columns of a W chunk
constexpr int LDW = KC + 4;     // its row stride (floats)
constexpr int STAGES = 3;       // W chunks in the ring
constexpr int NG = 5;           // dW n-tiles issued term by term together
constexpr int HP_MAX = 320;     // columns of a part: 2 x 20 n-tiles
constexpr int NT = HP_MAX / 16;   // dW n-tiles of a warp (8 columns each)
constexpr int ROWS_WHOLE = 128;   // rows of h a CTA holds for its life
constexpr int MAX_PARTS = 8;    // CTAs of a cluster (the portable most)
constexpr int SMEM_MAX = 232448;

// Shared memory of a CTA: h's part [RC][hp + 4], the exchange / coef
// buffer [16 VG][RC], the rows' (lse, dlse, dgold, label) [RC] and the W
// ring [STAGES][16 VG][LDW], all 4-byte words.
__host__ __device__ inline size_t smem_bytes(int VG, int RC, int hp) {
  return ((size_t)RC * (hp + 4) + (size_t)16 * VG * RC + (size_t)RC * 4 +
          (size_t)STAGES * 16 * VG * LDW) *
         sizeof(float);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x split into hi + lo halves, as the fragment registers take them
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32_raw_lo(__uint_as_float(x[i]), hi[i], lo[i]);
}

// NKS k-steps of a warp's logits [16 vocab, 8 NJ rows] over one W chunk
// (fused_ce_dbt_tf32.cu's logits_chunk): W's A fragments (ldmatrix at
// wa) and h's B fragments (at hb, n-tiles 2 p and 2 p + 1 16 p rows
// apart), each split here; the three products into two accumulators an
// n-tile (lo.hi + hi.lo; hi.hi), issued term by term, so no mma.sync
// waits on the one before it; the next k-step's fragments loaded before
// this one's products (ldmatrix and mma.sync are volatile asm, issued in
// source order).
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

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// acc [NT n-tiles of 8 columns] += coef^T h over KS k-steps of 8 rows: the
// A fragment of k-step s at ca[32 s] (a float4 a lane: (c0, c2, c1, c3)),
// split here once for the n-tiles; h's B fragments at hd (rows 2t, 2t + 1
// of the k-step, column g of each n-tile; n-tiles past n_own read column
// 0's and are never stored), split once for their three products, which
// are issued term by term over NG n-tiles (al.bh, ah.bl, ah.bh, as
// mma_3xtf32 orders them), so no mma.sync waits on the one before it
template <int KS>
__device__ __forceinline__ void dw_product(float (&acc)[NT][4],
                                           const float4* ca, const float* hd,
                                           int LDH, int n_own) {
#pragma unroll 1
  for (int s = 0; s < KS; ++s) {
    const float4 a = ca[s * 32];
    uint32_t ah[4], al[4];
    split_tf32_raw_lo(a.x, ah[0], al[0]);
    split_tf32_raw_lo(a.y, ah[1], al[1]);
    split_tf32_raw_lo(a.z, ah[2], al[2]);
    split_tf32_raw_lo(a.w, ah[3], al[3]);
    const float* hr = hd + s * 8 * LDH;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int o = n0 + i < n_own ? (n0 + i) * 8 : 0;
        split_tf32_raw_lo(hr[o], bh[i][0], bl[i][0]);
        split_tf32_raw_lo(hr[LDH + o], bh[i][1], bl[i][1]);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma_1688_tf32(acc[n0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma_1688_tf32(acc[n0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma_1688_tf32(acc[n0 + i], ah, bh[i][0], bh[i][1]);
    }
  }
}

// acc (vocab rows v0, v0 + 8 of the lane; n-tiles of 8 columns from dst)
// to dW by 16-byte streaming stores: in each quad, even lanes take columns
// 2t..2t+3 of n-tile n, odd lanes 2t-2..2t+1 of n-tile n + 1 (one shuffle
// swaps the halves); rows past V and n-tiles past n_own are not written
__device__ __forceinline__ void store_dw(const float (&acc)[NT][4],
                                         float* dst, int v0, int V, int H,
                                         int n_own, int t) {
  const bool odd = t & 1;
#pragma unroll
  for (int n = 0; n < NT; n += 2)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float a0 = acc[n][2 * hi], a1 = acc[n][2 * hi + 1];
      const float b0 = acc[n + 1][2 * hi], b1 = acc[n + 1][2 * hi + 1];
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      const float4 out = odd ? make_float4(x0, x1, b0, b1)
                             : make_float4(a0, a1, x0, x1);
      const int nn = odd ? n + 1 : n;
      if (v0 + 8 * hi < V && nn < n_own)
        __stcs(reinterpret_cast<float4*>(dst + (size_t)(8 * hi) * H +
                                         nn * 8 + 2 * (t & 2)),
               out);
    }
}

// VG vocab groups of 16 rows x RS = 8 / VG row splits; NJ n-tiles of 8
// rows a warp's logits, so RC = 8 RS NJ rows of h a CTA: ROWS_WHOLE, held
// for the CTA's life (R <= RC), or fewer, h then in chunks of RC rows
// (CHUNKED), reloaded for every tile when there is more than one.
template <int VG, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
dw_tf32_kernel(const float* __restrict__ h, const float* __restrict__ w,
               const int* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ dlse,
               const float* __restrict__ dgold, float* __restrict__ dw,
               int R, int V, int H, int hp) {
  constexpr int RS = WARPS / VG;
  constexpr int VT = 16 * VG;            // vocab rows of a tile
  constexpr int RC = 8 * RS * NJ;        // rows of h a CTA holds
  constexpr int KS = RS * NJ;            // k-steps of the dW product
  constexpr bool CHUNKED = RC < ROWS_WHOLE;
  static_assert(NT % NG == 0 && NT % 2 == 0, "whole n-tile groups");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDH = hp + 4;
  float* h_s = reinterpret_cast<float*>(smem_raw);           // [RC][LDH]
  float4* x_s = reinterpret_cast<float4*>(h_s + RC * LDH);   // [RC VT / 4]
  float4* row_s = x_s + WARPS * NJ * 32;                     // [RC]
  float* w_s = reinterpret_cast<float*>(row_s + RC);  // [STAGES][VT][LDW]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int vg = warp % VG, rs = warp / VG;
  const int P = gridDim.x, part = blockIdx.x;
  const int col0 = part * hp, hpe = min(hp, H - col0);  // the part's columns
  const int n_vt = (V + VT - 1) / VT;
  const int n_tiles = (n_vt - 1 - (int)blockIdx.y) / (int)gridDim.y + 1;
  const int n_chunks = CHUNKED ? (R + RC - 1) / RC : 1;
  const int n_kc = (hpe + KC - 1) / KC;  // W chunks a tile
  const int n_q = n_tiles * n_chunks * n_kc;

  // columns [hpe, hp) of h's part are zero (cp.async never writes them):
  // the dW n-tiles there add nothing and are never stored
  if (hpe < hp) {
    const int tail = hp - hpe;
    for (int i = tid; i < RC * tail; i += THREADS)
      h_s[(i / tail) * LDH + hpe + i % tail] = 0.f;
  }
  const int CH = hpe / 4;                // 16-byte pieces of a row's part
  // rows [ch RC, +RC) of h's part (zeros past R) and their row data
  // (lse, dlse, dgold, label; dlse = dgold = 0, label -1 past R: coef 0)
  auto load_rows = [&](int ch) {
    const int r0 = ch * RC;
    for (int i = tid; i < RC * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4, gr = r0 + r;
      cp_async_16(h_s + r * LDH + c,
                  h + (size_t)min(gr, R - 1) * H + col0 + c, gr < R);
    }
    for (int r = tid; r < RC; r += THREADS) {
      const int gr = r0 + r;
      row_s[r] = gr < R ? make_float4(lse[gr], dlse[gr], dgold[gr],
                                      __int_as_float(labels[gr]))
                        : make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
    }
  };
  // chunk q of this CTA's sequence (tiles, then row chunks, then W
  // chunks): the tile's VT rows of W, columns [kc KC, +KC) of the part
  // (fewer in the last chunk of a part: those are never read)
  auto stage = [&](int q, int buf) {
    const int qi = q / n_kc, kc = q - qi * n_kc;
    const int tile = blockIdx.y + (qi / n_chunks) * gridDim.y;
    const int k0 = kc * KC, nc = min(KC, hpe - k0) / 4;
    float* dst = w_s + buf * VT * LDW;
    for (int i = tid; i < VT * (KC / 4); i += THREADS) {
      const int r = i / (KC / 4), c = i % (KC / 4);
      const int gv = tile * VT + r;
      if (c < nc)
        cp_async_16(dst + r * LDW + c * 4,
                    w + (size_t)min(gv, V - 1) * H + col0 + k0 + c * 4,
                    gv < V);
    }
  };
  // h's first chunk its own group, the oldest; then a ring of STAGES W
  // buffers, STAGES - 1 chunks ahead, one group each
  load_rows(0);
  cp_async_commit();
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_q) stage(i, i);
    cp_async_commit();
  }

  // lane addresses: W's A fragment (vocab rows of the group, row-major
  // [16][8]) and h's B fragments of the logits ([n][k]: n-tiles 2 p, 2 p
  // + 1 of the split's rows 16 p..) by ldmatrix; h's B fragments of the
  // dW product (rows 2t and 2t + 1 of each k-step, column g of each
  // n-tile of the warp's columns; a warp with no column in the part reads
  // column 0's, never stored)
  const int a_off = (vg * 16 + lr + (lm % 2) * 8) * LDW + (lm / 2) * 4;
  const int b_off = (rs * (RC / RS) + lr + (lm / 2) * 8) * LDH + (lm % 2) * 4;
  const int hpw = hp / RS;               // dW columns a warp
  const int wc0 = rs * hpw;
  const int n_own = max(0, min(hpw, hpe - wc0)) / 8;
  const int bd_off = 2 * t * LDH + (n_own > 0 ? wc0 : 0) + g;

  float sm[NJ][4], hh[NJ][4];   // the logits: lo.hi + hi.lo; hi.hi
  zero(sm);
  zero(hh);
  float acc[CHUNKED ? NT : 1][4];   // dW across row chunks
  zero(acc);

  for (int q = 0, kc = 0, ch = 0, ti = 0, buf = 0; q < n_q; ++q) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk q landed; buffer (q - 1) consumed
    if (q + STAGES - 1 < n_q)
      stage(q + STAGES - 1, (buf + STAGES - 1) % STAGES);
    cp_async_commit();
    {
      const float* wa = w_s + buf * VT * LDW + a_off;
      const int k0 = kc * KC;
      const float* hb = h_s + b_off + k0;
      const int nks = min(KC, hpe - k0) / 8;
      if (nks == KC / 8) {
        logits_chunk<NJ, KC / 8>(sm, hh, wa, hb, LDH);
      } else {   // the part's last chunk, narrower
        for (int ks = 0; ks < nks; ++ks)
          logits_chunk<NJ, 1>(sm, hh, wa + ks * 8, hb + ks * 8, LDH);
      }
    }
    buf = buf + 1 == STAGES ? 0 : buf + 1;
    if (++kc < n_kc) continue;
    kc = 0;

    // the (tile, row chunk)'s logits over this part's columns are whole:
    // the full logits, every part's partial added in part order
    float x[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[j][e] = hh[j][e] + sm[j][e];
        sm[j][e] = hh[j][e] = 0.f;
      }
    if (P > 1) {
      float4* mine = x_s + warp * NJ * 32 + lane;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mine[j * 32] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      cluster_arrive();
      cluster_wait();   // every part's partial is in its x_s
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
      for (int p = 0; p < P; ++p) {
        const float4* src = cluster.map_shared_rank(mine, p);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 v = src[j * 32];
          x[j][0] += v.x;
          x[j][1] += v.y;
          x[j][2] += v.z;
          x[j][3] += v.w;
        }
      }
      cluster_arrive();   // done reading the parts' x_s
    }

    // coef of this lane's vocab rows v0 (elements 0, 1) and v0 + 8 (2, 3)
    // and rows 8 j + 2 t + e of the warp's split, as the A fragment of
    // the dW product's k-step (rs NJ + j): (c0, c2, c1, c3)
    const int tile = blockIdx.y + ti * gridDim.y;
    const int v0 = tile * VT + vg * 16 + g;
    float4 cf[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float c[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 rw = row_s[rs * (RC / RS) + 8 * j + 2 * t + e];
        const int lab = __float_as_int(rw.w);
        c[e] = v0 < V ? rw.y * __expf(x[j][e] - rw.x) +
                            (v0 == lab ? rw.z : 0.f)
                      : 0.f;
        c[2 + e] = v0 + 8 < V ? rw.y * __expf(x[j][2 + e] - rw.x) +
                                    (v0 + 8 == lab ? rw.z : 0.f)
                              : 0.f;
      }
      cf[j] = make_float4(c[0], c[2], c[1], c[3]);
    }
    if (P > 1) cluster_wait();   // every part has read this CTA's x_s
    {
      float4* ca = x_s + (vg * KS + rs * NJ) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NJ; ++j) ca[j * 32] = cf[j];
    }
    __syncthreads();   // the group's coef is in x_s

    // dW [16 vocab, the warp's columns] += coef^T [16, RC] h [RC,
    // columns], stored after the last row chunk (the accumulators live
    // across the logits only when h comes in chunks)
    const float4* ca = x_s + vg * KS * 32 + lane;
    const float* hd = h_s + bd_off;
    float* dst = dw + (size_t)v0 * H + col0 + wc0;
    const bool last_chunk = ch + 1 == n_chunks;
    if constexpr (CHUNKED) {
      dw_product<KS>(acc, ca, hd, LDH, n_own);
      if (last_chunk) {
        store_dw(acc, dst, v0, V, H, n_own, t);
        zero(acc);
      }
    } else {
      float part_acc[NT][4];
      zero(part_acc);
      dw_product<KS>(part_acc, ca, hd, LDH, n_own);
      store_dw(part_acc, dst, v0, V, H, n_own, t);
    }
    if (last_chunk) ++ti;
    ch = last_chunk ? 0 : ch + 1;
    if (CHUNKED && n_chunks > 1 && q + 1 < n_q) {
      __syncthreads();   // every warp is done with h's chunk and row data
      load_rows(ch);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  cp_async_wait<0>();   // no copy left in flight at exit
}

template <int VG, int NJ>
int launch(const float* h, const float* w, const int* labels,
           const float* lse, const float* dlse, const float* dgold,
           float* dw, int R, int V, int H, int hp, int n_parts,
           int n_clusters, cudaStream_t st) {
  constexpr int RC = 8 * (WARPS / VG) * NJ;
  n_clusters = min(n_clusters, (V + 16 * VG - 1) / (16 * VG));  // a tile each
  const size_t smem = smem_bytes(VG, RC, hp);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = dw_tf32_kernel<VG, NJ>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_parts, n_clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;   // clusters the card holds at once
  e = cudaOccupancyMaxActiveClusters(&active, (void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active <= 0) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(n_parts, min(n_clusters, active));
  e = cudaLaunchKernelEx(&cfg, kernel, h, w, labels, lse, dlse, dgold, dw,
                         R, V, H, hp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// (vocab groups, row chunk) -> an instantiation: 4 vocab groups holding
// 128 rows whole (64 < R <= 128) or 64-row chunks (any other R); 2 vocab
// groups in 64-row chunks, the layout of one CTA whose h chunks are
// reloaded from L2 (kernel_variants.py's comparison)
int dispatch(int vg, int rc, const float* h, const float* w,
             const int* labels, const float* lse, const float* dlse,
             const float* dgold, float* dw, int R, int V, int H, int hp,
             int n_parts, int n_clusters, cudaStream_t st) {
#define MFT_LAUNCH(VG, NJ)                                                  \
  return launch<VG, NJ>(h, w, labels, lse, dlse, dgold, dw, R, V, H, hp,   \
                        n_parts, n_clusters, st)
  if (vg == 4 && rc == ROWS_WHOLE && R <= ROWS_WHOLE) MFT_LAUNCH(4, 8);
  if (vg == 4 && rc == 64) MFT_LAUNCH(4, 4);
  if (vg == 2 && rc == 64) MFT_LAUNCH(2, 2);
#undef MFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mft_fused_ce_dw_tf32(const void* h, const void* w,
                                    const int* labels, const float* lse,
                                    const float* dlse, const float* dgold,
                                    float* dw, int R, int V, int H,
                                    int vocab_groups, int row_chunk, int hp,
                                    int n_parts, int n_clusters, int dtype,
                                    void* stream) {
  if (dtype != 0 || R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 ||
      (vocab_groups != 2 && vocab_groups != 4) || hp <= 0 ||
      hp % (8 * (WARPS / vocab_groups)) != 0 ||
      hp > HP_MAX * (4 / vocab_groups) || n_parts < 1 ||
      n_parts > MAX_PARTS || (long long)hp * n_parts < H ||
      (long long)hp * (n_parts - 1) >= H || n_clusters <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(vocab_groups, row_chunk, static_cast<const float*>(h),
                  static_cast<const float*>(w), labels, lse, dlse, dgold,
                  dw, R, V, H, hp, n_parts, n_clusters,
                  static_cast<cudaStream_t>(stream));
}
