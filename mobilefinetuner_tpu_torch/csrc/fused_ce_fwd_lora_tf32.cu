// Head-adapter fused cross-entropy forward on Hopper's tensor cores
// (sm_90a) for f32 operands, the dtype every CLI defaults to, in 3xTF32.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_fwd_kernel_lora`
// (launched by `_fwd_lora`, row 9) for f32 operands:
//   lse [R] f32  = logsumexp over V of logits = h W^T + xa bt^T,
//   gold [R] f32 = the logit at the row's label,
// xa [R, r] the scale-folded bottleneck of a LoRA on the tied head and
// bt = B^T [V, r]; neither the logits nor the [R, V] delta is written to
// device memory. bf16 and f16 run fused_ce_fwd_lora_mma.cu; fused_ce.cu's
// FMA kernel (mft_fused_ce_fwd_lora), which f32 ran before, is kept as
// this kernel's earlier version, on no path.
//
// Bound on this card, at the Gemma-3-270M training shape with a rank-8
// head adapter (R = 128 rows of a loss chunk, V = 262,144, H = 640, r =
// 8): W and bt must be read once, 680 MB, ~203 us at 3.35 TB/s; the
// logits' 2 R V (H + r) = 43.5 GFLOP are 130.4 GFLOP of TF32 in 3xTF32,
// ~264 us at the 495 TFLOP/s TF32 rate. Operations bound it (the f32 FMA
// units would need ~650 us for the logits alone).
//
// Design: every product an m16n8k8 TF32 mma.sync on operands split into
// hi + lo halves, three products a k-step (lo.hi + hi.lo into one
// accumulator, hi.hi into another; tensor_core_tf32.cuh), since one TF32
// product would move a logit by ~2^-11 of its terms. The loop is
// fused_ce_fwd_tf32.cu's (row 6; its note gives the layout
// and why: W the A operand, so a warp owns a [16 vocab, RT rows] logits
// block over the whole row in registers and runs the online max / sum-exp
// / gold on its C fragments; h's row tile raw in shared memory, split at
// fragment load with a raw lo; each warp's own W rows in chunks through
// its own cp.async ring, ordered by __syncwarp; per-(slab, row) partials
// merged in slab order) on row 11's widened row (fused_ce_dbt_tf32.cu):
// the rank term is one more contraction of the logits, so h's tile is
// [h | xa | 0] and each W chunk row [W | bt | 0] over HX = H + r8 columns
// (r rounded up to 8, the columns past r zero-filled). The adapter then
// costs r8 / H more k-steps of the same loop and nothing else: at r 8,
// HX = 648 is 20 whole 32-column chunks and one of 8 columns (a single
// k-step, the loop's narrower last chunk).
//   The rank columns of h's tile and of W's chunks are copied 4 bytes at
// a time (cp.async, zero-filled past r and past an edge), so r need not
// be a multiple of 4. A large r takes narrower row tiles
// (ops/fused_ce.fwd_lora_tf32_plan).
//   Deterministic: each CTA writes a (m, s, gold) partial per (slab, row)
// and a merge kernel folds the slabs in order; no atomics, so two calls
// give identical bits.
// Ragged R and V are masked (rows past R zero-filled and not written,
// vocab rows past V zero-filled and left out of the max, the sum and
// gold); H must be a multiple of 8 (16-byte rows, whole k-steps).
//
// C interface (ctypes): mft_fused_ce_fwd_lora_tf32 returns the CUDA error
// code of its launches. h [R, H], W [V, H], xa [R, r], bt [V, r]
// contiguous f32 (dtype 0; any other code is refused), h and W 16-byte
// aligned; labels [R] int32 in [0, V); part [n_slabs, R, 3], lse and gold
// [R] f32. The launch plan (row tile, chunk, stages, n_slabs,
// tiles_per_slab) comes from the wrapper (ops/fused_ce.fwd_lora_tf32_plan).

#include "tensor_core.cuh"
#include "tensor_core_tf32.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_4;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::ldmatrix_x4;
using mft::mma_1688_tf32;
using mft::split_tf32_raw_lo;

constexpr int VT = 128;         // vocab rows of a tile, 16 a warp
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_STAGES = 4;
constexpr int MAX_RANK = 128;
constexpr int SMEM_MAX = 232448;
constexpr float NEG_BIG = -1e30f;   // the running max before any column

// the widened row: H columns of h (W), then r of xa (bt), zero to a
// multiple of 8
__host__ __device__ inline int hx_of(int H, int r) {
  return H + (r + 7) / 8 * 8;
}

// Shared memory of a CTA: [h | xa] [RT][HX + 4] and [W | bt]
// [stages][VT][KC + 4], all f32 (after the loop the W ring holds the
// warps' [WARPS][RT][3]).
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

// (m, s) <- the logsumexp state of (m, s) and (mo, so) together
__device__ __forceinline__ void merge(float& m, float& s, float mo,
                                      float so) {
  const float mx = fmaxf(m, mo);
  s = s * expf(m - mx) + so * expf(mo - mx);
  m = mx;
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

// NJ n-tiles of 8 rows: RT = 8 NJ rows a CTA
template <int NJ, int KC>
__global__ void __launch_bounds__(THREADS, 1)
fwd_lora_tf32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ xa,
                     const float* __restrict__ bt,
                     const int* __restrict__ labels, float* __restrict__ part,
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
  // this lane's rows i = 2 j + e (local row 8 j + 2 t + e): label,
  // running max, sum of exp and gold over the lane's vocab rows
  int lab[NI];
  float m[NI], s[NI], gl[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = row0 + 8 * (i / 2) + 2 * t + (i % 2);
    lab[i] = r < R ? labels[r] : -1;
    m[i] = NEG_BIG;
    s[i] = 0.f;
    gl[i] = 0.f;
  }

  // lane addresses: W's A fragment (vocab rows of the warp, row-major
  // [16][8]) and h's B fragments ([n][k]: n-tiles 2 p, 2 p + 1 of rows
  // 16 p..) by ldmatrix
  const int a_off = (lr + (lm % 2) * 8) * LDW + (lm / 2) * 4;
  const int b_off = (lr + (lm / 2) * 8) * LDH + (lm % 2) * 4;

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
      // the tile's logits are whole: fold this lane's vocab rows v0 + g
      // (fragment elements e) and v0 + g + 8 (2 + e) into rows i = 2 j + e
      const int v0 = tile * VT + warp * 16 + g;
      const bool ok0 = v0 < V, ok1 = v0 + 8 < V;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          const float x0 = hh[j][e] + sm[j][e];
          const float x1 = hh[j][2 + e] + sm[j][2 + e];
          if (ok0 && v0 == lab[i]) gl[i] += x0;
          if (ok1 && v0 + 8 == lab[i]) gl[i] += x1;
          float mx = m[i];
          if (ok0) mx = fmaxf(mx, x0);
          if (ok1) mx = fmaxf(mx, x1);
          s[i] = s[i] * expf(m[i] - mx) + (ok0 ? expf(x0 - mx) : 0.f) +
                 (ok1 ? expf(x1 - mx) : 0.f);
          m[i] = mx;
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm[j][e] = hh[j][e] = 0.f;
      kc = 0;
      ++tile;
    } else {
      ++kc;
    }
    buf = buf + 1 == stages ? 0 : buf + 1;
  }

  // the 8 lanes of a row (g = 0..7, lane bits 2-4) merge by xor shuffles
  // (a + b == b + a, so they agree bit for bit)
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int off = 4; off <= 16; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off);
      gl[i] += __shfl_xor_sync(0xffffffffu, gl[i], off);
      merge(m[i], s[i], mo, so);
    }

  // the warps' states through shared memory, merged in warp order
  cp_async_wait<0>();   // no copy left in flight
  __syncthreads();      // every warp is done with the W ring
  float* red = w_s;     // [WARPS][RT][3]
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float* p = red + (warp * RT + 8 * (i / 2) + 2 * t + (i % 2)) * 3;
      p[0] = m[i];
      p[1] = s[i];
      p[2] = gl[i];
    }
  }
  __syncthreads();
  if (tid < RT && row0 + tid < R) {
    float mm = red[tid * 3], ss = red[tid * 3 + 1], gg = red[tid * 3 + 2];
    for (int k = 1; k < WARPS; ++k) {
      const float* o = red + (k * RT + tid) * 3;
      merge(mm, ss, o[0], o[1]);
      gg += o[2];
    }
    float* p = part + ((size_t)slab * R + row0 + tid) * 3;
    p[0] = mm;
    p[1] = ss;
    p[2] = gg;
  }
}

// lse = M + log(sum_k s_k exp(m_k - M)) and gold = sum_k gold_k over the
// slabs, in slab order
__global__ void fwd_lora_merge_kernel(const float* __restrict__ part,
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

template <int NJ, int KC>
int launch(const float* h, const float* w, const float* xa, const float* bt,
           const int* labels, float* part, float* lse, float* gold, int R,
           int V, int H, int rk, int n_slabs, int tiles_per_slab, int stages,
           cudaStream_t st) {
  const size_t smem = smem_bytes(8 * NJ, stages, hx_of(H, rk), KC);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_lora_tf32_kernel<NJ, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + 8 * NJ - 1) / (8 * NJ), n_slabs);
  fwd_lora_tf32_kernel<NJ, KC><<<grid, THREADS, smem, st>>>(
      h, w, xa, bt, labels, part, R, V, H, rk, tiles_per_slab, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_lora_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(part, lse, gold, R,
                                                         n_slabs);
  return (int)cudaGetLastError();
}

// the instantiation of (row tile, chunk): those of LOGITS_PLANS
// (ops/fused_ce.py) and 32 rows of 32 columns, kernel_variants.py's
// comparison for the chunk width
int dispatch(int row_tile, int chunk, const float* h, const float* w,
             const float* xa, const float* bt, const int* labels,
             float* part, float* lse, float* gold, int R, int V, int H,
             int rk, int n_slabs, int tiles_per_slab, int stages,
             cudaStream_t st) {
#define MFT_LAUNCH(NJ, KC)                                                 \
  return launch<NJ, KC>(h, w, xa, bt, labels, part, lse, gold, R, V, H,   \
                        rk, n_slabs, tiles_per_slab, stages, st)
  if (row_tile == 64 && chunk == 32) MFT_LAUNCH(8, 32);
  if (row_tile == 32 && chunk == 64) MFT_LAUNCH(4, 64);
  if (row_tile == 32 && chunk == 32) MFT_LAUNCH(4, 32);
  if (row_tile == 16 && chunk == 64) MFT_LAUNCH(2, 64);
#undef MFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mft_fused_ce_fwd_lora_tf32(
    const void* h, const void* w, const void* xa, const void* bt,
    const int* labels, float* part, float* lse, float* gold, int R, int V,
    int H, int rk, int row_tile, int chunk, int stages, int n_slabs,
    int tiles_per_slab, int dtype, void* stream) {
  if (dtype != 0 || R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || rk <= 0 ||
      rk > MAX_RANK || stages < 1 || stages > MAX_STAGES || n_slabs <= 0 ||
      tiles_per_slab <= 0 || (long long)n_slabs * tiles_per_slab * VT < V ||
      (long long)(n_slabs - 1) * tiles_per_slab * VT >= V)
    return (int)cudaErrorInvalidValue;
  return dispatch(row_tile, chunk, static_cast<const float*>(h),
                  static_cast<const float*>(w),
                  static_cast<const float*>(xa),
                  static_cast<const float*>(bt), labels, part, lse, gold, R,
                  V, H, rk, n_slabs, tiles_per_slab, stages,
                  static_cast<cudaStream_t>(stream));
}
