// Fused cross-entropy forward on Hopper's tensor cores (sm_90a), bf16 and
// f16.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_fwd_kernel` (launched by
// `_fwd`, row 6) for 16-bit h and W:
//   lse [R] f32  = logsumexp over V of logits = h W^T,
//   gold [R] f32 = the logit at the row's label,
// the logits accumulated in f32 from operands in their storage dtype (the
// TPU kernel's preferred_element_type=jnp.float32) and never written to
// device memory. f32 stays on mft_fused_ce_fwd (fused_ce.cu); the
// head-adapter variant (row 9) stays there too.
//
// Bound on this card, at the Gemma-3-270M training shape (R = 128 rows of
// a loss chunk, V = 262,144, H = 640, bf16): W must be read once, 335.5
// MB, ~100 us at 3.35 TB/s; the 2 R V H = 42.9 GFLOP need ~43 us at the
// bf16 tensor-core rate. Bytes bound it.
//
// Design: row 7's layout (fused_ce_dh_mma.cu) without its second product.
// A CTA owns (a 16 RG-row tile, a vocabulary slab); 2 RG warps, warp
// (rg, vg) holding rows 16 rg.. of the tile and vocab columns 16 vg.. of
// each 32-column W tile.
//   h's row tile [16 RG, H] is staged in shared memory once a slab; up to
//   H = 640 (KR = 40 k-steps) each lane then keeps its rows' A fragments
//   of h in registers for the whole slab (160 registers), so a k-step
//   reads only W's B fragment from shared memory: one ldmatrix a pair of
//   MMAs, half the traffic of reading h again for every tile (263 us
//   against 354 us at the Gemma chunk on an H100 80GB HBM3, PERF.md). A
//   wider H reads h's fragments from shared memory for every tile.
//   W tiles [32, H] stream through a ring of up to three buffers in their
//   storage dtype (16-byte cp.async, loads two tiles ahead). The logits
//   are m16n8k16 mma.sync (W as the column-major B operand by ldmatrix),
//   f32 accumulate.
//   The online max, sum-exp and gold run on the C fragments: each lane
//   keeps (m, s, gold) for its two rows over its own columns, rescaled
//   once a tile; at the end of the slab the four lanes of a quad merge
//   by xor shuffles, and the vg = 1 warps hand their rows to the vg = 0
//   warps through shared memory, merged in that fixed order.
//   W reaches device memory about once: the grid's x index runs over the
//   row tiles of one slab, so the CTAs that read the same W tiles are
//   launched together and the second finds them in L2; slabs are sized
//   so that the grid is one wave of CTAs (ops/fused_ce.fwd_mma_plan).
//   Deterministic: each CTA writes a (m, s, gold) partial per (slab, row)
//   and a merge kernel folds the slabs in order; no atomics, so two calls
//   give identical bits.
// Ragged R and V are masked (rows past R are zero-filled and not written,
// columns past V add nothing to the max, the sum or gold); H must be a
// multiple of 8 (16-byte rows); columns [H, H16) are zero in shared
// memory so the last k-step adds nothing.
// What holds it back (2.6x its bound on an H100, PERF.md): each warp's
// chain of ldmatrix -> mma a k-step, with no registers left to load W's
// fragments further ahead (160 hold h). Not the W stream: five buffers
// instead of three, or one CTA a slab so that W leaves L2 once, were
// slower. wgmma, which reads its B operand from shared memory itself,
// is the next step.
//
// C interface (ctypes): mft_fused_ce_fwd_mma returns the CUDA error code
// of its launches. h [R, H], W [V, H] contiguous in one dtype (1 bf16,
// 2 f16); labels [R] int32 in [0, V); part [n_slabs, R, 3], lse and gold
// [R] f32. The launch plan (row groups, stages, n_slabs, tiles_per_slab)
// comes from the wrapper (ops/fused_ce.fwd_mma_plan).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::from_f32;
using mft::ldmatrix_x4;
using mft::mma_16816;
using mft::NEG_INF;

constexpr int VT = 32;          // vocab columns of a tile
constexpr int VG = 2;           // vocab groups (warps) of 16 columns
constexpr int KR = 40;          // k-steps of h a lane holds (H16 <= 640)
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int h16_of(int H) { return (H + 15) / 16 * 16; }

// Whether a lane holds its rows' A fragments of h for the whole slab.
__host__ __device__ inline bool h_in_regs(int H) {
  return h16_of(H) <= 16 * KR;
}

// Shared memory of a CTA: h [16 RG][LD] and W [stages][VT][LD] in T
// (after the loop its first bytes hold the vg = 1 warps' [16 RG][3]).
__host__ __device__ inline size_t smem_bytes(int RG, int stages, int H,
                                             size_t elem) {
  return (size_t)(16 * RG + stages * VT) * (h16_of(H) + 8) * elem;
}

// (m, s) <- the logsumexp state of (m, s) and (mo, so) together
__device__ __forceinline__ void merge(float& m, float& s, float mo,
                                      float so) {
  const float mx = fmaxf(m, mo);
  s = s * expf(m - mx) + so * expf(mo - mx);
  m = mx;
}

template <typename T, int RG, bool AREG>
__global__ void __launch_bounds__(RG * VG * 32, 1)
fwd_mma_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const int* __restrict__ labels, float* __restrict__ part,
               int R, int V, int H, int tiles_per_slab, int stages) {
  constexpr int RT = 16 * RG;
  constexpr int THREADS = RG * VG * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H16 = h16_of(H), LD = H16 + 8;
  T* h_s = reinterpret_cast<T*>(smem_raw);
  T* w_s = h_s + RT * LD;                 // [stages][VT][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int rg = warp % RG, vg = warp / RG;
  const int row0 = blockIdx.x * RT;
  const int slab = blockIdx.y;
  const int n_vt = (V + VT - 1) / VT;
  const int t0 = slab * tiles_per_slab;
  const int t_end = min(n_vt, t0 + tiles_per_slab);

  // columns [H, H16) of every staged row are zero (cp.async never
  // writes them): the last k-step of the logits adds 0
  if (H16 > H) {
    const int tail = H16 - H;
    for (int i = tid; i < (RT + stages * VT) * tail; i += THREADS)
      h_s[(i / tail) * LD + H + i % tail] = from_f32<T>(0.f);
  }
  const int CH = H / 8;                   // 16-byte chunks a row
  for (int i = tid; i < RT * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8, gr = row0 + r;
    cp_async_16(h_s + r * LD + c, h + (size_t)min(gr, R - 1) * H + c,
                gr < R);
  }
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
  };
  // a ring of `stages` W buffers, `stages` - 1 tiles ahead (one group
  // each; the first also carries h); a single buffer is refilled in turn
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

  // lane addresses: A of the warp's rows in h_s; W's 16 vocab rows of
  // this warp as the logits' B (non-transposed)
  const T* h_lane = h_s + (rg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
  const int wl_row = vg * 16 + lr + (lm / 2) * 8, wl_col = (lm % 2) * 8;

  const int KD = H16 / 16;
  uint32_t af[AREG ? KR : 1][4];   // h's A fragments (AREG)
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

    // logits of 16 rows x 16 vocab columns over all of H
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
    __syncthreads();   // this buffer is consumed before it is restaged
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

template <typename T, int RG, bool AREG>
int launch(const void* h, const void* w, const int* labels, float* part,
           float* lse, float* gold, int R, int V, int H, int n_slabs,
           int tiles_per_slab, int stages, cudaStream_t st) {
  const size_t smem = smem_bytes(RG, stages, H, sizeof(T));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_mma_kernel<T, RG, AREG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (R + 16 * RG - 1) / (16 * RG);
  dim3 grid(row_tiles, n_slabs);
  fwd_mma_kernel<T, RG, AREG><<<grid, RG * VG * 32, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, part, R,
      V, H, tiles_per_slab, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(part, lse, gold, R,
                                                    n_slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rg(int rg, const void* h, const void* w, const int* labels,
                float* part, float* lse, float* gold, int R, int V, int H,
                int n_slabs, int tiles_per_slab, int stages,
                cudaStream_t st) {
  if (h_in_regs(H))   // the plan takes 64-row tiles up to H 640
    return rg == 4 ? launch<T, 4, true>(h, w, labels, part, lse, gold, R, V,
                                        H, n_slabs, tiles_per_slab, stages,
                                        st)
                   : (int)cudaErrorInvalidValue;
  switch (rg) {
    case 4:
      return launch<T, 4, false>(h, w, labels, part, lse, gold, R, V, H,
                                 n_slabs, tiles_per_slab, stages, st);
    case 2:
      return launch<T, 2, false>(h, w, labels, part, lse, gold, R, V, H,
                                 n_slabs, tiles_per_slab, stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_fused_ce_fwd_mma(const void* h, const void* w,
                                    const int* labels, float* part,
                                    float* lse, float* gold, int R, int V,
                                    int H, int row_groups, int stages,
                                    int n_slabs, int tiles_per_slab,
                                    int dtype, void* stream) {
  if (R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || stages < 1 ||
      stages > 3 || n_slabs <= 0 || tiles_per_slab <= 0 ||
      (long long)n_slabs * tiles_per_slab * VT < V ||
      (long long)(n_slabs - 1) * tiles_per_slab * VT >= V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_rg<__nv_bfloat16>(row_groups, h, w, labels, part, lse,
                                        gold, R, V, H, n_slabs,
                                        tiles_per_slab, stages, st);
    case 2:
      return dispatch_rg<__half>(row_groups, h, w, labels, part, lse, gold,
                                 R, V, H, n_slabs, tiles_per_slab, stages,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
