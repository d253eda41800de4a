// Fused cross-entropy head for Hopper (sm_90a): the [R, V] logits of a
// vocabulary head are computed tile by tile and never written to device
// memory.
//
// Replaces mobilefinetuner_tpu/ops/fused_ce.py
//   row 6  `_fwd_kernel` (launched by `_fwd`):   lse, gold [R] f32 of
//          logits = h @ W^T, h [R, H], W [V, H];
//   row 7  `_dh_kernel` (`_bwd_dh`):  dh [R, H] f32 = coef @ W;
//   row 8  `_dw_kernel` (`_bwd_dw`):  dW [V, H] f32 = coef^T @ h;
// with coef = dlse * softmax(logits) + dgold * onehot(label), rounded to
// the storage dtype before its product as the TPU kernels round it.
//
// Bound on this card, at the Gemma-3-270M training shape (R = 128 rows of
// one loss chunk, V = 262,144, H = 640, bf16): each kernel must read W
// once, 335.5 MB, ~100 us at 3.35 TB/s; the forward's 2 R V H = 42.9
// GFLOP need 43 us at the bf16 tensor-core rate, the dh and dW kernels'
// twice that, and dW also writes 671 MB of f32 (~300 us in all). Bytes
// bound all three.
//
// Design. The TPU kernels walk the vocabulary as a SEQUENTIAL grid axis
// and carry running sums in VMEM scratch from one vocab tile to the next.
// Here the vocab tiles of a slab run inside one CTA's loop and the slabs
// are parallel CTAs:
//   forward  CTA (32-row tile, vocab slab): online max / sum-exp / gold
//            per row over the slab's 64-column tiles, a partial
//            (m, s, gold) per (slab, row) to a workspace; a merge kernel
//            forms lse = M + log(sum s exp(m - M)).
//   dh       CTA (32-row tile, vocab slab): per 64-column tile, the logits
//            tile, coef, then coef @ W_tile into a [32, H] f32 accumulator
//            in shared memory; one partial [32, H] per (slab, row tile),
//            summed over slabs by a reduce kernel. Chosen over f32 atomics
//            (deterministic, and contention-free) and over CTAs per
//            (row tile, H tile), which would recompute every logits tile
//            once per H tile.
//   dW       CTA (32-column vocab tile): loops over 64-row tiles, logits,
//            coef, then coef^T @ h_tile into a [32, H] f32 accumulator in
//            shared memory; naturally parallel over V, the contraction
//            over R inside the CTA; no reduction across CTAs.
// Products are f32 FMAs from shared memory (each thread a small register
// tile), not tensor cores: a first, simple version, far from the bound
// (wgmma and TMA are the next step). Ragged R, V and H edges are masked,
// so any shape is taken (the TPU kernels need R % 8 and V % block == 0).
// The dh and dW kernels hold a [32, H] f32 accumulator in shared memory:
// H <= 1,520 (MAX_HIDDEN in ops/fused_ce.py).
//
// C interface (ctypes), each returning the CUDA error code of its
// launches. h [R, H] and W [V, H] contiguous, one dtype (0 f32, 1 bf16,
// 2 f16); labels [R] int32 in [0, V); lse, dlse, dgold [R] f32;
// workspaces and outputs f32, allocated by the wrapper.

#include "flash_attention_common.cuh"

namespace {

using mft::from_f32;
using mft::to_f32;

constexpr int THREADS = 256;      // 16 x 16 threads: (ty, tx)
constexpr int KC = 32;            // contraction chunk of a logits tile
constexpr int HC = 64;            // column chunk of the dh / dW products
constexpr int FWD_TM = 32;        // forward and dh: rows of a tile
constexpr int FWD_TN = 64;        //                 vocab of a tile
constexpr int DW_TM = 64;         // dW: rows of a tile
constexpr int DW_TN = 32;         //     vocab of a CTA

// Logits tile acc[i][j] = h[r0 + ty + 16 i] . W[v0 + tx + 16 j] over H,
// staged through shared memory in KC-wide chunks (zero outside R, V, H).
template <typename T, int TM, int TN>
__device__ __forceinline__ void logits_tile(
    const T* __restrict__ h, const T* __restrict__ w, int R, int V, int H,
    int r0, int v0, float* hs, float* ws, float (&acc)[TM / 16][TN / 16]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += KC) {
    __syncthreads();              // earlier reads of hs / ws are done
    for (int e = tid; e < TM * KC; e += THREADS) {
      const int m = e / KC, kk = e % KC, r = r0 + m, k = k0 + kk;
      hs[kk * (TM + 1) + m] =
          (r < R && k < H) ? to_f32(h[(size_t)r * H + k]) : 0.f;
    }
    for (int e = tid; e < TN * KC; e += THREADS) {
      const int n = e / KC, kk = e % KC, v = v0 + n, k = k0 + kk;
      ws[kk * (TN + 1) + n] =
          (v < V && k < H) ? to_f32(w[(size_t)v * H + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[TM / 16], b[TN / 16];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) a[i] = hs[kk * (TM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN / 16; ++j) b[j] = ws[kk * (TN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i)
#pragma unroll
        for (int j = 0; j < TN / 16; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Sum / max over the 16 lanes that share a row (a half warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// coef of one logits cell, rounded to the storage dtype T (0 outside).
template <typename T>
__device__ __forceinline__ float coef_of(float logit, bool in, bool hit,
                                         float lse, float dlse,
                                         float dgold) {
  if (!in) return 0.f;
  const float c = dlse * expf(logit - lse) + (hit ? dgold : 0.f);
  return to_f32(from_f32<T>(c));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
           const int* __restrict__ labels, float* __restrict__ part, int R,
           int V, int H, int tiles_per_slab) {
  __shared__ float hs[KC * (FWD_TM + 1)];
  __shared__ float ws[KC * (FWD_TN + 1)];
  constexpr int NI = FWD_TM / 16, NJ = FWD_TN / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * FWD_TM, slab = blockIdx.y;
  int lab[NI];
  float m[NI], s[NI], g[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = r0 + ty + 16 * i;
    lab[i] = r < R ? labels[r] : -1;
    m[i] = -INFINITY;
    s[i] = 0.f;
    g[i] = 0.f;
  }
  const int n_vt = (V + FWD_TN - 1) / FWD_TN;
  const int t_end = min(n_vt, (slab + 1) * tiles_per_slab);
  for (int t = slab * tiles_per_slab; t < t_end; ++t) {
    const int v0 = t * FWD_TN;
    float acc[NI][NJ];
    logits_tile<T, FWD_TM, FWD_TN>(h, w, R, V, H, r0, v0, hs, ws, acc);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int v = v0 + tx + 16 * j;
        if (v < V) {
          tmax = fmaxf(tmax, acc[i][j]);
          if (v == lab[i]) g[i] += acc[i][j];
        }
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (v0 + tx + 16 * j < V) se += expf(acc[i][j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + row_sum(se);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float gi = row_sum(g[i]);
    const int r = r0 + ty + 16 * i;
    if (tx == 0 && r < R) {
      float* p = part + ((size_t)slab * R + r) * 3;
      p[0] = m[i];
      p[1] = s[i];
      p[2] = gi;
    }
  }
}

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

// Shared-memory floats of the dh and dW kernels besides the [32, H]
// accumulator (both: 9,408).
constexpr int BWD_STAGE_FLOATS =
    KC * (FWD_TM + 1) + KC * (FWD_TN + 1) + FWD_TN * (FWD_TM + 1) +
    FWD_TN * (HC + 1);
static_assert(BWD_STAGE_FLOATS == KC * (DW_TM + 1) + KC * (DW_TN + 1) +
                                      DW_TM * (DW_TN + 1) +
                                      DW_TM * (HC + 1),
              "dh and dW stage the same number of floats");

template <typename T>
__global__ void __launch_bounds__(THREADS)
dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
          const int* __restrict__ labels, const float* __restrict__ lse,
          const float* __restrict__ dlse, const float* __restrict__ dgold,
          float* __restrict__ part, int R, int V, int H,
          int tiles_per_slab) {
  extern __shared__ float smem[];
  float* hs = smem;                              // [KC][TM + 1]
  float* ws = hs + KC * (FWD_TM + 1);            // [KC][TN + 1]
  float* cs = ws + KC * (FWD_TN + 1);            // [TN][TM + 1] coef
  float* wc = cs + FWD_TN * (FWD_TM + 1);        // [TN][HC + 1] W chunk
  float* acc_s = wc + FWD_TN * (HC + 1);         // [TM][H]
  constexpr int NI = FWD_TM / 16, NJ = FWD_TN / 16, NC = HC / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * FWD_TM, slab = blockIdx.y;
  for (int e = tid; e < FWD_TM * H; e += THREADS) acc_s[e] = 0.f;
  int lab[NI];
  float l_r[NI], dl_r[NI], dg_r[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = r0 + ty + 16 * i;
    const bool ok = r < R;
    lab[i] = ok ? labels[r] : -1;
    l_r[i] = ok ? lse[r] : 0.f;
    dl_r[i] = ok ? dlse[r] : 0.f;
    dg_r[i] = ok ? dgold[r] : 0.f;
  }
  const int n_vt = (V + FWD_TN - 1) / FWD_TN;
  const int t_end = min(n_vt, (slab + 1) * tiles_per_slab);
  for (int t = slab * tiles_per_slab; t < t_end; ++t) {
    const int v0 = t * FWD_TN;
    float acc[NI][NJ];
    logits_tile<T, FWD_TM, FWD_TN>(h, w, R, V, H, r0, v0, hs, ws, acc);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = r0 + ty + 16 * i, v = v0 + tx + 16 * j;
        cs[(tx + 16 * j) * (FWD_TM + 1) + ty + 16 * i] = coef_of<T>(
            acc[i][j], r < R && v < V, v == lab[i], l_r[i], dl_r[i],
            dg_r[i]);
      }
    for (int c0 = 0; c0 < H; c0 += HC) {
      __syncthreads();            // cs written, earlier wc reads done
      for (int e = tid; e < FWD_TN * HC; e += THREADS) {
        const int n = e / HC, cc = e % HC, v = v0 + n, col = c0 + cc;
        wc[n * (HC + 1) + cc] =
            (v < V && col < H) ? to_f32(w[(size_t)v * H + col]) : 0.f;
      }
      __syncthreads();
      float o[NI][NC];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) o[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < FWD_TN; ++n) {
        float a[NI], b[NC];
#pragma unroll
        for (int i = 0; i < NI; ++i) a[i] = cs[n * (FWD_TM + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NC; ++j) b[j] = wc[n * (HC + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col < H) acc_s[(ty + 16 * i) * H + col] += o[i][j];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < FWD_TM * H; e += THREADS) {
    const int r = r0 + e / H;
    if (r < R) part[((size_t)slab * R + r) * H + e % H] = acc_s[e];
  }
}

__global__ void dh_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dh, size_t RH,
                                 int n_slabs) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= RH) return;
  float sum = 0.f;
  for (int k = 0; k < n_slabs; ++k) sum += part[(size_t)k * RH + e];
  dh[e] = sum;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
          const int* __restrict__ labels, const float* __restrict__ lse,
          const float* __restrict__ dlse, const float* __restrict__ dgold,
          float* __restrict__ dw, int R, int V, int H) {
  extern __shared__ float smem[];
  float* hs = smem;                              // [KC][TM + 1]
  float* ws = hs + KC * (DW_TM + 1);             // [KC][TN + 1]
  float* cs = ws + KC * (DW_TN + 1);             // [TM][TN + 1] coef
  float* hc = cs + DW_TM * (DW_TN + 1);          // [TM][HC + 1] h chunk
  float* acc_s = hc + DW_TM * (HC + 1);          // [TN][H]
  constexpr int NI = DW_TM / 16, NJ = DW_TN / 16, NO = DW_TN / 16,
                NC = HC / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * DW_TN;
  for (int e = tid; e < DW_TN * H; e += THREADS) acc_s[e] = 0.f;
  for (int r0 = 0; r0 < R; r0 += DW_TM) {
    float acc[NI][NJ];
    logits_tile<T, DW_TM, DW_TN>(h, w, R, V, H, r0, v0, hs, ws, acc);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = r0 + ty + 16 * i;
      const bool ok = r < R;
      const int lab = ok ? labels[r] : -1;
      const float l = ok ? lse[r] : 0.f, dl = ok ? dlse[r] : 0.f,
                  dg = ok ? dgold[r] : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int v = v0 + tx + 16 * j;
        cs[(ty + 16 * i) * (DW_TN + 1) + tx + 16 * j] =
            coef_of<T>(acc[i][j], ok && v < V, v == lab, l, dl, dg);
      }
    }
    for (int c0 = 0; c0 < H; c0 += HC) {
      __syncthreads();            // cs written, earlier hc reads done
      for (int e = tid; e < DW_TM * HC; e += THREADS) {
        const int m = e / HC, cc = e % HC, r = r0 + m, col = c0 + cc;
        hc[m * (HC + 1) + cc] =
            (r < R && col < H) ? to_f32(h[(size_t)r * H + col]) : 0.f;
      }
      __syncthreads();
      float o[NO][NC];
#pragma unroll
      for (int i = 0; i < NO; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) o[i][j] = 0.f;
#pragma unroll 4
      for (int m = 0; m < DW_TM; ++m) {
        float a[NO], b[NC];
#pragma unroll
        for (int i = 0; i < NO; ++i) a[i] = cs[m * (DW_TN + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NC; ++j) b[j] = hc[m * (HC + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NO; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
      }
#pragma unroll
      for (int i = 0; i < NO; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col < H) acc_s[(ty + 16 * i) * H + col] += o[i][j];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < DW_TN * H; e += THREADS) {
    const int v = v0 + e / H;
    if (v < V) dw[(size_t)v * H + e % H] = acc_s[e];
  }
}

size_t bwd_smem_bytes(int H) {
  return (size_t)(BWD_STAGE_FLOATS + 32 * H) * sizeof(float);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* h, const void* w, const int* labels, float* part,
               float* lse, float* gold, int R, int V, int H, int n_slabs,
               int tiles_per_slab, cudaStream_t st) {
  dim3 grid((R + FWD_TM - 1) / FWD_TM, n_slabs);
  fwd_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, part, R,
      V, H, tiles_per_slab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(part, lse, gold, R,
                                                    n_slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* h, const void* w, const int* labels,
              const float* lse, const float* dlse, const float* dgold,
              float* part, float* dh, int R, int V, int H, int n_slabs,
              int tiles_per_slab, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(H);
  int e = allow_smem(dh_kernel<T>, smem);
  if (e) return e;
  dim3 grid((R + FWD_TM - 1) / FWD_TM, n_slabs);
  dh_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, dlse,
      dgold, part, R, V, H, tiles_per_slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t RH = (size_t)R * H;
  dh_reduce_kernel<<<(unsigned)((RH + 255) / 256), 256, 0, st>>>(
      part, dh, RH, n_slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* h, const void* w, const int* labels,
              const float* lse, const float* dlse, const float* dgold,
              float* dw, int R, int V, int H, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(H);
  int e = allow_smem(dw_kernel<T>, smem);
  if (e) return e;
  dw_kernel<T><<<(V + DW_TN - 1) / DW_TN, THREADS, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, dlse,
      dgold, dw, R, V, H);
  return (int)cudaGetLastError();
}

bool bad_shape(int R, int V, int H) {
  return R <= 0 || V <= 0 || H <= 0 || bwd_smem_bytes(H) > 232448;
}

}  // namespace

extern "C" int mft_fused_ce_fwd(const void* h, const void* w,
                                const int* labels, float* part, float* lse,
                                float* gold, int R, int V, int H,
                                int n_slabs, int tiles_per_slab, int dtype,
                                void* stream) {
  if (R <= 0 || V <= 0 || H <= 0 || n_slabs <= 0 || tiles_per_slab <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(h, w, labels, part, lse, gold, R, V, H,
                               n_slabs, tiles_per_slab, st);
    case 1:
      return launch_fwd<__nv_bfloat16>(h, w, labels, part, lse, gold, R, V,
                                       H, n_slabs, tiles_per_slab, st);
    case 2:
      return launch_fwd<__half>(h, w, labels, part, lse, gold, R, V, H,
                                n_slabs, tiles_per_slab, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mft_fused_ce_dh(const void* h, const void* w,
                               const int* labels, const float* lse,
                               const float* dlse, const float* dgold,
                               float* part, float* dh, int R, int V, int H,
                               int n_slabs, int tiles_per_slab, int dtype,
                               void* stream) {
  if (bad_shape(R, V, H) || n_slabs <= 0 || tiles_per_slab <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dh<float>(h, w, labels, lse, dlse, dgold, part, dh, R,
                              V, H, n_slabs, tiles_per_slab, st);
    case 1:
      return launch_dh<__nv_bfloat16>(h, w, labels, lse, dlse, dgold, part,
                                      dh, R, V, H, n_slabs, tiles_per_slab,
                                      st);
    case 2:
      return launch_dh<__half>(h, w, labels, lse, dlse, dgold, part, dh, R,
                               V, H, n_slabs, tiles_per_slab, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mft_fused_ce_dw(const void* h, const void* w,
                               const int* labels, const float* lse,
                               const float* dlse, const float* dgold,
                               float* dw, int R, int V, int H, int dtype,
                               void* stream) {
  if (bad_shape(R, V, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dw<float>(h, w, labels, lse, dlse, dgold, dw, R, V, H,
                              st);
    case 1:
      return launch_dw<__nv_bfloat16>(h, w, labels, lse, dlse, dgold, dw, R,
                                      V, H, st);
    case 2:
      return launch_dw<__half>(h, w, labels, lse, dlse, dgold, dw, R, V, H,
                               st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
