// Fused cross-entropy dh on Hopper's tensor cores (sm_90a), bf16 and f16.
//
// Replaces: mobilefinetuner_tpu/ops/fused_ce.py `_dh_kernel` (launched by
// `_bwd_dh`, row 7) for 16-bit h and W:
//   dh [R, H] f32 = coef @ W,
//   coef = dlse * exp(h W^T - lse) + dgold * onehot(label),
// coef rounded to W's dtype before the product, as the TPU kernel's
// `coef.astype(w.dtype)`. f32 stays on mft_fused_ce_dh (fused_ce.cu); the
// head-adapter variant (row 10) stays there too.
//
// Bound on this card, at the Gemma-3-270M training shape (R = 128 rows of
// a loss chunk, V = 262,144, H = 640, bf16): W must be read once, 335.5
// MB, ~100 us at 3.35 TB/s; the two products' 4 R V H = 86 GFLOP need
// ~87 us at the bf16 tensor-core rate. Bytes bound it, barely: both
// sides have to be near their peaks.
//
// Design. A CTA owns (a 16 RG-row tile, an H part of at most HP_MAX
// columns, a vocabulary slab); 2 RG warps, warp (rg, vg) holding rows
// 16 rg.. of the tile and vocab columns 16 vg.. of each 32-column tile.
//   One W tile [32, H] in shared memory (its storage dtype, cp.async,
//   in a ring of up to three buffers, as shared memory allows: loads run
//   two tiles ahead) serves both products:
//   the logits h W^T read it as a column-major B operand (ldmatrix), dh +=
//   coef W_tile as a row-major one (ldmatrix.trans). h's row tile [16 RG,
//   H] stays in shared memory for the whole slab. Both products are
//   m16n8k16 mma.sync, f32 accumulate.
//   coef never leaves registers: it is formed from the logits C
//   fragments, rounded to W's dtype, and packed as the A fragment of the
//   second product (16 rows x 16 vocab columns, one k-step).
//   Accumulators: a warp's [16, HP_MAX] dh partial is HP_MAX / 2 f32
//   registers a lane (160 at HP_MAX = 320). H > HP_MAX is cut into parts
//   that each recompute the logits (H = 640: two parts, +43 GFLOP);
//   cutting rows instead would not help, since [128, 640] f32 is more
//   than an SM's register file.
//   W reaches device memory about once: the grid's x index runs over the
//   (row tile, H part) CTAs of one slab, so the CTAs that read the same W
//   tiles are launched together and all but the first find them in L2;
//   slabs are sized so that the grid is one wave of CTAs.
//   Deterministic: the two vocab-group warps of a row group add their
//   partials through shared memory in a fixed order, each CTA writes a
//   [rows, part] partial of its slab, and a reduce kernel sums the slabs
//   in order; no atomics, so two calls give identical bits.
// Ragged R and V are masked (zero-filled rows, coef 0 past V); H must be
// a multiple of 8 (16-byte rows); columns past H are zero in shared
// memory so the last k-step adds nothing.
//
// C interface (ctypes): mft_fused_ce_dh_mma returns the CUDA error code
// of its launches. h [R, H], W [V, H] contiguous in one dtype (1 bf16,
// 2 f16); labels [R] int32 in [0, V); lse, dlse, dgold [R] f32; part
// [n_slabs, R, H] and dh [R, H] f32. The launch plan (row groups, stages,
// hp, n_parts, n_slabs, tiles_per_slab) comes from the wrapper
// (ops/fused_ce.dh_mma_plan).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::from_f32;
using mft::ldmatrix_x4;
using mft::ldmatrix_x4_trans;
using mft::mma_16816;
using mft::pack2;
using mft::to_f32;

constexpr int VT = 32;          // vocab columns of a tile
constexpr int VG = 2;           // vocab groups (warps) of 16 columns
constexpr int HP_MAX = 320;     // dh columns of a CTA
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int h16_of(int H) { return (H + 15) / 16 * 16; }

// Shared memory of a CTA: h [16 RG][LD] and W [stages][VT][LD] in T
// during the loop, then the [16 RG][hp] f32 partial of the vg = 1 warps.
__host__ __device__ inline size_t smem_bytes(int RG, int stages, int H,
                                             int hp, size_t elem) {
  const size_t ld = (size_t)h16_of(H) + 8;
  const size_t loop = (16 * RG + stages * VT) * ld * elem;
  const size_t red = (size_t)16 * RG * hp * sizeof(float);
  return loop > red ? loop : red;
}

template <typename T, int RG>
__global__ void __launch_bounds__(RG * VG * 32, 1)
dh_mma_kernel(const T* __restrict__ h, const T* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ dlse,
              const float* __restrict__ dgold, float* __restrict__ part,
              int R, int V, int H, int hp, int n_parts, int tiles_per_slab,
              int stages) {
  constexpr int RT = 16 * RG;
  constexpr int THREADS = RG * VG * 32;
  constexpr int NH = HP_MAX / 8;          // dh n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H16 = h16_of(H), LD = H16 + 8;
  T* h_s = reinterpret_cast<T*>(smem_raw);
  T* w_s = h_s + RT * LD;                 // [stages][VT][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane % 8, lm = lane / 8;
  const int rg = warp % RG, vg = warp / RG;
  const int row0 = (blockIdx.x / n_parts) * RT;
  const int c0 = (blockIdx.x % n_parts) * hp;
  const int ncols = min(hp, H - c0);
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

  // lane addresses: A of the warp's rows in h_s; W's 16 vocab rows of
  // this warp as the logits' B (non-transposed) and as dh's B (trans)
  const T* h_lane = h_s + (rg * 16 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
  const int wl_row = vg * 16 + lr + (lm / 2) * 8, wl_col = (lm % 2) * 8;
  const int wt_row = vg * 16 + lr + (lm % 2) * 8,
            wt_col = c0 + (lm / 2) * 8;

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

    // coef, rounded to T, packed as the A fragment of dh's k-step
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
    }

    // dh[16, part] += coef [16, 16] . W_tile[16 vocab, part]
    // Straight-line code, so the loads are issued ahead of the products:
    // column pairs past the part read its first pair instead, and their
    // sums are never stored (a branch per pair made each load wait for
    // the previous pair's products).
    const T* wtr = wt + wt_row * LD + wt_col;
#pragma unroll
    for (int n = 0; n < NH; n += 2) {
      uint32_t bw[4];
      ldmatrix_x4_trans(bw, wtr + (n * 8 < ncols ? n * 8 : 0));
      mma_16816<T>(acc[n], cf, bw[0], bw[1]);
      mma_16816<T>(acc[n + 1], cf, bw[2], bw[3]);
    }
    __syncthreads();   // this buffer is consumed before it is restaged
  }

  // the vg = 1 warps' partials through shared memory, added in order
  cp_async_wait<0>();   // (an empty slab leaves h's copy in flight)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);   // [RT][hp]
  if (vg == 1) {
#pragma unroll
    for (int n = 0; n < NH; ++n)
      if (n * 8 < ncols)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(rg * 16 + g + 8 * (e >> 1)) * hp + n * 8 + 2 * t + (e & 1)] =
              acc[n][e];
  }
  __syncthreads();
  if (vg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!rin[i]) continue;
      const int rl = rg * 16 + g + 8 * i;
      float* dst = part + ((size_t)slab * R + row0 + rl) * H + c0;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < ncols) {
          float2 x;
          x.x = acc[n][2 * i] + red[rl * hp + col];
          x.y = acc[n][2 * i + 1] + red[rl * hp + col + 1];
          *reinterpret_cast<float2*>(dst + col) = x;
        }
      }
    }
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

template <typename T, int RG>
int launch(const void* h, const void* w, const int* labels,
           const float* lse, const float* dlse, const float* dgold,
           float* part, float* dh, int R, int V, int H, int hp, int n_parts,
           int n_slabs, int tiles_per_slab, int stages, cudaStream_t st) {
  const size_t smem = smem_bytes(RG, stages, H, hp, sizeof(T));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dh_mma_kernel<T, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (R + 16 * RG - 1) / (16 * RG);
  dim3 grid(row_tiles * n_parts, n_slabs);
  dh_mma_kernel<T, RG><<<grid, RG * VG * 32, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, dlse,
      dgold, part, R, V, H, hp, n_parts, tiles_per_slab, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)R * H;
  dh_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dh, n,
                                                                n_slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rg(int rg, const void* h, const void* w, const int* labels,
                const float* lse, const float* dlse, const float* dgold,
                float* part, float* dh, int R, int V, int H, int hp,
                int n_parts, int n_slabs, int tiles_per_slab, int stages,
                cudaStream_t st) {
  switch (rg) {
    case 4:
      return launch<T, 4>(h, w, labels, lse, dlse, dgold, part, dh, R, V, H,
                          hp, n_parts, n_slabs, tiles_per_slab, stages, st);
    case 2:
      return launch<T, 2>(h, w, labels, lse, dlse, dgold, part, dh, R, V, H,
                          hp, n_parts, n_slabs, tiles_per_slab, stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_fused_ce_dh_mma(const void* h, const void* w,
                                   const int* labels, const float* lse,
                                   const float* dlse, const float* dgold,
                                   float* part, float* dh, int R, int V,
                                   int H, int row_groups, int stages, int hp,
                                   int n_parts, int n_slabs,
                                   int tiles_per_slab, int dtype,
                                   void* stream) {
  if (R <= 0 || V <= 0 || H <= 0 || H % 8 != 0 || hp <= 0 ||
      hp % 16 != 0 || hp > HP_MAX || n_parts <= 0 ||
      (long long)hp * n_parts < H || (long long)hp * (n_parts - 1) >= H ||
      stages < 1 || stages > 3 || n_slabs <= 0 || tiles_per_slab <= 0 ||
      (long long)n_slabs * tiles_per_slab * VT < V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_rg<__nv_bfloat16>(row_groups, h, w, labels, lse, dlse,
                                        dgold, part, dh, R, V, H, hp,
                                        n_parts, n_slabs, tiles_per_slab,
                                        stages, st);
    case 2:
      return dispatch_rg<__half>(row_groups, h, w, labels, lse, dlse, dgold,
                                 part, dh, R, V, H, hp, n_parts, n_slabs,
                                 tiles_per_slab, stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
