// Contiguous-cache decode attention on Hopper's tensor cores (sm_90a),
// bf16 and f16: flash-decoding.
//
// Replaces: mobilefinetuner_tpu/ops/decode_attention.py `_decode_kernel`
// (launched by `decode_attention`) for 16-bit caches: one query token per
// batch row attends its whole contiguous K/V cache [B, KV, T, D] under a
// [B, T] mask of attendable columns (validity and any sliding window: the
// caller composes it). f32 caches stay on csrc/decode_attention.cu.
//
// Rounding as decode_attention.cu's (the oracle `xla_reference`): f32
// scores and softmax statistics, masked columns score NEG_INF and get
// probability exactly 0, p rounded to the cache dtype before P.V, which
// accumulates in f32; the row sum l adds the unrounded p and divides at
// the end. ctx is f32. A row with no attendable column gets ctx 0.
//
// Bound on this card: bytes. Each (b, kv-head) reads the K and V rows of
// its attendable columns once (2 * D * size bytes a column); the 4 G D
// FLOPs a column are far below the tensor cores' rate.
//
// Design (flash-decoding): the first version ran B * KV * G CTAs, 16 at
// Gemma-3-270M's last generate step, each walking its T alone and each
// query head reading the same K/V. Here:
// - One CTA per (T chunk, kv head, b) takes all G query heads of its kv
//   head (up to 16; more heads take more CTAs), so K/V are read once. The
//   chunk count comes from ops/decode_attention.decode_mma_plan, from
//   shapes only, aiming at four CTAs an SM and at most 128 chunks: 21
//   chunks of one 32-key tile at Gemma's B 4 x KV 1 x T 665, 6 at
//   GPT-2's 96 (b, head) pairs.
// - S = Q K^T and O += P V run on m16n8k16 mma.sync: the G query rows,
//   padded to 16 with zeros, are the A operand (their fragments loaded
//   once into registers), K's B fragments come by ldmatrix and V's by
//   ldmatrix.trans. Each warp owns D / WARPS head-dim columns: its own
//   slice of each K/V tile, in its own cp.async ring (no CTA barrier for
//   the copies), its partial S over those columns, and O for those
//   columns. The partial S of the warps meet in shared memory (one
//   barrier a tile, in two alternating buffers), each warp sums
//   them in warp order and runs the same online softmax in registers,
//   the row max and sum over the lane quad that holds a row.
// - A masked column's K/V rows are never read: their cp.async copies
//   zero-fill the shared-memory rows (src-size 0), so the tensor cores
//   multiply p = 0 by 0 and a masked column adds exactly 0 whatever the
//   cache holds there (Inf, NaN, unwritten memory). A tile with no
//   attendable column is skipped (its copies read nothing); a chunk with
//   none so writes (m, l) = (NEG_INF, 0) and reads no K/V.
// - Each chunk writes its partials (m, l, acc [G, D], f32) to a workspace
//   the wrapper allocates, and a merge kernel combines them in fixed chunk
//   order, so two calls are bit-identical; it is launched as a
//   programmatic dependent of the chunk grid, so its launch overlaps that
//   grid. A one-chunk plan writes ctx itself and launches no merge.
//
// C interface (ctypes): mft_decode_attention_mma returns the CUDA error
// code of the launches (0 on success). q [B, KV, G, D] and the caches
// [B, KV, T, D] contiguous in one dtype (1 bf16, 2 f16), the caches
// 16-byte and q 4-byte aligned; ok [B, T] bool; ctx [B, KV, G, D] f32;
// ws n_chunks * B * KV * G * (D + 2) floats (null for one chunk); tpc
// tiles of 32 keys a chunk, n_chunks = ceil(ceil(T / 32) / tpc).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using mft::cp_async_16;
using mft::cp_async_commit;
using mft::cp_async_wait;
using mft::ldmatrix_x4;
using mft::ldmatrix_x4_trans;
using mft::mma_16816;
using mft::NEG_INF;
using mft::pack2;

constexpr int TILE = 32;        // keys a tile
constexpr int QR = 16;          // query heads a CTA: the A operand's rows
constexpr int STAGES = 2;       // K/V tiles of a warp's ring
constexpr int SP = TILE + 8;    // row stride of the partial scores (f32)
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int WARPS = D >= 64 ? 4 : 2;
  static constexpr int DW = D / WARPS;   // head-dim columns a warp
  static constexpr int LD = DW + 8;      // smem row stride: +16 bytes
  static constexpr int KS = DW / 16;     // k-steps of a warp's partial S
  static constexpr int ND = DW / 8;      // O n-tiles a warp
  static constexpr int CPR = DW / 8;     // 16-byte copies a row slice
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RING = 2 * STAGES * TILE * LD;   // a warp's K, V
  // rings [WARPS][K/V][STAGES][TILE][LD] in T, then the partial scores
  // [2][WARPS][QR][SP] in f32
  static constexpr size_t smem_bytes(size_t elem) {
    return (size_t)WARPS * RING * elem +
           (size_t)2 * WARPS * QR * SP * sizeof(float);
  }
  static_assert(KS >= 1 && ND % 2 == 0, "D in {32, 64, 128, 256}");
};

// A warp's slice of one tile's K and V rows into ring slot `slot`: 16-byte
// cp.async copies, the rows of masked columns zero-filled (not read)
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* k_ring, T* v_ring,
                                           const T* kp, const T* vp,
                                           const unsigned char* okr,
                                           int tile, int slot, int Tn,
                                           int lane) {
  using C = Cfg<D>;
  const int t0 = tile * TILE;
  const unsigned okm =
      __ballot_sync(FULL, t0 + lane < Tn && okr[t0 + lane] != 0);
  T* kd = k_ring + slot * TILE * C::LD;
  T* vd = v_ring + slot * TILE * C::LD;
#pragma unroll
  for (int j = 0; j < C::CPR; ++j) {
    const int i = lane + 32 * j, rr = i / C::CPR, ch = (i % C::CPR) * 8;
    const bool valid = (okm >> rr) & 1u;
    const size_t off = (size_t)min(t0 + rr, Tn - 1) * D + ch;
    cp_async_16(kd + rr * C::LD + ch, kp + off, valid);
    cp_async_16(vd + rr * C::LD + ch, vp + off, valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
decode_mma_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc,
                  const unsigned char* __restrict__ ok,
                  float* __restrict__ ctx, float* __restrict__ ws, int KV,
                  int G, int Tn, int n_qg, int tpc, float scale) {
  using C = Cfg<D>;
  constexpr int WARPS = C::WARPS, DW = C::DW, LD = C::LD, KS = C::KS,
                ND = C::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int kv = blockIdx.y / n_qg, qg0 = (blockIdx.y % n_qg) * QR;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column pair
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row, matrix
  const int d0 = warp * DW;
  T* k_ring = reinterpret_cast<T*>(smem_raw) + warp * C::RING;
  T* v_ring = k_ring + STAGES * TILE * LD;
  float* s_part = reinterpret_cast<float*>(reinterpret_cast<T*>(smem_raw) +
                                           WARPS * C::RING);

  const size_t cbase = ((size_t)b * KV + kv) * (size_t)Tn * D + d0;
  const T* kp = kc + cbase;
  const T* vp = vc + cbase;
  const unsigned char* okr = ok + (size_t)b * Tn;
  const int n_tiles = (Tn + TILE - 1) / TILE;
  const int tile0 = chunk * tpc, tile1 = min(tile0 + tpc, n_tiles);
  const size_t rows_total = (size_t)gridDim.z * KV * G;
  const size_t row0 = ((size_t)b * KV + kv) * G + qg0;   // q / ctx row
  const int nq = min(QR, G - qg0);                        // heads here
  float* ws_ml = ws;                                      // [c][row][2]
  float* ws_acc = ws + (size_t)n_chunks * rows_total * 2; // [c][row][D]

  // the merge grid may launch now: it waits for this grid to complete
  asm volatile("griddepcontrol.launch_dependents;");
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (tile0 + i < tile1)
      stage_tile<T, D>(k_ring, v_ring, kp, vp, okr, tile0 + i, i, Tn, lane);
    cp_async_commit();
  }

  // Q's A fragments of the warp's columns: a0 (g, 2t..), a1 (g + 8, 2t..),
  // a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); heads past G are zero rows
  uint32_t qf[KS][4];
  const T* qb = q + row0 * D + d0;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + (i & 1) * 8, col = ks * 16 + (i >> 1) * 8 + 2 * t;
      qf[ks][i] = row < nq ? *reinterpret_cast<const uint32_t*>(
                                 qb + (size_t)row * D + col)
                           : 0u;
    }
  const bool live[2] = {g < nq, g + 8 < nq};

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int k_off = (lr + (lm >> 1) * 8) * LD + (lm & 1) * 8;
  const int v_off = (lr + (lm & 1) * 8) * LD + (lm >> 1) * 8;

  // it counts the tiles, pc the computed ones (the partial scores'
  // buffer alternates by pc: between two uses of a buffer stands the
  // barrier of the computed tile in between)
  for (int tile = tile0, it = 0, pc = 0; tile < tile1; ++tile, ++it) {
    const int slot = it % STAGES;
    if (tile + STAGES - 1 < tile1)
      stage_tile<T, D>(k_ring, v_ring, kp, vp, okr, tile + STAGES - 1,
                       (it + STAGES - 1) % STAGES, Tn, lane);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // this tile's copies have landed
    __syncwarp();
    const int t0 = tile * TILE;
    const unsigned okm =
        __ballot_sync(FULL, t0 + lane < Tn && okr[t0 + lane] != 0);
    if (okm != 0u) {   // the same for every warp of the CTA
      const T* kt = k_ring + slot * TILE * LD;
      const T* vt = v_ring + slot * TILE * LD;

      // the warp's partial S over its columns, four n-tiles of 8 keys
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + k_off + j * 8 * LD + ks * 16);
          mma_16816<T>(s[j], qf[ks], bk[0], bk[1]);
          mma_16816<T>(s[j + 1], qf[ks], bk[2], bk[3]);
        }
      float* sp = s_part + (size_t)((pc & 1) * WARPS + warp) * QR * SP;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(sp + g * SP + j * 8 + 2 * t) =
            make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(sp + (g + 8) * SP + j * 8 + 2 * t) =
            make_float2(s[j][2], s[j][3]);
      }
      __syncthreads();

      // the whole scores: the warps' partials summed in warp order; scale,
      // mask, the online softmax over the lane quad of each row
      const float* sb = s_part + (size_t)(pc & 1) * WARPS * QR * SP;
      ++pc;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // rows g, g + 8: keys 2t, 2t + 1
          float2 sum = make_float2(0.f, 0.f);
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            const float2 v = *reinterpret_cast<const float2*>(
                sb + (w * QR + g + 8 * h) * SP + j * 8 + 2 * t);
            sum.x += v.x;
            sum.y += v.y;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * h + c, key = j * 8 + 2 * t + c;
            const bool ok_e = live[h] && ((okm >> key) & 1u);
            s[j][e] = ok_e ? (c ? sum.y : sum.x) * scale : NEG_INF;
            mx[h] = fmaxf(mx[h], s[j][e]);
          }
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * 8 + 2 * t + (e & 1);
          const bool ok_e = live[e >> 1] && ((okm >> key) & 1u);
          const float p = ok_e ? expf(s[j][e] - m[e >> 1]) : 0.f;
          psum[e >> 1] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        psum[i] += __shfl_xor_sync(FULL, psum[i], 1);
        psum[i] += __shfl_xor_sync(FULL, psum[i], 2);
        l[i] = l[i] * alpha[i] + psum[i];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V, 16 keys a k-step: P (rounded to T) as A fragments from
      // the C fragments of n-tiles 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* c = &s[2 * kk + (i >> 1)][(i & 1) * 2];
          a[i] = pack2<T>(c[0], c[1]);
        }
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + v_off + kk * 16 * LD + n * 8);
          mma_16816<T>(o[n], a, bv[0], bv[1]);
          mma_16816<T>(o[n + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncwarp();   // this slot is consumed before it is restaged
  }

  // ctx (one chunk) or the chunk's partials: c0, c1 of o[n] are row g,
  // columns d0 + 8 n + 2 t (+1); c2, c3 row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    if (row >= nq) continue;
    if (n_chunks == 1) {
      const float li = l[i];
      float* dst = ctx + (row0 + row) * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(li > 0.f ? o[n][2 * i] / li : 0.f,
                        li > 0.f ? o[n][2 * i + 1] / li : 0.f);
    } else {
      const size_t r = (size_t)chunk * rows_total + row0 + row;
      float* dst = ws_acc + r * D + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (warp == 0 && t == 0) {
        ws_ml[r * 2] = m[i];
        ws_ml[r * 2 + 1] = l[i];
      }
    }
  }
}

// ctx [row, d] from the chunks' partials, in chunk order; a chunk with
// l = 0 (no attendable column) is selected out, not multiplied. One CTA
// of D threads a row: the chunks' (m, l) staged in shared memory and a
// thread's acc values of up to MERGE_BATCH chunks loaded into registers,
// all before the one barrier, so their latencies overlap.
constexpr int MERGE_MAX_CHUNKS = 128;   // decode_mma_plan's most chunks
constexpr int MERGE_BATCH = 32;

__global__ void decode_merge_kernel(const float* __restrict__ ws,
                                    float* __restrict__ ctx, int rows_total,
                                    int n_chunks, int D) {
  __shared__ float m_s[MERGE_MAX_CHUNKS], l_s[MERGE_MAX_CHUNKS];
  // launched as a programmatic dependent of the chunk grid: wait for its
  // partials (a no-op under an ordinary launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = blockIdx.x, d = threadIdx.x;
  const float* ml = ws;
  const float* acc = ws + (size_t)n_chunks * rows_total * 2 +
                     (size_t)row * D + d;
  const size_t stride = (size_t)rows_total * D;   // between chunks
  for (int c = d; c < n_chunks; c += blockDim.x) {
    const size_t r = (size_t)c * rows_total + row;
    m_s[c] = ml[r * 2];
    l_s[c] = ml[r * 2 + 1];
  }
  float a[MERGE_BATCH];
#pragma unroll
  for (int i = 0; i < MERGE_BATCH; ++i)
    a[i] = i < n_chunks ? acc[i * stride] : 0.f;
  __syncthreads();
  float mmax = NEG_INF;
  for (int c = 0; c < n_chunks; ++c)
    if (l_s[c] > 0.f) mmax = fmaxf(mmax, m_s[c]);
  float num = 0.f, den = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += MERGE_BATCH) {
    if (c0 > 0) {
#pragma unroll
      for (int i = 0; i < MERGE_BATCH; ++i)
        a[i] = c0 + i < n_chunks ? acc[(c0 + i) * stride] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i) {
      const int c = c0 + i;
      if (c < n_chunks && l_s[c] > 0.f) {
        const float f = expf(m_s[c] - mmax);
        num += f * a[i];
        den += f * l_s[c];
      }
    }
  }
  ctx[(size_t)row * D + d] = den > 0.f ? num / den : 0.f;
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* ok,
           void* ctx, void* ws, int B, int KV, int G, int Tn, int tpc,
           int n_chunks, float scale, cudaStream_t st) {
  const size_t smem = Cfg<D>::smem_bytes(sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      decode_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qg = (G + QR - 1) / QR;
  dim3 grid(n_chunks, KV * n_qg, B);
  decode_mma_kernel<T, D><<<grid, Cfg<D>::THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const unsigned char*>(ok),
      static_cast<float*>(ctx), static_cast<float*>(ws), KV, G, Tn, n_qg,
      tpc, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  // programmatic dependent launch: the merge CTAs are scheduled while the
  // chunk grid runs and wait in griddepcontrol.wait, so the second launch
  // overlaps the first kernel instead of following it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * G);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_merge_kernel,
                         static_cast<const float*>(ws),
                         static_cast<float*>(ctx), B * KV * G, n_chunks, D);
  return (int)e;
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kc, const void* vc,
               const void* ok, void* ctx, void* ws, int B, int KV, int G,
               int Tn, int tpc, int n_chunks, float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kc, vc, ok, ctx, ws, B, KV, G, Tn, tpc,
                           n_chunks, scale, st);
    case 64:
      return launch<T, 64>(q, kc, vc, ok, ctx, ws, B, KV, G, Tn, tpc,
                           n_chunks, scale, st);
    case 128:
      return launch<T, 128>(q, kc, vc, ok, ctx, ws, B, KV, G, Tn, tpc,
                            n_chunks, scale, st);
    case 256:
      return launch<T, 256>(q, kc, vc, ok, ctx, ws, B, KV, G, Tn, tpc,
                            n_chunks, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_decode_attention_mma(
    const void* q, const void* k_cache, const void* v_cache, const void* ok,
    void* ctx, void* ws, int B, int KV, int G, int D, int Tn, int tpc,
    int n_chunks, int dtype, float scale, void* stream) {
  const int n_tiles = (Tn + TILE - 1) / TILE;
  if (B <= 0 || B > 65535 || KV <= 0 || G <= 0 || Tn <= 0 || tpc <= 0 ||
      (long long)KV * ((G + QR - 1) / QR) > 65535 ||
      n_chunks != (n_tiles + tpc - 1) / tpc ||
      n_chunks > MERGE_MAX_CHUNKS || (n_chunks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, ok, ctx, ws,
                                       B, KV, G, Tn, tpc, n_chunks, scale,
                                       st);
    case 2:
      return dispatch_d<__half>(D, q, k_cache, v_cache, ok, ctx, ws, B, KV,
                                G, Tn, tpc, n_chunks, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
