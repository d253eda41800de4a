// Block-paged decode attention for Hopper (sm_90a), bf16 and f16: each
// lane loads its own rows' K and V straight into registers, all at once.
//
// Replaces: mobilefinetuner_tpu/ops/decode_attention.py `_paged_kernel`
// (launched by `paged_decode_attention`) for 16-bit pools: one query token
// per slot attends its pages of the shared block pool [NB, L, KV, bT, D],
// page tbl[s, m] of `layer`, under an [S, M * bT] mask of attendable
// columns (occupancy and any sliding window: the caller composes it). f32
// pools stay on csrc/paged_decode_attention.cu.
//
// Rounding as the plain version (`paged_attention`): f32 scores and
// softmax statistics, masked columns get probability exactly 0, p rounded
// to the pool dtype before P.V, which accumulates in f32; the row sum l
// adds the unrounded p and divides at the end. ctx is f32. A row with no
// attendable column gets ctx 0.
//
// Bound on this card: bytes, and before that the latency of dependent
// memory round trips. Each (slot, kv head) reads the K and V rows of its
// attendable columns once (2 * D * size bytes a column); the 4 G D FLOPs
// a column are far below any unit's rate. The first version ran one CTA
// per query head (Gemma's 4 heads of a kv head each read its pages) and
// walked each page as a chain of round trips (the mask, the table entry,
// K, the softmax, V) with nothing in flight ahead of it. Here:
// - One CTA per (chunk of logical columns, kv head, group of up to 4 query
//   heads, slot) takes all of its query heads (G <= 4: every Gemma-3), so
//   each live page is read once. The chunk count comes from
//   ops/decode_attention.paged_plan, from shapes only: the most chunks
//   that keep the CTAs within one wave of the SMs, whole pages a chunk
//   where they fit, at most ROW_SLOTS passes of rows a chunk. GPT-2's
//   serve step (8 slots x 12 heads) is one chunk, Gemma's 8 slots x 1 kv
//   head are 14 chunks of 3 pages at T 672.
// - A row is D / 8 lanes of 16 bytes each; a warp takes 256 / D rows a
//   pass and at most ROW_SLOTS / WARPS passes (16 warps x 6, or 8 x 12
//   with four query heads, whose q and acc take more registers). Two
//   dependent round trips a CTA: each lane loads its rows' mask bytes and
//   table entries (clamped to [0, NB) as an XLA gather clamps) with its
//   16-byte piece of q, then the K and V pieces of all of its live rows,
//   every load issued before the first use. No shared-memory staging.
// - A masked row is never read: its K and V registers stay 0, its score
//   is NEG_INF and its p exactly 0, so it adds exactly 0 whatever the pool
//   holds there (Inf, NaN, another slot's page, the trash page). A page
//   with no attendable column reads no K/V.
// - Scores: a shuffle sum over the row's lanes leaves the score in each
//   of them; the warps' maxima meet in shared memory (one barrier), so
//   every warp exponentiates against the chunk's max; P.V and l in
//   registers, the row groups of a warp summed by shuffles, the warps'
//   (l, acc) in warp order after a second barrier. The chunks' partials
//   (m, l, acc) are merged in chunk order by a kernel launched as a
//   programmatic dependent (PDL), so two calls are bit-identical. A
//   one-chunk plan writes ctx itself and launches no merge.
//
// C interface (ctypes): mft_paged_decode_attention_vec returns the CUDA
// error code of the launches (0 on success). q [S, KV, G, D] and the pools
// [NB, L, KV, bT, D] contiguous in one dtype (1 bf16, 2 f16), 16-byte
// aligned; tbl [S, M] int32; ok [S, M * bT] bool; ctx [S, KV, G, D] f32;
// ws n_chunks * S * KV * G * (D + 2) floats (null for one chunk); cpc
// logical columns a chunk (cpc * D <= ROW_SLOTS * 256), n_chunks =
// ceil(M * bT / cpc).

#include "flash_attention_common.cuh"
#include "tensor_core.cuh"   // round_to

namespace {

using mft::NEG_INF;
using mft::round_to;
using mft::to_f32;

// warps a CTA; each lane holds the K and V pieces of ROW_SLOTS / warps
// rows (passes) in registers: 16 x 6 where q and acc are small, 8 x 12
// with four query heads
__host__ __device__ constexpr int warps_for(int QG) {
  return QG == 4 ? 8 : 16;
}
constexpr int ROW_SLOTS = 96;       // warps x passes
constexpr int MAX_QG = 4;           // query heads a CTA
constexpr int MAX_CHUNKS = 4096;    // the merge's (m, l) in shared memory
constexpr int MERGE_BATCH = 32;
constexpr unsigned FULL = 0xffffffffu;

// the bytes of shared memory: the warps' maxima and row sums [2][WARPS]
// [QG] and acc [WARPS][QG][D], f32
__host__ __device__ __forceinline__ size_t smem_bytes(int D, int QG) {
  return ((size_t)2 * warps_for(QG) * QG +
          (size_t)warps_for(QG) * QG * D) * 4;
}

template <typename T, int D, int QG>
__global__ void __launch_bounds__(32 * warps_for(QG))
paged_vec_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                 const T* __restrict__ pool_v, const int* __restrict__ tbl,
                 const unsigned char* __restrict__ ok,
                 float* __restrict__ ctx, float* __restrict__ ws, int KV,
                 int G, int NB, int L, int layer, int bT, int M, int n_qg,
                 int cpc, float scale) {
  constexpr int WARPS = warps_for(QG), THREADS = 32 * WARPS;
  constexpr int MAX_PASSES = ROW_SLOTS / WARPS;
  constexpr int LPR = D / 8;        // lanes on a row: 16 bytes each
  constexpr int RPP = 32 / LPR;     // rows a warp a pass
  constexpr int ROWS = WARPS * RPP; // rows a CTA a pass
  static_assert(D == 64 || D == 128 || D == 256, "D in {64, 128, 256}");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_s = reinterpret_cast<float*>(smem_raw);   // [WARPS][QG]
  float* l_s = m_s + WARPS * QG;                      // [WARPS][QG]
  float* acc_s = l_s + WARPS * QG;                    // [WARPS][QG][D]
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int kv = blockIdx.y / n_qg, g0 = (blockIdx.y % n_qg) * QG;
  const int s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cl = lane % LPR, rg = lane / LPR;   // piece, row of a pass
  const int nq = min(QG, G - g0);               // query heads here
  const int Tc = M * bT;
  const int c0 = chunk * cpc, rows = min(cpc, Tc - c0);
  const int r0 = warp * RPP + rg;               // the lane's first row

  // the merge grid may launch now: it waits for this grid to complete
  asm volatile("griddepcontrol.launch_dependents;");

  // 1. q's piece of each head, each pass's mask byte and table entry:
  // all loads in flight at once
  float qv[QG][8];
  const size_t qrow0 = ((size_t)s * KV + kv) * G + g0;
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (g < nq)
      raw = *reinterpret_cast<const uint4*>(q + (qrow0 + g) * D + cl * 8);
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[g][e] = to_f32(el[e]);
  }
  const unsigned char* okr = ok + (size_t)s * Tc + c0;
  const int* trow = tbl + (size_t)s * M;
  bool live[MAX_PASSES];
  int ent[MAX_PASSES], pg[MAX_PASSES];
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
    const int r = r0 + p * ROWS;
    pg[p] = (c0 + r) / bT;
    live[p] = r < rows && okr[r] != 0;
    ent[p] = r < rows ? trow[pg[p]] : 0;
  }

  // 2. every live row's K and V piece into registers, all loads issued
  // before the first use; a masked row is not read (zeros)
  uint4 kr[MAX_PASSES], vr[MAX_PASSES];
  const size_t lane_off = ((size_t)layer * KV + kv) * bT * D + cl * 8;
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
    kr[p] = vr[p] = make_uint4(0u, 0u, 0u, 0u);
    if (live[p]) {
      const int blk = min(max(ent[p], 0), NB - 1);
      const int t = c0 + r0 + p * ROWS - pg[p] * bT;
      const size_t off =
          (size_t)blk * L * KV * bT * D + lane_off + (size_t)t * D;
      kr[p] = *reinterpret_cast<const uint4*>(pool_k + off);
      vr[p] = *reinterpret_cast<const uint4*>(pool_v + off);
    }
  }

  // 3. scores: a row's LPR lanes each dot their piece, a shuffle sum
  // leaves the row's score in all of them; the warp's max of each head
  float sc[MAX_PASSES][QG], m[QG];
#pragma unroll
  for (int g = 0; g < QG; ++g) m[g] = NEG_INF;
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
#pragma unroll
    for (int g = 0; g < QG; ++g) sc[p][g] = NEG_INF;
    if (warp * RPP + p * ROWS >= rows) continue;   // warp-uniform
    const T* el = reinterpret_cast<const T*>(&kr[p]);
    float part[QG];
#pragma unroll
    for (int g = 0; g < QG; ++g) part[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float kf = to_f32(el[e]);
#pragma unroll
      for (int g = 0; g < QG; ++g) part[g] = fmaf(qv[g][e], kf, part[g]);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < QG; ++g)
        part[g] += __shfl_xor_sync(FULL, part[g], off);
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      sc[p][g] = live[p] ? part[g] * scale : NEG_INF;
      m[g] = fmaxf(m[g], sc[p][g]);
    }
  }
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < QG; ++g)
      m[g] = fmaxf(m[g], __shfl_xor_sync(FULL, m[g], off));
  // the chunk's max of each head: the warps' maxima meet in shared memory
  if (lane < QG) {
    float v = m[0];
#pragma unroll
    for (int g = 1; g < QG; ++g)
      if (lane == g) v = m[g];
    m_s[warp * QG + lane] = v;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    m[g] = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m[g] = fmaxf(m[g], m_s[w * QG + g]);
  }

  // 4. P.V in registers: p = exp(s - m) (rounded to T for the product,
  // unrounded in l), then the row groups' sums by shuffles
  float l[QG], acc[QG][8];
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
    if (!live[p]) continue;
    const T* el = reinterpret_cast<const T*>(&vr[p]);
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      const float pv = expf(sc[p][g] - m[g]);
      l[g] += pv;
      const float pr = round_to<T>(pv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] = fmaf(pr, to_f32(el[e]), acc[g][e]);
    }
  }
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      float4* dst = reinterpret_cast<float4*>(
          acc_s + (warp * QG + g) * D + cl * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      if (cl == 0) l_s[warp * QG + g] = l[g];
    }
  }
  __syncthreads();

  // 5. the warps' partials summed in warp order: ctx (one chunk) or the
  // chunk's partials
  const size_t rows_total = (size_t)gridDim.z * KV * G;
  for (int i = tid; i < nq * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mg = NEG_INF, a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mg = fmaxf(mg, m_s[w * QG + g]);
      a += acc_s[(w * QG + g) * D + d];
      lsum += l_s[w * QG + g];
    }
    const size_t row = qrow0 + g;
    if (n_chunks == 1) {
      ctx[row * D + d] = lsum > 0.f ? a / lsum : 0.f;
    } else {
      const size_t rc = (size_t)chunk * rows_total + row;
      ws[(size_t)n_chunks * rows_total * 2 + rc * D + d] = a;
      if (d == 0) {
        ws[rc * 2] = mg;
        ws[rc * 2 + 1] = lsum;
      }
    }
  }
}

// ctx [row, d] from the chunks' partials, in chunk order; a chunk with
// l = 0 (no attendable column) is selected out, not multiplied. One CTA
// of D threads a row: the chunks' (m, l) staged in shared memory and a
// thread's acc values of up to MERGE_BATCH chunks loaded into registers,
// all before the one barrier, so their latencies overlap.
__global__ void paged_merge_kernel(const float* __restrict__ ws,
                                   float* __restrict__ ctx, int rows_total,
                                   int n_chunks, int D) {
  extern __shared__ float ml_s[];   // m [n_chunks], then l [n_chunks]
  // launched as a programmatic dependent of the chunk grid: wait for its
  // partials (a no-op under an ordinary launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = blockIdx.x, d = threadIdx.x;
  const float* acc = ws + (size_t)n_chunks * rows_total * 2 +
                     (size_t)row * D + d;
  const size_t stride = (size_t)rows_total * D;   // between chunks
  for (int c = d; c < n_chunks; c += blockDim.x) {
    const size_t r = (size_t)c * rows_total + row;
    ml_s[c] = ws[r * 2];
    ml_s[n_chunks + c] = ws[r * 2 + 1];
  }
  float a[MERGE_BATCH];
#pragma unroll
  for (int i = 0; i < MERGE_BATCH; ++i)
    a[i] = i < n_chunks ? acc[i * stride] : 0.f;
  __syncthreads();
  const float* l_c = ml_s + n_chunks;
  float mmax = NEG_INF;
  for (int c = 0; c < n_chunks; ++c)
    if (l_c[c] > 0.f) mmax = fmaxf(mmax, ml_s[c]);
  float num = 0.f, den = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += MERGE_BATCH) {
    if (c0 > 0) {
#pragma unroll
      for (int i = 0; i < MERGE_BATCH; ++i)
        a[i] = c0 + i < n_chunks ? acc[(size_t)(c0 + i) * stride] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i) {
      const int c = c0 + i;
      if (c < n_chunks && l_c[c] > 0.f) {
        const float f = expf(ml_s[c] - mmax);
        num += f * a[i];
        den += f * l_c[c];
      }
    }
  }
  ctx[(size_t)row * D + d] = den > 0.f ? num / den : 0.f;
}

template <typename T, int D, int QG>
int launch(const void* q, const void* pk, const void* pv, const void* tbl,
           const void* ok, void* ctx, void* ws, int S, int KV, int G, int NB,
           int L, int layer, int bT, int M, int cpc, int n_chunks,
           float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(D, QG);   // under the default 48 KB
  const int n_qg = (G + QG - 1) / QG;
  dim3 grid(n_chunks, KV * n_qg, S);
  paged_vec_kernel<T, D, QG><<<grid, 32 * warps_for(QG), smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(tbl),
      static_cast<const unsigned char*>(ok), static_cast<float*>(ctx),
      static_cast<float*>(ws), KV, G, NB, L, layer, bT, M, n_qg, cpc, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  // programmatic dependent launch: the merge CTAs are scheduled while the
  // chunk grid runs and wait in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * KV * G);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = (size_t)2 * n_chunks * sizeof(float);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_merge_kernel,
                         static_cast<const float*>(ws),
                         static_cast<float*>(ctx), S * KV * G, n_chunks, D);
  return (int)e;
}

template <typename T, int D>
int dispatch_g(const void* q, const void* pk, const void* pv,
               const void* tbl, const void* ok, void* ctx, void* ws, int S,
               int KV, int G, int NB, int L, int layer, int bT, int M,
               int cpc, int n_chunks, float scale, cudaStream_t st) {
  if (G == 1)
    return launch<T, D, 1>(q, pk, pv, tbl, ok, ctx, ws, S, KV, G, NB, L,
                           layer, bT, M, cpc, n_chunks, scale, st);
  if (G == 2)
    return launch<T, D, 2>(q, pk, pv, tbl, ok, ctx, ws, S, KV, G, NB, L,
                           layer, bT, M, cpc, n_chunks, scale, st);
  return launch<T, D, MAX_QG>(q, pk, pv, tbl, ok, ctx, ws, S, KV, G, NB, L,
                              layer, bT, M, cpc, n_chunks, scale, st);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* pk, const void* pv,
               const void* tbl, const void* ok, void* ctx, void* ws, int S,
               int KV, int G, int NB, int L, int layer, int bT, int M,
               int cpc, int n_chunks, float scale, cudaStream_t st) {
  switch (D) {
    case 64:
      return dispatch_g<T, 64>(q, pk, pv, tbl, ok, ctx, ws, S, KV, G, NB, L,
                               layer, bT, M, cpc, n_chunks, scale, st);
    case 128:
      return dispatch_g<T, 128>(q, pk, pv, tbl, ok, ctx, ws, S, KV, G, NB,
                                L, layer, bT, M, cpc, n_chunks, scale, st);
    case 256:
      return dispatch_g<T, 256>(q, pk, pv, tbl, ok, ctx, ws, S, KV, G, NB,
                                L, layer, bT, M, cpc, n_chunks, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_paged_decode_attention_vec(
    const void* q, const void* pool_k, const void* pool_v, const void* tbl,
    const void* ok, void* ctx, void* ws, int S, int KV, int G, int D, int NB,
    int L, int layer, int bT, int M, int cpc, int n_chunks, int dtype,
    float scale, void* stream) {
  const int qg = G == 1 ? 1 : G == 2 ? 2 : MAX_QG;
  if (S <= 0 || S > 65535 || KV <= 0 || G <= 0 || NB <= 0 || bT <= 0 ||
      M <= 0 || layer < 0 || layer >= L || cpc <= 0 ||
      (long long)KV * ((G + qg - 1) / qg) > 65535 ||
      (long long)cpc * D > (long long)ROW_SLOTS * 256 ||
      n_chunks != (M * bT + cpc - 1) / cpc || n_chunks > MAX_CHUNKS ||
      (n_chunks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, pool_k, pool_v, tbl, ok, ctx,
                                       ws, S, KV, G, NB, L, layer, bT, M,
                                       cpc, n_chunks, scale, st);
    case 2:
      return dispatch_d<__half>(D, q, pool_k, pool_v, tbl, ok, ctx, ws, S,
                                KV, G, NB, L, layer, bT, M, cpc, n_chunks,
                                scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
