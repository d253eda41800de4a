// The f32 flash-decoding split for Hopper (sm_90a), shared by row 12's
// csrc/paged_decode_attention_vec_f32.cu and row 13's
// csrc/decode_attention_split_f32.cu: the chunk kernel, the merge kernel
// and their launch, over a `Rows` policy that maps a (slot or batch row,
// kv head, logical column) to the index of its K/V row in the cache. The
// design and its reasons are in those sources' notes.
//
// One CTA per (kv head x group of up to MAX_QG query heads, chunk of
// `cpc` logical columns, slot): grid (KV * n_qg, n_chunks, S), so any KV
// and G the first versions took still fit (grid x up to 2^31 - 1), and
// warps_for(QG) warps a CTA. A row of D floats is D / 8 lanes, each
// holding 8 floats of it as two 16-byte loads (elements [4 c, 4 c + 4)
// and [D / 2 + 4 c, D / 2 + 4 c + 4) of lane piece c), so each load
// instruction of a row's lanes reads 2 D contiguous bytes. A warp takes
// 256 / D rows a pass; a round is ROW_SLOTS / WARPS passes, every load of
// a round issued before its first use (the mask bytes and the table
// entries, then the K and V rows of the live columns). A chunk longer
// than a round loops over rounds with a per-warp online softmax (the
// plans make one round the rule at the paths' shapes).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace split_f32 {

constexpr int ROW_SLOTS = 48;      // warps x passes: the rows of a round
constexpr int MAX_QG = 4;          // query heads a CTA
constexpr int MAX_CHUNKS = 4096;   // the merge's (m, l) in shared memory
constexpr int MERGE_BATCH = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

// warps a CTA: 8 x 6 passes with four query heads (whose q and acc take
// more registers), 16 x 3 with one or two
__host__ __device__ constexpr int warps_for(int QG) {
  return QG == 4 ? 8 : 16;
}

// query heads a CTA for G query heads a kv head (the QG instantiations)
__host__ __device__ constexpr int qg_for(int G) {
  return G == 1 ? 1 : G == 2 ? 2 : MAX_QG;
}

// the bytes of shared memory: the warps' maxima and row sums [2][WARPS]
// [QG] and acc [WARPS][QG][D], f32
__host__ __device__ __forceinline__ size_t smem_bytes(int D, int QG) {
  return ((size_t)2 * warps_for(QG) * QG +
          (size_t)warps_for(QG) * QG * D) * 4;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int D, int QG, class Rows>
__global__ void __launch_bounds__(32 * warps_for(QG))
split_kernel(const float* __restrict__ q, const float* __restrict__ kc,
             const float* __restrict__ vc,
             const unsigned char* __restrict__ ok, float* __restrict__ ctx,
             float* __restrict__ ws, const Rows rows_of, int KV, int G,
             int n_qg, int cols, int cpc, float scale) {
  constexpr int WARPS = warps_for(QG), THREADS = 32 * WARPS;
  constexpr int PASSES = ROW_SLOTS / WARPS;
  constexpr int LPR = D / 8;          // lanes on a row: 8 floats each
  constexpr int RPP = 32 / LPR;       // rows a warp a pass
  constexpr int ROWS = WARPS * RPP;   // rows a CTA a pass
  constexpr int RND = PASSES * ROWS;  // rows a CTA a round
  constexpr int HALF = D / 2;         // a lane's second 16 bytes
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "D in {32, 64, 128, 256}");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_s = reinterpret_cast<float*>(smem_raw);   // [WARPS][QG]
  float* l_s = m_s + WARPS * QG;                      // [WARPS][QG]
  float* acc_s = l_s + WARPS * QG;                    // [WARPS][QG][D]
  const int kv = blockIdx.x / n_qg, g0 = (blockIdx.x % n_qg) * QG;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cl = lane % LPR, rg = lane / LPR;   // piece, row of a pass
  const int nq = min(QG, G - g0);               // query heads here
  const int c0 = chunk * cpc, rows = min(cpc, cols - c0);
  const int r0 = warp * RPP + rg;               // the lane's first row

  // the merge grid may launch now: it waits for this grid to complete
  asm volatile("griddepcontrol.launch_dependents;");

  // q's 8 elements of this lane's piece, each head (q is only 4-byte
  // aligned in the contiguous wrapper: scalar loads, once a CTA)
  float qv[QG][8];
  const size_t qrow0 = ((size_t)s * KV + kv) * G + g0;
#pragma unroll
  for (int g = 0; g < QG; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qv[g][i] = g < nq ? q[(qrow0 + g) * D + (i >> 2) * HALF + cl * 4 +
                            (i & 3)]
                        : 0.f;

  // this warp's online softmax state, each head
  float m[QG], l[QG], acc[QG][8];
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const unsigned char* okr = ok + (size_t)s * cols + c0;
  for (int base = 0; base < rows; base += RND) {
    // 1. each pass's mask byte and table entry: all loads in flight
    bool live[PASSES];
    int ent[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = base + r0 + p * ROWS;
      live[p] = r < rows && okr[r] != 0;
      ent[p] = r < rows ? rows_of.entry(s, c0 + r) : 0;
    }

    // 2. every live row's K and V pieces, all issued before the first
    // use; a masked row is never read (zeros)
    float4 kr[PASSES][2], vr[PASSES][2];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      kr[p][0] = kr[p][1] = vr[p][0] = vr[p][1] =
          make_float4(0.f, 0.f, 0.f, 0.f);
      if (live[p]) {
        const size_t off =
            rows_of.row(s, kv, c0 + base + r0 + p * ROWS, ent[p]) * D +
            cl * 4;
        kr[p][0] = *reinterpret_cast<const float4*>(kc + off);
        kr[p][1] = *reinterpret_cast<const float4*>(kc + off + HALF);
        vr[p][0] = *reinterpret_cast<const float4*>(vc + off);
        vr[p][1] = *reinterpret_cast<const float4*>(vc + off + HALF);
      }
    }

    // 3. scores: a row's LPR lanes each dot their piece, a shuffle sum
    // leaves the row's score in all of them; masked rows are selected to
    // NEG_INF; the warp's max of each head
    float sc[PASSES][QG], mx[QG];
#pragma unroll
    for (int g = 0; g < QG; ++g) mx[g] = NEG_INF;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
#pragma unroll
      for (int g = 0; g < QG; ++g) sc[p][g] = NEG_INF;
      if (base + warp * RPP + p * ROWS >= rows) continue;   // warp-uniform
      float part[QG];
#pragma unroll
      for (int g = 0; g < QG; ++g) part[g] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float kf = comp(kr[p][i >> 2], i & 3);
#pragma unroll
        for (int g = 0; g < QG; ++g) part[g] = fmaf(qv[g][i], kf, part[g]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < QG; ++g)
          part[g] += __shfl_xor_sync(FULL, part[g], off);
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        sc[p][g] = live[p] ? part[g] * scale : NEG_INF;
        mx[g] = fmaxf(mx[g], sc[p][g]);
      }
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < QG; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(FULL, mx[g], off));

    // 4. the warp's running (m, l, acc) rescaled to the round's max, then
    // P.V in registers: p = exp(s - m) (f32 needs no rounding of p); a
    // masked row is skipped, so it adds exactly 0 whatever it holds
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      if (!live[p]) continue;
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        const float pv = expf(sc[p][g] - m[g]);
        l[g] += pv;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[g][i] = fmaf(pv, comp(vr[p][i >> 2], i & 3), acc[g][i]);
      }
    }
  }

  // 5. the warp's row groups summed by shuffles (they share the warp's
  // max), the warps' partials to shared memory
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[g][i] += __shfl_xor_sync(FULL, acc[g][i], off);
    }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      float* dst = acc_s + (warp * QG + g) * D + cl * 4;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      *reinterpret_cast<float4*>(dst + HALF) =
          make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      if (cl == 0) {
        m_s[warp * QG + g] = m[g];
        l_s[warp * QG + g] = l[g];
      }
    }
  }
  __syncthreads();

  // 6. the warps' partials merged in warp order (a warp with l = 0 is
  // selected out): ctx (one chunk) or the chunk's (m, l, acc)
  const size_t rows_total = (size_t)gridDim.z * KV * G;
  for (int i = tid; i < nq * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mg = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (l_s[w * QG + g] > 0.f) mg = fmaxf(mg, m_s[w * QG + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float lw = l_s[w * QG + g];
      if (lw > 0.f) {
        const float f = expf(m_s[w * QG + g] - mg);
        num = fmaf(f, acc_s[(w * QG + g) * D + d], num);
        den = fmaf(f, lw, den);
      }
    }
    const size_t row = qrow0 + g;
    if (n_chunks == 1) {
      ctx[row * D + d] = den > 0.f ? num / den : 0.f;
    } else {
      const size_t rc = (size_t)chunk * rows_total + row;
      ws[(size_t)n_chunks * rows_total * 2 + rc * D + d] = num;
      if (d == 0) {
        ws[rc * 2] = mg;
        ws[rc * 2 + 1] = den;
      }
    }
  }
}

// ctx [row, d] from the chunks' partials, in chunk order; a chunk with
// l = 0 (no attendable column) is selected out, not multiplied. One CTA
// of D threads a row: the chunks' (m, l) staged in shared memory and a
// thread's acc values of up to MERGE_BATCH chunks loaded into registers,
// all before the one barrier, so their latencies overlap.
__global__ void merge_kernel(const float* __restrict__ ws,
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
        num = fmaf(f, a[i], num);
        den = fmaf(f, l_c[c], den);
      }
    }
  }
  ctx[(size_t)row * D + d] = den > 0.f ? num / den : 0.f;
}

template <int D, int QG, class Rows>
int launch(const float* q, const float* kc, const float* vc,
           const unsigned char* ok, float* ctx, float* ws,
           const Rows& rows_of, int S, int KV, int G, int cols, int cpc,
           int n_chunks, float scale, cudaStream_t st) {
  const int n_qg = (G + QG - 1) / QG;
  dim3 grid(KV * n_qg, n_chunks, S);
  // under the default 48 KB: 33,024 bytes at D 256
  split_kernel<D, QG, Rows><<<grid, 32 * warps_for(QG),
                              smem_bytes(D, QG), st>>>(
      q, kc, vc, ok, ctx, ws, rows_of, KV, G, n_qg, cols, cpc, scale);
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
  e = cudaLaunchKernelEx(&cfg, merge_kernel, static_cast<const float*>(ws),
                         ctx, S * KV * G, n_chunks, D);
  return (int)e;
}

template <int D, class Rows>
int dispatch_g(const float* q, const float* kc, const float* vc,
               const unsigned char* ok, float* ctx, float* ws,
               const Rows& rows_of, int S, int KV, int G, int cols, int cpc,
               int n_chunks, float scale, cudaStream_t st) {
  if (G == 1)
    return launch<D, 1>(q, kc, vc, ok, ctx, ws, rows_of, S, KV, G, cols,
                        cpc, n_chunks, scale, st);
  if (G == 2)
    return launch<D, 2>(q, kc, vc, ok, ctx, ws, rows_of, S, KV, G, cols,
                        cpc, n_chunks, scale, st);
  return launch<D, MAX_QG>(q, kc, vc, ok, ctx, ws, rows_of, S, KV, G, cols,
                           cpc, n_chunks, scale, st);
}

// D outside the instantiations is refused, and D 32 where the rows policy
// does not take it (Rows::kD32: the paged pools' entry refuses D 32, so
// its library builds no kernel for it)
template <class Rows>
int dispatch_d(int D, const void* q, const void* kc, const void* vc,
               const void* ok, void* ctx, void* ws, const Rows& rows_of,
               int S, int KV, int G, int cols, int cpc, int n_chunks,
               float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(kc);
  const float* vf = static_cast<const float*>(vc);
  const unsigned char* okb = static_cast<const unsigned char*>(ok);
  float* cf = static_cast<float*>(ctx);
  float* wf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      if constexpr (Rows::kD32)
        return dispatch_g<32>(qf, kf, vf, okb, cf, wf, rows_of, S, KV, G,
                              cols, cpc, n_chunks, scale, st);
      return (int)cudaErrorInvalidValue;
    case 64:
      return dispatch_g<64>(qf, kf, vf, okb, cf, wf, rows_of, S, KV, G, cols,
                            cpc, n_chunks, scale, st);
    case 128:
      return dispatch_g<128>(qf, kf, vf, okb, cf, wf, rows_of, S, KV, G,
                             cols, cpc, n_chunks, scale, st);
    case 256:
      return dispatch_g<256>(qf, kf, vf, okb, cf, wf, rows_of, S, KV, G,
                             cols, cpc, n_chunks, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the launch arguments every entry checks: a plan of n_chunks chunks of
// cpc columns over `cols`, at most MAX_CHUNKS, a workspace for more than
// one, the grid's x (KV x the query-head groups) and z (S) in range
inline bool plan_ok(long long cols, int S, int KV, int G, int cpc,
                    int n_chunks, const void* ws) {
  if (S <= 0 || S > 65535 || KV <= 0 || G <= 0 || cols <= 0 ||
      cols > 0x7fffffffLL || cpc <= 0)
    return false;
  const long long n_qg = (G + qg_for(G) - 1) / qg_for(G);
  return (long long)KV * n_qg <= 0x7fffffffLL &&
         (long long)S * KV * G <= 0x7fffffffLL &&
         n_chunks == (cols + cpc - 1) / cpc && n_chunks <= MAX_CHUNKS &&
         (n_chunks == 1 || ws != nullptr);
}

}  // namespace split_f32

}  // namespace
