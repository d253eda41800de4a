// Contiguous-cache decode attention for Hopper (sm_90a).
//
// Replaces: mobilefinetuner_tpu/ops/decode_attention.py `_decode_kernel`
// (launched by `decode_attention`): one query token per batch row attends
// its whole contiguous K/V cache [B, KV, T, D] under a [B, T] mask of
// attendable columns (validity, and the sliding window on Gemma's local
// layers: the caller composes it).
//
// Rounding follows the TPU kernel's oracle `xla_reference`: q is in the
// cache dtype (the wrapper refuses anything else), scores and the softmax
// statistics are f32, masked columns score NEG_INF and get probability
// exactly 0, the probabilities are cast to the cache dtype before P.V,
// which accumulates in f32. ctx is f32. One difference of order, inside
// the bf16 tolerance: the online softmax casts exp(s - m_running) and
// divides by the row sum at the end, where the oracle casts p / l.
//
// Bound on this card: memory. Each (b, kv-head) reads its T rows of K and
// V once, 2 * T * D * size bytes; the arithmetic is 4 * G * D flops a key
// (scores and P.V for G query heads), far below the tensor cores' rate.
//
// Design: an online softmax over T tiles, so any T runs (not only
// multiples of 8, and up to a 32,768-token Gemma context, which whole-T
// blocks in shared memory would not hold). One CTA of eight warps per
// (query head, b): grid (KV * G, B). The warps take 32-row tiles round
// robin; a tile with no attendable column is skipped before its K/V are
// read, which is exact because it would add 0. A tile's K rows are read
// as 16-byte vector loads (a row split over D * size / 16 lanes, or 32
// lanes with several loads each where a row is wider than 512 bytes:
// f32 at D = 256), each score reduced over its lanes with shuffles; the
// warp then updates its (m, l) and rescales its [D] accumulator, each lane
// holding D / 32 columns of ctx (one vector load of a V row). In P.V a row
// with probability 0 (masked) is selected out, not multiplied, so masked
// columns contribute exactly 0 whatever they hold (left-pad K/V,
// unwritten zeros, even non-finite values). Loops over a tile's rows are
// unrolled 8 deep, so a lane has 8 loads in flight. The warps
// merge their (m, l, acc) in shared memory at the end. A row with no
// attendable column gets ctx 0 (the generate path never makes one: the
// fed token's own column is always attendable).
//
// What holds it back: parallelism. The grid has B * KV * G CTAs: 96 at
// GPT-2 small's B 8 x 12 heads, 16 at Gemma-3-270M's B 4 x 1 kv head x 4
// query heads, on 132 SMs, each CTA walking its T alone, and the G query
// heads of one kv head each read the same K/V. bf16 and f16 caches run
// csrc/decode_attention_mma.cu (flash-decoding on the tensor cores); this
// source keeps f32.
//
// C interface (ctypes): mft_decode_attention returns the CUDA error code
// of the launch (0 on success). Shapes: q [B, KV, G, D] and the caches
// [B, KV, T, D] contiguous in f32 (dtype 0; any other is refused), the
// caches 16-byte aligned; ok [B, T] bool; ctx [B, KV, G, D] f32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int TILE = 32;   // cache rows a warp takes at a time (one a lane)
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// the register type of one vector load of B bytes
template <int B> struct VecT;
template <> struct VecT<2> { using type = unsigned short; };
template <> struct VecT<4> { using type = unsigned; };
template <> struct VecT<8> { using type = uint2; };
template <> struct VecT<16> { using type = uint4; };

// p rounded to the cache dtype (and back to f32 for the FMA)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, __half) {
  return __half2float(__float2half(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const unsigned char* __restrict__ ok,
              float* __restrict__ ctx, int KV, int G, int Tn, float scale) {
  constexpr int VEC = 16 / sizeof(T);                  // one 16-byte load
  constexpr int LPR = D / VEC < 32 ? D / VEC : 32;     // lanes on a K row
  constexpr int EPL = D / LPR;                         // its elements a lane
  constexpr int LOADS = EPL / VEC;                     // its loads a lane
  constexpr int RPP = 32 / LPR;                        // rows a warp a pass
  constexpr int DPL = D / 32;                          // ctx columns a lane
  constexpr int VB = DPL * (int)sizeof(T);             // its V bytes a row
  constexpr int VCH = VB < 16 ? VB : 16;               // one V load
  constexpr int NVL = VB / VCH;                        // V loads a row
  using VLoad = typename VecT<VCH>::type;
  static_assert(LPR >= 1 && 32 % LPR == 0 && TILE % RPP == 0, "row split");
  static_assert(EPL % VEC == 0 && DPL >= 1, "D in {32, 64, 128, 256}");

  __shared__ float s_tile[WARPS][TILE];   // a warp's scores, then probs
  __shared__ float m_sh[WARPS], l_sh[WARPS];
  __shared__ float acc_sh[WARPS][D];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvg = blockIdx.x, kv = kvg / G, b = blockIdx.y;
  const size_t qrow = ((size_t)b * KV * G + kvg) * D;
  const size_t cbase = ((size_t)b * KV + kv) * (size_t)Tn * D;
  const T* kp = kc + cbase;
  const T* vp = vc + cbase;
  const unsigned char* okr = ok + (size_t)b * Tn;
  const int d0 = (lane % LPR) * EPL;
  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = to_f32(q[qrow + d0 + e]);

  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float* sw = s_tile[warp];

  const int ntiles = (Tn + TILE - 1) / TILE;
  for (int tile = warp; tile < ntiles; tile += WARPS) {
    const int t0 = tile * TILE;
    const bool ok_lane = t0 + lane < Tn && okr[t0 + lane] != 0;
    if (!__any_sync(FULL, ok_lane)) continue;   // adds exactly 0: skip it

    // scores of the tile's rows, RPP rows a pass
#pragma unroll 8
    for (int r0 = 0; r0 < TILE; r0 += RPP) {
      const int r = r0 + lane / LPR, t = t0 + r;
      float part = 0.f;
      if (t < Tn && okr[t]) {
        const T* row = kp + (size_t)t * D + d0;
#pragma unroll
        for (int c = 0; c < LOADS; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row + c * VEC);
          const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part = fmaf(qv[c * VEC + e], to_f32(el[e]), part);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(FULL, part, off);
      if (lane % LPR == 0) sw[r] = part;
    }
    __syncwarp();

    // online softmax: lane j owns row t0 + j
    const float s = ok_lane ? sw[lane] * scale : NEG_INF;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = ok_lane ? expf(s - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(FULL, psum, off);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();
    sw[lane] = p;
    __syncwarp();

    // P.V over the tile's rows; a row with p == 0 (masked) is selected
    // out, not multiplied, so it contributes exactly 0
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    const int nrows = min(TILE, Tn - t0);
#pragma unroll 8
    for (int r = 0; r < nrows; ++r) {
      const float pr = sw[r];
      const float pc = round_to(pr, T());
      const VLoad* src = reinterpret_cast<const VLoad*>(
          vp + (size_t)(t0 + r) * D + lane * DPL);
      VLoad raw[NVL];
#pragma unroll
      for (int c = 0; c < NVL; ++c) raw[c] = src[c];
      const T* el = reinterpret_cast<const T*>(raw);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = pr != 0.f ? fmaf(pc, to_f32(el[i]), acc[i]) : acc[i];
    }
    __syncwarp();   // sw is rewritten by the next tile
  }

  if (lane == 0) {
    m_sh[warp] = m;
    l_sh[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc_sh[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  float mmax = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mmax = fmaxf(mmax, m_sh[w]);
  for (int d = threadIdx.x; d < D; d += WARPS * 32) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_sh[w] - mmax);
      num += f * acc_sh[w][d];
      den += f * l_sh[w];
    }
    ctx[qrow + d] = den > 0.f ? num / den : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const void* ok,
           void* ctx, int B, int KV, int G, int Tn, float scale,
           cudaStream_t st) {
  dim3 grid(KV * G, B);
  decode_kernel<T, D><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const unsigned char*>(ok),
      static_cast<float*>(ctx), KV, G, Tn, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kc, const void* vc,
               const void* ok, void* ctx, int B, int KV, int G, int Tn,
               float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kc, vc, ok, ctx, B, KV, G, Tn, scale, st);
    case 64:
      return launch<T, 64>(q, kc, vc, ok, ctx, B, KV, G, Tn, scale, st);
    case 128:
      return launch<T, 128>(q, kc, vc, ok, ctx, B, KV, G, Tn, scale, st);
    case 256:
      return launch<T, 256>(q, kc, vc, ok, ctx, B, KV, G, Tn, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* ok,
                                    void* ctx, int B, int KV, int G, int D,
                                    int Tn, int dtype, float scale,
                                    void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || G <= 0 || Tn <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0) return (int)cudaErrorInvalidValue;   // 16-bit: _mma.cu
  return dispatch_d<float>(D, q, k_cache, v_cache, ok, ctx, B, KV, G, Tn,
                           scale, static_cast<cudaStream_t>(stream));
}
