// Block-paged decode attention for Hopper (sm_90a), f32: a flash-decoding
// split that reads each live K/V row once for all of a kv head's query
// heads.
//
// Replaces: mobilefinetuner_tpu/ops/decode_attention.py `_paged_kernel`
// (launched by `paged_decode_attention`) for f32 pools, every CLI's
// default dtype: one query token per slot attends its pages of the shared
// block pool [NB, L, KV, bT, D], page tbl[s, m] of `layer`, under an
// [S, M * bT] mask of attendable columns (occupancy and any sliding
// window: the caller composes it). bf16 and f16 pools run
// csrc/paged_decode_attention_vec.cu; csrc/paged_decode_attention.cu, the
// f32 first version, is on no path (kept to time this source against).
//
// Rounding as the plain version (`paged_attention`) in f32: f32 scores,
// softmax and P.V (p needs no rounding to the pool dtype); masked columns
// get probability exactly 0. ctx is f32. A row with no attendable column
// gets ctx 0.
//
// Bound on this card: bytes. Each (slot, kv head) reads the K and V rows
// of its attendable columns once, 2 * D * 4 bytes a column: 6.2 MB at
// Gemma-3-270M serving's 8 slots x 42 pages (3,046 of 5,376 columns
// attendable), 1.9 us at 3.35 TB/s. The 4 G D FLOPs a column are 2 FLOPs
// a byte at G 4 (0.5 at G 1), a tenth of the ~20 FLOPs a byte where the
// f32 FMA units (67 TFLOP/s) would become the limit: plain FMA on the
// CUDA cores keeps up with the bytes, so no tensor cores and no 3xTF32.
//
// What the first version lost: it ran one CTA of four warps per (query
// head, slot), 32 CTAs on 132 SMs at Gemma serving, each walking its
// slot's pages as a chain of dependent round trips, and each of Gemma's
// four query heads of a kv head read the same pages again (71.62 us,
// 38x the bound). Here, with csrc/decode_split_f32.cuh:
// - One CTA per (kv head x group of up to 4 query heads, chunk of `cpc`
//   logical columns, slot) scores each K row against all of its query
//   heads, so each live row is read once. The chunk count comes from
//   ops/decode_attention.paged_f32_plan, from shapes only (never from
//   the mask or the table, so a CUDA graph can capture the launch): the
//   most chunks that keep the CTAs within one wave of the SMs, but at
//   least one round's rows a chunk, whole pages a chunk where they fit;
//   Gemma serving's 8 slots x 1 kv head are 14 chunks of 3 pages (112
//   CTAs of 8 warps; 12 or 19 chunks took 7-8% longer on an H100).
// - Two dependent round trips a round: each lane loads its rows' mask
//   bytes and table entries (clamped to [0, NB) as an XLA gather clamps)
//   together, then the K and V pieces of all of its live rows as 16-byte
//   loads, 24 in flight a lane, before the first use. No shared-memory
//   staging: a round's 48 rows of D 256 sit in registers (a cp.async copy
//   of the round into shared memory took 13.8 us against 13.0 on an
//   H100; loads that bypass L1 took 13.0, no gain).
// - A masked row, and so a page with no attendable column, is never
//   read: its registers stay 0, its score is selected to NEG_INF and its
//   P.V skipped, so it adds exactly 0 whatever the pool holds there (Inf,
//   NaN, another slot's page, the trash page).
// - Each warp keeps an online softmax over its rows (a chunk longer than
//   one round loops); the warps' partials meet in shared memory in warp
//   order after one barrier. The chunks' partials (m, l, acc) go to a
//   workspace and are merged in chunk order, so two calls give identical
//   bits (no atomics on ctx). The merge is a second kernel launched as a
//   programmatic dependent (PDL), as the 16-bit sources do, rather than
//   the last CTA of a row merging behind a counter: a last-CTA merge took
//   29.5-30.8 us here on an H100 against 13.0 (its one CTA walks every
//   chunk's partials alone, after all the others), PDL keeps no state
//   between calls (a counter must start at 0 in every replay of a graph,
//   after a failed call and on every stream), its CTAs are resident
//   before the chunk grid ends, and its capture in a CUDA graph works on
//   the card (csrc/decode_attention_mma.cu's merge). A one-chunk plan
//   writes ctx itself and launches no merge.
//
// C interface (ctypes): mft_paged_decode_attention_vec_f32 returns the
// CUDA error code of the launches (0 on success). q [S, KV, G, D] and the
// pools [NB, L, KV, bT, D] contiguous in f32 (dtype 0; any other is
// refused), 16-byte aligned; tbl [S, M] int32; ok [S, M * bT] bool; ctx
// [S, KV, G, D] f32; ws n_chunks * S * KV * G * (D + 2) floats (null for
// one chunk); cpc logical columns a chunk, n_chunks = ceil(M * bT / cpc)
// <= 4096; D in {64, 128, 256}.

#include "decode_split_f32.cuh"

namespace {

// the K/V row of logical column `col` of slot s: page tbl[s, col / bT]
// of `layer`, row col % bT
struct PagedRows {
  static constexpr bool kD32 = false;
  const int* tbl;
  int NB, L, layer, bT, M, KV;
  __device__ __forceinline__ int entry(int s, int col) const {
    return tbl[(size_t)s * M + col / bT];
  }
  __device__ __forceinline__ size_t row(int, int kv, int col,
                                        int ent) const {
    const int blk = min(max(ent, 0), NB - 1);
    return (((size_t)blk * L + layer) * KV + kv) * bT + col % bT;
  }
};

}  // namespace

extern "C" int mft_paged_decode_attention_vec_f32(
    const void* q, const void* pool_k, const void* pool_v, const void* tbl,
    const void* ok, void* ctx, void* ws, int S, int KV, int G, int D, int NB,
    int L, int layer, int bT, int M, int cpc, int n_chunks, int dtype,
    float scale, void* stream) {
  const long long cols = (long long)M * bT;
  if (dtype != 0 || (D != 64 && D != 128 && D != 256) || NB <= 0 ||
      bT <= 0 || M <= 0 || layer < 0 || layer >= L ||
      !split_f32::plan_ok(cols, S, KV, G, cpc, n_chunks, ws))
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(tbl), NB, L, layer, bT, M,
                       KV};
  return split_f32::dispatch_d(D, q, pool_k, pool_v, ok, ctx, ws, rows, S,
                               KV, G, (int)cols, cpc, n_chunks, scale,
                               stream);
}
