// Contiguous-cache decode attention for Hopper (sm_90a), f32: a
// flash-decoding split that reads each K/V row once for all of a kv
// head's query heads.
//
// Replaces: mobilefinetuner_tpu/ops/decode_attention.py `_decode_kernel`
// (launched by `decode_attention`) for f32 caches, every CLI's default
// dtype: one query token per batch row attends its whole contiguous K/V
// cache [B, KV, T, D] under a [B, T] mask of attendable columns (validity
// and, on Gemma's local layers, the sliding window: the caller composes
// it). bf16 and f16 caches run csrc/decode_attention_mma.cu;
// csrc/decode_attention.cu, the f32 first version, is on no path (kept to
// time this source against).
//
// Rounding as the oracle `xla_reference` in f32: f32 scores, softmax and
// P.V (the cast of p to the cache dtype is the identity); masked columns
// score NEG_INF and get probability exactly 0. ctx is f32. A row with no
// attendable column gets ctx 0.
//
// Bound on this card: bytes. Each (b, kv head) reads the K and V rows of
// its attendable columns once, 2 * D * 4 bytes a column: 4.2 MB at
// Gemma-3-270M's last f32 generate step (B 4, T 617, 2,048 of 2,468
// columns attendable), 1.3 us at 3.35 TB/s; 1.6 MB at GPT-2 small's (B 8
// x 12 heads, T 144). The 4 G D FLOPs a column are 2 FLOPs a byte at
// Gemma's G 4 and 0.5 at GPT-2's G 1, a tenth or less of the ~20 FLOPs a
// byte where the f32 FMA units (67 TFLOP/s) would become the limit:
// plain FMA on the CUDA cores keeps up, so no tensor cores and no 3xTF32.
//
// What the first version lost: one CTA of eight warps per (query head,
// b), 16 CTAs at Gemma's step on 132 SMs and 96 at GPT-2's (where T 144
// gave 5 of a CTA's 8 warps a 32-row tile), each walking its T alone,
// and each of Gemma's four query heads of a kv head read the same rows
// again (35.12 us, 28x the bound; GPT-2 11.28 us, 8x). Here, with
// csrc/decode_split_f32.cuh (its note has the lane map):
// - One CTA per (kv head x group of up to 4 query heads, chunk of `cpc`
//   columns, b) scores each K row against all of its query heads, so each
//   attendable row is read once. The chunk count comes from
//   ops/decode_attention.decode_f32_plan, from shapes only (never from
//   the mask, so a CUDA graph can capture the launch): the most chunks
//   that keep the CTAs within one wave of the SMs, but at least one
//   round's rows a chunk (fuller CTAs and fewer partials to merge beat a
//   whole wave of short chunks: 10.88 us against 12.19 for 33 chunks of
//   19 at Gemma's step, H100); Gemma's 4 (b, kv) units over T 617 are 13
//   chunks of 48 columns (52 CTAs), GPT-2's 96 (b, head) units one chunk
//   each (96 CTAs, no merge).
// - Two dependent round trips a round: the mask bytes, then the K and V
//   pieces of every attendable row as 16-byte loads straight into
//   registers, all in flight before the first use (a cp.async copy into
//   shared memory took 11.22 us against 10.80 at Gemma's step on an
//   H100); a chunk longer than one round (48 rows at D 256, 192
//   at D 64) loops over rounds with a per-warp online softmax, so any T
//   runs (a 32,768-token Gemma-3 context: 132 chunks of 249 columns).
// - A masked row, and so a tile or chunk with no attendable column, is
//   never read: its registers stay 0, its score is selected to NEG_INF
//   and its P.V skipped, so it adds exactly 0 whatever the cache holds
//   there (left-pad K/V, unwritten memory, Inf, NaN).
// - The warps' partials meet in shared memory in warp order; the chunks'
//   partials (m, l, acc) are merged in chunk order by a kernel launched
//   as a programmatic dependent (PDL), so two calls give identical bits.
//   PDL rather than a last-CTA merge behind a per-row counter: that
//   merge took 26.4 us at Gemma's step on an H100 against 10.8 (its one
//   CTA walks every chunk's partials alone, after all the others), PDL
//   keeps no state between calls (a counter must start at 0 in every
//   graph replay, after a failed call and on every stream), the merge
//   CTAs are resident before the chunk grid ends, and its capture in a
//   CUDA graph works on the card (csrc/decode_attention_mma.cu's merge).
//   A one-chunk plan writes ctx itself and launches no merge.
//
// C interface (ctypes): mft_decode_attention_split_f32 returns the CUDA
// error code of the launches (0 on success). q [B, KV, G, D] (4-byte
// aligned) and the caches [B, KV, T, D] (16-byte aligned) contiguous in
// f32 (dtype 0; any other is refused); ok [B, T] bool; ctx [B, KV, G, D]
// f32; ws n_chunks * B * KV * G * (D + 2) floats (null for one chunk);
// cpc columns a chunk, n_chunks = ceil(T / cpc) <= 4096; D in {32, 64,
// 128, 256}.

#include "decode_split_f32.cuh"

namespace {

// the K/V row of column `col` of batch row b, kv head kv
struct ContiguousRows {
  static constexpr bool kD32 = true;
  int T, KV;
  __device__ __forceinline__ int entry(int, int) const { return 0; }
  __device__ __forceinline__ size_t row(int b, int kv, int col,
                                        int) const {
    return ((size_t)b * KV + kv) * T + col;
  }
};

}  // namespace

extern "C" int mft_decode_attention_split_f32(
    const void* q, const void* k_cache, const void* v_cache, const void* ok,
    void* ctx, void* ws, int B, int KV, int G, int D, int T, int cpc,
    int n_chunks, int dtype, float scale, void* stream) {
  if (dtype != 0 || (D != 32 && D != 64 && D != 128 && D != 256) ||
      !split_f32::plan_ok(T, B, KV, G, cpc, n_chunks, ws))
    return (int)cudaErrorInvalidValue;
  const ContiguousRows rows{T, KV};
  return split_f32::dispatch_d(D, q, k_cache, v_cache, ok, ctx, ws, rows, B,
                               KV, G, T, cpc, n_chunks, scale, stream);
}
