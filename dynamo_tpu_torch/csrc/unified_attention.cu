// Unified ragged paged attention: any mix of prefill segments and decode
// tokens in one launch, reading K/V straight from the paged cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_unified.py
// (_unified_kernel, launched by ragged_paged_attention) with its row
// attributes, on the bf16 cache and on the int8 cache (int8 pages plus f32
// [num_blocks, kvh] scale rows read through the same block table,
// dequantized on the way into shared memory), at head_dim 128 and 256:
//   - windows [R] int32 (nullable = full attention for every row; an entry
//     <= 0 = full attention for its row): key j is visible to a query at position p iff
//     p - w < j <= p. A block's key loop starts at the step holding the
//     first key its earliest query sees, max(ctx_start + t0 - w + 1, 0)
//     floored to TN, so pages a window aged out are never read (the
//     reference's page skip); keys below a row's own bound inside the first
//     step are masked per row;
//   - sinks [h] f32 (nullable): per-query-head sink logits in the softmax
//     denominator (the state starts at m = sink, l = 1, acc = 0);
//   - softcap (0 = off): cap * tanh(s / cap) on the scaled score, before
//     the mask.
//
// Semantics: row r owns query tokens q[q_starts[r] : q_starts[r] + q_lens[r]],
// its newest tokens, at the tail of its context: token i sits at position
// seq_lens[r] - q_lens[r] + i and sees the row's keys < position + 1 (and
// inside its window). Rows with q_len == 0 or seq_len == 0 write nothing;
// the wrapper zeroes the output, so tokens outside every segment read back
// zero. (The TPU kernel kept one output block resident across rows and
// merged clamped tiles with a read-modify-write; here each block writes only
// its own member rows.)
//
// Bound on this card: bytes for decode rows (each reads its live pages once
// for G heads), operations for long prefill segments (as flash_extend.cu).
// One block per (q tile, kv head, row) with the shared tile body of
// attn_common.cuh; the grid's q-tile extent comes from the host's bound on
// q_lens, and blocks past their row's segment exit at once. Pages past
// ceil(seq_len / block_size) are never read. At head_dim 256 the tile's
// shared memory (141 KB) allows one block per SM.

#include "attn_common.cuh"

namespace dtt {

// row offsets of one sequence's keys in the paged cache; the scale of a key
// is its page's row of the [num_blocks, kvh] scales
template <int D>
struct PagedRows {
  const int* table;
  int bs, kvh, kh;
  __device__ long operator()(int kpos) const {
    const long page = table[kpos / bs];
    return ((page * bs + kpos % bs) * kvh + kh) * D;
  }
  __device__ long scale(int kpos) const {
    return (long)table[kpos / bs] * kvh + kh;
  }
};

template <int D, class KV>
__global__ void __launch_bounds__(NTHREADS)
unified_kernel(const __nv_bfloat16* __restrict__ q, const KV kv,
               const int* __restrict__ tables, const int* __restrict__ q_starts,
               const int* __restrict__ q_lens, const int* __restrict__ seq_lens,
               const int* __restrict__ windows, const float* __restrict__ sinks,
               __nv_bfloat16* __restrict__ out, int Tq, int h, int kvh, int bs,
               int max_blocks, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<D>& sm = *reinterpret_cast<TileSmem<D>*>(smem_raw);
  const int G = h / kvh, TQ = TM / G;
  const int qt = blockIdx.x, kh = blockIdx.y, r = blockIdx.z;
  const int q_start = q_starts[r], q_len = q_lens[r], seq_len = seq_lens[r];
  const int t0 = qt * TQ;
  if (q_len <= 0 || seq_len <= 0 || t0 >= q_len) return;  // block-uniform
  // clamp to the packed buffer so a malformed row cannot write out of bounds
  const int ntok = min(min(TQ, q_len - t0), Tq - (q_start + t0));
  if (ntok <= 0) return;
  KV row_kv = kv;
  row_kv.rows = PagedRows<D>{tables + (long)r * max_blocks, bs, kvh, kh};
  const RowAttrs at{windows != nullptr ? windows[r] : 0, sinks, softcap};
  tile_attention<D>(sm, q, out, row_kv, h, kh, G, (long)q_start + t0, ntok,
                    seq_len - q_len + t0, seq_len, at);
}

template <int D, class KV>
int launch_unified(const void* q, const KV& kv, const void* tables,
                   const void* q_starts, const void* q_lens, const void* seq_lens,
                   const void* windows, const void* sinks, void* out, int Tq,
                   int h, int kvh, int bs, int R, int max_blocks, int max_q_len,
                   float softcap, void* stream) {
  if (R <= 0 || max_q_len <= 0 || Tq <= 0) return 0;
  if (kvh <= 0 || h % kvh || TM % (h / kvh)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(TileSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      unified_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int TQ = TM / (h / kvh);
  const dim3 grid((max_q_len + TQ - 1) / TQ, kvh, R);
  unified_kernel<D, KV><<<grid, NTHREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), kv, static_cast<const int*>(tables),
      static_cast<const int*>(q_starts), static_cast<const int*>(q_lens),
      static_cast<const int*>(seq_lens), static_cast<const int*>(windows),
      static_cast<const float*>(sinks), static_cast<__nv_bfloat16*>(out), Tq, h,
      kvh, bs, max_blocks, softcap);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// q [Tq, h, d] bf16 (d = 128 or 256); k/v cache [num_blocks, bs, kvh, d]
// bf16; tables [R, max_blocks], q_starts/q_lens/seq_lens [R] int32;
// windows [R] int32 or null (null: every row full; an entry <= 0: full);
// sinks [h] f32 or null; softcap 0 = off; max_q_len >= every q_lens[r]
// -> out [Tq, h, d] bf16 (member rows only; the caller zeroes it).
// Returns cudaGetLastError() after the launch.
extern "C" int dtt_unified(const void* q, const void* kc, const void* vc,
                           const void* tables, const void* q_starts,
                           const void* q_lens, const void* seq_lens,
                           const void* windows, const void* sinks, void* out,
                           int Tq, int h, int kvh, int d, int bs, int R,
                           int max_blocks, int max_q_len, float softcap,
                           void* stream) {
  using namespace dtt;
  if (d == 128) {
    const Bf16KV<PagedRows<128>> kv{static_cast<const __nv_bfloat16*>(kc),
                                    static_cast<const __nv_bfloat16*>(vc), {}};
    return launch_unified<128>(q, kv, tables, q_starts, q_lens, seq_lens, windows,
                               sinks, out, Tq, h, kvh, bs, R, max_blocks,
                               max_q_len, softcap, stream);
  }
  if (d == 256) {
    const Bf16KV<PagedRows<256>> kv{static_cast<const __nv_bfloat16*>(kc),
                                    static_cast<const __nv_bfloat16*>(vc), {}};
    return launch_unified<256>(q, kv, tables, q_starts, q_lens, seq_lens, windows,
                               sinks, out, Tq, h, kvh, bs, R, max_blocks,
                               max_q_len, softcap, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// As dtt_unified with an int8 cache kc/vc [num_blocks, bs, kvh, d] and its
// f32 scale rows ks/vs [num_blocks, kvh].
extern "C" int dtt_unified_i8(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs, const void* tables,
                              const void* q_starts, const void* q_lens,
                              const void* seq_lens, const void* windows,
                              const void* sinks, void* out, int Tq, int h,
                              int kvh, int d, int bs, int R, int max_blocks,
                              int max_q_len, float softcap, void* stream) {
  using namespace dtt;
  if (d == 128) {
    const Int8KV<PagedRows<128>> kv{
        static_cast<const int8_t*>(kc), static_cast<const int8_t*>(vc),
        static_cast<const float*>(ks), static_cast<const float*>(vs), {}};
    return launch_unified<128>(q, kv, tables, q_starts, q_lens, seq_lens, windows,
                               sinks, out, Tq, h, kvh, bs, R, max_blocks,
                               max_q_len, softcap, stream);
  }
  if (d == 256) {
    const Int8KV<PagedRows<256>> kv{
        static_cast<const int8_t*>(kc), static_cast<const int8_t*>(vc),
        static_cast<const float*>(ks), static_cast<const float*>(vs), {}};
    return launch_unified<256>(q, kv, tables, q_starts, q_lens, seq_lens, windows,
                               sinks, out, Tq, h, kvh, bs, R, max_blocks,
                               max_q_len, softcap, stream);
  }
  return (int)cudaErrorInvalidValue;
}
