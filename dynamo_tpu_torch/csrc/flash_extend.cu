// Flash prefix-extend attention for one prefill chunk over its gathered
// context.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_prefill.py
// (_prefill_kernel, launched by flash_extend_attention): the bf16 context,
// and the int8 context with per-position f32 scales [T, kvh] (the
// reference's k_scales/v_scales, ops/attention.gather_kv_quant), copied
// raw (half the context bytes) and converted to bf16 exactly in shared
// memory, its scales applied to the f32 score and probability columns.
//
// Head sizes 64 (Llama-3.2-1B, Qwen2.5-0.5B) and 128, any G = h / kvh up
// to 64 (the tile body's G is a run-time value).
//
// Semantics: query row i of the chunk sits at absolute position start + i
// (the engine's chunks are contiguous) and sees context keys
// j < min(start + i + 1, total_len). Any S and T: ragged tiles are masked
// here (the TPU needed S % 128 == 0 and T % 256 == 0), so the engine runs
// this for every prefill chunk, the 64-token bucket included.
//
// Bound on the H100: operations once a chunk is long (each K/V tile serves
// 64 query-head rows: ~32 flops per byte of context read), bytes for short
// chunks against a long cached prefix. Design (attn_common.cuh):
//   - one block (one warpgroup) per (q tile, kv head): TQ = floor(64 / G)
//     tokens x the G heads sharing one kv head, TQ * G <= TM = 64 valid
//     query-head rows, so each K/V tile serves every head of its GQA group;
//     where G does not divide 64 (Qwen2.5's G 3, 5, 6 and 7) the tile's
//     last 64 - TQ * G rows are padding: zero queries, every key masked
//     (their softmax state stays m = -1e30, l = 0, finite), never stored;
//     S = Q K^T and O += P V on the tensor cores (wgmma), the softmax in
//     registers;
//   - the TPU grid's sequential kv dimension becomes a loop over 64-key
//     steps fed by a 2-stage cp.async ring (80 KB at d = 128: two blocks
//     per SM; 40 KB at d = 64, the tile body's one-region form);
//   - KV steps past the tile's causal limit min(start + (qt+1) * TQ,
//     total_len) are skipped, keys past it are never read; the longest
//     tiles (the last q tiles) are scheduled first.
// The context is contiguous, so TMA (cp.async.bulk.tensor) could replace
// the per-thread copies; that is later work (PERF.md).

#include "attn_common.cuh"

namespace dtt {

// row offsets of the gathered context [T, kvh, D]; its scales are [T, kvh]
template <int D>
struct ContextRows {
  int kvh, kh;
  __device__ long operator()(int kpos) const {
    return ((long)kpos * kvh + kh) * D;
  }
  __device__ long scale(int kpos) const { return (long)kpos * kvh + kh; }
};

template <int D, bool I8>
__global__ void __launch_bounds__(tile_threads<D>())
flash_extend_kernel(const __nv_bfloat16* __restrict__ q, const KVSrc<ContextRows<D>> kv,
                    __nv_bfloat16* __restrict__ out, int S, int h, int kvh,
                    int start, int total_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = tile_smem<TileSmem<D, I8>>(smem_raw);
  // TQ tokens a tile: TQ * G <= TM rows, the rest padding
  const int G = h / kvh, TQ = TM / G;
  // causal: the last q tiles see the most keys; start them first
  const int qt = gridDim.x - 1 - blockIdx.x, kh = blockIdx.y;
  const int tok0 = qt * TQ;
  const int ntok = min(TQ, S - tok0);
  KVSrc<ContextRows<D>> src = kv;
  src.rows.kh = kh;
  const int pos0 = start + tok0;
  int klo, hi;
  tile_range(pos0, ntok, total_len, 0, klo, hi);
  const TileJob job{tok0, ntok, pos0, total_len, klo, hi, false, nullptr, nullptr, nullptr, 0};
  tile_attention<D, I8>(sm, q, out, src, h, kh, G, RowAttrs{0, nullptr, 0.f}, job);
}

template <int D, bool I8>
int launch_flash(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, void* out, int S, int h, int kvh, int start,
                 int total_len, void* stream) {
  if (S <= 0) return 0;
  const KVSrc<ContextRows<D>> kv{k, v, static_cast<const float*>(ks),
                                 static_cast<const float*>(vs), {kvh, 0}};
  const int smem = tile_smem_bytes<TileSmem<D, I8>>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_extend_kernel<D, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int TQ = TM / (h / kvh);
  const dim3 grid((S + TQ - 1) / TQ, kvh);
  flash_extend_kernel<D, I8><<<grid, tile_threads<D>(), smem,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), kv, static_cast<__nv_bfloat16*>(out), S,
      h, kvh, start, total_len);
  return (int)cudaGetLastError();
}

template <bool I8>
int flash_entry(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                void* out, int S, int h, int kvh, int d, int start, int total_len,
                void* stream) {
  if (kvh <= 0 || h % kvh || h / kvh > TM) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return launch_flash<64, I8>(q, k, v, ks, vs, out, S, h, kvh, start, total_len, stream);
  if (d == 128)
    return launch_flash<128, I8>(q, k, v, ks, vs, out, S, h, kvh, start, total_len, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dtt

// q [S, h, d] bf16 (d = 64 or 128, G = h / kvh <= 64); k/v [T, kvh, d]
// bf16; rows i of q at positions start + i; keys < total_len (<= T) valid
// -> out [S, h, d] bf16. Returns cudaGetLastError() after the launch.
extern "C" int dtt_flash_extend(const void* q, const void* k, const void* v,
                                void* out, int S, int h, int kvh, int d, int start,
                                int total_len, void* stream) {
  return dtt::flash_entry<false>(q, k, v, nullptr, nullptr, out, S, h, kvh, d, start,
                                 total_len, stream);
}

// As dtt_flash_extend with an int8 context k/v [T, kvh, d] and its f32
// per-position scales ks/vs [T, kvh].
extern "C" int dtt_flash_extend_i8(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs, void* out,
                                   int S, int h, int kvh, int d, int start,
                                   int total_len, void* stream) {
  return dtt::flash_entry<true>(q, k, v, ks, vs, out, S, h, kvh, d, start, total_len,
                                stream);
}
