// Flash prefix-extend attention for one prefill chunk over its gathered
// context.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_prefill.py
// (_prefill_kernel, launched by flash_extend_attention): the bf16 context,
// and the int8 context with per-position f32 scales [T, kvh] (the
// reference's k_scales/v_scales, ops/attention.gather_kv_quant), which is
// dequantized on its way into shared memory and halves the context bytes.
//
// Semantics: query row i of the chunk sits at absolute position start + i
// (the engine's chunks are contiguous) and sees context keys
// j < min(start + i + 1, total_len). Any S and T: ragged tiles are masked
// here (the TPU needed S % 128 == 0 and T % 256 == 0), so the engine runs
// this for every prefill chunk, the 64-token bucket included.
//
// Bound on this card: operations once a chunk is long (each K/V tile is
// reused by TM query-head rows: ~TM / 2 flops per byte of context read),
// bytes for short chunks against a long cached prefix. Design:
//   - one block per (q tile, kv head): TM = 64 query-head rows = 64 / G
//     tokens x the G heads sharing one kv head, so each K/V tile loaded to
//     shared memory serves every head of its GQA group;
//   - the TPU grid's sequential kv dimension (online-softmax state in VMEM
//     scratch across grid steps) becomes a loop inside the block;
//   - KV tiles past the tile's causal limit min(start + (qt+1) * TQ,
//     total_len) are skipped, keys past it are never read.
// This first version multiplies on CUDA cores; tensor cores (wgmma), TMA
// and a deeper pipeline are later work (PERF.md has its time and bound).

#include "attn_common.cuh"

namespace dtt {

constexpr int FLASH_D = 128;  // the only head size this kernel takes

// row offsets of the gathered context [T, kvh, FLASH_D]; its scales are
// [T, kvh]
struct ContextRows {
  int kvh, kh;
  __device__ long operator()(int kpos) const {
    return ((long)kpos * kvh + kh) * FLASH_D;
  }
  __device__ long scale(int kpos) const { return (long)kpos * kvh + kh; }
};

template <class KV>
__global__ void __launch_bounds__(NTHREADS)
flash_extend_kernel(const __nv_bfloat16* __restrict__ q, const KV kv,
                    __nv_bfloat16* __restrict__ out, int S, int h, int kvh,
                    int start, int total_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<FLASH_D>& sm = *reinterpret_cast<TileSmem<FLASH_D>*>(smem_raw);
  const int G = h / kvh, TQ = TM / G;
  const int qt = blockIdx.x, kh = blockIdx.y;
  const int tok0 = qt * TQ;
  const int ntok = min(TQ, S - tok0);
  KV rows_of_kh = kv;
  rows_of_kh.rows.kh = kh;
  tile_attention<FLASH_D>(sm, q, out, rows_of_kh, h, kh, G, tok0, ntok,
                          start + tok0, total_len, RowAttrs{0, nullptr, 0.f});
}

template <class KV>
int launch_flash(const void* q, const KV& kv, void* out, int S, int h, int kvh,
                 int start, int total_len, void* stream) {
  if (S <= 0) return 0;
  const int smem = (int)sizeof(TileSmem<FLASH_D>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_extend_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int TQ = TM / (h / kvh);
  const dim3 grid((S + TQ - 1) / TQ, kvh);
  flash_extend_kernel<KV><<<grid, NTHREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), kv, static_cast<__nv_bfloat16*>(out), S,
      h, kvh, start, total_len);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// q [S, h, 128] bf16; k/v [T, kvh, 128] bf16; rows i of q at positions
// start + i; keys < total_len (<= T) valid -> out [S, h, 128] bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int dtt_flash_extend(const void* q, const void* k, const void* v,
                                void* out, int S, int h, int kvh, int start,
                                int total_len, void* stream) {
  using namespace dtt;
  if (kvh <= 0 || h % kvh || TM % (h / kvh)) return (int)cudaErrorInvalidValue;
  const Bf16KV<ContextRows> kv{static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v), {kvh, 0}};
  return launch_flash(q, kv, out, S, h, kvh, start, total_len, stream);
}

// As dtt_flash_extend with an int8 context k/v [T, kvh, 128] and its f32
// per-position scales ks/vs [T, kvh].
extern "C" int dtt_flash_extend_i8(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs, void* out,
                                   int S, int h, int kvh, int start,
                                   int total_len, void* stream) {
  using namespace dtt;
  if (kvh <= 0 || h % kvh || TM % (h / kvh)) return (int)cudaErrorInvalidValue;
  const Int8KV<ContextRows> kv{static_cast<const int8_t*>(k),
                               static_cast<const int8_t*>(v),
                               static_cast<const float*>(ks),
                               static_cast<const float*>(vs), {kvh, 0}};
  return launch_flash(q, kv, out, S, h, kvh, start, total_len, stream);
}
