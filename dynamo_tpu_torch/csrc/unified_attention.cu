// Unified ragged paged attention: any mix of prefill segments and decode
// tokens in one launch, reading K/V straight from the paged cache.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_unified.py
// (_unified_kernel, launched by ragged_paged_attention) with its row
// attributes, on the bf16 cache and on the int8 cache (int8 pages plus f32
// [num_blocks, kvh] scale rows read through the same block table, the
// payload converted to bf16 exactly and the scales applied to the score
// and probability columns), at head_dim 64 (gpt-oss), 128 and 256:
//   - windows [R] int32 (nullable = full attention for every row; an entry
//     <= 0 = full attention for its row): key j is visible to a query at
//     position p iff p - w < j <= p. A block reads keys from the first one
//     its earliest query sees, max(ctx_start + t0 - w + 1, 0), so pages a
//     window aged out are never read (the reference's page skip); keys
//     below a row's own bound are masked per row;
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
// Bound on the H100: bytes for decode rows (each reads its live pages once
// for its G heads), operations for long prefill segments (as
// flash_extend.cu). The tile body (attn_common.cuh) runs S and P.V on the
// tensor cores (wgmma) over a 2-stage cp.async ring of 64-key steps, one
// warpgroup per 128 dims (one at d = 64). At d = 64 a block takes 43 KB of
// shared memory and 128 threads, so four fit an SM; gpt-oss's G = 8 puts 8
// tokens in a q tile, and with window 128 a decode row reads at most 3
// 64-key steps, an 8-token tile at most 4 (tile_range skips the pages the
// window aged out). A row of one q tile (a decode row, a short
// segment) alone would keep one block per kv head walking thousands of
// keys while most SMs idle (a Gemma decode batch: 32 blocks on 132 SMs), so
// such a row's live keys [klo, hi) are cut into splits of SPLIT_KEYS keys
// (32 pages of 16), one block each, which write their partial state (m, l,
// unnormalized acc, f32) to scratch; merge_kernel, which the same entry
// point launches next on the same stream, then combines each
// (token, head)'s splits in split order (deterministic, no atomics), the
// sink counted once. A row whose range fits one split, and every row of
// more than one q tile (long prefill segments, whose q tiles already fill
// the grid), writes its output directly. The grid's split extent S comes
// from the host's bound on seq_lens (max_seq_len); a row whose range would
// need more than S splits takes longer ones, so the bound sizes the grid
// but never decides correctness.

#include <type_traits>

#include "attn_common.cuh"

namespace dtt {

// keys per split of a one-tile row: 32 pages of 16, 8 steps of TN
constexpr int SPLIT_KEYS = 512;

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

// Scratch of the split rows (null when S == 1): part_acc [R, S, QS, h, D],
// part_m / part_l [R, S, QS, h] f32, n_splits [R] int32 (the row's split
// count, 0 = written directly), written by block (0, 0) of each row.
struct Splits {
  float* acc;
  float* m;
  float* l;
  int* n;
  int S, QS;
};

template <int D, bool I8>
__global__ void __launch_bounds__(tile_threads<D>())
unified_kernel(const __nv_bfloat16* __restrict__ q, const KVSrc<PagedRows<D>> kv,
               const int* __restrict__ tables, const int* __restrict__ q_starts,
               const int* __restrict__ q_lens, const int* __restrict__ seq_lens,
               const int* __restrict__ windows, const float* __restrict__ sinks,
               __nv_bfloat16* __restrict__ out, const Splits sp, int Tq, int h, int kvh,
               int bs, int max_blocks, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = h / kvh, TQ = TM / G;
  const int x = blockIdx.x, kh = blockIdx.y, r = blockIdx.z;
  const int q_start = q_starts[r], q_len = q_lens[r], seq_len = seq_lens[r];
  const int window = windows != nullptr ? windows[r] : 0;
  const bool live = q_len > 0 && seq_len > 0;
  // a row of one q tile whose keys span more than one split: blockIdx.x
  // is the split
  int nsplit = 0, split = 0, first = 0, klo = 0, hi = 0;
  if (live && sp.S > 1 && q_len <= sp.QS) {
    tile_range(seq_len - q_len, q_len, seq_len, window, klo, hi);
    first = klo - klo % TN;
    const int range = hi - first;
    split = max(SPLIT_KEYS, ((range + sp.S - 1) / sp.S + TN - 1) / TN * TN);
    nsplit = (range + split - 1) / split;
    if (nsplit < 2) nsplit = 0;
  }
  if (sp.n != nullptr && x == 0 && kh == 0 && threadIdx.x == 0) sp.n[r] = nsplit;
  if (!live) return;  // block-uniform exits
  TileJob job;
  if (nsplit) {
    // (clamped to the packed buffer, as below)
    const int ntok = min(q_len, Tq - q_start);
    if (x >= nsplit || ntok <= 0) return;
    job = TileJob{q_start, ntok, seq_len - q_len, seq_len,
                  x == 0 ? klo : first + x * split, min(first + (x + 1) * split, hi),
                  false, sp.acc, sp.m, sp.l, (long)(r * sp.S + x) * sp.QS * h};
  } else {
    // blockIdx.x is the q tile
    const int t0 = x * TQ;
    if (t0 >= q_len) return;
    // clamp to the packed buffer so a malformed row cannot write out of bounds
    const int ntok = min(min(TQ, q_len - t0), Tq - (q_start + t0));
    if (ntok <= 0) return;
    const int pos0 = seq_len - q_len + t0;
    tile_range(pos0, ntok, seq_len, window, klo, hi);
    job = TileJob{(long)q_start + t0, ntok, pos0, seq_len, klo, hi, true,
                  nullptr, nullptr, nullptr, 0};
  }
  KVSrc<PagedRows<D>> src = kv;
  src.rows = PagedRows<D>{tables + (long)r * max_blocks, bs, kvh, kh};
  tile_attention<D, I8>(tile_smem<TileSmem<D, I8>>(smem_raw), q, out, src, h, kh, G,
                        RowAttrs{window, sinks, softcap}, job);
}

// One (token t of row r, head hh) per block, 4 dims per thread (D / 4
// threads: 16 at d = 64, 32 at 128, 64 at 256): merges the
// row's n_splits[r] partial states in split order,
//   M = max(sink, m_s over splits with l_s > 0),
//   out = sum_s exp(m_s - M) acc_s / max(exp(sink - M) + sum_s exp(m_s - M) l_s, 1e-30),
// the sink counted once (not per split); a split that saw no key (l_s = 0)
// weighs 0. Rows with n_splits < 2 were written by the attention kernel.
__global__ void merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                             const float* __restrict__ part_l, const int* __restrict__ n_splits,
                             const int* __restrict__ q_starts, const int* __restrict__ q_lens,
                             const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
                             int Tq, int h, int D, int S, int QS) {
  const int t = blockIdx.x, hh = blockIdx.y, r = blockIdx.z;
  const int ns = n_splits[r];
  if (ns < 2 || t >= q_lens[r]) return;
  const long tok = (long)q_starts[r] + t;
  if (tok >= Tq) return;
  const long row0 = ((long)r * S * QS + t) * h + hh;  // split s: row0 + s * QS * h
  const long stride = (long)QS * h;
  float M = sinks != nullptr ? sinks[hh] : NEG_INF;
  for (int s = 0; s < ns; ++s)
    if (part_l[row0 + s * stride] > 0.f) M = fmaxf(M, part_m[row0 + s * stride]);
  float L = sinks != nullptr ? __expf(sinks[hh] - M) : 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c = threadIdx.x * 4;
  for (int s = 0; s < ns; ++s) {
    const long row = row0 + s * stride;
    const float l = part_l[row];
    if (!(l > 0.f)) continue;
    const float w = __expf(part_m[row] - M);
    L += l * w;
    const float4 a = *reinterpret_cast<const float4*>(part_acc + row * D + c);
    acc.x += w * a.x;
    acc.y += w * a.y;
    acc.z += w * a.z;
    acc.w += w * a.w;
  }
  const float inv = 1.0f / fmaxf(L, 1e-30f);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (tok * h + hh) * D + c);
  dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}

int launch_merge(const void* part_acc, const void* part_m, const void* part_l,
                 const void* n_splits, const void* q_starts, const void* q_lens,
                 const void* sinks, void* out, int Tq, int h, int d, int R, int S, int QS,
                 void* stream) {
  if ((d != 64 && d != 128 && d != 256) || R <= 0 || S < 1 || QS < 1 || h <= 0)
    return (int)cudaErrorInvalidValue;
  merge_kernel<<<dim3(QS, h, R), d / 4, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<const int*>(n_splits),
      static_cast<const int*>(q_starts), static_cast<const int*>(q_lens),
      static_cast<const float*>(sinks), static_cast<__nv_bfloat16*>(out), Tq, h, d, S, QS);
  return (int)cudaGetLastError();
}

template <int D, bool I8>
int launch_unified(const void* q, const KVSrc<PagedRows<D>>& kv, const void* tables,
                   const void* q_starts, const void* q_lens, const void* seq_lens,
                   const void* windows, const void* sinks, void* out, const Splits& sp,
                   int Tq, int h, int kvh, int bs, int R, int max_blocks, int max_q_len,
                   float softcap, void* stream) {
  const int smem = tile_smem_bytes<TileSmem<D, I8>>();
  cudaError_t err = cudaFuncSetAttribute(
      unified_kernel<D, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int TQ = TM / (h / kvh);
  const dim3 grid(max((max_q_len + TQ - 1) / TQ, sp.S), kvh, R);
  unified_kernel<D, I8><<<grid, tile_threads<D>(), smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), kv, static_cast<const int*>(tables),
      static_cast<const int*>(q_starts), static_cast<const int*>(q_lens),
      static_cast<const int*>(seq_lens), static_cast<const int*>(windows),
      static_cast<const float*>(sinks), static_cast<__nv_bfloat16*>(out), sp, Tq, h,
      kvh, bs, max_blocks, softcap);
  return (int)cudaGetLastError();
}

// blocks of unified_kernel<D, I8> that fit one SM (the occupancy calculator)
// and its dynamic shared memory
template <int D, bool I8>
int occupancy(int* blocks, int* smem) {
  *smem = tile_smem_bytes<TileSmem<D, I8>>();
  cudaError_t err = cudaFuncSetAttribute(
      unified_kernel<D, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, unified_kernel<D, I8>,
                                                            tile_threads<D>(), *smem);
}

template <bool I8>
int unified_entry(const void* q, const void* kc, const void* vc, const void* ks,
                  const void* vs, const void* tables, const void* q_starts,
                  const void* q_lens, const void* seq_lens, const void* windows,
                  const void* sinks, void* out, void* part_acc, void* part_m,
                  void* part_l, void* n_splits, int Tq, int h, int kvh, int d, int bs,
                  int R, int max_blocks, int max_q_len, int S, int QS, float softcap,
                  void* stream) {
  if (kvh <= 0 || h % kvh || TM % (h / kvh)) return (int)cudaErrorInvalidValue;
  if (S < 1 || (S > 1 && (QS < 1 || !part_acc || !part_m || !part_l || !n_splits)))
    return (int)cudaErrorInvalidValue;
  const Splits sp{static_cast<float*>(part_acc), static_cast<float*>(part_m),
                  static_cast<float*>(part_l), static_cast<int*>(n_splits), S, QS};
  if (d != 64 && d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  if (R <= 0 || max_q_len <= 0 || Tq <= 0) return 0;
  const float* fks = static_cast<const float*>(ks);
  const float* fvs = static_cast<const float*>(vs);
  auto launch = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch_unified<D, I8>(q, KVSrc<PagedRows<D>>{kc, vc, fks, fvs, {}}, tables,
                                 q_starts, q_lens, seq_lens, windows, sinks, out, sp, Tq, h,
                                 kvh, bs, R, max_blocks, max_q_len, softcap, stream);
  };
  const int err = d == 64    ? launch(std::integral_constant<int, 64>{})
                  : d == 128 ? launch(std::integral_constant<int, 128>{})
                             : launch(std::integral_constant<int, 256>{});
  // the split rows' merge, on the same stream (one call from the host per layer)
  if (err || S < 2) return err;
  return launch_merge(part_acc, part_m, part_l, n_splits, q_starts, q_lens, sinks, out, Tq,
                      h, d, R, S, QS, stream);
}

}  // namespace dtt

// q [Tq, h, d] bf16 (d = 64, 128 or 256); k/v cache [num_blocks, bs, kvh, d]
// bf16; tables [R, max_blocks], q_starts/q_lens/seq_lens [R] int32;
// windows [R] int32 or null (null: every row full; an entry <= 0: full);
// sinks [h] f32 or null; softcap 0 = off; max_q_len >= every q_lens[r]
// -> out [Tq, h, d] bf16 (member rows only; the caller zeroes it).
// Split-K: S >= 1 splits at most per row (S == 1: none, scratch pointers
// may be null); rows with 0 < q_len <= QS may be split into pieces of at
// least SPLIT_KEYS keys, their partial state going to
// part_acc [R, S, QS, h, d] / part_m / part_l [R, S, QS, h] f32 and their
// split counts to n_splits [R] int32; with S > 1 the entry then launches
// the merge (as dtt_merge_partials) on the same stream, which writes the
// split rows' outputs. Returns cudaGetLastError() after the launches.
extern "C" int dtt_unified(const void* q, const void* kc, const void* vc,
                           const void* tables, const void* q_starts,
                           const void* q_lens, const void* seq_lens,
                           const void* windows, const void* sinks, void* out,
                           void* part_acc, void* part_m, void* part_l, void* n_splits,
                           int Tq, int h, int kvh, int d, int bs, int R,
                           int max_blocks, int max_q_len, int S, int QS, float softcap,
                           void* stream) {
  return dtt::unified_entry<false>(q, kc, vc, nullptr, nullptr, tables, q_starts, q_lens,
                                   seq_lens, windows, sinks, out, part_acc, part_m, part_l,
                                   n_splits, Tq, h, kvh, d, bs, R, max_blocks, max_q_len, S,
                                   QS, softcap, stream);
}

// As dtt_unified with an int8 cache kc/vc [num_blocks, bs, kvh, d] and its
// f32 scale rows ks/vs [num_blocks, kvh].
extern "C" int dtt_unified_i8(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs, const void* tables,
                              const void* q_starts, const void* q_lens,
                              const void* seq_lens, const void* windows,
                              const void* sinks, void* out, void* part_acc, void* part_m,
                              void* part_l, void* n_splits, int Tq, int h, int kvh, int d,
                              int bs, int R, int max_blocks, int max_q_len, int S, int QS,
                              float softcap, void* stream) {
  return dtt::unified_entry<true>(q, kc, vc, ks, vs, tables, q_starts, q_lens, seq_lens,
                                  windows, sinks, out, part_acc, part_m, part_l, n_splits,
                                  Tq, h, kvh, d, bs, R, max_blocks, max_q_len, S, QS,
                                  softcap, stream);
}

// The split rows' outputs from their partial states (layouts as above):
// out [Tq, h, d] bf16 rows of tokens q_starts[r] + t, t < q_lens[r], of rows
// with n_splits[r] >= 2; sinks [h] f32 or null. d = 64, 128 or 256.
// Returns cudaGetLastError() after the launch.
extern "C" int dtt_merge_partials(const void* part_acc, const void* part_m,
                                  const void* part_l, const void* n_splits,
                                  const void* q_starts, const void* q_lens,
                                  const void* sinks, void* out, int Tq, int h, int d,
                                  int R, int S, int QS, void* stream) {
  return dtt::launch_merge(part_acc, part_m, part_l, n_splits, q_starts, q_lens, sinks, out,
                          Tq, h, d, R, S, QS, stream);
}

// Blocks per SM of the unified kernel at head_dim d (64, 128 or 256), bf16
// (i8 = 0) or int8 cache, by the occupancy calculator, and its dynamic
// shared memory in bytes. Returns a CUDA error code.
extern "C" int dtt_unified_occupancy(int d, int i8, int* blocks, int* smem) {
  if (d == 64) return i8 ? dtt::occupancy<64, true>(blocks, smem)
                         : dtt::occupancy<64, false>(blocks, smem);
  if (d == 128) return i8 ? dtt::occupancy<128, true>(blocks, smem)
                          : dtt::occupancy<128, false>(blocks, smem);
  if (d == 256) return i8 ? dtt::occupancy<256, true>(blocks, smem)
                          : dtt::occupancy<256, false>(blocks, smem);
  return (int)cudaErrorInvalidValue;
}
