// Latent paged attention (MLA): ragged paged attention over a one-kv-head
// cache of latent rows, d_qk = 576 (kv_lora_rank 512 + qk_rope_head_dim
// 64), d_v = 512, with the splits of long rows merged in the same launch.
//
// The latent form of the TPU kernel dynamo_tpu/ops/pallas_unified.py:93
// (_unified_kernel, launched by ragged_paged_attention at :494), at a shape
// that kernel could not take (its Mosaic DMAs need head_dim % 128 == 0, so
// the reference runs MLA's attention in plain JAX). Same function as
// ops.attention.ragged_paged_attention(q, kv, kv, ...), restricted to the
// first 512 output lanes: row r owns the query tokens
// q[q_starts[r] : q_starts[r] + q_lens[r]], at the tail of its seq_lens[r]
// keys, causal; tokens outside every row stay as the caller left them (0).
// q [Tq, h, 576] bf16, h = G (one kv head) a multiple of 16 up to 128;
// kv cache [num_blocks, bs, 1, 576] bf16; out [Tq, h, 512] bf16. The model
// has pre-scaled q (models/mla.py); the kernel scales by 1/sqrt(576), as
// the plain op does, and by nothing else.
//
// Values come from the key rows. The model caches K' = [c, k_pe] and V' =
// [c, 0] (the reference's layout, kept for the KVBM and transfer formats),
// so V' lanes 0-511 equal K' lanes 0-511 bit for bit: MLA's attention is
// MQA over the latent c. The kernel reads only K' and takes P.V's B
// operand from the first 512 lanes of the staged key tile; no V byte
// moves.
//
// Bound on this card: bytes for decode-shaped rows (each key brings 1152 B
// for G * 2 * 1088 flops: 30 flops per byte at G = 16), operations for
// prefill chunks. Two forms of one kernel, one per launch, chosen by the
// host bound max_q_len * h (ops/cuda_mla.tile_shape), so a CUDA graph
// captured at one bound always replays one form:
//   - narrow (rows < 64 pairs: G = 16 decode, short rows): one mma.sync
//     m16n8k16 tile of 16 rows, exactly one token's 16 heads at G = 16.
//     4 warps split the 512 output lanes (64 accumulators a thread); S =
//     Q K^T (36 k-steps over 576) is computed once per 32-key tile, warp w
//     taking lanes 144w .. 144w + 143 of all 32 keys, and the partial S,
//     row maxima and P (bf16) go through shared memory. P.V's B fragments
//     are ldmatrix.trans reads of the key tile. A 2-stage ring of 32-key
//     tiles (36,864 B a stage) with Q and P is 103,936 B: two blocks fit an
//     SM, so a G = 16 decode batch of ~141 blocks runs in one wave;
//   - wide (rows of 64 or more pairs: prefill chunks, mixed steps, G = 128
//     decode): one wgmma M tile of 64 rows a block (4 tokens at G = 16,
//     half a token at G = 128) and three warpgroups. The producer
//     warpgroup keeps the 2-stage ring of 64-key tiles full with cp.async
//     (each thread four keys of a tile, 128 contiguous bytes a warp
//     instruction), each of its threads arriving on the stage's "full"
//     mbarrier when its copies land; it runs on 56 registers a thread
//     (setmaxnreg), the two consumer warpgroups on 224. The consumers wait
//     on "full", run the tile, and arrive on the stage's "empty" mbarrier,
//     which the producer waits on before it refills the stage. The 64-key
//     tile's S is computed once: consumer w takes keys 32w .. 32w + 31
//     (m64n32k16, 36 k-steps, Q and K 128-byte-swizzled in shared memory),
//     the two exchange row maxima through shared memory, each writes its
//     half of P (bf16) to one shared 64 x 64 tile, and each then adds P.V
//     for its 256 output lanes (m64n128k16 twice, 128 f32 accumulators a
//     thread) with V read MN-major from the key tile's first 8 swizzle
//     regions. Q 73,728 + 2 x 73,728 + P 8,192 B, one block per SM. (TMA
//     would take 9 boxes a 16-key page and a tensor map per cache and
//     launch; a stage's 4,608 16-byte copies are 36 a producer thread.)
//     Each key tile serves 64 rows instead of 32, which halves the L2
//     traffic of a prefill chunk, and the tensor cores run wgmma, not
//     mma.sync;
//   - split-K (both forms): a row of at most QS = max(1, 64 / G) tokens
//     (every row of a narrow launch: 4 at G = 16; one 64-row tile of the
//     wide form) is cut from key 0 into splits of MLA_SPLIT_KEYS keys
//     (longer where it would need more than the grid's S, rounded up to a
//     page): exactly ops.attention.split_plan(q_len, seq_len, 0,
//     MLA_SPLIT_KEYS, bs, S). Each split block writes its rows' (m, l,
//     unnormalized acc) in f32 to scratch; the last split block of each
//     (row, tile group) to finish (__threadfence, then an atomicAdd on the
//     pair's counter) merges all of them in split order, so the result
//     does not depend on which block finished last, and resets the
//     counter to 0. The partials reach the merging block by bulk (TMA)
//     copies into its dead ring (mla_merge). The plan does not depend on
//     the grid's extent for rows up to max_seq_len, so a CUDA graph
//     captured at a length bucket replays what the eager launch computes.
// The scratch and the counters are one buffer per (device, stream) that
// ops/cuda_attention.py keeps (launches on one stream run in order, so a
// launch finds every counter at 0). The kernel writes each row's split
// count (0 = not split) to n_splits, which the wrapper's split log reads.

#include "attn_common.cuh"

namespace dtt {

constexpr int MLA_DQK = 576;          // kv_lora_rank + qk_rope_head_dim
constexpr int MLA_DV = 512;           // output lanes (V = the first 512 key lanes)
constexpr int MLA_QCH = MLA_DQK / 8;  // 16-byte chunks of a Q / K row: 72
// keys per split (16 pages of 16); ops/cuda_mla.py mirrors it
constexpr int MLA_SPLIT_KEYS = 256;
// rows ((token, head) pairs) of a block in each form; ops/cuda_mla.py
// mirrors them
constexpr int MLA_NARROW_ROWS = 16;
constexpr int MLA_WIDE_ROWS = 64;
constexpr int MLA_NK = 32;     // narrow: keys per tile
constexpr int MLA_NST = 2;     // narrow: ring stages (two blocks an SM)
constexpr int MLA_WK = 64;     // wide: keys per tile
constexpr int P_STRIDE = 40;   // narrow: bf16 per P row (32 keys + 8: conflict-free ldmatrix)
constexpr int S_STRIDE = 40;   // narrow: f32 per partial S row (32 keys + 8: conflict-free float2)

// Split-K scratch: acc [R, S, QSH, 512], m and l [R, S, QSH] f32 (QSH =
// QS * h, the rows of the longest row that may be split), n_splits [R],
// count [R, XS] (XS: tile groups of such a row); acc null: S == 1
struct MlaSplits {
  float* acc;
  float* m;
  float* l;
  int* n;
  int* count;
  int S;
  int QSH;
  int XS;
};

// What one block computes: pairs row0 .. row0 + ROWS - 1 (those below
// nrows) of row r, keys [klo, khi); split s of nsplit (0: not split)
struct MlaJob {
  int ql, sl, nrows, row0, xg;
  int s, nsplit, klo, khi;
  long qrow0;  // the block's first row of q / out
};

// The block's job from the row's split plan (ops.attention.split_plan with
// window 0; rows of at most QS = max(1, 64 / h) tokens are split, in either
// form); false where the block has no work (an empty row, or blocks
// past the row's work). Writes the row's split count once.
template <int ROWS>
__device__ __forceinline__ bool mla_job(const MlaSplits& sp, const int* __restrict__ q_starts,
                                        const int* __restrict__ q_lens,
                                        const int* __restrict__ seq_lens, int h, int bs,
                                        MlaJob& job) {
  const int r = blockIdx.y;
  job.ql = q_lens[r];
  job.sl = seq_lens[r];
  const bool live = job.ql > 0 && job.sl > 0;
  const int QS = max(1, MLA_WIDE_ROWS / h);  // both forms: every narrow launch's rows
  int split = 0;
  job.nsplit = 0;
  if (live && sp.S > 1 && job.ql <= QS) {
    const int per = (job.sl + sp.S - 1) / sp.S;
    split = max(MLA_SPLIT_KEYS, (per + bs - 1) / bs * bs);
    job.nsplit = (job.sl + split - 1) / split;
    if (job.nsplit < 2) job.nsplit = 0;
  }
  if (sp.n != nullptr && blockIdx.x == 0 && threadIdx.x == 0) sp.n[r] = job.nsplit;
  if (!live) return false;
  // blockIdx.x: the tile group of an unsplit row, or (split, tile group)
  // of a split one
  job.nrows = job.ql * h;
  const int xs = (job.nrows + ROWS - 1) / ROWS;
  job.s = 0;
  job.xg = blockIdx.x;
  if (job.nsplit) {
    job.s = blockIdx.x / xs;
    job.xg = blockIdx.x % xs;
    if (job.s >= job.nsplit) return false;
  } else if (job.xg >= xs) {
    return false;
  }
  job.row0 = job.xg * ROWS;
  const int last_tok = (min(job.row0 + ROWS, job.nrows) - 1) / h;
  const int kend = job.sl - job.ql + last_tok + 1;  // keys the block's last token sees
  job.klo = job.nsplit ? job.s * split : 0;
  job.khi = job.nsplit ? min(job.klo + split, kend) : kend;
  job.qrow0 = (long)q_starts[r] * h + job.row0;
  return true;
}

// element offset of key ``key``'s row in the cache
__device__ __forceinline__ long mla_key_row(const int* __restrict__ table, int key, int bs,
                                            int bs_shift) {
  const int page = bs_shift >= 0 ? key >> bs_shift : key / bs;
  const int in_page = bs_shift >= 0 ? key & (bs - 1) : key % bs;
  return ((long)table[page] * bs + in_page) * MLA_DQK;
}

// rows of partial state one bulk copy of the merge brings (32 KB)
constexpr int MLA_MCH = 16;

// After a split block wrote its partial state: the last split block of
// (r, xg) to arrive merges every split, in split order. Every (split, row)
// pair's m and l first go to shared memory, all their loads in flight at
// once; then each row's weights exp(m_x - M) (0 where l_x = 0) and their
// sum L. The partial accumulators (nsplit x ROWS x 2 KB: 4 MB for a G =
// 128 row of 32 splits, more than one SM's loads keep in flight) arrive
// by bulk copies of MLA_MCH rows of one split, NBUF of them in flight,
// issued by one thread and completing on an mbarrier each; every thread
// adds its 4 lanes of every (THREADS / 128)-th row of the chunk, in split
// order. s_w: (2 nsplit + 1) * ROWS floats of shared memory no thread
// reads any more; buf: NBUF * MLA_MCH * 512 such floats, 16-byte aligned;
// bars: NBUF 8-byte mbarriers; s_last: an int (the kernels keep all their
// shared memory dynamic). Run by the THREADS threads t = 0 .. THREADS - 1
// that barrier BAR joins.
template <int ROWS, int THREADS, int NBUF, int BAR>
__device__ void mla_merge(const MlaSplits& sp, const MlaJob& job, int t, float* s_w,
                          float* buf, uint64_t* bars, int& s_last,
                          __nv_bfloat16* __restrict__ out) {
  const int r = blockIdx.y, nsplit = job.nsplit;
  __threadfence();
  bar_sync(BAR, THREADS);
  int* counter = sp.count + (long)r * sp.XS + job.xg;
  if (t == 0) s_last = atomicAdd(counter, 1) == nsplit - 1;
  bar_sync(BAR, THREADS);
  if (!s_last) return;
  __threadfence();
  float* s_l = s_w + nsplit * ROWS;                       // [nsplit][ROWS]
  float* s_L = s_l + nsplit * ROWS;                       // [ROWS]
  const long rbase = (long)r * sp.S * sp.QSH + job.row0;  // split x, row j: rbase + x * QSH + j
  const int nr = min(ROWS, job.nrows - job.row0);
  const int nchunks = (nr + MLA_MCH - 1) / MLA_MCH, items = nchunks * nsplit;
  const uint32_t buf_s = smem_addr(buf), bar_s = smem_addr(bars);
  // item i: rows MLA_MCH * (i / nsplit) .. of split i % nsplit, into
  // buffer i % NBUF
  auto issue = [&](int i) {
    const int c = i / nsplit, x = i % nsplit, b = i % NBUF;
    const uint32_t bytes = (uint32_t)min(MLA_MCH, nr - c * MLA_MCH) * MLA_DV * 4;
    mbar_expect_tx(bar_s + 8 * b, bytes);
    bulk_g2s(buf_s + b * (MLA_MCH * MLA_DV * 4),
             sp.acc + (rbase + (long)x * sp.QSH + c * MLA_MCH) * MLA_DV, bytes, bar_s + 8 * b);
  };
  if (t == 0) {
#pragma unroll
    for (int b = 0; b < NBUF; ++b) mbar_init(bar_s + 8 * b, 1);
    fence_mbar_init();
  }
  // the buffers' bytes were the ring's: every thread's generic accesses of
  // them before the copies' writes
  fence_async_smem();
  bar_sync(BAR, THREADS);
  if (t == 0) {
    fence_async_global();
    for (int i = 0; i < min(NBUF, items); ++i) issue(i);
  }
  for (int i = t; i < nsplit * nr; i += THREADS) {
    const int x = i / nr, j = i % nr;
    const long at = rbase + (long)x * sp.QSH + j;
    s_w[x * ROWS + j] = __ldcg(sp.m + at);
    s_l[x * ROWS + j] = __ldcg(sp.l + at);
  }
  bar_sync(BAR, THREADS);
  if (t < nr) {
    float M = NEG_INF;
    for (int x = 0; x < nsplit; ++x)
      if (s_l[x * ROWS + t] > 0.f) M = fmaxf(M, s_w[x * ROWS + t]);
    float L = 0.f;
    for (int x = 0; x < nsplit; ++x) {
      const float lx = s_l[x * ROWS + t];
      const float w = lx > 0.f ? __expf(s_w[x * ROWS + t] - M) : 0.f;
      L += lx * w;
      s_w[x * ROWS + t] = w;
    }
    s_L[t] = L;
  }
  bar_sync(BAR, THREADS);
  constexpr int CG = MLA_DV / 4;       // 16-byte lane groups of a row
  constexpr int RSTEP = THREADS / CG;  // rows between one thread's rows
  constexpr int MR = MLA_MCH / RSTEP;  // its rows of a chunk
  const int cg = t % CG, rsub = t / CG;
  float4 a[MR];
  for (int i = 0; i < items; ++i) {
    const int c = i / nsplit, x = i % nsplit, b = i % NBUF;
    if (x == 0) {
#pragma unroll
      for (int k = 0; k < MR; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    mbar_wait(bar_s + 8 * b, (uint32_t)(i / NBUF) & 1u);
    const float4* src = reinterpret_cast<const float4*>(buf + b * (MLA_MCH * MLA_DV));
#pragma unroll
    for (int k = 0; k < MR; ++k) {
      const int row = rsub + k * RSTEP;
      if (c * MLA_MCH + row >= nr) continue;
      const float w = s_w[x * ROWS + c * MLA_MCH + row];
      const float4 v = src[row * CG + cg];
      a[k].x += w * v.x;
      a[k].y += w * v.y;
      a[k].z += w * v.z;
      a[k].w += w * v.w;
    }
    fence_async_smem();
    bar_sync(BAR, THREADS);  // buffer b read by every thread
    if (t == 0 && i + NBUF < items) issue(i + NBUF);
    if (x == nsplit - 1) {
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        const int row = c * MLA_MCH + rsub + k * RSTEP;
        if (row >= nr) continue;
        const float inv = 1.0f / fmaxf(s_L[row], 1e-30f);
        __nv_bfloat162* o2 =
            reinterpret_cast<__nv_bfloat162*>(out + (job.qrow0 + row) * MLA_DV + cg * 4);
        o2[0] = __floats2bfloat162_rn(a[k].x * inv, a[k].y * inv);
        o2[1] = __floats2bfloat162_rn(a[k].z * inv, a[k].w * inv);
      }
    }
  }
  if (t == 0) *counter = 0;  // ready for the next launch on this stream
}

// ---------------------------------------------------------------------------
// The narrow form: 16 rows, mma.sync, 2-stage ring of 32-key tiles
// ---------------------------------------------------------------------------

struct __align__(128) NarrowSmem {
  static constexpr int ROWS = MLA_NARROW_ROWS;
  __nv_bfloat16 k[MLA_NST][MLA_NK * MLA_DQK];
  __nv_bfloat16 q[ROWS * MLA_DQK];
  __nv_bfloat16 p[ROWS * P_STRIDE];
  float s_part[4][ROWS * S_STRIDE];  // each warp's S over its quarter of the lanes
  float m_run[ROWS], l_run[ROWS], alpha[ROWS];
  uint64_t bar[2];  // the merge's
  int last;
};

// byte offset of chunk c of row j in a swizzled tile of 576-lane rows (72
// chunks): chunk c sits at c ^ (j & 7) within its group of 8
__device__ __forceinline__ uint32_t swz(int j, int c) {
  return (uint32_t)((j * MLA_QCH + ((c & ~7) | ((c ^ j) & 7))) << 4);
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(128, 2)
latent_narrow(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
              const int* __restrict__ tables, const int* __restrict__ q_starts,
              const int* __restrict__ q_lens, const int* __restrict__ seq_lens,
              __nv_bfloat16* __restrict__ out, const MlaSplits sp, int h, int bs,
              int max_blocks) {
  constexpr int ROWS = MLA_NARROW_ROWS, THREADS = 128;
  constexpr int LW = MLA_DV / 4;  // output lanes of one warp
  constexpr int NT = LW / 8;      // their n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  NarrowSmem& sm = *reinterpret_cast<NarrowSmem*>(smem_raw);
  MlaJob job;
  if (!mla_job<ROWS>(sp, q_starts, q_lens, seq_lens, h, bs, job)) return;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int ntiles = job.khi > job.klo ? (job.khi - job.klo + MLA_NK - 1) / MLA_NK : 0;
  const int* table = tables + (long)blockIdx.y * max_blocks;
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;

  const uint32_t q_s = smem_addr(sm.q), p_s = smem_addr(sm.p);
  // Q, rows past the row's pairs zero-filled; it lands with the first tile
  for (int i = t; i < ROWS * MLA_QCH; i += THREADS) {
    const int j = i / MLA_QCH, c = i % MLA_QCH;
    const bool ok = job.row0 + j < job.nrows;
    cp_async16(q_s + swz(j, c), q + (ok ? (job.qrow0 + j) * MLA_DQK + c * 8 : 0),
               ok ? 16 : 0);
  }
  // one tile's copies: thread t copies key t / 4, chunks t % 4 + 4i (one
  // page-table read a tile, not one a chunk); keys past khi zero-filled,
  // never read
  static_assert(MLA_NK * 4 == THREADS, "four threads a key");
  const int lkey = t >> 2, lc = t & 3;
  auto load_tile = [&](int it) {
    if (it >= ntiles) return;
    const uint32_t k_s = smem_addr(sm.k[it % MLA_NST]);
    const int key = job.klo + it * MLA_NK + lkey;
    const bool ok = key < job.khi;
    const __nv_bfloat16* src = ok ? kc + mla_key_row(table, key, bs, bs_shift) : kc;
#pragma unroll
    for (int i = 0; i < MLA_QCH / 4; ++i) {
      const int c = lc + 4 * i;
      cp_async16(k_s + swz(lkey, c), src + c * 8, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int it = 0; it < MLA_NST - 1; ++it) {
    load_tile(it);
    cp_async_commit();
  }

  // S: warp w takes lanes 144w .. 144w + 143 (9 k-steps) of all 32 keys
  // (4 n-tiles), its Q fragments held in registers over the tiles; the 4
  // partial S tiles are summed through shared memory. Softmax: warp w
  // owns rows 4w .. 4w + 3 (8 lanes a row, 4 keys a lane), their running
  // max and sum in registers. P.V: warp w adds its 128 output lanes for
  // all 16 rows.
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const int pos = job.sl - job.ql + job.row0 / h;  // the token's position (h % 16 == 0)
  const int lim = min(pos + 1, job.khi);           // keys < lim are seen
  const int srow = warp * 4 + (lane >> 3), skey = (lane & 7) * 4;  // softmax row, first key
  const float scale = 1.0f / sqrtf((float)MLA_DQK);
  float m_run = NEG_INF, l_run = 0.f;
  uint32_t qa[9][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<MLA_NST - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    load_tile(it + MLA_NST - 1);
    cp_async_commit();
    const int base = job.klo + it * MLA_NK;
    const uint32_t k_s = smem_addr(sm.k[it % MLA_NST]);
    if (it == 0) {  // Q landed with the first tile
      const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
#pragma unroll
      for (int ks = 0; ks < 9; ++ks)
        ldsm4(q_s + swz(arow, 18 * warp + 2 * ks + ahalf), qa[ks]);
    }

    // this warp's partial S: 9 k-steps x 4 n-tiles; one ldmatrix.x4 brings
    // a k-step's B fragments of two n-tiles
    float sacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
    {
      const int mi = lane >> 3;
#pragma unroll
      for (int ks = 0; ks < 9; ++ks) {
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          uint32_t b[4];
          ldsm4(k_s + swz((2 * pr + (mi >> 1)) * 8 + (lane & 7), 18 * warp + 2 * ks + (mi & 1)),
                b);
          mma16816(sacc[2 * pr], qa[ks], b[0], b[1]);
          mma16816(sacc[2 * pr + 1], qa[ks], b[2], b[3]);
        }
      }
    }
    float* part = sm.s_part[warp];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<float2*>(&part[g * S_STRIDE + nt * 8 + cq]) =
          make_float2(sacc[nt][0], sacc[nt][1]);
      *reinterpret_cast<float2*>(&part[(g + 8) * S_STRIDE + nt * 8 + cq]) =
          make_float2(sacc[nt][2], sacc[nt][3]);
    }
    __syncthreads();  // the partial S tiles are in

    // softmax of row srow over keys skey .. skey + 3 (8 lanes a row)
    float sv[4];
    {
      float4 x = *reinterpret_cast<const float4*>(&sm.s_part[0][srow * S_STRIDE + skey]);
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float4 y = *reinterpret_cast<const float4*>(&sm.s_part[w][srow * S_STRIDE + skey]);
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      sv[0] = x.x;
      sv[1] = x.y;
      sv[2] = x.z;
      sv[3] = x.w;
    }
    float mx = NEG_INF;
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // scale and causal mask
      sv[e] = base + skey + e < lim ? sv[e] * scale : NEG_INF;
      mx = fmaxf(mx, sv[e]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx), alpha = __expf(m_run - m_new);
    float pv[4], psum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // masked keys weigh exactly 0
      pv[e] = sv[e] > 0.5f * NEG_INF ? __expf(sv[e] - m_new) : 0.f;
      psum += pv[e];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    m_run = m_new;
    l_run = l_run * alpha + psum;
    __nv_bfloat162* prow = reinterpret_cast<__nv_bfloat162*>(&sm.p[srow * P_STRIDE + skey]);
    prow[0] = __floats2bfloat162_rn(pv[0], pv[1]);
    prow[1] = __floats2bfloat162_rn(pv[2], pv[3]);
    if ((lane & 7) == 0) sm.alpha[srow] = alpha;
    __syncthreads();  // P and the rescale factors are in

    // O = O * alpha + P V over this warp's lanes; V's B fragments are
    // transposed reads of the key tile's first 512 lanes
    const float aa = sm.alpha[g], ab = sm.alpha[g + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= aa;
      acc[n][1] *= aa;
      acc[n][2] *= ab;
      acc[n][3] *= ab;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
      const int prow_l = (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm4(p_s + (uint32_t)(prow_l * P_STRIDE + kk * 16 + (lane >> 4) * 8) * 2, pa);
      const int vkey = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm4_t(k_s + swz(vkey, warp * NT + 2 * np + (lane >> 4)), b);
        mma16816(acc[2 * np], pa, b[0], b[1]);
        mma16816(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait_all();
  if ((lane & 7) == 0) {
    sm.m_run[srow] = m_run;
    sm.l_run[srow] = l_run;
  }
  __syncthreads();  // the row state is in

  const int lane0 = warp * LW + cq;  // this thread's output lanes: lane0 + n * 8 + {0, 1}
  if (!job.nsplit) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = g + hf * 8;
      if (job.row0 + row >= job.nrows) continue;
      const float inv = 1.0f / fmaxf(sm.l_run[row], 1e-30f);
      __nv_bfloat16* dst = out + (job.qrow0 + row) * MLA_DV + lane0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * hf] * inv, acc[n][2 * hf + 1] * inv);
    }
    return;
  }
  // this split's partial state: rows (r, s, row0 + row)
  const long prow0 = ((long)blockIdx.y * sp.S + job.s) * sp.QSH + job.row0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = g + hf * 8;
    if (job.row0 + row >= job.nrows) continue;
    float* dst = sp.acc + (prow0 + row) * MLA_DV + lane0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
  }
  if (t < ROWS && job.row0 + t < job.nrows) {
    sp.m[prow0 + t] = sm.m_run[t];
    sp.l[prow0 + t] = sm.l_run[t];
  }
  // the merge: weights in Q's bytes, 2 bulk-copy buffers in the ring's
  mla_merge<ROWS, THREADS, 2, 0>(sp, job, t, reinterpret_cast<float*>(sm.q),
                                 reinterpret_cast<float*>(sm.k[0]), sm.bar, sm.last, out);
}

// ---------------------------------------------------------------------------
// The wide form: 64 rows, a producer warpgroup and two consumer warpgroups,
// wgmma, 2-stage ring of 64-key tiles
// ---------------------------------------------------------------------------

constexpr int WIDE_THREADS = 384;        // producer warpgroup, then 2 consumer warpgroups
constexpr int WIDE_CONSUMERS = 256;
// setmaxnreg: a block starts at 168 registers a thread (65,536 / 384);
// the producer gives back (168 - 56) x 128, the consumers take (224 - 168)
// x 256
constexpr int WIDE_PRODUCER_REGS = 56;
constexpr int WIDE_CONSUMER_REGS = 224;
constexpr int WIDE_BAR = 1;              // the consumers' named barrier

// Q and each key tile: 9 swizzle regions of 64 rows x 128 B (sw128_off<64>);
// P: one region (64 rows x 64 keys); red: the consumers' row maxima in
// the loop, their row sums after it; full / empty: each ring stage's
// mbarriers. 230,400 B (+ 1024 of alignment slack) of the 232,448 a block
// may take
struct __align__(1024) WideSmem {
  __nv_bfloat16 q[MLA_WIDE_ROWS * MLA_DQK];
  __nv_bfloat16 k[2][MLA_WK * MLA_DQK];
  __nv_bfloat16 p[MLA_WIDE_ROWS * MLA_WK];
  float red[2][MLA_WIDE_ROWS];
  uint64_t full[2], empty[2];
  uint64_t bar[4];  // the merge's
  int last;
};

__global__ void __launch_bounds__(WIDE_THREADS, 1)
latent_wide(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
            const int* __restrict__ tables, const int* __restrict__ q_starts,
            const int* __restrict__ q_lens, const int* __restrict__ seq_lens,
            __nv_bfloat16* __restrict__ out, const MlaSplits sp, int h, int bs,
            int max_blocks) {
  constexpr int ROWS = MLA_WIDE_ROWS;
  constexpr int REGION = ROWS * 128;  // bytes of one swizzle region (64 rows or keys)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideSmem& sm = tile_smem<WideSmem>(smem_raw);
  MlaJob job;
  if (!mla_job<ROWS>(sp, q_starts, q_lens, seq_lens, h, bs, job)) return;
  const int ntiles = job.khi > job.klo ? (job.khi - job.klo + MLA_WK - 1) / MLA_WK : 0;
  const uint32_t q_s = smem_addr(sm.q), p_s = smem_addr(sm.p);
  const uint32_t full_s = smem_addr(sm.full), empty_s = smem_addr(sm.empty);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(full_s + 8 * b, 128);  // every producer thread's copies
      mbar_init(empty_s + 8 * b, WIDE_CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: Q with the first tile, then each tile once the
    // consumers released its stage; thread t copies keys t / 8 + 16j of a
    // tile, chunks t % 8 + 8i (each warp: 4 keys, 128 contiguous bytes of
    // each per copy); keys past khi zero-filled, never read
    regs_dec<WIDE_PRODUCER_REGS>();
    if (ntiles == 0) return;
    const int t = threadIdx.x, lkey = t >> 3, lc = t & 7;
    const int* table = tables + (long)blockIdx.y * max_blocks;
    const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
    for (int i = t; i < ROWS * MLA_QCH; i += 128) {
      const int j = i / MLA_QCH, c = i % MLA_QCH;
      const bool ok = job.row0 + j < job.nrows;
      cp_async16(q_s + sw128_off<ROWS>(j, c),
                 q + (ok ? (job.qrow0 + j) * MLA_DQK + c * 8 : 0), ok ? 16 : 0);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int slot = it & 1, base = job.klo + it * MLA_WK;
      if (it >= 2) mbar_wait(empty_s + 8 * slot, ((it >> 1) - 1) & 1);
      const uint32_t k_s = smem_addr(sm.k[slot]);
#pragma unroll 1
      for (int j = 0; j < MLA_WK / 16; ++j) {
        const int kr = lkey + 16 * j, key = base + kr;
        const bool ok = key < job.khi;
        const __nv_bfloat16* src = ok ? kc + mla_key_row(table, key, bs, bs_shift) : kc;
#pragma unroll
        for (int i = 0; i < MLA_QCH / 8; ++i)
          cp_async16(k_s + sw128_off<ROWS>(kr, lc + 8 * i), src + (lc + 8 * i) * 8,
                     ok ? 16 : 0);
      }
      cp_async_mbar_arrive(full_s + 8 * slot);
    }
    cp_async_wait_all();
    return;
  }

  // the consumers: t = 0 .. 255, warpgroup cw
  regs_inc<WIDE_CONSUMER_REGS>();
  const int t = threadIdx.x - 128, cw = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  // this thread's fragment rows r0 and r0 + 8 (entries with (i / 2) % 2 ==
  // rr); S columns (i / 4) * 8 + cq + i % 2 of this warpgroup's 32 keys
  const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  int lim[2];
  float m[2], lsum[2];  // lsum: this thread's share of its warpgroup's row sum
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = job.row0 + r0 + 8 * rr;
    lim[rr] = row < job.nrows ? min(job.sl - job.ql + row / h + 1, job.khi) : 0;
    m[rr] = NEG_INF;
    lsum[rr] = 0.f;
  }
  const float scale = 1.0f / sqrtf((float)MLA_DQK);
  float o[2][64];  // output lanes 256 cw + 128 half + (i / 4) * 8 + cq + i % 2
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[hf][i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it & 1, base = job.klo + it * MLA_WK;
    mbar_wait(full_s + 8 * slot, (it >> 1) & 1);
    fence_async_smem();  // the copies' writes (generic) before the tensor cores' reads
    const uint32_t k_s = smem_addr(sm.k[slot]);

    // S = Q K^T over this warpgroup's 32 keys
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MLA_DQK / 16; ++kk) {
      const uint32_t off = (kk >> 2) * REGION + (kk & 3) * 32;
      wgmma_ss_n32(s, sw128_desc(q_s + off, 16, 1024),
                   sw128_desc(k_s + off + cw * 32 * 128, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // scale and causal mask; this warpgroup's row maxima -> shared
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int rr = (i >> 1) & 1;
      const int key = base + cw * 32 + (i >> 2) * 8 + cq + (i & 1);
      const float x = key < lim[rr] ? s[i] * scale : NEG_INF;
      s[i] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    if ((lane & 3) == 0) {
      sm.red[cw][r0] = mx[0];
      sm.red[cw][r0 + 8] = mx[1];
    }
    bar_sync(WIDE_BAR, WIDE_CONSUMERS);
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      const float m_new = fmaxf(m[rr], fmaxf(sm.red[0][row], sm.red[1][row]));
      alpha[rr] = __expf(m[rr] - m_new);
      m[rr] = m_new;
      lsum[rr] *= alpha[rr];
    }
    // P (bf16) -> this warpgroup's 32 columns of the shared P tile
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int rr = (i >> 1) & 1;
      // masked keys weigh exactly 0
      const float p0 = s[i] > 0.5f * NEG_INF ? __expf(s[i] - m[rr]) : 0.f;
      const float p1 = s[i + 1] > 0.5f * NEG_INF ? __expf(s[i + 1] - m[rr]) : 0.f;
      lsum[rr] += p0 + p1;
      const uint32_t at = p_s + sw128_off<ROWS>(r0 + 8 * rr, cw * 4 + (i >> 2)) + cq * 2;
      const __nv_bfloat162 b = __floats2bfloat162_rn(p0, p1);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(*reinterpret_cast<const uint32_t*>(&b))
                   : "memory");
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[hf][i] *= alpha[(i >> 1) & 1];
    fence_async_smem();
    bar_sync(WIDE_BAR, WIDE_CONSUMERS);  // both halves of P are in

    // O += P V over this warpgroup's 256 lanes: V regions 4cw .. 4cw + 3
    // of the key tile, MN-major
    fence_regs(o[0]);
    fence_regs(o[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MLA_WK / 16; ++kk) {
      const uint64_t dp = sw128_desc(p_s + kk * 32, 16, 1024);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        wgmma_ss_n128_tb(o[hf], dp,
                         sw128_desc(k_s + (4 * cw + 2 * hf) * REGION + kk * 16 * 128, REGION,
                                    1024));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o[0]);
    fence_regs(o[1]);
    mbar_arrive(empty_s + 8 * slot);  // this thread is done with the stage
  }

  // the row sums: quads, then the two warpgroups' keys (every read of the
  // row maxima came before the last P barrier)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float l = quad_sum(lsum[rr]);
    if ((lane & 3) == 0) sm.red[cw][r0 + 8 * rr] = l;
  }
  bar_sync(WIDE_BAR, WIDE_CONSUMERS);
  float l[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l[rr] = sm.red[0][r0 + 8 * rr] + sm.red[1][r0 + 8 * rr];

  const int lane0 = cw * 256 + cq;  // + 128 hf + j * 8 + {0, 1}
  if (!job.nsplit) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      if (job.row0 + row >= job.nrows) continue;
      const float inv = 1.0f / fmaxf(l[rr], 1e-30f);
      __nv_bfloat16* dst = out + (job.qrow0 + row) * MLA_DV + lane0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + hf * 128 + j * 8) = __floats2bfloat162_rn(
              o[hf][4 * j + 2 * rr] * inv, o[hf][4 * j + 2 * rr + 1] * inv);
    }
    return;
  }
  const long prow0 = ((long)blockIdx.y * sp.S + job.s) * sp.QSH + job.row0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (job.row0 + row >= job.nrows) continue;
    float* dst = sp.acc + (prow0 + row) * MLA_DV + lane0;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(dst + hf * 128 + j * 8) =
            make_float2(o[hf][4 * j + 2 * rr], o[hf][4 * j + 2 * rr + 1]);
    if (cw == 0 && (lane & 3) == 0) {
      sp.m[prow0 + row] = m[rr];
      sp.l[prow0 + row] = l[rr];
    }
  }
  // the merge, by the consumers (every copy of the producer has landed):
  // weights in Q's bytes, 4 bulk-copy buffers in the ring's
  mla_merge<ROWS, WIDE_CONSUMERS, 4, WIDE_BAR>(sp, job, t, reinterpret_cast<float*>(sm.q),
                                               reinterpret_cast<float*>(sm.k[0]), sm.bar,
                                               sm.last, out);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// the kernel of a form, its threads and dynamic shared memory; false for
// a form that does not exist
struct MlaForm {
  const void* fn;
  int threads, smem, q_bytes;
};

inline bool mla_form(int rows, MlaForm& f) {
  if (rows == MLA_NARROW_ROWS) {
    f = {(const void*)latent_narrow, 128, (int)sizeof(NarrowSmem), (int)sizeof(NarrowSmem::q)};
  } else if (rows == MLA_WIDE_ROWS) {
    f = {(const void*)latent_wide, WIDE_THREADS, tile_smem_bytes<WideSmem>(),
         (int)sizeof(WideSmem::q)};
  } else {
    return false;
  }
  return true;
}

}  // namespace dtt

// q [Tq, h, 576] bf16 (h a multiple of 16, at most 128), kv cache
// [num_blocks, bs, 1, 576] bf16 (V = its first 512 lanes), tables [R,
// max_blocks] int32, q_starts, q_lens, seq_lens [R] int32 -> out [Tq, h,
// 512] bf16 (rows' tokens only). rows: the form, 16 (narrow) or 64
// (wide). Split-K: S >= 1 splits at most per row; with
// S > 1, part holds f32 acc [R, S, QSH, 512], then m and l [R, S, QSH]
// (QSH = max(1, 64 / h) * h in both forms), and counts [R, XS] int32 (XS =
// ceil(QSH / rows), the tile groups of a row of QSH pairs) must be 0 (the kernel
// leaves them 0). n_splits [R] int32 (nullable) receives each row's split
// count, 0 = not split. Returns cudaGetLastError() after the launch.
extern "C" int dtt_latent_attention(const void* q, const void* kc, const void* tables,
                                    const void* q_starts, const void* q_lens,
                                    const void* seq_lens, void* out, void* part,
                                    void* n_splits, void* counts, int h, int bs, int R,
                                    int max_blocks, int max_q_len, int S, int rows,
                                    void* stream) {
  dtt::MlaForm f;
  if (h <= 0 || h % 16 || h > 128 || bs <= 0 || S < 1 || !dtt::mla_form(rows, f))
    return (int)cudaErrorInvalidValue;
  if (S > 1 && (!part || !counts)) return (int)cudaErrorInvalidValue;
  // the merging block stages (2S + 1) x rows floats in Q's bytes: S <= 143
  if ((2L * S + 1) * rows * 4 > f.q_bytes) return (int)cudaErrorInvalidValue;
  if (R <= 0 || max_q_len <= 0) return 0;
  const int qs = dtt::MLA_WIDE_ROWS / h > 1 ? dtt::MLA_WIDE_ROWS / h : 1;
  const int qsh = qs * h;
  const long n = (long)R * S * qsh;
  float* acc = static_cast<float*>(part);
  const dtt::MlaSplits sp{acc, acc ? acc + n * dtt::MLA_DV : nullptr,
                          acc ? acc + n * (dtt::MLA_DV + 1) : nullptr,
                          static_cast<int*>(n_splits), static_cast<int*>(counts), S, qsh,
                          (qsh + rows - 1) / rows};
  const cudaError_t err =
      cudaFuncSetAttribute(f.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (err != cudaSuccess) return (int)err;
  const int xg = (max_q_len * h + rows - 1) / rows;
  const dim3 grid(xg > S * sp.XS ? xg : S * sp.XS, R);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(kc);
  const int* tp = static_cast<const int*>(tables);
  const int* sp0 = static_cast<const int*>(q_starts);
  const int* lp = static_cast<const int*>(q_lens);
  const int* slp = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rows == dtt::MLA_WIDE_ROWS)
    dtt::latent_wide<<<grid, f.threads, f.smem, st>>>(qp, kp, tp, sp0, lp, slp, op, sp, h, bs,
                                                      max_blocks);
  else
    dtt::latent_narrow<<<grid, f.threads, f.smem, st>>>(qp, kp, tp, sp0, lp, slp, op, sp, h, bs,
                                                        max_blocks);
  return (int)cudaGetLastError();
}

// blocks of a form's kernel that fit one SM (the occupancy calculator) and
// its dynamic shared memory in bytes. Returns a CUDA error code.
extern "C" int dtt_latent_occupancy(int rows, int* blocks, int* smem) {
  dtt::MlaForm f;
  if (!dtt::mla_form(rows, f)) return (int)cudaErrorInvalidValue;
  *smem = f.smem;
  const cudaError_t err =
      cudaFuncSetAttribute(f.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f.fn, f.threads, f.smem);
}
