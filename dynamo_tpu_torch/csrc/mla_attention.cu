// Latent paged attention (MLA): ragged paged attention over a one-kv-head
// cache of latent rows, d_qk = 576 (kv_lora_rank 512 + qk_rope_head_dim
// 64), d_v = 512, with the splits of long rows merged in the same launch.
//
// The latent form of the TPU kernel dynamo_tpu/ops/pallas_unified.py:93
// (_unified_kernel, launched by ragged_paged_attention at :494), at a shape
// that kernel could not take (its Mosaic DMAs need head_dim % 128 == 0, so
// the reference runs MLA's attention in plain JAX). Same function as
// ops.attention.ragged_paged_attention on the cache, restricted to the
// first 512 output lanes: row r owns the query tokens
// q[q_starts[r] : q_starts[r] + q_lens[r]], at the tail of its seq_lens[r]
// keys, causal; tokens outside every row stay as the caller left them (0).
// q [Tq, h, 576] bf16, h = G (one kv head) a multiple of 16 up to 128;
// k/v cache [num_blocks, bs, 1, 576] bf16; out [Tq, h, 512] bf16. The
// model has pre-scaled q (models/mla.py); the kernel scales by
// 1/sqrt(576), as the plain op does, and by nothing else. It reads the
// first 512 lanes of each V row (row stride 576: lanes 512-575 of V are
// the reference's zero padding and are never read).
//
// Bound on this card: bytes for decode-shaped rows (each key brings
// 1152 B of K and 1024 B of V for G * 2 * 1088 flops: 16 flops per byte at
// G = 16), operations for prefill chunks. The design:
//   - rows: the (token, head) pairs of a row, flattened (token-major), in
//     tiles of 16: one mma.sync m16n8k16 row tile is exactly one token's 16
//     heads at G = 16, so a decode row wastes nothing. A block takes MT
//     such tiles (MT = 1 for decode batches at G = 16; MT = 2 when a launch
//     has rows of 32 or more pairs: prefill chunks, mixed steps, G = 128),
//     which share each K/V tile;
//   - registers: 16 rows x 512 f32 output lanes would be 256 accumulators
//     a thread in one warp. The block's 4 * MT warps split the 512 V lanes
//     (128 / MT each) and each warp keeps all MT tiles' rows for its lanes:
//     64 accumulators a thread. S = Q K^T (36 k-steps over 576) is computed
//     once per key tile, warp w taking tile w / 4's rows and keys 8 * (w %
//     4) .. + 7; the scores go through shared memory (per-warp row maxima
//     and sums, then P in bf16), and every warp adds its own lanes of P V;
//   - shared memory: a 2-stage cp.async ring of 32-key tiles (K 32 x 576 x
//     2 B = 36,864 B and V 32 x 512 x 2 B = 32,768 B a stage), Q (16 * MT
//     rows x 1152 B, 18,432 B a tile), P (16 * MT x 80 B) and the row
//     state: 159,744 B at MT = 1 and 180,224 B at MT = 2 (one block per SM;
//     the ring keeps a 69,632-byte tile in flight while the last computes).
//     Rows are 128-byte swizzled (16-byte chunk c of row j at c ^ (j & 7)
//     within its group of 8), so each ldmatrix's 8 rows hit 8 bank groups;
//   - split-K: a row of at most QS = max(1, 16 * MT / G) tokens is cut from
//     key 0 into splits of MLA_SPLIT_KEYS keys (longer where it would need
//     more than the grid's S, rounded up to a page): exactly
//     ops.attention.split_plan(q_len, seq_len, 0, MLA_SPLIT_KEYS, bs, S).
//     Each split block writes its rows' (m, l, unnormalized acc) in f32 to
//     scratch; the last split block of each (row, tile group) to finish
//     (__threadfence, then an atomicAdd on the pair's counter) merges all
//     of them in split order, so the result does not depend on which block
//     finished last, and resets the counter to 0. The plan does not depend
//     on the grid's extent for rows up to max_seq_len, so a CUDA graph
//     captured at a length bucket replays what the eager launch computes.
// The scratch and the counters are one buffer per (device, stream) that
// ops/cuda_attention.py keeps (launches on one stream run in order, so a
// launch finds every counter at 0). The kernel writes each row's split
// count (0 = not split) to n_splits, which the wrapper's split log reads.

#include "attn_common.cuh"

namespace dtt {

constexpr int MLA_DQK = 576;           // kv_lora_rank + qk_rope_head_dim
constexpr int MLA_DV = 512;            // lanes read from V and written out
constexpr int MLA_QCH = MLA_DQK / 8;   // 16-byte chunks of a Q / K row: 72
constexpr int MLA_VCH = MLA_DV / 8;    // chunks of a staged V row: 64
constexpr int MLA_TK = 32;             // keys per tile
// keys per split (16 pages of 16); ops/cuda_mla.py mirrors it
constexpr int MLA_SPLIT_KEYS = 256;
constexpr int P_STRIDE = 40;           // bf16 per P row: 32 keys + 8 (conflict-free ldmatrix)

template <int MT>
struct __align__(128) MlaSmem {
  static constexpr int ROWS = 16 * MT;
  __nv_bfloat16 k[2][MLA_TK * MLA_DQK];
  __nv_bfloat16 v[2][MLA_TK * MLA_DV];
  __nv_bfloat16 q[ROWS * MLA_DQK];
  __nv_bfloat16 p[ROWS * P_STRIDE];
  float m_run[ROWS], l_run[ROWS], alpha[ROWS], m_new[ROWS];
  float red_max[4][ROWS], red_sum[4][ROWS];
};

// byte offset of chunk c of row j in a swizzled tile of CH chunks a row
template <int CH>
__device__ __forceinline__ uint32_t swz(int j, int c) {
  return (uint32_t)((j * CH + ((c & ~7) | ((c ^ j) & 7))) << 4);
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

template <int MT>
__global__ void __launch_bounds__(128 * MT, 1)
latent_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
              const __nv_bfloat16* __restrict__ vc, const int* __restrict__ tables,
              const int* __restrict__ q_starts, const int* __restrict__ q_lens,
              const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
              const MlaSplits sp, int h, int bs, int max_blocks) {
  constexpr int ROWS = 16 * MT, THREADS = 128 * MT, NW = 4 * MT;
  constexpr int LW = MLA_DV / NW;  // V lanes of one warp
  constexpr int NT = LW / 8;       // their n-tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MlaSmem<MT>& sm = *reinterpret_cast<MlaSmem<MT>*>(smem_raw);
  const int r = blockIdx.y, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int ql = q_lens[r], sl = seq_lens[r];
  const bool live = ql > 0 && sl > 0;

  // the row's split plan (ops.attention.split_plan with window 0)
  const int QS = max(1, ROWS / h);
  int split = 0, nsplit = 0;
  if (live && sp.S > 1 && ql <= QS) {
    const int per = (sl + sp.S - 1) / sp.S;
    split = max(MLA_SPLIT_KEYS, (per + bs - 1) / bs * bs);
    nsplit = (sl + split - 1) / split;
    if (nsplit < 2) nsplit = 0;
  }
  if (sp.n != nullptr && blockIdx.x == 0 && t == 0) sp.n[r] = nsplit;
  if (!live) return;
  // blockIdx.x: the tile group of an unsplit row, or (split, tile group)
  // of a split one; blocks past the row's work exit at once
  const int nrows = ql * h, xs = (nrows + ROWS - 1) / ROWS;
  int s = 0, xg = blockIdx.x;
  if (nsplit) {
    s = blockIdx.x / xs;
    xg = blockIdx.x % xs;
    if (s >= nsplit) return;
  } else if (xg >= xs) {
    return;
  }
  const int row0 = xg * ROWS;
  const int last_tok = (min(row0 + ROWS, nrows) - 1) / h;
  const int kend = sl - ql + last_tok + 1;  // keys the block's last token sees
  const int klo = nsplit ? s * split : 0;
  const int khi = nsplit ? min(klo + split, kend) : kend;
  const int ntiles = khi > klo ? (khi - klo + MLA_TK - 1) / MLA_TK : 0;
  const long qrow0 = (long)q_starts[r] * h + row0;  // the block's first row of q / out
  const int* table = tables + (long)r * max_blocks;
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;

  const uint32_t q_s = smem_addr(sm.q), p_s = smem_addr(sm.p);
  // Q, rows past the row's pairs zero-filled; then the first K/V tile
  for (int i = t; i < ROWS * MLA_QCH; i += THREADS) {
    const int j = i / MLA_QCH, c = i % MLA_QCH;
    const bool ok = row0 + j < nrows;
    cp_async16(q_s + swz<MLA_QCH>(j, c), q + (ok ? (qrow0 + j) * MLA_DQK + c * 8 : 0),
               ok ? 16 : 0);
  }
  // one tile's copies: every chunk of the K rows, the first 64 chunks
  // (512 lanes) of the V rows; keys past khi zero-filled, never read
  auto load_tile = [&](int slot, int base) {
    const uint32_t k_s = smem_addr(sm.k[slot]), v_s = smem_addr(sm.v[slot]);
    for (int i = t; i < MLA_TK * MLA_QCH; i += THREADS) {
      const int j = i / MLA_QCH, c = i % MLA_QCH, key = base + j;
      const bool ok = key < khi;
      long off = 0;
      if (ok) {
        const int page = bs_shift >= 0 ? key >> bs_shift : key / bs;
        const int in_page = bs_shift >= 0 ? key & (bs - 1) : key % bs;
        off = ((long)table[page] * bs + in_page) * MLA_DQK + c * 8;
      }
      cp_async16(k_s + swz<MLA_QCH>(j, c), kc + off, ok ? 16 : 0);
      if (c < MLA_VCH) cp_async16(v_s + swz<MLA_VCH>(j, c), vc + off, ok ? 16 : 0);
    }
  };
  if (ntiles > 0) load_tile(0, klo);
  cp_async_commit();
  for (int i = t; i < ROWS; i += THREADS) {
    sm.m_run[i] = NEG_INF;
    sm.l_run[i] = 0.f;
  }

  // this warp's S tile: rows mi * 16 .. + 15 (one token: h % 16 == 0),
  // keys nw * 8 .. + 7 of each key tile
  const int mi = warp >> 2, nw = warp & 3;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  const bool valid = row0 + mi * 16 < nrows;
  const int pos = valid ? sl - ql + (row0 + mi * 16) / h : -1;  // the token's position
  const int ra = mi * 16 + g, rb = ra + 8;
  const float scale = 1.0f / sqrtf((float)MLA_DQK);
  float acc[MT][NT][4];
#pragma unroll
  for (int m2 = 0; m2 < MT; ++m2)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m2][n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < ntiles) load_tile((it + 1) & 1, klo + (it + 1) * MLA_TK);
    cp_async_commit();
    const int slot = it & 1, base = klo + it * MLA_TK;
    const uint32_t k_s = smem_addr(sm.k[slot]), v_s = smem_addr(sm.v[slot]);

    // S = Q K^T: 36 k-steps, the K fragments of two per ldmatrix.x4
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const int arow = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
      const int bkey = nw * 8 + (lane & 7), bq = lane >> 3;
#pragma unroll 6
      for (int kk = 0; kk < MLA_QCH / 2; kk += 2) {
        uint32_t b[4], a[4];
        ldsm4(k_s + swz<MLA_QCH>(bkey, 2 * kk + bq), b);
        ldsm4(q_s + swz<MLA_QCH>(arow, 2 * kk + ahalf), a);
        mma16816(sacc, a, b[0], b[1]);
        ldsm4(q_s + swz<MLA_QCH>(arow, 2 * kk + 2 + ahalf), a);
        mma16816(sacc, a, b[2], b[3]);
      }
    }
    // scale and causal mask: rows ra (sacc 0, 1) and rb (sacc 2, 3)
    float sv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = base + nw * 8 + cq + (e & 1);
      sv[e] = key <= pos && key < khi ? sacc[e] * scale : NEG_INF;
    }
    const float mxa = quad_max(fmaxf(sv[0], sv[1])), mxb = quad_max(fmaxf(sv[2], sv[3]));
    if ((lane & 3) == 0) {
      sm.red_max[nw][ra] = mxa;
      sm.red_max[nw][rb] = mxb;
    }
    __syncthreads();
    float mna = sm.m_run[ra], mnb = sm.m_run[rb];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mna = fmaxf(mna, sm.red_max[j][ra]);
      mnb = fmaxf(mnb, sm.red_max[j][rb]);
    }
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)  // masked keys weigh exactly 0
      pv[e] = sv[e] > 0.5f * NEG_INF ? __expf(sv[e] - (e < 2 ? mna : mnb)) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(&sm.p[ra * P_STRIDE + nw * 8 + cq]) =
        __floats2bfloat162_rn(pv[0], pv[1]);
    *reinterpret_cast<__nv_bfloat162*>(&sm.p[rb * P_STRIDE + nw * 8 + cq]) =
        __floats2bfloat162_rn(pv[2], pv[3]);
    const float sa = quad_sum(pv[0] + pv[1]), sb = quad_sum(pv[2] + pv[3]);
    if ((lane & 3) == 0) {
      sm.red_sum[nw][ra] = sa;
      sm.red_sum[nw][rb] = sb;
    }
    if (t < ROWS) {
      const float m = sm.m_run[t];
      float mn = m;
#pragma unroll
      for (int j = 0; j < 4; ++j) mn = fmaxf(mn, sm.red_max[j][t]);
      sm.alpha[t] = __expf(m - mn);
      sm.m_new[t] = mn;
    }
    __syncthreads();  // P, the row sums and the rescale factors are in
    if (t < ROWS) {
      float l = sm.l_run[t] * sm.alpha[t];
#pragma unroll
      for (int j = 0; j < 4; ++j) l += sm.red_sum[j][t];
      sm.l_run[t] = l;
      sm.m_run[t] = sm.m_new[t];
    }
    // O = O * alpha + P V over this warp's lanes, for every tile of rows
#pragma unroll
    for (int m2 = 0; m2 < MT; ++m2) {
      const float aa = sm.alpha[m2 * 16 + g], ab = sm.alpha[m2 * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[m2][n][0] *= aa;
        acc[m2][n][1] *= aa;
        acc[m2][n][2] *= ab;
        acc[m2][n][3] *= ab;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int m2 = 0; m2 < MT; ++m2) {
        const int prow = m2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm4(p_s + (uint32_t)(prow * P_STRIDE + kk * 16 + (lane >> 4) * 8) * 2, pa[m2]);
      }
      const int vkey = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm4_t(v_s + swz<MLA_VCH>(vkey, warp * NT + 2 * np + (lane >> 4)), b);
#pragma unroll
        for (int m2 = 0; m2 < MT; ++m2) {
          mma16816(acc[m2][2 * np], pa[m2], b[0], b[1]);
          mma16816(acc[m2][2 * np + 1], pa[m2], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the last tile's row state is in

  const int lane0 = warp * LW + cq;  // this thread's output lanes: lane0 + n * 8 + {0, 1}
  if (!nsplit) {
#pragma unroll
    for (int m2 = 0; m2 < MT; ++m2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m2 * 16 + g + hf * 8;
        if (row0 + row >= nrows) continue;
        const float inv = 1.0f / fmaxf(sm.l_run[row], 1e-30f);
        __nv_bfloat16* dst = out + (qrow0 + row) * MLA_DV + lane0;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
              acc[m2][n][2 * hf] * inv, acc[m2][n][2 * hf + 1] * inv);
      }
    }
    return;
  }
  // this split's partial state: rows (r, s, row0 + row)
  const long prow0 = ((long)r * sp.S + s) * sp.QSH + row0;
#pragma unroll
  for (int m2 = 0; m2 < MT; ++m2) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m2 * 16 + g + hf * 8;
      if (row0 + row >= nrows) continue;
      float* dst = sp.acc + (prow0 + row) * MLA_DV + lane0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(acc[m2][n][2 * hf], acc[m2][n][2 * hf + 1]);
    }
  }
  if (t < ROWS && row0 + t < nrows) {
    sp.m[prow0 + t] = sm.m_run[t];
    sp.l[prow0 + t] = sm.l_run[t];
  }
  __threadfence();
  __syncthreads();
  __shared__ int s_last;
  int* counter = sp.count + (long)r * sp.XS + xg;
  if (t == 0) s_last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  // the last split block of (r, xg): merge every split, in split order.
  // Each split's weight exp(m_x - M) (0 where l_x = 0) per row, and the
  // sum L, go to shared memory (the ring's bytes); then each thread sums
  // 4 lanes of one row over the splits
  __threadfence();
  float* s_w = reinterpret_cast<float*>(smem_raw);  // [nsplit][ROWS]
  float* s_L = s_w + nsplit * ROWS;                  // [ROWS]
  const long rbase = (long)r * sp.S * sp.QSH + row0;  // split x, row j: rbase + x * QSH + j
  const int nr = min(ROWS, nrows - row0);
  if (t < nr) {
    float M = NEG_INF;
    for (int x = 0; x < nsplit; ++x)
      if (__ldcg(sp.l + rbase + (long)x * sp.QSH + t) > 0.f)
        M = fmaxf(M, __ldcg(sp.m + rbase + (long)x * sp.QSH + t));
    float L = 0.f;
    for (int x = 0; x < nsplit; ++x) {
      const float lx = __ldcg(sp.l + rbase + (long)x * sp.QSH + t);
      const float w = lx > 0.f ? __expf(__ldcg(sp.m + rbase + (long)x * sp.QSH + t) - M) : 0.f;
      L += lx * w;
      s_w[x * ROWS + t] = w;
    }
    s_L[t] = L;
  }
  __syncthreads();
  for (int item = t; item < nr * (MLA_DV / 4); item += THREADS) {
    const int row = item / (MLA_DV / 4), c4 = (item % (MLA_DV / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x0 = 0; x0 < nsplit; x0 += 8) {  // 8 splits' loads in flight
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = x0 + u < nsplit
                   ? __ldcg(reinterpret_cast<const float4*>(
                         sp.acc + (rbase + (long)(x0 + u) * sp.QSH + row) * MLA_DV + c4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float w = x0 + u < nsplit ? s_w[(x0 + u) * ROWS + row] : 0.f;
        a.x += w * v[u].x;
        a.y += w * v[u].y;
        a.z += w * v[u].z;
        a.w += w * v[u].w;
      }
    }
    const float inv = 1.0f / fmaxf(s_L[row], 1e-30f);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + (qrow0 + row) * MLA_DV + c4);
    o2[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    o2[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
  if (t == 0) *counter = 0;  // ready for the next launch on this stream
}

template <int MT>
int launch_latent(const void* q, const void* kc, const void* vc, const void* tables,
                  const void* q_starts, const void* q_lens, const void* seq_lens, void* out,
                  const MlaSplits& sp, int h, int bs, int R, int max_blocks, int max_q_len,
                  cudaStream_t stream) {
  constexpr int ROWS = 16 * MT;
  constexpr int smem = (int)sizeof(MlaSmem<MT>);
  const cudaError_t err = cudaFuncSetAttribute(
      latent_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int xg = (max_q_len * h + ROWS - 1) / ROWS;
  const dim3 grid(xg > sp.S * sp.XS ? xg : sp.S * sp.XS, R);
  latent_kernel<MT><<<grid, 128 * MT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(tables),
      static_cast<const int*>(q_starts), static_cast<const int*>(q_lens),
      static_cast<const int*>(seq_lens), static_cast<__nv_bfloat16*>(out), sp, h, bs,
      max_blocks);
  return (int)cudaGetLastError();
}

template <int MT>
int occupancy(int* blocks, int* smem) {
  *smem = (int)sizeof(MlaSmem<MT>);
  const cudaError_t err = cudaFuncSetAttribute(
      latent_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, latent_kernel<MT>,
                                                            128 * MT, *smem);
}

}  // namespace dtt

// q [Tq, h, 576] bf16 (h a multiple of 16, at most 128), k/v cache
// [num_blocks, bs, 1, 576] bf16, tables [R, max_blocks] int32, q_starts,
// q_lens, seq_lens [R] int32 -> out [Tq, h, 512] bf16 (rows' tokens only).
// MT in {1, 2}: 16-row tiles per block. Split-K: S >= 1 splits at most per
// row; with S > 1, part holds f32 acc [R, S, QSH, 512], then m and l
// [R, S, QSH] (QSH = max(1, 16 * MT / h) * h), and counts [R, XS] int32
// (XS = ceil(QSH / (16 * MT)), the tile groups of a row of QSH rows) must
// be 0 (the kernel leaves them 0). n_splits [R] int32 (nullable) receives
// each row's split count, 0 = not split. Returns cudaGetLastError() after
// the launch.
extern "C" int dtt_latent_attention(const void* q, const void* kc, const void* vc,
                                    const void* tables, const void* q_starts,
                                    const void* q_lens, const void* seq_lens, void* out,
                                    void* part, void* n_splits, void* counts, int h, int bs,
                                    int R, int max_blocks, int max_q_len, int S, int MT,
                                    void* stream) {
  if (h <= 0 || h % 16 || h > 128 || bs <= 0 || S < 1 || (MT != 1 && MT != 2))
    return (int)cudaErrorInvalidValue;
  if (S > 1 && (!part || !counts)) return (int)cudaErrorInvalidValue;
  const int rows = 16 * MT;
  // the merging block stages (S + 1) x rows floats in the K ring's bytes
  if ((S + 1L) * rows * 4 > (long)sizeof(dtt::MlaSmem<1>::k)) return (int)cudaErrorInvalidValue;
  if (R <= 0 || max_q_len <= 0) return 0;
  const int qsh = (rows / h > 1 ? rows / h : 1) * h;
  const long n = (long)R * S * qsh;
  float* acc = static_cast<float*>(part);
  const dtt::MlaSplits sp{acc, acc ? acc + n * dtt::MLA_DV : nullptr,
                          acc ? acc + n * (dtt::MLA_DV + 1) : nullptr,
                          static_cast<int*>(n_splits), static_cast<int*>(counts), S, qsh,
                          (qsh + rows - 1) / rows};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (MT == 1)
    return dtt::launch_latent<1>(q, kc, vc, tables, q_starts, q_lens, seq_lens, out, sp, h,
                                 bs, R, max_blocks, max_q_len, s);
  return dtt::launch_latent<2>(q, kc, vc, tables, q_starts, q_lens, seq_lens, out, sp, h, bs,
                               R, max_blocks, max_q_len, s);
}

// blocks of latent_kernel<MT> that fit one SM (the occupancy calculator)
// and its dynamic shared memory in bytes. Returns a CUDA error code.
extern "C" int dtt_latent_occupancy(int mt, int* blocks, int* smem) {
  if (mt == 1) return dtt::occupancy<1>(blocks, smem);
  if (mt == 2) return dtt::occupancy<2>(blocks, smem);
  return (int)cudaErrorInvalidValue;
}
