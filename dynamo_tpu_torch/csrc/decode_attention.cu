// Paged decode attention: one query token per sequence over its own pages,
// split over the context, with the splits merged in the same launch.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_attention.py:36
// (_decode_kernel, launched by paged_decode_attention at :255) on the bf16
// cache and on the int8 cache (int8 pages plus f32 [num_blocks, kvh] scale
// rows). q [B, h, d] bf16 with head_dim d in {64, 128} and G = h / kvh in
// 1 .. 8 (Llama-3 G 4 at d 128 and Llama-3.2-1B G 4 at d 64, Qwen2.5's G 3,
// 5, 6 and 7), out [B, h, d] bf16; a row with seq_len == 0 reads back zeros.
//
// Bound on this card: bytes. Each (sequence, kv head) reads its K and V rows
// once (2 * seq_len * 2d bytes in bf16, half that plus one scale per page
// in int8) for its G query heads: about 4 * G flops per byte, far below the
// ~295 flops per byte at which an H100 stops being memory-bound. The design
// keeps the card's loads in flight and spends as few instructions per key
// as it can, so that a block streams its keys at the rate they arrive:
//   - split-K over the context: grid (split, kv head, row). A row's keys
//     are cut from key 0 into splits of DEC_SPLIT_KEYS keys (longer ones
//     where the row would need more than the grid's S splits, rounded up to
//     a page), exactly as ops.attention.split_plan(1, seq_len, 0,
//     DEC_SPLIT_KEYS, bs, S) cuts them; a block past its row's splits exits
//     at once. The llama check batch (8 rows of 1-2100 keys) runs 208
//     working blocks on the 132 SMs, against 64 with one block per
//     (row, kv head);
//   - each block streams its keys through a DEC_STAGES-deep cp.async ring of
//     DEC_TILE-key tiles in shared memory (16-byte copies; the page ids of a
//     tile are read from the block table one tile ahead of its copies), the
//     tile two ahead in flight while one is computed; keys past the split
//     are zero-filled by the copy, never read; the int8 tile brings its
//     pages' K and V scales, one read per page and kv head;
//   - the products run on the tensor cores, mma.sync m16n8k16 (bf16 in,
//     f32 out), the G <= 8 query heads padded to the 16 rows of an mma:
//     each of the 4 warps owns 16 keys of a tile, computes their scores
//     S = Q K^T (K read by ldmatrix from 128-byte-swizzled rows, Q held in
//     registers), takes ONE max and ONE rescale per head for them, and
//     adds P V (P straight from the S accumulators, V by ldmatrix.trans).
//     Any G up to 8 fills rows 0 .. G - 1 of the tile; rows G .. 15 stay
//     padding;
//   - head_dim 64: a bf16 key row is 128 bytes, 8 chunks of 16, so the
//     swizzle XORs all three chunk bits with the row's low bits (at 128 a
//     row has 16 chunks and the top bit is kept); the ring's stages are
//     half as large, S takes 4 k-steps and P V 8 n-tiles.
//     A first form on the CUDA cores (a half-warp per key, 16-lane shuffle
//     reductions) spent several times the instructions per key and was
//     slower on every decode case of chip_smoke.py (PERF.md); the padded
//     rows waste tensor-core work the card has to spare;
//   - the per-key address work is small: a power-of-two page size turns
//     the page and row of a key into a shift and a mask;
//   - int8: the payload is copied raw (half the bytes) and converted to
//     bf16 exactly in shared memory (attn_common.cuh's byte-permute
//     conversion); the page's K scale multiplies its score columns and its
//     V scale the probabilities before their bf16 rounding, so nothing is
//     dequantized in memory;
//   - the merge in the same launch: a split writes its (m, l, unnormalized
//     acc) in f32 to scratch; the LAST split block of each (row, kv head) to
//     finish (__threadfence, then an atomicAdd on the pair's counter) merges
//     all of the row's splits in split order, so the result does not depend
//     on which block finishes last, and resets the counter to 0 for the next
//     launch. A row that fits one split writes its output directly.
// The scratch and the counters are one buffer the wrapper keeps per device
// and passes by address: launches on one stream run in order, so one launch
// finds every counter back at 0 (the wrapper zeroes the buffer when it
// grows it). The kernel writes each row's split count (0 = not split) to
// n_splits, which the wrapper's split log reads.

#include "attn_common.cuh"

namespace dtt {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_TILE = 64;                   // keys per tile
constexpr int WKEYS = DEC_TILE / DEC_WARPS;    // keys per warp per tile: 16
constexpr int DEC_STAGES = 3;                  // ring depth
// keys per split (16 pages of 16); ops/cuda_attention.py mirrors it
constexpr int DEC_SPLIT_KEYS = 256;

// The ring: K and V rows of DEC_STAGES tiles (bf16: swizzled, int8: raw),
// and for int8 the tile converted to bf16, the K and V scale of each page
// a tile touches (at most DEC_TILE pages: a tile starts on a page boundary)
// and of each key. After the key loop the same bytes hold the merges.
template <int D, bool I8>
struct __align__(128) DecSmem {
  static constexpr int BF16_ROW = 2 * D;                 // bytes of a bf16 key row
  static constexpr int ROW = I8 ? D : BF16_ROW;          // bytes of a staged key row
  unsigned char k[DEC_STAGES][DEC_TILE * ROW];
  unsigned char v[DEC_STAGES][DEC_TILE * ROW];
  unsigned char kb[I8 ? DEC_TILE * BF16_ROW : 16];
  unsigned char vb[I8 ? DEC_TILE * BF16_ROW : 16];
  float ks[DEC_STAGES][I8 ? DEC_TILE : 4];
  float vs[DEC_STAGES][I8 ? DEC_TILE : 4];
  float kscale[I8 ? DEC_TILE : 4];
  float vscale[I8 ? DEC_TILE : 4];
};

// merge_warps' shared arrays for G = 8: s_acc [DEC_WARPS][G][D], s_m, s_l
static_assert(sizeof(DecSmem<64, false>) >= (DEC_WARPS * 8 * (64 + 2)) * 4 &&
                  sizeof(DecSmem<128, false>) >= (DEC_WARPS * 8 * (128 + 2)) * 4,
              "the ring must hold the block merge");

// byte offset of 16-byte chunk c (dims 8c .. 8c + 7) of key row j in a
// swizzled bf16 tile of head_dim D: the chunk index XOR the row's low 3
// bits, so the 8 rows one ldmatrix reads at one chunk fall on 8 different
// bank groups
template <int D>
__device__ __forceinline__ uint32_t row_off(int j, int c) {
  return (uint32_t)(j * 2 * D + ((c ^ (j & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulate; the A rows
// 8 .. 15 (registers a1, a3) are the padding rows, always 0 here
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split-K scratch (layouts in the entry points' comment); null acc: S == 1
struct DecSplits {
  float* acc;
  float* m;
  float* l;
  int* n;
  int* count;
  int S;
};

// Each warp holds, for its lane's row r = lane / 4 (a query head when
// r < G), an online-softmax state over the keys it saw: m, its quad's
// share of l, and o[nt][0..1] = dims nt * 8 + (lane % 4) * 2 + {0, 1}.
// Merge the warps through shared memory: threads t < G * D / 8 end with
// head g = t / (D / 8)'s block state for dims c = (t % (D / 8)) * 8 .. + 7
// in (M, L, O).
template <int D, int G>
__device__ __forceinline__ void merge_warps(float m, float l, const float (&o)[D / 8][4],
                                            unsigned char* smem, int warp, int lane,
                                            float& M, float& L, float (&O)[8]) {
  constexpr int CPH = D / 8;  // threads per head
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* s_acc = reinterpret_cast<float*>(smem);   // [DEC_WARPS][G][D]
  float* s_m = s_acc + DEC_WARPS * G * D;          // [DEC_WARPS][G]
  float* s_l = s_m + DEC_WARPS * G;
  const int r = lane >> 2, cq = (lane & 3) * 2;
  if (r < G) {
#pragma unroll
    for (int nt = 0; nt < CPH; ++nt)
      *reinterpret_cast<float2*>(&s_acc[(warp * G + r) * D + nt * 8 + cq]) =
          make_float2(o[nt][0], o[nt][1]);
    if ((lane & 3) == 0) {
      s_m[warp * G + r] = m;
      s_l[warp * G + r] = l;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= G * CPH) return;
  const int g = t / CPH, c = (t % CPH) * 8;
  M = NEG_INF;
#pragma unroll
  for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, s_m[w * G + g]);
  L = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) O[e] = 0.f;
#pragma unroll
  for (int w = 0; w < DEC_WARPS; ++w) {
    const float a = __expf(s_m[w * G + g] - M);
    L += s_l[w * G + g] * a;
#pragma unroll
    for (int e = 0; e < 8; ++e) O[e] += s_acc[(w * G + g) * D + c + e] * a;
  }
}

template <int D, int G, bool I8>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kc,
                    const void* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ tables,
                    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
                    const DecSplits sp, int h, int kvh, int bs, int max_blocks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  static_assert(D == 64 || D == 128, "the decode kernel takes head_dim 64 or 128");
  static_assert(G >= 1 && G <= 8, "G query heads fill at most 8 of an mma's 16 rows");
  using Smem = DecSmem<D, I8>;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  constexpr int ROW = Smem::ROW;
  constexpr int KSTEPS = D / 16, NTILES = D / 8;  // mma k-steps of S, n-tiles of P V
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = lane >> 2, cq = (lane & 3) * 2;  // this lane's fragment row and columns
  const int seq_len = lens[b];
  const int* table = tables + (long)b * max_blocks;

  // the row's split plan (ops.attention.split_plan with q_len 1, window 0)
  int split = 0, nsplit = 0;
  if (sp.S > 1 && seq_len > 0) {
    const int per = (seq_len + sp.S - 1) / sp.S;
    split = max(DEC_SPLIT_KEYS, (per + bs - 1) / bs * bs);
    nsplit = (seq_len + split - 1) / split;
    if (nsplit < 2) nsplit = 0;
  }
  if (sp.n != nullptr && s == 0 && kh == 0 && threadIdx.x == 0) sp.n[b] = nsplit;
  if (s >= (nsplit ? nsplit : 1)) return;  // block-uniform exit
  const int klo = nsplit ? s * split : 0;
  const int khi = nsplit ? min(klo + split, seq_len) : max(seq_len, 0);
  // a key's page and its row in the page: shifts for a power-of-two page
  // size (a runtime division costs ~20 instructions, and the copies of a
  // tile need 2 per key row a thread moves)
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  const auto page_of = [&](int key) { return bs_shift >= 0 ? key >> bs_shift : key / bs; };
  const auto row_of = [&](int key) { return bs_shift >= 0 ? key & (bs - 1) : key % bs; };

  // Q as the A operand of the k-steps over the D dims: row r0 (a query
  // head when r0 < G, else padding 0), columns cq, cq + 1 and cq + 8, + 9
  uint32_t qa[KSTEPS][2];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qa[kk][0] = qa[kk][1] = 0u;
    if (r0 < G) {
      const __nv_bfloat16* qr = q + ((long)b * h + (long)kh * G + r0) * D + kk * 16 + cq;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }
  const float scale = 1.0f / sqrtf((float)D);
  float m = NEG_INF, lsum = 0.f;  // row r0's state over this warp's keys
  float o[NTILES][4];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  // The copies of one tile: this thread's PER key rows (chunk c of keys
  // (tid + i * DEC_THREADS) / CHUNKS) and, for int8, one page's K and V
  // scale. Their page ids are fetched one tile ahead of the copies (fetch,
  // then issue at the next step), so no copy waits on a table read.
  constexpr int CHUNKS = ROW / 16;  // 16-byte chunks per staged key row
  constexpr int PER = DEC_TILE * CHUNKS / DEC_THREADS;
  static_assert(DEC_THREADS % CHUNKS == 0 && PER >= 1, "copy mapping");
  const int cc = threadIdx.x % CHUNKS;
  const int st = threadIdx.x % (DEC_THREADS / 2);  // int8: the tile's page st
  auto fetch = [&](int base, int (&pages)[PER], int& spage) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int key = base + (threadIdx.x + i * DEC_THREADS) / CHUNKS;
      pages[i] = key < khi ? table[page_of(key)] : 0;
    }
    if constexpr (I8) {
      const int p = page_of(base) + st;
      spage = base < khi && p <= page_of(min(base + DEC_TILE, khi) - 1) ? table[p] : -1;
    }
  };
  auto issue = [&](int slot, int base, const int (&pages)[PER], int spage) {
    const unsigned char* kg = static_cast<const unsigned char*>(kc);
    const unsigned char* vg = static_cast<const unsigned char*>(vc);
    const uint32_t k_s = smem_addr(sm.k[slot]), v_s = smem_addr(sm.v[slot]);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int jj = (threadIdx.x + i * DEC_THREADS) / CHUNKS, key = base + jj;
      const bool ok = key < khi;
      const long off = ok ? ((((long)pages[i] * bs + row_of(key)) * kvh + kh) * D) *
                                (I8 ? 1 : 2) + cc * 16 : 0;
      const uint32_t dst = I8 ? (uint32_t)(jj * ROW + cc * 16) : row_off<D>(jj, cc);
      cp_async16(k_s + dst, kg + off, ok ? 16 : 0);
      cp_async16(v_s + dst, vg + off, ok ? 16 : 0);
    }
    if constexpr (I8) {
      if (spage >= 0) {
        const long si = (long)spage * kvh + kh;
        if (threadIdx.x < DEC_THREADS / 2) cp_async4(smem_addr(&sm.ks[slot][st]), ks + si, 4);
        else cp_async4(smem_addr(&sm.vs[slot][st]), vs + si, 4);
      }
    }
  };

  // the prologue reads both first tiles' page ids before any copy, then
  // keeps the next tile's ids one step ahead
  static_assert(DEC_STAGES == 3, "the prologue fills two ring slots");
  const int ntiles = (khi - klo + DEC_TILE - 1) / DEC_TILE;
  int pages[PER], pages1[PER], spage = -1, spage1 = -1;
  fetch(klo, pages, spage);
  fetch(klo + DEC_TILE, pages1, spage1);
  if (ntiles > 0) issue(0, klo, pages, spage);
  cp_async_commit();
  if (ntiles > 1) issue(1, klo + DEC_TILE, pages1, spage1);
  cp_async_commit();
  fetch(klo + 2 * DEC_TILE, pages, spage);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    const int nt_ = t + DEC_STAGES - 1;
    if (nt_ < ntiles) {
      issue(nt_ % DEC_STAGES, klo + nt_ * DEC_TILE, pages, spage);
      fetch(klo + (nt_ + 1) * DEC_TILE, pages, spage);
    }
    cp_async_commit();
    const int slot = t % DEC_STAGES, base = klo + t * DEC_TILE;
    uint32_t k_s = smem_addr(sm.k[slot]), v_s = smem_addr(sm.v[slot]);
    if constexpr (I8) {
      // raw int8 rows -> swizzled bf16 rows, exactly; each key's scales
      for (int idx = threadIdx.x; idx < DEC_TILE * (D / 16); idx += DEC_THREADS) {
        const int jj = idx / (D / 16), c = idx % (D / 16);
        const uint4 kr = *reinterpret_cast<const uint4*>(&sm.k[slot][jj * ROW + c * 16]);
        const uint4 vr = *reinterpret_cast<const uint4*>(&sm.v[slot][jj * ROW + c * 16]);
        *reinterpret_cast<uint4*>(sm.kb + row_off<D>(jj, 2 * c)) = i8x8_to_bf16x8(kr.x, kr.y);
        *reinterpret_cast<uint4*>(sm.kb + row_off<D>(jj, 2 * c + 1)) = i8x8_to_bf16x8(kr.z, kr.w);
        *reinterpret_cast<uint4*>(sm.vb + row_off<D>(jj, 2 * c)) = i8x8_to_bf16x8(vr.x, vr.y);
        *reinterpret_cast<uint4*>(sm.vb + row_off<D>(jj, 2 * c + 1)) = i8x8_to_bf16x8(vr.z, vr.w);
      }
      if (threadIdx.x < DEC_TILE) {
        const int key = base + threadIdx.x;
        const int pi = key < khi ? page_of(key) - page_of(base) : 0;
        sm.kscale[threadIdx.x] = sm.ks[slot][pi];
        sm.vscale[threadIdx.x] = sm.vs[slot][pi];
      }
      __syncthreads();
      k_s = smem_addr(sm.kb);
      v_s = smem_addr(sm.vb);
    }

    // S = Q K^T for this warp's 16 keys: two n-tiles of 8 keys
    const int w0 = warp * WKEYS;
    float sacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
    {
      // ldmatrix rows: matrix lane / 8 = (n-tile, half of the k-step)
      const int mi = lane >> 3, key = w0 + (mi >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t b00, b01, b10, b11;
        ldsm_x4(k_s + row_off<D>(key, 2 * kk + (mi & 1)), b00, b01, b10, b11);
        mma_16816(sacc[0], qa[kk][0], qa[kk][1], b00, b01);
        mma_16816(sacc[1], qa[kk][0], qa[kk][1], b10, b11);
      }
    }
    // row r0's scores (int8: x the key's K scale), one max, one rescale
    float p[2][2];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kt = w0 + j * 8 + cq + e;
        float x = sacc[j][e] * scale;
        if constexpr (I8) x *= sm.kscale[kt];
        x = base + kt < khi ? x : NEG_INF;
        p[j][e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    m = m_new;
    lsum *= alpha;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      o[nt][0] *= alpha;
      o[nt][1] *= alpha;
    }
    uint32_t pa[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float pe[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // masked keys weigh exactly 0
        pe[e] = p[j][e] > 0.5f * NEG_INF ? __expf(p[j][e] - m) : 0.f;
        lsum += pe[e];
        if constexpr (I8) pe[e] *= sm.vscale[w0 + j * 8 + cq + e];
      }
      pa[j] = pack_bf16(pe[0], pe[1]);
    }
    // O += P V over the D dims: D / 8 n-tiles, V by ldmatrix.trans
    {
      const int mi = lane >> 3, key = w0 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(v_s + row_off<D>(key, 2 * np + (mi >> 1)), b0, b1, b2, b3);
        mma_16816(o[2 * np], pa[0], pa[1], b0, b1);
        mma_16816(o[2 * np + 1], pa[0], pa[1], b2, b3);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring's bytes become the merge's

  constexpr int CPH = D / 8;  // merge threads per head
  float M, L, O[8];
  merge_warps<D, G>(m, lsum, o, smem_raw, warp, lane, M, L, O);
  const int t = threadIdx.x, g = t / CPH, c = (t % CPH) * 8;
  __nv_bfloat16* dst = out + ((long)b * h + (long)kh * G + g) * D + c;
  if (!nsplit) {
    if (t < G * CPH) {
      const float inv = 1.0f / fmaxf(L, 1e-30f);
#pragma unroll
      for (int e = 0; e < 8; ++e) O[e] *= inv;
      store8(dst, O);
    }
    return;
  }
  // this split's partial state: rows (b, kh, split, g)
  const long row0 = ((long)b * kvh + kh) * sp.S * G;  // split s', head g: row0 + s' * G + g
  if (t < G * CPH) {
    const long row = row0 + (long)s * G + g;
    float4* a = reinterpret_cast<float4*>(sp.acc + row * D + c);
    a[0] = make_float4(O[0], O[1], O[2], O[3]);
    a[1] = make_float4(O[4], O[5], O[6], O[7]);
    if (c == 0) {
      sp.m[row] = M;
      sp.l[row] = L;
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int s_last;
  int* counter = sp.count + (long)b * kvh + kh;
  if (t == 0) s_last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  // the last split block of (b, kh): merge every split, in split order.
  // The splits' m and l (contiguous: split x, head g at row0 + x * G + g)
  // come into shared memory in one parallel pass and become each split's
  // weight exp(m_x - M) (0 where l_x = 0) and the sum L; then each thread
  // sums 4 dims of one head over the splits, 16 splits' loads in flight
  __threadfence();
  float* s_w = reinterpret_cast<float*>(smem_raw);   // [nsplit][G]: m, then the weight
  float* s_pl = s_w + nsplit * G;                     // [nsplit][G]
  float* s_L = s_pl + nsplit * G;                     // [G]
  for (int i = t; i < nsplit * G; i += DEC_THREADS) {
    s_w[i] = __ldcg(sp.m + row0 + i);
    s_pl[i] = __ldcg(sp.l + row0 + i);
  }
  __syncthreads();
  if (t < G) {
    float MM = NEG_INF, LL = 0.f;
    for (int x = 0; x < nsplit; ++x)
      if (s_pl[x * G + t] > 0.f) MM = fmaxf(MM, s_w[x * G + t]);
    for (int x = 0; x < nsplit; ++x) {
      const float lx = s_pl[x * G + t];
      const float w = lx > 0.f ? __expf(s_w[x * G + t] - MM) : 0.f;
      LL += lx * w;
      s_w[x * G + t] = w;
    }
    s_L[t] = LL;
  }
  __syncthreads();
  for (int item = t; item < G * (D / 4); item += DEC_THREADS) {
    const int gg = item / (D / 4), c4 = (item % (D / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x0 = 0; x0 < nsplit; x0 += 16) {
      float4 v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        v[u] = x0 + u < nsplit
                   ? __ldcg(reinterpret_cast<const float4*>(
                         sp.acc + (row0 + (long)(x0 + u) * G + gg) * D + c4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float w = x0 + u < nsplit ? s_w[(x0 + u) * G + gg] : 0.f;
        a.x += w * v[u].x;
        a.y += w * v[u].y;
        a.z += w * v[u].z;
        a.w += w * v[u].w;
      }
    }
    const float inv = 1.0f / fmaxf(s_L[gg], 1e-30f);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
        out + ((long)b * h + (long)kh * G + gg) * D + c4);
    o2[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    o2[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
  if (t == 0) *counter = 0;  // ready for the next launch on this stream
}

template <int D, int G, bool I8>
int launch_decode(const void* q, const void* kc, const void* vc, const void* ks,
                  const void* vs, const void* tables, const void* lens, void* out,
                  const DecSplits& sp, int B, int h, int kvh, int bs, int max_blocks,
                  cudaStream_t stream) {
  constexpr int smem = (int)sizeof(DecSmem<D, I8>);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<D, G, I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<D, G, I8><<<dim3(sp.S, kvh, B), DEC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kc, vc, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), sp, h, kvh, bs,
      max_blocks);
  return (int)cudaGetLastError();
}

// one head size's launch at the group size G = h / kvh (1 .. 8)
template <int D, bool I8>
int decode_launch_g(const void* q, const void* kc, const void* vc, const void* ks,
                    const void* vs, const void* tables, const void* lens, void* out,
                    void* part, void* n_splits, void* counts, int B, int h, int kvh, int bs,
                    int max_blocks, int S, cudaStream_t s) {
  const int G = h / kvh;
  // the last split block stages every split's m and l in the ring's bytes
  if ((2L * S + 1) * G * 4 > (long)sizeof(DecSmem<D, I8>)) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * kvh * S * G;
  float* acc = static_cast<float*>(part);
  const DecSplits sp{acc, acc ? acc + rows * D : nullptr, acc ? acc + rows * (D + 1) : nullptr,
                     static_cast<int*>(n_splits), static_cast<int*>(counts), S};
#define DTT_DECODE_G(g)                                                                       \
  case g:                                                                                     \
    return launch_decode<D, g, I8>(q, kc, vc, ks, vs, tables, lens, out, sp, B, h, kvh, bs, \
                                   max_blocks, s);
  switch (G) {
    DTT_DECODE_G(1)
    DTT_DECODE_G(2)
    DTT_DECODE_G(3)
    DTT_DECODE_G(4)
    DTT_DECODE_G(5)
    DTT_DECODE_G(6)
    DTT_DECODE_G(7)
    DTT_DECODE_G(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DTT_DECODE_G
}

template <bool I8>
int decode_entry(const void* q, const void* kc, const void* vc, const void* ks,
                 const void* vs, const void* tables, const void* lens, void* out,
                 void* part, void* n_splits, void* counts, int B, int h, int kvh, int d,
                 int bs, int max_blocks, int S, void* stream) {
  if (B <= 0) return 0;
  if (kvh <= 0 || h % kvh || bs <= 0 || S < 1) return (int)cudaErrorInvalidValue;
  if (S > 1 && (!part || !counts)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d == 64)
    return decode_launch_g<64, I8>(q, kc, vc, ks, vs, tables, lens, out, part, n_splits,
                                   counts, B, h, kvh, bs, max_blocks, S, s);
  if (d == 128)
    return decode_launch_g<128, I8>(q, kc, vc, ks, vs, tables, lens, out, part, n_splits,
                                    counts, B, h, kvh, bs, max_blocks, S, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dtt

// q [B, h, d] bf16 (d = 64 or 128, G = h / kvh in 1 .. 8), k/v cache
// [num_blocks, bs, kvh, d] bf16, tables [B, max_blocks] int32, lens [B]
// int32 -> out [B, h, d] bf16.
// Split-K: S >= 1 splits at most per row (grid (S, kvh, B)); with S > 1,
// part holds f32 acc [B, kvh, S, G, d], then m and l [B, kvh, S, G], and
// counts [B * kvh] int32 must be 0 (the kernel leaves them 0). n_splits
// [B] int32 (nullable) receives each row's split count, 0 = not split.
// Returns cudaGetLastError() after the launch.
extern "C" int dtt_paged_decode(const void* q, const void* kc, const void* vc,
                                const void* tables, const void* lens, void* out,
                                void* part, void* n_splits, void* counts, int B, int h,
                                int kvh, int d, int bs, int max_blocks, int S, void* stream) {
  return dtt::decode_entry<false>(q, kc, vc, nullptr, nullptr, tables, lens, out, part,
                                  n_splits, counts, B, h, kvh, d, bs, max_blocks, S, stream);
}

// As dtt_paged_decode with an int8 cache kc/vc [num_blocks, bs, kvh, d]
// and its f32 scale rows ks/vs [num_blocks, kvh].
extern "C" int dtt_paged_decode_i8(const void* q, const void* kc, const void* vc,
                                   const void* ks, const void* vs, const void* tables,
                                   const void* lens, void* out, void* part, void* n_splits,
                                   void* counts, int B, int h, int kvh, int d, int bs,
                                   int max_blocks, int S, void* stream) {
  return dtt::decode_entry<true>(q, kc, vc, ks, vs, tables, lens, out, part, n_splits,
                                 counts, B, h, kvh, d, bs, max_blocks, S, stream);
}
