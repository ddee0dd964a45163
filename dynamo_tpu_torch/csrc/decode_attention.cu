// Paged decode attention: one query token per sequence over its own pages.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas_attention.py
// (_decode_kernel, launched by paged_decode_attention): paged_decode_kernel
// reads the bf16 cache, paged_decode_i8_kernel the int8 cache (int8 pages
// plus f32 [num_blocks, kvh] scale rows, dequantized in registers).
//
// Bound on this card: bytes. Each (sequence, kv head) reads its K and V rows
// once (2 * seq_len * 256 bytes in bf16) and does ~4 * G flops per byte
// read, far below the ~295 flops/byte at which an H100 stops being
// memory-bound. So the design is about keeping many loads in flight:
//   - one block per (sequence, kv head), covering the G = h / kvh query heads
//     that share that kv head, so every K/V byte is read once for all G;
//   - 8 warps; each half-warp owns one key at a time and reads its 256-byte
//     row with 16-byte loads (neighbouring lanes on neighbouring addresses),
//     KB keys per half-warp per iteration issued before any arithmetic, with
//     the next iteration's page indices loaded one iteration ahead;
//   - each half-warp keeps its own online-softmax state in registers, merged
//     across halves by shuffles and across warps through shared memory;
//   - only the ceil(seq_len / block_size) real pages are read; keys past
//     seq_len are never loaded and weigh exactly 0.
//
// The int8 form halves the page bytes (a 128-dim key row is 128 B, not
// 256), so the bf16 mapping is re-derived for it:
//   - each half-warp owns whole pages in turn (page p of the sequence goes to
//     half-warp p % 16) and reads the page's K and V scale once, with its
//     table entry, one page ahead;
//   - a key row is read by the half-warp with 8-byte loads (16 lanes x 8
//     int8 = one 128-byte row), so each lane keeps the same 8 dims of q and
//     of the accumulator as in the bf16 kernel (no extra registers for G=8);
//   - the raw int8 stays packed in registers (2 words per K or V chunk) until
//     it is used, so twice as many keys are in flight per half-warp (8) for
//     the same registers, and the same bytes in flight per warp as bf16;
//   - scores take the scale once per key (s = sk * q.k_int) and values once
//     per key (acc += (p * sv) * v_int).
// Later work (PERF.md): split-K over the context when B * kvh is small
// against the card's 132 SMs.

#include "attn_common.cuh"

namespace dtt {

constexpr int HEAD_DIM = 128;  // the only head size this kernel takes
constexpr int DEC_WARPS = 8;
constexpr int DEC_KB = 4;  // keys per half-warp per iteration (bf16)
constexpr int I8_KB = 8;   // keys per half-warp per iteration (int8)

// Each half-warp holds an online-softmax state (m, l, acc over its lane's 8
// dims) for the G heads; merge the two halves by shuffles, the warps through
// shared memory, and write the G normalized output rows at out [G, 128].
template <int G>
__device__ __forceinline__ void merge_and_store(float (&m)[G], float (&l)[G],
                                                float (&acc)[G][8],
                                                __nv_bfloat16* __restrict__ out,
                                                int warp, int hw, int j) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m[g], 16);
    const float l_o = __shfl_xor_sync(0xffffffffu, l[g], 16);
    const float m_new = fmaxf(m[g], m_o);
    const float a = __expf(m[g] - m_new), a_o = __expf(m_o - m_new);
    l[g] = l[g] * a + l_o * a_o;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      acc[g][e] = acc[g][e] * a + acc_o * a_o;
    }
    m[g] = m_new;
  }

  __shared__ float s_m[DEC_WARPS][G], s_l[DEC_WARPS][G];
  __shared__ __align__(16) float s_acc[DEC_WARPS][G][HEAD_DIM];
  if (hw == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s_acc[warp][g][j * 8 + e] = acc[g][e];
      if (j == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  // thread t finalizes dims (t % 16) * 8..+7 of head t / 16
  for (int t = threadIdx.x; t < G * 16; t += DEC_WARPS * 32) {
    const int g = t / 16, c = (t % 16) * 8;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float a = __expf(s_m[w][g] - mx);
      lsum += s_l[w][g] * a;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] += s_acc[w][g][c + e] * a;
    }
    const float inv = 1.0f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] *= inv;
    store8(out + (long)g * HEAD_DIM + c, o);
  }
}

template <int G>
__global__ void __launch_bounds__(DEC_WARPS * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ tables, const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out, int h, int kvh, int bs,
                    int max_blocks) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = lane >> 4, j = lane & 15;  // half-warp; dims j*8..+7
  const int seq_len = lens[b];
  const int* table = tables + (long)b * max_blocks;
  const float scale = 1.0f / sqrtf((float)HEAD_DIM);

  float qr[G][8], m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((long)b * h + (long)kh * G + g) * HEAD_DIM + j * 8, qr[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] *= scale;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  // key = base + kb * 2 * DEC_WARPS + warp * 2 + hw: one stream per half-warp
  constexpr int STEP = DEC_WARPS * 2 * DEC_KB;
  const int lane_key = warp * 2 + hw;
  int next_page[DEC_KB];
#pragma unroll
  for (int kb = 0; kb < DEC_KB; ++kb) {
    const int key = kb * (DEC_WARPS * 2) + lane_key;
    next_page[kb] = key < seq_len ? table[key / bs] : 0;
  }
  for (int base = 0; base < seq_len; base += STEP) {
    float kf[DEC_KB][8], vf[DEC_KB][8];
    bool valid[DEC_KB];
    int page[DEC_KB];
#pragma unroll
    for (int kb = 0; kb < DEC_KB; ++kb) {
      page[kb] = next_page[kb];
      const int key = base + STEP + kb * (DEC_WARPS * 2) + lane_key;
      next_page[kb] = key < seq_len ? table[key / bs] : 0;
    }
#pragma unroll
    for (int kb = 0; kb < DEC_KB; ++kb) {
      const int key = base + kb * (DEC_WARPS * 2) + lane_key;
      valid[kb] = key < seq_len;
      if (valid[kb]) {
        const long off = (((long)page[kb] * bs + key % bs) * kvh + kh) * HEAD_DIM + j * 8;
        load8(kc + off, kf[kb]);
        load8(vc + off, vf[kb]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[kb][e] = vf[kb][e] = 0.f;
      }
    }
#pragma unroll
    for (int kb = 0; kb < DEC_KB; ++kb) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qr[g][e], kf[kb][e], s);
        // reduce over the 16 lanes of this half-warp
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (valid[kb]) {
          const float m_new = fmaxf(m[g], s);
          const float a = __expf(m[g] - m_new);
          const float p = __expf(s - m_new);
          l[g] = l[g] * a + p;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[kb][e], acc[g][e] * a);
          m[g] = m_new;
        }
      }
    }
  }

  merge_and_store<G>(m, l, acc, out + ((long)b * h + (long)kh * G) * HEAD_DIM,
                     warp, hw, j);
}

template <int G>
__global__ void __launch_bounds__(DEC_WARPS * 32)
paged_decode_i8_kernel(const __nv_bfloat16* __restrict__ q,
                       const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       const int* __restrict__ tables, const int* __restrict__ lens,
                       __nv_bfloat16* __restrict__ out, int h, int kvh, int bs,
                       int max_blocks) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = lane >> 4, j = lane & 15;  // half-warp; dims j*8..+7
  const int seq_len = lens[b];
  const int* table = tables + (long)b * max_blocks;
  const float scale = 1.0f / sqrtf((float)HEAD_DIM);
  constexpr int NHW = DEC_WARPS * 2;  // half-warps per block
  const long key_stride = (long)kvh * HEAD_DIM;  // int8 elements between keys

  float qr[G][8], m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((long)b * h + (long)kh * G + g) * HEAD_DIM + j * 8, qr[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] *= scale;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  const int npages = (seq_len + bs - 1) / bs;
  // page slot p0 + hw: the loop bound is uniform across the warp (both
  // halves run every iteration, so the full-warp shuffles stay converged);
  // a half whose page is past the end has no valid key
  int pg = warp * 2 + hw;
  int page = pg < npages ? table[pg] : 0;
  float sk = pg < npages ? ks[(long)page * kvh + kh] : 0.f;
  float sv = pg < npages ? vs[(long)page * kvh + kh] : 0.f;
  for (int p0 = warp * 2; p0 < npages; p0 += NHW) {
    // the next page's table entry, then its scales, one page ahead
    const int npg = pg + NHW;
    const int next_page = npg < npages ? table[npg] : 0;
    const int kend = min(bs, seq_len - pg * bs);  // valid keys of this page
    const int8_t* kp = kc + ((long)page * bs * kvh + kh) * HEAD_DIM + j * 8;
    const int8_t* vp = vc + ((long)page * bs * kvh + kh) * HEAD_DIM + j * 8;
    float nsk = 0.f, nsv = 0.f;
    for (int t0 = 0; t0 < bs; t0 += I8_KB) {
      uint2 kr[I8_KB], vr[I8_KB];
#pragma unroll
      for (int kb = 0; kb < I8_KB; ++kb) {
        const int t = t0 + kb;
        if (t < kend) {
          kr[kb] = *reinterpret_cast<const uint2*>(kp + t * key_stride);
          vr[kb] = *reinterpret_cast<const uint2*>(vp + t * key_stride);
        } else {
          kr[kb] = vr[kb] = make_uint2(0u, 0u);
        }
      }
      if (t0 == 0 && npg < npages) {
        nsk = ks[(long)next_page * kvh + kh];
        nsv = vs[(long)next_page * kvh + kh];
      }
#pragma unroll
      for (int kb = 0; kb < I8_KB; ++kb) {
        const bool valid = t0 + kb < kend;
        float kf[8], vf[8];
        unpack8_i8(kr[kb], kf);
        unpack8_i8(vr[kb], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(qr[g][e], kf[e], s);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          if (valid) {
            s *= sk;
            const float m_new = fmaxf(m[g], s);
            const float a = __expf(m[g] - m_new);
            const float p = __expf(s - m_new);
            const float pv = p * sv;
            l[g] = l[g] * a + p;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e] * a);
            m[g] = m_new;
          }
        }
      }
    }
    pg = npg;
    page = next_page;
    sk = nsk;
    sv = nsv;
  }

  merge_and_store<G>(m, l, acc, out + ((long)b * h + (long)kh * G) * HEAD_DIM,
                     warp, hw, j);
}

}  // namespace dtt

// q [B, h, 128] bf16, k/v cache [num_blocks, bs, kvh, 128] bf16,
// tables [B, max_blocks] int32, lens [B] int32 -> out [B, h, 128] bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int dtt_paged_decode(const void* q, const void* kc, const void* vc,
                                const void* tables, const void* lens, void* out,
                                int B, int h, int kvh, int bs, int max_blocks,
                                void* stream) {
  using namespace dtt;
  if (B <= 0) return 0;
  if (kvh <= 0 || h % kvh) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, kvh);
  const dim3 block(DEC_WARPS * 32);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(kc);
  const auto* vp = static_cast<const __nv_bfloat16*>(vc);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (h / kvh) {
    case 1: paged_decode_kernel<1><<<grid, block, 0, s>>>(qp, kp, vp, tp, lp, op, h, kvh, bs, max_blocks); break;
    case 2: paged_decode_kernel<2><<<grid, block, 0, s>>>(qp, kp, vp, tp, lp, op, h, kvh, bs, max_blocks); break;
    case 4: paged_decode_kernel<4><<<grid, block, 0, s>>>(qp, kp, vp, tp, lp, op, h, kvh, bs, max_blocks); break;
    case 8: paged_decode_kernel<8><<<grid, block, 0, s>>>(qp, kp, vp, tp, lp, op, h, kvh, bs, max_blocks); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As dtt_paged_decode with an int8 cache kc/vc [num_blocks, bs, kvh, 128]
// and its f32 scale rows ks/vs [num_blocks, kvh].
extern "C" int dtt_paged_decode_i8(const void* q, const void* kc, const void* vc,
                                   const void* ks, const void* vs,
                                   const void* tables, const void* lens, void* out,
                                   int B, int h, int kvh, int bs, int max_blocks,
                                   void* stream) {
  using namespace dtt;
  if (B <= 0) return 0;
  if (kvh <= 0 || h % kvh) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, kvh);
  const dim3 block(DEC_WARPS * 32);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(kc);
  const auto* vp = static_cast<const int8_t*>(vc);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (h / kvh) {
    case 1: paged_decode_i8_kernel<1><<<grid, block, 0, s>>>(qp, kp, vp, ksp, vsp, tp, lp, op, h, kvh, bs, max_blocks); break;
    case 2: paged_decode_i8_kernel<2><<<grid, block, 0, s>>>(qp, kp, vp, ksp, vsp, tp, lp, op, h, kvh, bs, max_blocks); break;
    case 4: paged_decode_i8_kernel<4><<<grid, block, 0, s>>>(qp, kp, vp, ksp, vsp, tp, lp, op, h, kvh, bs, max_blocks); break;
    case 8: paged_decode_i8_kernel<8><<<grid, block, 0, s>>>(qp, kp, vp, ksp, vsp, tp, lp, op, h, kvh, bs, max_blocks); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
