// Shared pieces of the port's attention kernels (decode_attention.cu,
// flash_extend.cu, unified_attention.cu): bf16/int8 -> f32 helpers and the
// tile-attention body that the flash-extend and unified kernels share, with
// its key-row loaders for the bf16 and the int8 (payload + f32 scale) KV.
//
// Numerics (the reference kernels' and ops/attention.py's): scale 1/sqrt(d)
// applied to q, float32 scores / running max m / running sum l /
// accumulator, masked keys at NEG_INF = -1e30 with their weight forced to 0,
// output acc / max(l, 1e-30) in q's dtype (bf16). bf16 converts only through
// the intrinsics. The tile body takes head_dim 128 and 256 (a template
// parameter) and the unified kernel's row attributes (RowAttrs): a sliding
// window, per-head sink logits and a logit softcap.
//
// The TPU kernels carried online-softmax state across sequential grid
// steps; on the GPU blocks run in parallel in no order, so each block walks
// its keys in a loop of its own and keeps the state in shared memory and
// registers. A simple, correct first version: CUDA-core FMAs, no tensor
// cores, no TMA, no split-K (later work, see PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

constexpr float NEG_INF = -1e30f;

// 8 consecutive bf16 (one 16-byte load) -> 8 floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

// 8 int8 packed in two words (dims in byte order) -> 8 floats
__device__ __forceinline__ void unpack8_i8(uint2 raw, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = (float)(int8_t)(raw.x >> (8 * i));
    out[4 + i] = (float)(int8_t)(raw.y >> (8 * i));
  }
}

// 8 consecutive int8 (one 8-byte load) times a scale -> 8 floats: the
// dequantization of ops/quant.py, float(q) * scale, in the same f32 product
__device__ __forceinline__ void load8_i8(const int8_t* p, float scale, float* out) {
  unpack8_i8(*reinterpret_cast<const uint2*>(p), out);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] *= scale;
}

// 8 floats -> 8 consecutive bf16 (one 16-byte store)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---------------------------------------------------------------------------
// Tile attention: one block computes TM query-head rows of ONE kv head
// against the keys [klo, hi) of one sequence, TN keys per step.
//
// Rows are token-major: row r is token r / G, query head kh*G + r % G, so a
// tile holds TQ = TM / G consecutive query tokens with all G heads that
// share kv head kh (GQA). The key rows come from a loader functor:
// kv.load(kpos, c, kf, vf) writes dims c..c+7 of key kpos's K and V rows
// (this kv head) as floats. The flash-extend kernel reads a gathered
// contiguous context, the unified kernel reads pages through a block
// table; each in bf16, or in int8 scaled by an f32 scale (dequantized on
// the way into shared memory, so the tile body is the same for both).
// ---------------------------------------------------------------------------

// bf16 key rows at kbuf/vbuf + rows(kpos)
template <class Rows>
struct Bf16KV {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  Rows rows;
  __device__ void load(int kpos, int c, float* kf, float* vf) const {
    const long off = rows(kpos) + c;
    load8(k + off, kf);
    load8(v + off, vf);
  }
};

// int8 key rows at k/v + rows(kpos), times the f32 scales at
// ks/vs[rows.scale(kpos)]
template <class Rows>
struct Int8KV {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  Rows rows;
  __device__ void load(int kpos, int c, float* kf, float* vf) const {
    const long off = rows(kpos) + c;
    const long si = rows.scale(kpos);
    load8_i8(k + off, ks[si], kf);
    load8_i8(v + off, vs[si], vf);
  }
};

// The optional attributes of a tile's rows (ops/pallas_unified.py):
//   window > 0: a query at position p sees keys j with p - window < j
//     (<= 0: full attention);
//   sinks != nullptr: per-query-head sink logits [h], folded into the
//     softmax denominator by seeding the state with a virtual zero-value
//     key (m = sink, l = 1, acc = 0);
//   softcap > 0: scores become softcap * tanh(s / softcap), after the
//     scale and before the mask.
struct RowAttrs {
  int window;
  const float* sinks;
  float softcap;
};

constexpr int TM = 64;        // query-head rows per block
constexpr int TN = 32;        // keys per step
constexpr int NTHREADS = 256;

// D = 128: 75 KB, two blocks per SM; D = 256: 141 KB, one block per SM
template <int D>
struct TileSmem {
  float q[TM][D];           // scaled queries
  float k[TN][D + 1];       // padded: conflict-free column reads
  float v[TN][D];
  float p[TM][TN + 1];      // scores, then probabilities
  float m[TM];              // running max
  float l[TM];              // running sum
  float alpha[TM];          // this step's rescale of l and the accumulator
  int lo[TM];               // keys >= lo[r] ...
  int lim[TM];              // ... and < lim[r] are visible to row r
};

// q, out: [*, h, D] bf16, token rows tok0 .. tok0+ntok-1 of this tile.
// Query token t of the tile sits at absolute position pos0 + t and sees
// keys < min(pos0 + t + 1, total), and with a window keys > pos0 + t - w.
template <int D, class KV>
__device__ void tile_attention(TileSmem<D>& sm, const __nv_bfloat16* __restrict__ q,
                               __nv_bfloat16* __restrict__ out, const KV kv,
                               int h, int kh, int G, long tok0, int ntok,
                               int pos0, int total, const RowAttrs at) {
  static_assert(D % 128 == 0, "the tile body takes head_dim 128 or 256");
  constexpr int NG = D / 128;   // groups of 8 output dims per thread
  const int tid = threadIdx.x;
  const int nrows = ntok * G;  // valid rows: r < nrows
  const float scale = 1.0f / sqrtf((float)D);

  // queries -> shared (f32, scaled); invalid rows are zero
  for (int idx = tid; idx < TM * (D / 8); idx += NTHREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    float f[8];
    if (r < nrows) {
      const long row = (tok0 + r / G) * h + (long)kh * G + r % G;
      load8(q + row * D + c, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(&sm.q[r][c]);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  if (tid < TM) {
    const bool valid = tid < nrows;
    const int pos = pos0 + tid / G;
    sm.lim[tid] = valid ? min(pos + 1, total) : 0;
    sm.lo[tid] = valid && at.window > 0 ? max(pos - at.window + 1, 0) : 0;
    // the sink is the QUERY head's (kh * G + r % G), not the kv head's
    const bool sink = valid && at.sinks != nullptr;
    sm.m[tid] = sink ? at.sinks[kh * G + tid % G] : NEG_INF;
    sm.l[tid] = sink ? 1.f : 0.f;
  }
  // highest key any valid row sees (the causal tile skip), and the lowest:
  // the earliest query (token 0, at pos0) sees no key below klo, so the
  // steps start at the step holding klo and keys a window aged out are
  // never read (the reference's page skip)
  const int hi = min(pos0 + ntok, total);
  const int klo = at.window > 0 ? max(pos0 - at.window + 1, 0) : 0;
  const float cap = at.softcap;

  // S = Q K^T: thread (ty, tx) owns rows ty*4..+3, key columns tx*2..+1
  // O += P V:  thread (ty, tx) owns rows ty*4..+3, dims g*128 + tx*8..+7
  const int ty = tid / 16, tx = tid % 16;
  const bool busy = ty * 4 < nrows;  // some owned row is valid
  float acc[4][NG][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][g][c] = 0.f;

  for (int base = klo - klo % TN; base < hi; base += TN) {
    __syncthreads();  // previous step done with k/v/p (and q/m/l/lim written)
    // K/V rows of this step -> shared (f32); keys outside [klo, hi) are
    // zero: they are never read from memory, and zero V keeps
    // 0 * garbage out of the sums
    for (int idx = tid; idx < TN * (D / 8); idx += NTHREADS) {
      const int j = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int kpos = base + j;
      float kf[8], vf[8];
      if (kpos >= klo && kpos < hi) {
        kv.load(kpos, c, kf, vf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.k[j][c + e] = kf[e];
      float4* dv = reinterpret_cast<float4*>(&sm.v[j][c]);
      dv[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      dv[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    if (busy) {
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float k0 = sm.k[tx * 2][d], k1 = sm.k[tx * 2 + 1][d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = sm.q[ty * 4 + i][d];
          s[i][0] = fmaf(a, k0, s[i][0]);
          s[i][1] = fmaf(a, k1, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = base + tx * 2 + j;
          const float sc = cap > 0.f ? cap * tanhf(s[i][j] / cap) : s[i][j];
          // per-row bounds: keys below a row's own window inside the
          // first step are masked here, not read as live
          sm.p[r][tx * 2 + j] = kpos >= sm.lo[r] && kpos < sm.lim[r] ? sc : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax, 4 threads per row (neighbouring lanes), 8 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float sv[8];
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sv[e] = sm.p[r][part * 8 + e];
        mx = fmaxf(mx, sv[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // masked keys weigh exactly 0 (exp(NEG_INF - NEG_INF) would be 1,
        // and with a sink m starts above NEG_INF, not at it)
        const float pe = sv[e] > 0.5f * NEG_INF ? __expf(sv[e] - m_new) : 0.f;
        sm.p[r][part * 8 + e] = pe;
        sum += pe;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float a = __expf(m_old - m_new);
        sm.alpha[r] = a;
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * a + sum;
      }
    }
    __syncthreads();

    if (busy) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = sm.alpha[ty * 4 + i];
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][g][c] *= a;
      }
#pragma unroll 4
      for (int j = 0; j < TN; ++j) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* vr = &sm.v[j][g * 128 + tx * 8];
          const float4 v0 = *reinterpret_cast<const float4*>(vr);
          const float4 v1 = *reinterpret_cast<const float4*>(vr + 4);
          const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pj = sm.p[ty * 4 + i][j];
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][g][c] = fmaf(pj, vv[c], acc[i][g][c]);
          }
        }
      }
    }
  }
  __syncthreads();

  // emit the valid rows: acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < nrows) {
      const float inv = 1.0f / fmaxf(sm.l[r], 1e-30f);
      const long row = (tok0 + r / G) * h + (long)kh * G + r % G;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float o[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) o[c] = acc[i][g][c] * inv;
        store8(out + row * D + g * 128 + tx * 8, o);
      }
    }
  }
}

}  // namespace dtt
