// Shared pieces of the port's attention kernels (decode_attention.cu,
// flash_extend.cu, unified_attention.cu, mla_attention.cu): bf16/int8
// helpers (the exact int8 conversion serves the decode kernel too), the
// Hopper primitives (cp.async, wgmma, 128-byte-swizzled shared tiles), and the
// tile-attention body that the flash-extend and unified kernels share.
//
// Numerics (the reference kernels' and ops/attention.py's): float32 scores
// (q.k in f32 on the tensor cores, then x 1/sqrt(d)), running max m,
// running sum l and accumulator; masked keys at NEG_INF = -1e30 with their
// weight forced to 0; output acc / max(l, 1e-30) in q's dtype (bf16). The
// probabilities are rounded to bf16 for the P.V product, as FlashAttention
// does. The tile body takes head_dim 64, 128 and 256 and the unified
// kernel's row attributes (RowAttrs): a sliding window, per-head sink
// logits and a logit softcap.
//
// What bounds it on the H100: operations for long prefill tiles (each K/V
// tile serves 64 query-head rows), bytes for decode-shaped rows. The design
// for both:
//   - S = Q K^T and O += P V on the tensor cores: wgmma.mma_async m64nNk16
//     (sm_90a), one warpgroup per 128 output dims. Q and K are read by the
//     tensor cores from 128-byte-swizzled shared memory (K-major); P goes
//     from the S accumulator registers straight into the A operand of the
//     P.V product (the f32 accumulator fragment of m64n64 is, pair for
//     pair, the bf16 A fragment of m64k16); V is read MN-major.
//   - the online softmax runs in those registers: row max and sum by quad
//     shuffles, no shared-memory round trip;
//   - K/V arrive through a 2-stage cp.async ring of 64 keys: step i + 1's
//     copies are in flight while step i computes; keys outside the block's
//     range are zero-filled by the copy itself (never read);
//   - int8 K/V: the payload is copied raw (half the bytes), converted to
//     bf16 exactly (|q| <= 127) in shared memory; the K scale multiplies
//     the f32 score columns and the V scale the probability columns before
//     their bf16 rounding, so no lossy dequantization happens anywhere;
//   - head_dim 256: two warpgroups, each owning 128 output dims (64 f32
//     accumulators a thread) and each computing the full S itself: the
//     tile needs no exchange and no thread holds all 256 dims;
//   - head_dim 64 (gpt-oss): one warpgroup; a 64-dim bf16 row is exactly
//     one 128-byte swizzle atom (one region of the layout below), S takes
//     4 k-steps of m64n64k16 and P.V is one m64n64 product per k16 slice
//     (32 f32 accumulators a thread); the shared tiles shrink to 40 KB.
// Split-K over long key ranges (decode-shaped rows) is the unified
// kernel's: a block may own a slice [klo, khi) of its rows' keys and write
// its partial state (m, l, unnormalized acc) instead of the output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

constexpr float NEG_INF = -1e30f;

// 8 floats -> 8 consecutive bf16 (one 16-byte store)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 4 int8 in a word -> 2 bf16 pairs, exactly (|q| <= 128 fits bf16's 8
// significant bits). Without the quarter-rate int-to-float conversion:
// each byte, offset to unsigned (x ^ 0x80 = x + 128), becomes the low
// mantissa byte of the float 2^23 (0x4B0000uu = 2^23 + x + 128), and one
// subtraction of 2^23 + 128 leaves x.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, __nv_bfloat162* o) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;  // 2^23 + 128
  o[0] = __floats2bfloat162_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias,
                               __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias);
  o[1] = __floats2bfloat162_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias,
                               __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias);
}

// 8 int8 in two words -> 8 bf16 in one 16-byte word, exactly
__device__ __forceinline__ uint4 i8x8_to_bf16x8(uint32_t w0, uint32_t w1) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
  i8x4_to_bf16x4(w0, o);
  i8x4_to_bf16x4(w1, o + 2);
  return out;
}

// tanh(x) = 1 - 2 / (e^2x + 1): one exponential and one fast division
// instead of tanhf's polynomial; its absolute error (a few 1e-7) times the
// softcap (tens) stays far below a logit's bf16 rounding. Saturates to
// +-1 where e^2x overflows or vanishes.
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// ---------------------------------------------------------------------------
// Hopper primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// this thread's shared-memory writes -> visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// this thread's earlier generic accesses of global memory -> ordered before
// its later async-proxy (bulk copy) reads of it
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// mbarriers and bulk (TMA) copies: a shared-memory barrier that completes
// a phase when its arrivals are in and the bytes it expects have landed
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects ``bytes`` more bytes in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity ``phase`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// one plain arrival
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival once every cp.async this thread issued so far has landed
// (counted in the barrier's init count: .noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// a barrier over ``threads`` threads (a multiple of 32) on barrier ``id``
// (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup's registers per thread from here on (warp specialization:
// every warp of the warpgroup runs it)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared in one bulk copy, completing on ``bar``
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// pins an accumulator's registers at this point of the program: keeps the
// compiler from moving their reads and writes across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma operand descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 = SW128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A swizzled tile of ROWS rows x D bf16 columns: D / 64 regions of
// ROWS x 128 bytes (64 columns each), regions 1024-byte aligned; inside a
// region row j's 16-byte chunk c sits at chunk c ^ (j % 8). The layout the
// K-major descriptors of Q and K and the MN-major descriptor of V read.
// Byte offset of chunk c (columns 8c .. 8c + 7) of row j:
template <int ROWS>
__device__ __forceinline__ uint32_t sw128_off(int j, int c) {
  return (uint32_t)((c >> 3) * ROWS * 128 + j * 128 + (((c & 7) ^ (j & 7)) << 4));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B K-major in shared
// memory (the latent kernel's S over one warpgroup's 32 keys)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A K-major and B MN-major
// (transposed) in shared memory (the latent kernel's P.V, P shared by two
// warpgroups)
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory: the P.V product at head_dim 64
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (bf16 pairs),
// B MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---------------------------------------------------------------------------
// Tile attention: one block computes TM = 64 query-head rows of ONE kv head
// against the keys [klo, khi) of one sequence, TN = 64 keys per step.
//
// Rows are token-major: row r is token r / G, query head kh*G + r % G, so a
// tile holds TQ = TM / G consecutive query tokens with all G heads that
// share kv head kh (GQA). Key rows come from a KVSrc: rows(kpos) is the
// element offset of key kpos's row (this kv head) in k and v, and for int8
// rows.scale(kpos) its scale's index in ks / vs. The flash-extend kernel
// reads a gathered contiguous context, the unified kernel pages through a
// block table.
// ---------------------------------------------------------------------------

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

constexpr int TM = 64;     // query-head rows per block: one wgmma M
constexpr int TN = 64;     // keys per step
constexpr int NSTAGE = 2;  // K/V ring depth

// one warpgroup per 128 output dims; one warpgroup at D = 64
template <int D>
__host__ __device__ constexpr int tile_threads() { return D < 128 ? 128 : 128 * (D / 128); }

// output dims of one warpgroup
template <int D>
__host__ __device__ constexpr int wg_dims() { return D < 128 ? D : 128; }

// bf16: Q + 2 stages of K/V tiles: 40 KB at D = 64, 80 KB at D = 128,
// 160 KB at D = 256. int8: Q + one bf16 K/V tile + 2 stages of raw int8 K/V
// and their scales: 24 KB + 16 KB at D = 64, 48 KB + 32 KB at D = 128,
// 96 KB + 64 KB at D = 256.
template <int D, bool I8>
struct __align__(1024) TileSmem {
  __nv_bfloat16 q[TM * D];
  __nv_bfloat16 k[I8 ? 1 : NSTAGE][TN * D];
  __nv_bfloat16 v[I8 ? 1 : NSTAGE][TN * D];
  int8_t kraw[I8 ? NSTAGE : 1][I8 ? TN * D : 16];
  int8_t vraw[I8 ? NSTAGE : 1][I8 ? TN * D : 16];
  float ks[NSTAGE][TN];
  float vs[NSTAGE][TN];
};

// dynamic shared memory of a tile kernel: the TileSmem at the first
// 1024-byte-aligned shared address (the swizzle is on address bits)
template <class Smem>
__device__ __forceinline__ Smem& tile_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_addr(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem*>(raw + pad);
}

template <class Smem>
constexpr int tile_smem_bytes() { return (int)sizeof(Smem) + 1024; }

template <class Rows>
struct KVSrc {
  const void* k;     // bf16 or int8 key rows
  const void* v;
  const float* ks;   // int8: f32 scales
  const float* vs;
  Rows rows;
};

// What one block computes: query tokens tok0 .. tok0 + ntok - 1 of the
// packed q / out [*, h, D], token t at absolute position pos0 + t, seeing
// keys < min(pos0 + t + 1, total) (and inside its window), of which this
// block reads [klo, khi). ``sink``: seed the state with the sink logits
// (a block that owns all its rows' keys). With part_acc the block writes
// its rows' partial state instead of the output: row (token t, head hh) at
// index part_row0 + t * h + hh of part_m / part_l, times D in part_acc.
struct TileJob {
  long tok0;
  int ntok, pos0, total;
  int klo, khi;
  bool sink;
  float* part_acc;
  float* part_m;
  float* part_l;
  long part_row0;
};

// The keys the earliest and the latest query token of a tile see:
// [klo, hi). The earliest token (at pos0) sees no key below klo, so pages
// a window aged out are never read (the reference's page skip).
__device__ __forceinline__ void tile_range(int pos0, int ntok, int total, int window,
                                           int& klo, int& hi) {
  hi = min(pos0 + ntok, total);
  klo = window > 0 ? max(pos0 - window + 1, 0) : 0;
}

template <int D, bool I8, class Rows>
__device__ void tile_attention(TileSmem<D, I8>& sm, const __nv_bfloat16* __restrict__ q,
                               __nv_bfloat16* __restrict__ out, const KVSrc<Rows>& kv,
                               int h, int kh, int G, const RowAttrs at, const TileJob job) {
  static_assert(D == 64 || D % 128 == 0, "the tile body takes head_dim 64, 128 or 256");
  constexpr int NT = tile_threads<D>();
  constexpr int DW = wg_dims<D>();   // this warpgroup's output dims
  constexpr int NO = DW / 2;         // its f32 accumulators a thread
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int nrows = job.ntok * G;  // valid rows: r < nrows
  const float scale = 1.0f / sqrtf((float)D);
  const float cap = at.softcap, inv_cap = cap > 0.f ? 1.0f / cap : 0.f;

  // queries -> shared (bf16, swizzled); invalid rows are zero
  const uint32_t q_s = smem_addr(sm.q);
  for (int idx = tid; idx < TM * (D / 8); idx += NT) {
    const int r = idx / (D / 8), c = idx % (D / 8);
    const bool ok = r < nrows;
    const __nv_bfloat16* src = q;
    if (ok) src = q + ((job.tok0 + r / G) * h + (long)kh * G + r % G) * D + c * 8;
    cp_async16(q_s + sw128_off<TM>(r, c), src, ok ? 16 : 0);
  }

  // the copies of one step's K/V rows (and int8 scales) into ring slot
  // ``slot``; keys outside [klo, khi) are zero-filled, never read
  auto load = [&](int slot, int base) {
    if constexpr (!I8) {
      const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(kv.k);
      const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(kv.v);
      const uint32_t k_s = smem_addr(sm.k[slot]), v_s = smem_addr(sm.v[slot]);
      for (int idx = tid; idx < TN * (D / 8); idx += NT) {
        const int j = idx / (D / 8), c = idx % (D / 8);
        const int kpos = base + j;
        const bool ok = kpos >= job.klo && kpos < job.khi;
        const long off = ok ? kv.rows(kpos) + c * 8 : 0;
        cp_async16(k_s + sw128_off<TN>(j, c), kg + off, ok ? 16 : 0);
        cp_async16(v_s + sw128_off<TN>(j, c), vg + off, ok ? 16 : 0);
      }
    } else {
      const int8_t* kg = static_cast<const int8_t*>(kv.k);
      const int8_t* vg = static_cast<const int8_t*>(kv.v);
      const uint32_t k_s = smem_addr(sm.kraw[slot]), v_s = smem_addr(sm.vraw[slot]);
      for (int idx = tid; idx < TN * (D / 16); idx += NT) {
        const int j = idx / (D / 16), c = idx % (D / 16);
        const int kpos = base + j;
        const bool ok = kpos >= job.klo && kpos < job.khi;
        const long off = ok ? kv.rows(kpos) + c * 16 : 0;
        cp_async16(k_s + j * D + c * 16, kg + off, ok ? 16 : 0);
        cp_async16(v_s + j * D + c * 16, vg + off, ok ? 16 : 0);
      }
      if (tid < 2 * TN) {
        const int j = tid % TN, kpos = base + j;
        const bool ok = kpos >= job.klo && kpos < job.khi;
        const long si = ok ? kv.rows.scale(kpos) : 0;
        if (tid < TN) cp_async4(smem_addr(&sm.ks[slot][j]), kv.ks + si, ok ? 4 : 0);
        else cp_async4(smem_addr(&sm.vs[slot][j]), kv.vs + si, ok ? 4 : 0);
      }
    }
  };

  // int8: raw slot -> the bf16 tiles, exactly
  auto convert = [&](int slot) {
    unsigned char* kb = reinterpret_cast<unsigned char*>(sm.k[0]);
    unsigned char* vb = reinterpret_cast<unsigned char*>(sm.v[0]);
    for (int idx = tid; idx < TN * (D / 16); idx += NT) {
      const int j = idx / (D / 16), c = idx % (D / 16);
      const uint4 kr = *reinterpret_cast<const uint4*>(&sm.kraw[slot][j * D + c * 16]);
      const uint4 vr = *reinterpret_cast<const uint4*>(&sm.vraw[slot][j * D + c * 16]);
      *reinterpret_cast<uint4*>(kb + sw128_off<TN>(j, 2 * c)) = i8x8_to_bf16x8(kr.x, kr.y);
      *reinterpret_cast<uint4*>(kb + sw128_off<TN>(j, 2 * c + 1)) = i8x8_to_bf16x8(kr.z, kr.w);
      *reinterpret_cast<uint4*>(vb + sw128_off<TN>(j, 2 * c)) = i8x8_to_bf16x8(vr.x, vr.y);
      *reinterpret_cast<uint4*>(vb + sw128_off<TN>(j, 2 * c + 1)) = i8x8_to_bf16x8(vr.z, vr.w);
    }
  };

  // this thread's rows of the wgmma fragments: r0 (accumulator entries
  // with (i / 2) % 2 == 0) and r0 + 8; its columns (i / 4) * 8 + cq + i % 2
  const int r0 = warp * 16 + lane / 4, cq = (lane & 3) * 2;
  int lo[2], lim[2];
  float m[2], lsum[2];  // lsum: this thread's share of the row sum
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    const bool valid = r < nrows;
    const int pos = job.pos0 + r / G;
    lim[rr] = valid ? min(pos + 1, job.total) : 0;
    lo[rr] = valid && at.window > 0 ? max(pos - at.window + 1, 0) : 0;
    // the sink is the QUERY head's (kh * G + r % G), not the kv head's
    const bool sink = valid && job.sink && at.sinks != nullptr;
    m[rr] = sink ? at.sinks[kh * G + r % G] : NEG_INF;
    lsum[rr] = sink && (lane & 3) == 0 ? 1.f : 0.f;
  }
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  const int kfirst = job.klo - job.klo % TN;
  const int nsteps = job.khi > job.klo ? (job.khi - kfirst + TN - 1) / TN : 0;
  if (nsteps > 0) load(0, kfirst);
  cp_async_commit();

  for (int it = 0; it < nsteps; ++it) {
    const int slot = it & 1, base = kfirst + it * TN;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // step it landed; every warpgroup is done with step it - 1
    if (it + 1 < nsteps) load(slot ^ 1, base + TN);
    cp_async_commit();
    if constexpr (I8) {
      convert(slot);
      fence_async_smem();
      __syncthreads();
    }
    const uint32_t k_s = smem_addr(sm.k[I8 ? 0 : slot]), v_s = smem_addr(sm.v[I8 ? 0 : slot]);

    // S = Q K^T (f32, 64 rows x 64 keys)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (TM * 128) + (kk & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(q_s + off, 16, 1024), sw128_desc(k_s + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // scale (int8: x the key's scale), softcap, mask; row max by quads
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + cq + (i & 1), rr = (i >> 1) & 1;
      const int kpos = base + col;
      float x = s[i] * scale;
      if constexpr (I8) x *= sm.ks[slot][col];
      if (cap > 0.f) x = cap * fast_tanh(x * inv_cap);
      // per-row bounds: keys below a row's own window inside the first
      // step are masked here, not read as live
      x = kpos >= lo[rr] && kpos < lim[rr] ? x : NEG_INF;
      s[i] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = __expf(m[rr] - m_new);
      m[rr] = m_new;
      lsum[rr] *= alpha[rr];
    }
    // P (bf16) as the A fragments of the four k16 slices of P.V: slice kk
    // is accumulator entries 8kk .. 8kk + 7, pair e -> register e
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e, rr = e & 1;
        const int col = (2 * kk + (e >> 1)) * 8 + cq;
        // masked keys weigh exactly 0 (with a sink m starts above NEG_INF)
        float p0 = s[i] > 0.5f * NEG_INF ? __expf(s[i] - m[rr]) : 0.f;
        float p1 = s[i + 1] > 0.5f * NEG_INF ? __expf(s[i + 1] - m[rr]) : 0.f;
        lsum[rr] += p0 + p1;
        if constexpr (I8) {
          p0 *= sm.vs[slot][col];
          p1 *= sm.vs[slot][col + 1];
        }
        __nv_bfloat162 b = __floats2bfloat162_rn(p0, p1);
        pa[kk][e] = *reinterpret_cast<uint32_t*>(&b);
      }
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V over this warpgroup's DW dims (V regions 2wg, 2wg + 1; at
    // D = 64 the one region)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv =
          sw128_desc(v_s + wg * 2 * (TN * 128) + kk * 16 * 128, TN * 128, 1024);
      if constexpr (DW == 64) wgmma_rs_n64(o, pa[kk], dv);
      else wgmma_rs_n128(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
  }
  cp_async_wait_all();

  // emit the valid rows: acc / max(l, 1e-30), or the partial state
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = lsum[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * rr;
    if (r >= nrows) continue;
    const long head = (long)kh * G + r % G, tok = r / G;
    if (job.part_acc != nullptr) {
      const long prow = job.part_row0 + tok * h + head;
      float* dst = job.part_acc + prow * D + wg * DW + cq;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[4 * j + 2 * rr], o[4 * j + 2 * rr + 1]);
      if (wg == 0 && (lane & 3) == 0) {
        job.part_m[prow] = m[rr];
        job.part_l[prow] = l;
      }
    } else {
      const float inv = 1.0f / fmaxf(l, 1e-30f);
      __nv_bfloat16* dst = out + ((job.tok0 + tok) * h + head) * D + wg * DW + cq;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    }
  }
}

}  // namespace dtt
