// Batched KV page moves: gather, scatter and copy of whole pages.
//
// Replaces the TPU kernels of dynamo_tpu/ops/block_copy.py: _gather_kernel
// (gather_blocks, out[m] = cache[ids[m]]), _scatter_kernel (scatter_blocks,
// cache[ids[m]] = blocks[m], in place) and _copy_kernel (copy_blocks,
// cache[dst[m]] = cache[src[m]], in place). On the TPU each was one HBM->HBM
// DMA per page driven by scalar-prefetched ids. Here one kernel serves all
// three: a page copy with an optional index map on each side. A page is the
// cache's leading-dimension slice of any dtype, moved as bytes: a bf16 page
// of Llama-3-8B is 32 KiB, an int8 page 16 KiB, an int8 scale row 32 B.
//
// Bound on this card: bytes (each page is read once and written once, no
// arithmetic). Design:
//   - grid (M, chunks): block (m, c) moves bytes [c * CHUNK, (c+1) * CHUNK)
//     of page m, CHUNK = 256 threads x 16 B, so a 32 KiB page spreads over 8
//     blocks and even M = 1 keeps several SMs busy;
//   - 16-byte vector loads and stores where both page starts are 16-byte
//     aligned, with a byte tail for a page size that is not a multiple of
//     16; byte moves otherwise (a scale row of an odd kv-head count);
//   - an index outside [0, num_blocks) moves nothing (gather leaves its
//     output page zero): the kernel never reads or writes out of bounds.
// One launch per array: the engine moves a layer's K and V (and their scale
// rows) with separate launches. A batched copy over a pointer array, as in
// upstream Dynamo's block_copy.cu, is later work (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

constexpr int COPY_THREADS = 256;
constexpr long CHUNK = COPY_THREADS * 16;

__global__ void __launch_bounds__(COPY_THREADS)
page_copy_kernel(const unsigned char* src, unsigned char* dst,
                 const int* __restrict__ src_ids, const int* __restrict__ dst_ids,
                 long page_bytes, int src_pages, int dst_pages) {
  const int m = blockIdx.x;
  const long lo = blockIdx.y * CHUNK;
  const long hi = lo + CHUNK < page_bytes ? lo + CHUNK : page_bytes;
  const int s = src_ids ? src_ids[m] : m;
  const int d = dst_ids ? dst_ids[m] : m;
  if (d < 0 || d >= dst_pages) return;
  unsigned char* dp = dst + (long)d * page_bytes;
  const bool src_ok = s >= 0 && s < src_pages;
  const unsigned char* sp = src + (long)s * page_bytes;
  const bool vec = ((reinterpret_cast<uintptr_t>(sp) | reinterpret_cast<uintptr_t>(dp)) & 15) == 0;
  if (vec) {
    // lo is a multiple of 16: vectors up to the last whole one, then bytes
    const long vhi = lo + ((hi - lo) & ~15L);
    for (long i = lo + threadIdx.x * 16; i < vhi; i += COPY_THREADS * 16) {
      const uint4 v = src_ok ? *reinterpret_cast<const uint4*>(sp + i) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dp + i) = v;
    }
    for (long i = vhi + threadIdx.x; i < hi; i += COPY_THREADS) dp[i] = src_ok ? sp[i] : 0;
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += COPY_THREADS) dp[i] = src_ok ? sp[i] : 0;
  }
}

int launch(const void* src, void* dst, const void* src_ids, const void* dst_ids,
           int M, long page_bytes, int src_pages, int dst_pages, void* stream) {
  if (M <= 0 || page_bytes <= 0) return 0;
  const dim3 grid(M, (unsigned)((page_bytes + CHUNK - 1) / CHUNK));
  page_copy_kernel<<<grid, COPY_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      static_cast<const int*>(src_ids), static_cast<const int*>(dst_ids), page_bytes,
      src_pages, dst_pages);
  return (int)cudaGetLastError();
}

}  // namespace dtt

// Each returns cudaGetLastError() after the launch; page_bytes is the size
// of one page (the wrapper keeps it below 2^31).

// out[m] = cache[ids[m]] for m < M; cache holds num_blocks pages.
extern "C" int dtt_gather_blocks(const void* cache, const void* ids, void* out, int M,
                                 int page_bytes, int num_blocks, void* stream) {
  return dtt::launch(cache, out, ids, nullptr, M, page_bytes, num_blocks, M, stream);
}

// cache[ids[m]] = blocks[m] for m < M, in place.
extern "C" int dtt_scatter_blocks(void* cache, const void* ids, const void* blocks, int M,
                                  int page_bytes, int num_blocks, void* stream) {
  return dtt::launch(blocks, cache, nullptr, ids, M, page_bytes, M, num_blocks, stream);
}

// cache[dst[m]] = cache[src[m]] for m < M, in place; src and dst disjoint.
extern "C" int dtt_copy_blocks(void* cache, const void* src, const void* dst, int M,
                               int page_bytes, int num_blocks, void* stream) {
  return dtt::launch(cache, cache, src, dst, M, page_bytes, num_blocks, num_blocks, stream);
}
