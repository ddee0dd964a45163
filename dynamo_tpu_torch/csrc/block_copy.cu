// Batched KV page moves: gather, scatter and copy of whole pages of any
// number of arrays in one launch.
//
// Replaces the TPU kernels of dynamo_tpu/ops/block_copy.py: _gather_kernel
// (:30, gather_blocks :57, out[m] = cache[ids[m]]), _scatter_kernel (:65,
// scatter_blocks :101, cache[ids[m]] = blocks[m], in place) and _copy_kernel
// (:110, copy_blocks :138, cache[dst[m]] = cache[src[m]], in place). On the
// TPU each was one HBM->HBM DMA per page driven by scalar-prefetched ids.
// Here one kernel serves all three over a descriptor table: each entry
// (PageMove) names one array move, its source and destination bases and
// page strides, its page size in bytes, and which side the launch's ids
// index (the source for gather, the destination for scatter, both for
// copy). A page is the leading-dimension slice of any dtype, moved as
// bytes: a bf16 Llama-3-8B page is 32 KiB, an int8 page 16 KiB, an int8
// scale row 32 B.
//
// Bound on this card: bytes (each page read once and written once, no
// arithmetic); a small move is bound by its launch instead, so the engine
// moves a whole offload or onboard batch, every layer's K and V (and their
// scale rows), in ONE launch. Design:
//   - the work is flattened over (page index m, entry, 4 KiB chunk): one
//     warp per item, the items of all entries side by side, so 32-byte
//     scale rows share blocks with the payload instead of taking blocks of
//     their own; a grid-stride loop over the items;
//   - each lane issues COPY_UNROLL 16-byte loads before any store (32 KiB
//     in flight per block of 8 warps), where both page starts are 16-byte
//     aligned; a byte path for the tail and for unaligned pages;
//   - an id outside its side's page range moves nothing (gather leaves zeros
//     in its output page): the kernel never reads or writes out of bounds;
//   - a side may be relative to one of two buffers given per launch (the
//     stacked [n, L, 2, ...] host-layout buffer of a layer-batched move), so
//     the table of an engine's caches is built once on the device and only
//     the ids and the buffer change per call. Up to MAX_INLINE entries come
//     by value in the launch's parameters instead (the single-array and
//     int8-pair wrappers), with no table upload.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace dtt {

constexpr int COPY_THREADS = 256;
constexpr int COPY_WARPS = COPY_THREADS / 32;
constexpr int COPY_UNROLL = 8;                       // 16-byte loads per lane in flight
constexpr long long CHUNK = 32LL * 16 * COPY_UNROLL;  // bytes per warp item: 4 KiB
constexpr int MAX_INLINE = 4;
constexpr long long MAX_GRID = 4096;

// flags: which side the ids index, and which launch buffer (1: base0,
// 2: base1; 0: none, the address is absolute) each side is relative to
enum : int { SRC_IDS = 1, DST_IDS = 2 };
__host__ __device__ constexpr int src_base(int flags) { return (flags >> 2) & 3; }
__host__ __device__ constexpr int dst_base(int flags) { return (flags >> 4) & 3; }

// one array move; ops/block_copy.py MOVE_DTYPE mirrors this layout
struct PageMove {
  long long src, dst;                // base addresses (or offsets into a launch buffer)
  long long src_stride, dst_stride;  // bytes between pages m and m + 1 of each side
  long long page_bytes;
  long long w0;                      // its first item among one page index's W items
  int src_limit, dst_limit;          // pages of an indexed side: ids outside move nothing
  int flags;
  int nchunk;                        // its items per page index: ceil(page_bytes / CHUNK)
};
static_assert(sizeof(PageMove) == 64, "PageMove is 64 bytes (MOVE_DTYPE)");

struct InlineMoves {
  PageMove e[MAX_INLINE];
};

// bytes [lo, hi) of one page, by one warp
__device__ __forceinline__ void copy_chunk(const unsigned char* sp, unsigned char* dp,
                                           long long lo, long long hi, bool src_ok, int lane) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(sp) | reinterpret_cast<uintptr_t>(dp)) & 15) == 0;
  long long tail = lo;
  if (vec) {
    const long long vhi = lo + ((hi - lo) & ~15LL);
    uint4 r[COPY_UNROLL];
#pragma unroll
    for (int k = 0; k < COPY_UNROLL; ++k) {
      const long long i = lo + ((long long)k * 32 + lane) * 16;
      r[k] = src_ok && i < vhi ? *reinterpret_cast<const uint4*>(sp + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < COPY_UNROLL; ++k) {
      const long long i = lo + ((long long)k * 32 + lane) * 16;
      if (i < vhi) *reinterpret_cast<uint4*>(dp + i) = r[k];
    }
    tail = vhi;
  }
  for (long long i = tail + lane; i < hi; i += 32) dp[i] = src_ok ? sp[i] : 0;
}

__global__ void __launch_bounds__(COPY_THREADS)
page_move_kernel(const PageMove* __restrict__ table, const InlineMoves inl, int n_entries,
                 int W, const int* __restrict__ src_ids, const int* __restrict__ dst_ids,
                 int M, unsigned char* base0, unsigned char* base1) {
  __shared__ PageMove s_inl[MAX_INLINE];
  const PageMove* tab = table;
  if (tab == nullptr) {
#pragma unroll
    for (int i = 0; i < MAX_INLINE; ++i)
      if (threadIdx.x == i && i < n_entries) s_inl[i] = inl.e[i];
    __syncthreads();
    tab = s_inl;
  }
  const int lane = threadIdx.x & 31;
  const long long items = (long long)M * W;
  const long long stride = (long long)gridDim.x * COPY_WARPS;
  for (long long it = (long long)blockIdx.x * COPY_WARPS + (threadIdx.x >> 5); it < items;
       it += stride) {
    const int m = (int)(it / W), w = (int)(it % W);
    // the entry holding item w: the last one with w0 <= w
    int lo = 0, hi = n_entries - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab[mid].w0 <= w) lo = mid;
      else hi = mid - 1;
    }
    const PageMove e = tab[lo];
    const int s = e.flags & SRC_IDS ? src_ids[m] : m;
    const int d = e.flags & DST_IDS ? dst_ids[m] : m;
    if ((e.flags & DST_IDS) && (d < 0 || d >= e.dst_limit)) continue;  // warp-uniform
    const bool src_ok = !(e.flags & SRC_IDS) || (s >= 0 && s < e.src_limit);
    const auto base = [&](int code) {
      return code == 1 ? (uintptr_t)base0 : code == 2 ? (uintptr_t)base1 : (uintptr_t)0;
    };
    const auto* sp = reinterpret_cast<const unsigned char*>(
        base(src_base(e.flags)) + e.src + (src_ok ? (long long)s * e.src_stride : 0));
    auto* dp = reinterpret_cast<unsigned char*>(base(dst_base(e.flags)) + e.dst +
                                                (long long)d * e.dst_stride);
    const long long c0 = (long long)(w - e.w0) * CHUNK;
    copy_chunk(sp, dp, c0, c0 + CHUNK < e.page_bytes ? c0 + CHUNK : e.page_bytes, src_ok, lane);
  }
}

}  // namespace dtt

// Moves M page indices of every entry of a descriptor table in one launch:
// entry e, page index m: dst page (DST_IDS ? dst_ids[m] : m) <- src page
// (SRC_IDS ? src_ids[m] : m), or zeros when an indexed source id is out of
// range. ``table``: n_entries PageMove on the device, or null with
// ``host_inline`` pointing at n_entries <= MAX_INLINE entries in host memory
// (copied into the launch's parameters). W: the sum of the entries'
// nchunk. base0 / base1: the launch's buffers, for entries whose sides are
// relative to them. Returns cudaGetLastError() after the launch.
extern "C" int dtt_page_moves(const void* src_ids, const void* dst_ids, const void* table,
                              const void* host_inline, void* base0, void* base1,
                              int n_entries, int W, int M, void* stream) {
  using namespace dtt;
  if (M <= 0 || W <= 0 || n_entries <= 0) return 0;
  InlineMoves inl{};
  if (table == nullptr) {
    if (host_inline == nullptr || n_entries > MAX_INLINE) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_entries; ++i) inl.e[i] = static_cast<const PageMove*>(host_inline)[i];
  }
  const long long items = (long long)M * W;
  long long blocks = (items + COPY_WARPS - 1) / COPY_WARPS;
  if (blocks > MAX_GRID) blocks = MAX_GRID;
  page_move_kernel<<<(unsigned)blocks, COPY_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const PageMove*>(table), inl, n_entries, W, static_cast<const int*>(src_ids),
      static_cast<const int*>(dst_ids), M, static_cast<unsigned char*>(base0),
      static_cast<unsigned char*>(base1));
  return (int)cudaGetLastError();
}

// Device memory shared between processes on one card (engine/transfer.py's
// device path): the transfer server's staging arena is one cudaMalloc of
// its own, outside PyTorch's caching allocator, so that its IPC handle
// names exactly the arena (a handle of a caching-allocator tensor names
// the whole segment it sits in). The server exports the handle once, each
// client process opens it once per server and caches the mapping; the
// page-move kernel above gathers into the arena and scatters out of it.
// Each returns a cudaError_t.
extern "C" int dtt_ipc_alloc(int device, long long nbytes, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMalloc(out, (size_t)nbytes);
}

extern "C" int dtt_ipc_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFree(ptr);
}

// ``handle_out``: CUDA_IPC_HANDLE_SIZE (64) bytes of host memory
extern "C" int dtt_ipc_export(int device, void* ptr, void* handle_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle_out, &h, sizeof(h));
  return (int)e;
}

// Fails (cudaErrorInvalidContext / cudaErrorInvalidValue) on a handle this
// process exported itself: the same process reaches its pages directly.
extern "C" int dtt_ipc_open(int device, const void* handle, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int dtt_ipc_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcCloseMemHandle(ptr);
}
