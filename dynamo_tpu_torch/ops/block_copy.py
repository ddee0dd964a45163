"""Batched KV page moves on the GPU: counterpart of the reference's
ops/block_copy.py (``gather_blocks``, ``scatter_blocks``, ``copy_blocks``
and the int8 pair wrappers).

The kernel is ``csrc/block_copy.cu``: one page copy with an optional index
map on each side serves all three moves, on a cache of any dtype (bf16
pages, int8 payload, f32 scale rows). On CPU tensors each wrapper runs its
plain version (``*_blocks_ref``); on CUDA tensors it launches the kernel or
raises. The reference donates the cache buffer to its scatter and copy;
here they write the cache tensor IN PLACE and return it.

Used by the engine's KVBM offload (gather) and onboard (scatter).
"""

from __future__ import annotations

import torch

from ._build import Kernel, check_cuda_tensor
from .quant import QuantizedKV

GATHER = Kernel("block_copy.cu", "dtt_gather_blocks", n_ptrs=3, n_ints=3)
SCATTER = Kernel("block_copy.cu", "dtt_scatter_blocks", n_ptrs=3, n_ints=3)
COPY = Kernel("block_copy.cu", "dtt_copy_blocks", n_ptrs=3, n_ints=3)


# ----------------------------------------------------------- plain versions
def gather_blocks_ref(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    return cache[block_ids.long()]


def scatter_blocks_ref(cache: torch.Tensor, block_ids: torch.Tensor,
                       blocks: torch.Tensor) -> torch.Tensor:
    cache[block_ids.long()] = blocks
    return cache


def copy_blocks_ref(cache: torch.Tensor, src_ids: torch.Tensor,
                    dst_ids: torch.Tensor) -> torch.Tensor:
    cache[dst_ids.long()] = cache[src_ids.long()]
    return cache


# ----------------------------------------------------------------- wrappers
def _page_bytes(cache: torch.Tensor) -> int:
    if cache.device.type != "cuda":
        raise ValueError(f"cache: expected a CUDA tensor, got {cache.device}")
    if not cache.is_contiguous() or cache.dim() < 1:
        raise ValueError("cache: must be contiguous with a leading block dim")
    n = cache[0].numel() * cache.element_size() if cache.shape[0] else 0
    if n >= 1 << 31:
        raise ValueError(f"a page of {n} bytes is past the kernel's int range")
    return n


def _check_ids(name: str, ids: torch.Tensor) -> None:
    check_cuda_tensor(name, ids, torch.int32, 1)


def _check_pages(cache: torch.Tensor, blocks: torch.Tensor, M: int) -> None:
    if blocks.dtype != cache.dtype or tuple(blocks.shape) != (M, *cache.shape[1:]):
        raise ValueError(
            f"blocks {blocks.dtype} {tuple(blocks.shape)} are not {M} pages of "
            f"{cache.dtype} {tuple(cache.shape[1:])}"
        )


def gather_blocks(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """Pages ``cache[block_ids]`` as a fresh contiguous [M, ...] tensor."""
    if cache.device.type == "cpu":
        return gather_blocks_ref(cache, block_ids)
    page = _page_bytes(cache)
    _check_ids("block_ids", block_ids)
    M = block_ids.shape[0]
    out = torch.empty((M, *cache.shape[1:]), dtype=cache.dtype, device=cache.device)
    if M and page:
        GATHER.launch([cache, block_ids, out], [M, page, cache.shape[0]])
    return out


def scatter_blocks(cache: torch.Tensor, block_ids: torch.Tensor,
                   blocks: torch.Tensor) -> torch.Tensor:
    """``cache[block_ids] = blocks`` in place; returns ``cache``."""
    if cache.device.type == "cpu":
        return scatter_blocks_ref(cache, block_ids, blocks)
    page = _page_bytes(cache)
    _check_ids("block_ids", block_ids)
    M = block_ids.shape[0]
    _check_pages(cache, blocks, M)
    if not blocks.is_contiguous() or blocks.device != cache.device:
        raise ValueError("blocks: must be contiguous on the cache's device")
    if M and page:
        SCATTER.launch([cache, block_ids, blocks], [M, page, cache.shape[0]])
    return cache


def _upload(ids: torch.Tensor, device: torch.device) -> torch.Tensor:
    """int32 ids on ``device``; host ids go through pinned memory, so the
    upload does not wait for the device to drain (a pageable copy would)."""
    ids = ids.to(torch.int32)
    if ids.device.type == "cpu":
        ids = ids.pin_memory().to(device, non_blocking=True)
    return ids


def copy_blocks(cache: torch.Tensor, src_ids: torch.Tensor,
                dst_ids: torch.Tensor) -> torch.Tensor:
    """``cache[dst_ids] = cache[src_ids]`` in place (defrag / prefix fork).
    ``src_ids`` and ``dst_ids`` must be disjoint, as the reference requires
    (a page both read and written would be read before or after its write
    depending on the order the blocks run in); the check reads the ids on
    the host, so ids passed as CPU tensors keep it free of a device sync."""
    if src_ids.shape != dst_ids.shape:
        raise ValueError("src_ids and dst_ids must have the same length")
    overlap = set(src_ids.tolist()) & set(dst_ids.tolist())
    if overlap:
        raise ValueError(f"copy_blocks: src and dst share pages {sorted(overlap)[:8]}")
    if cache.device.type == "cpu":
        return copy_blocks_ref(cache, src_ids, dst_ids)
    page = _page_bytes(cache)
    src_ids, dst_ids = (_upload(i, cache.device) for i in (src_ids, dst_ids))
    _check_ids("src_ids", src_ids)
    _check_ids("dst_ids", dst_ids)
    M = src_ids.shape[0]
    if M and page:
        COPY.launch([cache, src_ids, dst_ids], [M, page, cache.shape[0]])
    return cache


# -- quantized caches (ops/quant.QuantizedKV) --------------------------------
# A quantized page move is two moves, the int8 payload and its f32 scale row,
# that MUST travel together (a payload under the wrong scale is silent
# corruption, not an error).
def gather_blocks_quant(cache: QuantizedKV, block_ids: torch.Tensor) -> QuantizedKV:
    """QuantizedKV pages -> (payload [M, bs, kvh, d] int8, scales [M, kvh])."""
    return QuantizedKV(gather_blocks(cache.data, block_ids),
                       gather_blocks(cache.scale, block_ids))


def scatter_blocks_quant(cache: QuantizedKV, block_ids: torch.Tensor,
                         blocks: QuantizedKV) -> QuantizedKV:
    """Scatter (payload, scales) pages into a QuantizedKV cache in place."""
    scatter_blocks(cache.data, block_ids, blocks.data)
    scatter_blocks(cache.scale, block_ids, blocks.scale)
    return cache
