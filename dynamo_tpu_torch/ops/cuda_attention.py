"""Paged decode attention on the GPU: counterpart of the reference's
ops/pallas_attention.py (``paged_decode_attention``, the TPU kernel
``_decode_kernel`` at :36).

The kernels are in ``csrc/decode_attention.cu``: ``KERNEL`` for a bf16
cache, ``KERNEL_INT8`` for an int8 ``QuantizedKV`` cache (int8 pages plus
f32 scale rows, converted to bf16 exactly in shared memory, the scales
applied to the score and probability columns), at head_dim 64 or 128 and any
G = h / kvh from 1 to 8. Bytes bound them on the H100 (~4 * G flops
per byte read), so the design keeps the card's loads in flight: split-K
over the context, grid (split, kv head, row), each row cut from key 0 into
``DEC_SPLIT_KEYS``-key splits (``ops.attention.split_plan``); each block
streams its keys through a ``cp.async`` ring of 64-key tiles, computes the
scores and P.V on the tensor cores (``mma.sync``, the G heads padded to 16
rows) and updates its softmax once per tile; the last split block of each
(row, kv head) to finish merges the row's splits in split order in the
same launch.

``max_seq_len``, a host bound on ``seq_lens``, sizes the grid's split
extent (a low bound only lengthens a row's splits). The split scratch and
the merge counters are one buffer per (device, stream), kept by this
module and grown on demand (``_scratch``): launches on one stream run in
order, so each finds the counters at 0. A CUDA graph keeps the address
its capture saw, so ``reserve`` sizes the capturing stream's buffer before
a capture, and a launch that would grow it during one raises. When
``split_log`` is a list, each launch outside a capture appends its grid
and a device copy of the split counts the kernel wrote.

On CPU tensors this wrapper runs the plain version,
``ops.attention.paged_decode_attention`` (``max_seq_len`` is taken and
ignored); its split form is ``ops.attention.split_paged_decode_attention``.
On CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import attention as att
from ._build import Kernel, check_cuda_tensor
from .quant import is_quantized

KERNEL = Kernel("decode_attention.cu", "dtt_paged_decode", n_ptrs=9, n_ints=7)
KERNEL_INT8 = Kernel("decode_attention.cu", "dtt_paged_decode_i8", n_ptrs=11, n_ints=7)
# query heads per kv head the kernel is instantiated for (the G heads fill
# rows of a 16-row mma tile; G 9-16, Qwen3-235B's 16 among them, is not)
GROUP_SIZES = tuple(range(1, 9))
HEAD_DIMS = (64, 128)


def supports(heads: int, kv_heads: int, head_dim: int) -> bool:
    """Whether the kernel has a form for this attention shape."""
    return (head_dim in HEAD_DIMS and heads % kv_heads == 0
            and heads // kv_heads in GROUP_SIZES)


# the kernel's DEC_SPLIT_KEYS (csrc/decode_attention.cu): keys per split
DEC_SPLIT_KEYS = 256

# when a list, each launch appends (grid, n_splits): its (S, kvh, B) grid
# and a device copy of the [B] int32 split counts the kernel wrote (0 = not
# split). The GPU smoke script reads it to show what split-K did.
split_log = None

# (device, stream) -> (int32 buffer, counter words): [counters | n_splits | partials]
_scratch: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, int]] = {}


def split_extent(max_seq_len: int) -> int:
    """S, the grid's split extent for rows of at most ``max_seq_len`` keys
    (1: no row is split)."""
    return max(1, -(-int(max_seq_len) // DEC_SPLIT_KEYS))


def scratch_words(batch: int, heads: int, kv_heads: int, max_seq_len: int,
                  head_dim: int = 128) -> Tuple[int, int]:
    """(counter words, other words) a launch of ``batch`` rows needs: the
    per-(row, kv head) counters, then n_splits (padded to 16 bytes) and
    the partials acc [B, kvh, S, G, head_dim], m and l [B, kvh, S, G] f32."""
    rows = batch * heads * split_extent(max_seq_len)
    return batch * kv_heads, -(-batch // 4) * 4 + rows * (head_dim + 2)


def stream_key(device: torch.device) -> int:
    """The scratch key of the current stream (0 off CUDA)."""
    return torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0


def _scratch_for(device: torch.device, stream: int, counters: int, words: int,
                 capturing: bool = False) -> Tuple[int, int]:
    """Addresses of the counters and of the rest (n_splits, then the
    partials) in the scratch buffer of (``device``, ``stream``), grown (and
    zeroed) when a launch needs more. The counters must be 0 before a
    launch; the kernel leaves them 0. Growing frees the old buffer, which a
    captured graph would go on writing: under a capture (``capturing``)
    it raises instead."""
    buf, have = _scratch.get((device, stream), (None, 0))
    if buf is None or have < counters or buf.numel() - have < words:
        if capturing:
            raise RuntimeError(
                f"decode scratch of stream {stream:#x} would grow during a CUDA-graph "
                f"capture ({counters} counters, {words} words needed): reserve() it first")
        # the rest keeps at least its old size: a later launch that needs
        # more counters but fewer words must not shrink what an earlier
        # reserve covered
        size = max(words, 0 if buf is None else buf.numel() - have)
        have = max(have, -(-counters // 4) * 4)
        buf = torch.zeros(have + size, dtype=torch.int32, device=device)
        _scratch[(device, stream)] = (buf, have)
    return buf.data_ptr(), buf.data_ptr() + 4 * have


def reserve(device, batch: int, heads: int, kv_heads: int, max_seq_len: int,
            head_dim: int = 128) -> None:
    """Size the current stream's scratch for every launch of at most
    ``batch`` rows bounded by ``max_seq_len`` keys (before a capture)."""
    device = torch.device(device)
    _scratch_for(device, stream_key(device),
                 *scratch_words(batch, heads, kv_heads, max_seq_len, head_dim))


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def paged_decode_attention(
    q: torch.Tensor,             # [B, h, d] bf16, d in HEAD_DIMS
    k_cache,                     # [num_blocks, bs, kvh, d] bf16, or QuantizedKV
    v_cache,                     # (int8 pages + f32 [num_blocks, kvh] scales)
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    seq_lens: torch.Tensor,      # [B] int32
    *,
    max_seq_len: Optional[int] = None,
) -> torch.Tensor:
    """Same semantics as ``ops.attention.paged_decode_attention`` for rows
    with ``seq_lens > 0``; a row with ``seq_len == 0`` reads back zeros.
    ``max_seq_len``: a host bound on every ``seq_lens[b]`` that sizes the
    split grid (default ``max_blocks * block_size``, always safe)."""
    if q.device.type == "cpu":
        return att.paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens)
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    quantized = is_quantized(k_cache)
    caches = check_caches(k_cache, v_cache)
    check_cuda_tensor("block_tables", block_tables, torch.int32, 2)
    check_cuda_tensor("seq_lens", seq_lens, torch.int32, 1)
    B, h, d = q.shape
    _, bs, kvh, dk = k_cache.shape
    if d not in HEAD_DIMS or dk != d or v_cache.shape != k_cache.shape:
        raise ValueError(f"the decode kernel takes head_dim in {HEAD_DIMS} and equal K/V "
                         "caches of the query's head_dim")
    if h % kvh or h // kvh not in GROUP_SIZES:
        raise ValueError(f"{h} heads over {kvh} kv heads: group size not in {GROUP_SIZES}")
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables / seq_lens must have one row per query")
    max_blocks = block_tables.shape[1]
    bound = max_blocks * bs if max_seq_len is None else min(int(max_seq_len), max_blocks * bs)
    S = split_extent(bound)
    out = torch.empty_like(q)
    if B:
        stream, capturing = stream_key(q.device), _capturing(q.device)
        counts, n_splits = _scratch_for(q.device, stream,
                                        *scratch_words(B, h, kvh, bound, d),
                                        capturing=capturing)
        part = n_splits + 4 * (-(-B // 4) * 4)
        (KERNEL_INT8 if quantized else KERNEL).launch(
            [q, *caches, block_tables, seq_lens, out, part, n_splits, counts],
            [B, h, kvh, d, bs, max_blocks, S],
        )
        if split_log is not None and not capturing:
            buf, have = _scratch[(q.device, stream)]
            split_log.append(((S, kvh, B), buf[have:have + B].clone()))
    return out


def check_caches(k_cache, v_cache) -> list:
    """The paged caches as the kernels' pointer arguments: [k, v] for bf16,
    [k_int8, v_int8, k_scales, v_scales] for ``QuantizedKV``; raises on
    anything else."""
    if is_quantized(k_cache) != is_quantized(v_cache):
        raise TypeError("k_cache and v_cache must both be quantized or both not")
    if not is_quantized(k_cache):
        check_cuda_tensor("k_cache", k_cache, torch.bfloat16, 4)
        check_cuda_tensor("v_cache", v_cache, torch.bfloat16, 4)
        return [k_cache, v_cache]
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_cuda_tensor(name + ".data", c.data, torch.int8, 4)
        check_cuda_tensor(name + ".scale", c.scale, torch.float32, 2)
        if tuple(c.scale.shape) != (c.data.shape[0], c.data.shape[2]):
            raise ValueError(f"{name}.scale must be [num_blocks, kv_heads]")
    return [k_cache.data, v_cache.data, k_cache.scale, v_cache.scale]
