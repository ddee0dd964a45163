"""Paged decode attention on the GPU: counterpart of the reference's
ops/pallas_attention.py (``paged_decode_attention``).

The kernel is ``csrc/decode_attention.cu`` (one block per (sequence, kv
head), online softmax over the sequence's real pages only). On CPU tensors
this wrapper runs the plain version, ``ops.attention.paged_decode_attention``;
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import attention as att
from ._build import Kernel, check_cuda_tensor

KERNEL = Kernel("decode_attention.cu", "dtt_paged_decode", n_ptrs=6, n_ints=5)
# query heads per kv head the kernel is instantiated for
GROUP_SIZES = (1, 2, 4, 8)


def paged_decode_attention(
    q: torch.Tensor,             # [B, h, 128] bf16
    k_cache: torch.Tensor,       # [num_blocks, bs, kvh, 128] bf16
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    seq_lens: torch.Tensor,      # [B] int32
) -> torch.Tensor:
    """Same semantics as ``ops.attention.paged_decode_attention`` for rows
    with ``seq_lens > 0``; a row with ``seq_len == 0`` reads back zeros."""
    if q.device.type == "cpu":
        return att.paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens)
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    check_cuda_tensor("k_cache", k_cache, torch.bfloat16, 4)
    check_cuda_tensor("v_cache", v_cache, torch.bfloat16, 4)
    check_cuda_tensor("block_tables", block_tables, torch.int32, 2)
    check_cuda_tensor("seq_lens", seq_lens, torch.int32, 1)
    B, h, d = q.shape
    _, bs, kvh, dk = k_cache.shape
    if d != 128 or dk != 128 or v_cache.shape != k_cache.shape:
        raise ValueError("the decode kernel takes head_dim 128 and equal K/V caches")
    if h % kvh or h // kvh not in GROUP_SIZES:
        raise ValueError(f"{h} heads over {kvh} kv heads: group size not in {GROUP_SIZES}")
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables / seq_lens must have one row per query")
    out = torch.empty_like(q)
    if B:
        KERNEL.launch(
            [q, k_cache, v_cache, block_tables, seq_lens, out],
            [B, h, kvh, bs, block_tables.shape[1]],
        )
    return out
