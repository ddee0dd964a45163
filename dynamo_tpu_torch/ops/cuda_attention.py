"""Paged decode attention on the GPU: counterpart of the reference's
ops/pallas_attention.py (``paged_decode_attention``).

The kernels are in ``csrc/decode_attention.cu`` (one block per (sequence,
kv head), online softmax over the sequence's real pages only): ``KERNEL``
for a bf16 cache, ``KERNEL_INT8`` for an int8 ``QuantizedKV`` cache (int8
pages plus f32 scale rows, dequantized in registers). On CPU tensors this
wrapper runs the plain version, ``ops.attention.paged_decode_attention``;
on CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import torch

from . import attention as att
from ._build import Kernel, check_cuda_tensor
from .quant import is_quantized

KERNEL = Kernel("decode_attention.cu", "dtt_paged_decode", n_ptrs=6, n_ints=5)
KERNEL_INT8 = Kernel("decode_attention.cu", "dtt_paged_decode_i8", n_ptrs=8, n_ints=5)
# query heads per kv head the kernel is instantiated for
GROUP_SIZES = (1, 2, 4, 8)


def paged_decode_attention(
    q: torch.Tensor,             # [B, h, 128] bf16
    k_cache,                     # [num_blocks, bs, kvh, 128] bf16, or QuantizedKV
    v_cache,                     # (int8 pages + f32 [num_blocks, kvh] scales)
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    seq_lens: torch.Tensor,      # [B] int32
) -> torch.Tensor:
    """Same semantics as ``ops.attention.paged_decode_attention`` for rows
    with ``seq_lens > 0``; a row with ``seq_len == 0`` reads back zeros."""
    if q.device.type == "cpu":
        return att.paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens)
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    quantized = is_quantized(k_cache)
    caches = check_caches(k_cache, v_cache)
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
        (KERNEL_INT8 if quantized else KERNEL).launch(
            [q, *caches, block_tables, seq_lens, out],
            [B, h, kvh, bs, block_tables.shape[1]],
        )
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
