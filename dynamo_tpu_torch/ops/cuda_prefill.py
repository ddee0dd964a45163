"""Flash prefix-extend attention on the GPU: counterpart of the reference's
ops/pallas_prefill.py (``flash_extend_attention``).

The kernel is ``csrc/flash_extend.cu`` (one block per (q tile, kv head),
S and P.V on the tensor cores with the online softmax in registers over a
cp.async ring of context tiles, tiles past the tile's causal limit
skipped), at head_dim 64 or 128 and any G = h / kvh up to 64 (a tile holds
``64 // G`` tokens; the rows past ``(64 // G) * G`` are padding). It takes
any ``S`` and ``T``: there are no tile-multiple constraints, so the engine
runs it for every prefill chunk. On CPU tensors
this wrapper runs the plain version; on CUDA tensors it launches the kernel
or raises. With ``k_scales``/``v_scales`` the context is int8 (a
quantized cache gathered raw by ``ops.attention.gather_kv_quant``):
``KERNEL_INT8`` copies the int8 rows, converts them to bf16 exactly and
applies the scales to the f32 score and probability columns.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import attention as att
from ._build import Kernel, check_cuda_tensor

KERNEL = Kernel("flash_extend.cu", "dtt_flash_extend", n_ptrs=4, n_ints=6)
KERNEL_INT8 = Kernel("flash_extend.cu", "dtt_flash_extend_i8", n_ptrs=6, n_ints=6)
HEAD_DIMS = (64, 128)
# query-head rows of a tile: it holds TILE_ROWS // G tokens of a kv head's
# G query heads, so G may be at most TILE_ROWS
TILE_ROWS = 64


def supports(heads: int, kv_heads: int, head_dim: int) -> bool:
    """Whether the kernel has a form for this attention shape."""
    return (head_dim in HEAD_DIMS and heads % kv_heads == 0
            and heads // kv_heads <= TILE_ROWS)


def flash_extend_reference(
    q: torch.Tensor, k_ctx: torch.Tensor, v_ctx: torch.Tensor,
    q_start: int, total_len: int,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: ``ops.attention.extend_attention`` with the
    chunk's contiguous positions ``q_start + i``; an int8 context is
    dequantized first (``float(q) * scale``, as ``gather_kv`` does)."""
    if k_scales is not None:
        k_ctx = k_ctx.float() * k_scales[..., None]
        v_ctx = v_ctx.float() * v_scales[..., None]
    pos = q_start + torch.arange(q.shape[0], device=q.device)
    return att.extend_attention(q, k_ctx, v_ctx, pos, total_len)


def flash_extend_attention(
    q: torch.Tensor,        # [S, h, d] bf16 queries of one chunk, d in HEAD_DIMS
    k_ctx: torch.Tensor,    # [T, kvh, d] bf16 gathered context, or int8
    v_ctx: torch.Tensor,
    q_start: int,           # absolute position of q row 0 (rows are contiguous)
    total_len: int,         # valid context length, <= T
    *,
    k_scales: Optional[torch.Tensor] = None,  # [T, kvh] f32: the context is int8
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Same semantics as ``ops.attention.extend_attention`` for contiguous
    query positions ``q_start + i``: key j is visible to row i iff
    ``j < min(q_start + i + 1, total_len)``."""
    if q.device.type == "cpu":
        return flash_extend_reference(q, k_ctx, v_ctx, q_start, total_len,
                                      k_scales, v_scales)
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    ctx_dtype = torch.int8 if quantized else torch.bfloat16
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    check_cuda_tensor("k_ctx", k_ctx, ctx_dtype, 3)
    check_cuda_tensor("v_ctx", v_ctx, ctx_dtype, 3)
    S, h, d = q.shape
    T, kvh, dk = k_ctx.shape
    if quantized:
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            check_cuda_tensor(name, sc, torch.float32, 2)
            if tuple(sc.shape) != (T, kvh):
                raise ValueError(f"{name} must be [T, kv_heads] = {(T, kvh)}")
    if d not in HEAD_DIMS or dk != d or v_ctx.shape != k_ctx.shape:
        raise ValueError(f"the flash-extend kernel takes head_dim in {HEAD_DIMS} and equal "
                         "K/V of the query's head_dim")
    if h % kvh or h // kvh > TILE_ROWS:
        raise ValueError(f"{h} heads over {kvh} kv heads: group size above {TILE_ROWS}")
    if not 0 <= int(total_len) <= T:
        raise ValueError(f"total_len {total_len} outside the context of {T} keys")
    out = torch.empty_like(q)
    if S:
        ints = [S, h, kvh, d, int(q_start), int(total_len)]
        if quantized:
            KERNEL_INT8.launch([q, k_ctx, v_ctx, k_scales, v_scales, out], ints)
        else:
            KERNEL.launch([q, k_ctx, v_ctx, out], ints)
    return out
