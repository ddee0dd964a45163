"""Unified ragged paged attention on the GPU: counterpart of the reference's
ops/pallas_unified.py (``ragged_paged_attention``), row attributes included.

The kernel is ``csrc/unified_attention.cu``: one launch serves any mix of
prefill segments and decode tokens, each row attending over its own pages
with its segment at the tail of its context, at head_dim 128 or 256. One
block per (q tile, kv head, row); blocks past their row's segment exit at
once. Rows may carry a sliding window (pages the window aged out are never
read), the launch per-head sink logits and a logit softcap. ``KERNEL``
reads a bf16 cache, ``KERNEL_INT8`` an int8 ``QuantizedKV`` one (int8 pages
plus f32 scale rows through the same block table). On CPU tensors this
wrapper runs the plain version, ``ops.attention.ragged_paged_attention``;
on CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import attention as att
from ._build import Kernel, check_cuda_tensor
from .cuda_attention import check_caches
from .quant import is_quantized

KERNEL = Kernel("unified_attention.cu", "dtt_unified", n_ptrs=10, n_ints=8, n_floats=1)
KERNEL_INT8 = Kernel("unified_attention.cu", "dtt_unified_i8", n_ptrs=12, n_ints=8,
                     n_floats=1)
HEAD_DIMS = (128, 256)

# launches (of either kernel) that carried a sliding window: the serving
# check reads it to show that windowed rows went through the kernel
windowed_launches = 0


def ragged_paged_attention(
    q: torch.Tensor,             # [Tq, h, d] bf16 packed ragged queries, d in HEAD_DIMS
    k_cache,                     # [num_blocks, bs, kvh, d] bf16, or QuantizedKV
    v_cache,
    block_tables: torch.Tensor,  # [R, max_blocks] int32
    q_starts: torch.Tensor,      # [R] int32
    q_lens: torch.Tensor,        # [R] int32 (0 = empty row)
    seq_lens: torch.Tensor,      # [R] int32
    *,
    windows: Optional[torch.Tensor] = None,   # [R] int32 per-row windows (<= 0: full)
    sinks: Optional[torch.Tensor] = None,     # [h] f32 sink logits
    softcap: Optional[float] = None,          # 0 or None: off
    max_q_len: Optional[int] = None,
) -> torch.Tensor:
    """Same semantics as ``ops.attention.ragged_paged_attention``.
    ``max_q_len`` is a host-side bound on every ``q_lens[r]`` that sizes
    the launch grid (default ``Tq``, always safe); the caller knows it
    without reading the device."""
    softcap = float(softcap) if softcap else None
    if q.device.type == "cpu":
        return att.ragged_paged_attention(
            q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens,
            windows=windows, sinks=sinks, softcap=softcap,
        )
    global windowed_launches
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    caches = check_caches(k_cache, v_cache)
    check_cuda_tensor("block_tables", block_tables, torch.int32, 2)
    for name, t in (("q_starts", q_starts), ("q_lens", q_lens), ("seq_lens", seq_lens)):
        check_cuda_tensor(name, t, torch.int32, 1)
    Tq, h, d = q.shape
    _, bs, kvh, dk = k_cache.shape
    R = block_tables.shape[0]
    if d not in HEAD_DIMS or dk != d or v_cache.shape != k_cache.shape:
        raise ValueError(f"the unified kernel takes head_dim in {HEAD_DIMS} and equal "
                         "K/V caches of the query's head_dim")
    if h % kvh or 64 % (h // kvh):
        raise ValueError(f"{h} heads over {kvh} kv heads: group size must divide 64")
    if not q_starts.shape[0] == q_lens.shape[0] == seq_lens.shape[0] == R:
        raise ValueError("q_starts / q_lens / seq_lens need one entry per table row")
    if windows is not None:
        check_cuda_tensor("windows", windows, torch.int32, 1)
        if windows.shape[0] != R:
            raise ValueError("windows needs one entry per table row")
    if sinks is not None:
        check_cuda_tensor("sinks", sinks, torch.float32, 1)
        if sinks.shape[0] != h:
            raise ValueError("sinks needs one logit per query head")
    bound = Tq if max_q_len is None else min(int(max_q_len), Tq)
    out = torch.zeros_like(q)
    if R and bound > 0 and Tq:
        (KERNEL_INT8 if is_quantized(k_cache) else KERNEL).launch(
            [q, *caches, block_tables, q_starts, q_lens, seq_lens, windows, sinks, out],
            [Tq, h, kvh, d, bs, R, block_tables.shape[1], bound],
            [softcap or 0.0],
        )
        if windows is not None:
            windowed_launches += 1
    return out
