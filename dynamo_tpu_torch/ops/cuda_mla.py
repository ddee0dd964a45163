"""Latent paged attention on the GPU: the MLA form of the reference's
ops/pallas_unified.py (``ragged_paged_attention``, the TPU kernel
``_unified_kernel`` at :93), at the shape the latent cache has and the
Pallas kernel could not take: one kv head, d_qk = 576 (kv_lora_rank 512 +
qk_rope_head_dim 64), output lanes d_v = 512, G = h query heads (a
multiple of 16, at most 128; 16 for DeepSeek-V2-Lite, 128 for V2 / V3).

The kernel is ``csrc/mla_attention.cu``: one launch serves any mix of
prefill chunks and decode tokens (ragged rows, each at the tail of its
context, causal), every attention call of an MLA model on the card. Rows
of at most ``tile_shape(...)[2]`` tokens are split over their keys
(``SPLIT_KEYS``-key splits from key 0, ``ops.attention.split_plan``) and
merged in split order by the last split block, in the same launch. The
split scratch and the merge counters live in the per-(device, stream)
buffer of ops/cuda_attention.py: ``reserve`` sizes it before a CUDA-graph
capture, and a launch that would grow it during one raises. When
``split_log`` is a list, each launch outside a capture appends its grid
and a device copy of the split counts the kernel wrote.

On CPU tensors this wrapper runs the plain version,
``ops.attention.ragged_paged_attention(...)[..., :v_dim]`` (its output
lanes below v_dim do not depend on the V lanes above it);
``split_latent_attention`` is the plain form of the split plan. On CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import attention as att
from . import cuda_attention
from ._build import Kernel, check_cuda_tensor
from .cuda_attention import _capturing, _scratch_for, stream_key
from .quant import is_quantized

KERNEL = Kernel("mla_attention.cu", "dtt_latent_attention", n_ptrs=11, n_ints=7)
D_QK, D_V = 576, 512
# the kernel's MLA_SPLIT_KEYS (csrc/mla_attention.cu): keys per split
SPLIT_KEYS = 256

# when a list, each launch appends (grid, n_splits): its (x, R) grid and a
# device copy of the [R] int32 split counts the kernel wrote (0 = not split)
split_log = None


def tile_shape(h: int, max_q_len: int) -> Tuple[int, int, int, int]:
    """(MT, rows, QS, XS) of a launch: 16-row tiles per block (2 when a row
    may hold 32 or more (token, head) pairs, else 1), the block's rows,
    the longest row that may be split (in tokens) and the blocks such a
    row takes per split."""
    mt = 2 if max_q_len * h >= 32 else 1
    rows = 16 * mt
    qs = max(1, rows // h)
    return mt, rows, qs, -(-qs * h // rows)


def split_extent(max_seq_len: int) -> int:
    """S, the most splits a row of at most ``max_seq_len`` keys takes."""
    return max(1, -(-int(max_seq_len) // SPLIT_KEYS))


def scratch_words(rows: int, h: int, max_q_len: int, max_seq_len: int) -> Tuple[int, int]:
    """(counter words, other words) of a launch over ``rows`` rows: the
    per-(row, tile group) counters, then n_splits (padded to 16 bytes) and
    the partials acc [R, S, QS * h, 512], m and l [R, S, QS * h] f32."""
    _, _, qs, xs = tile_shape(h, max_q_len)
    n = rows * split_extent(max_seq_len) * qs * h
    return rows * xs, -(-rows // 4) * 4 + n * (D_V + 2)


def reserve(device, rows: int, heads: int, max_seq_len: int) -> None:
    """Size the current stream's scratch for every launch of at most
    ``rows`` rows bounded by ``max_seq_len`` keys, whatever their q_len
    (before a capture)."""
    device = torch.device(device)
    _scratch_for(device, stream_key(device), *scratch_words(rows, heads, 2, max_seq_len))


def latent_paged_attention(
    q: torch.Tensor,             # [Tq, h, 576] bf16 packed ragged queries
    k_cache: torch.Tensor,       # [num_blocks, bs, 1, 576] bf16
    v_cache: torch.Tensor,       # [num_blocks, bs, 1, 576] bf16 (lanes >= v_dim unread)
    block_tables: torch.Tensor,  # [R, max_blocks] int32
    q_starts: torch.Tensor,      # [R] int32
    q_lens: torch.Tensor,        # [R] int32 (0 = empty row)
    seq_lens: torch.Tensor,      # [R] int32
    *,
    v_dim: int = D_V,
    max_q_len: Optional[int] = None,
    max_seq_len: Optional[int] = None,
) -> torch.Tensor:
    """``ops.attention.ragged_paged_attention(...)[..., :v_dim]`` ->
    [Tq, h, v_dim]. ``max_q_len`` and ``max_seq_len`` are host bounds on
    every ``q_lens[r]`` and ``seq_lens[r]`` that size the grid (defaults
    ``Tq`` and ``max_blocks * block_size``, always safe); a low
    ``max_seq_len`` only lengthens a row's splits."""
    if q.device.type == "cpu":
        return att.ragged_paged_attention(q, k_cache, v_cache, block_tables, q_starts,
                                          q_lens, seq_lens)[..., :v_dim]
    if is_quantized(k_cache) or is_quantized(v_cache):
        raise TypeError("the latent kernel takes bf16 caches (no int8 form yet)")
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    check_cuda_tensor("k_cache", k_cache, torch.bfloat16, 4)
    check_cuda_tensor("v_cache", v_cache, torch.bfloat16, 4)
    check_cuda_tensor("block_tables", block_tables, torch.int32, 2)
    for name, t in (("q_starts", q_starts), ("q_lens", q_lens), ("seq_lens", seq_lens)):
        check_cuda_tensor(name, t, torch.int32, 1)
    Tq, h, d = q.shape
    _, bs, kvh, dk = k_cache.shape
    R = block_tables.shape[0]
    if d != D_QK or dk != D_QK or kvh != 1 or v_cache.shape != k_cache.shape:
        raise ValueError(f"the latent kernel takes q [Tq, h, {D_QK}] and K/V caches "
                         f"[num_blocks, bs, 1, {D_QK}]")
    if v_dim != D_V:
        raise ValueError(f"the latent kernel writes v_dim {D_V}, not {v_dim}")
    if h % 16 or not 16 <= h <= 128:
        raise ValueError(f"{h} query heads: the latent kernel takes a multiple of 16 "
                         "up to 128")
    if not q_starts.shape[0] == q_lens.shape[0] == seq_lens.shape[0] == R:
        raise ValueError("q_starts / q_lens / seq_lens need one entry per table row")
    max_blocks = block_tables.shape[1]
    bound = Tq if max_q_len is None else min(int(max_q_len), Tq)
    seq_bound = max_blocks * bs if max_seq_len is None else min(int(max_seq_len),
                                                                max_blocks * bs)
    out = torch.zeros(Tq, h, D_V, dtype=q.dtype, device=q.device)
    if R and bound > 0 and Tq:
        mt, rows, qs, xs = tile_shape(h, bound)
        S = split_extent(seq_bound)
        stream, capturing = stream_key(q.device), _capturing(q.device)
        counts, n_splits = _scratch_for(q.device, stream,
                                        *scratch_words(R, h, bound, seq_bound),
                                        capturing=capturing)
        part = n_splits + 4 * (-(-R // 4) * 4)
        KERNEL.launch(
            [q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens, out, part,
             n_splits, counts],
            [h, bs, R, max_blocks, bound, S, mt],
        )
        if split_log is not None and not capturing:
            buf, have = cuda_attention._scratch[(q.device, stream)]
            grid = (max(-(-bound * h // rows), S * xs), R)
            split_log.append((grid, buf[have:have + R].clone()))
    return out


def split_latent_attention(
    q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
    q_starts: torch.Tensor, q_lens: torch.Tensor, seq_lens: torch.Tensor,
    *, max_seq_len: int, max_q_len: int, v_dim: int = D_V, drop_last_split: bool = False,
) -> torch.Tensor:
    """latent_paged_attention computed as the kernel does with split-K
    (plain PyTorch): rows of at most QS tokens (tile_shape) whose keys
    span two or more ``SPLIT_KEYS``-key splits go through
    ``ops.attention.attention_partials`` and
    ``merge_attention_partials`` in split order; every other row directly.
    ``drop_last_split``: merge without each split row's last split (a
    mutant that a check must catch)."""
    _, h, _ = q.shape
    _, _, qs, _ = tile_shape(h, max_q_len)
    bs = k_cache.shape[1]
    acc, m, l, n = att.attention_partials(
        q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens,
        split_keys=SPLIT_KEYS, align=bs, max_splits=split_extent(max_seq_len),
        tile_tokens=qs)
    split = {r for r, c in enumerate(n.tolist()) if c >= 2}
    R = q_starts.shape[0]
    out = att._ragged_rows(q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens,
                           [0] * R, None, None, skip=split)
    if drop_last_split:
        n = torch.where(n >= 2, n - 1, n)
    att.merge_attention_partials(acc, m, l, n, q_starts, q_lens, out)
    return out[..., :v_dim].to(q.dtype)
