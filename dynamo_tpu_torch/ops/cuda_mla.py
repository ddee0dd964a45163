"""Latent paged attention on the GPU: the MLA form of the reference's
ops/pallas_unified.py (``ragged_paged_attention``, the TPU kernel
``_unified_kernel`` at :93), at the shape the latent cache has and the
Pallas kernel could not take: one kv head, d_qk = 576 (kv_lora_rank 512 +
qk_rope_head_dim 64), output lanes d_v = 512, G = h query heads (a
multiple of 16, at most 128; 16 for DeepSeek-V2-Lite, 128 for V2 / V3).

The kernel is ``csrc/mla_attention.cu``: one launch serves any mix of
prefill chunks and decode tokens (ragged rows, each at the tail of its
context, causal), every attention call of an MLA model on the card. It
reads one cache: the values are the keys' first 512 lanes (an MLA model
caches K' = [c, k_pe] and V' = [c, 0], equal there bit for bit), so no V
byte moves. Each launch takes one of two forms, by ``tile_shape``: the
wide form (64-row ``wgmma`` tiles, a producer warpgroup filling the
key ring for two consumer warpgroups) where a row may hold
64 or more (token, head) pairs (prefill chunks, mixed steps, G = 128
decode), else the narrow form (16-row ``mma.sync`` tiles, two blocks per
SM: G = 16 decode, short rows). Rows of at most ``tile_shape(...)[2]``
tokens are split over their keys
(``SPLIT_KEYS``-key splits from key 0, ``ops.attention.split_plan``) and
merged in split order by the last split block, in the same launch. The
split scratch and the merge counters live in the per-(device, stream)
buffer of ops/cuda_attention.py: ``reserve`` sizes it before a CUDA-graph
capture, and a launch that would grow it during one raises. When
``split_log`` is a list, each launch outside a capture appends its grid
and a device copy of the split counts the kernel wrote.

On CPU tensors this wrapper runs the plain version,
``ops.attention.ragged_paged_attention(q, kv, kv, ...)[..., :v_dim]``
(output lanes below v_dim read only value lanes below v_dim);
``split_latent_attention`` is the plain form of the split plan. On CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import attention as att
from . import cuda_attention
from ._build import Kernel, LaunchCounter, check_cuda_tensor
from .cuda_attention import _capturing, _scratch_for, stream_key
from .quant import is_quantized

KERNEL = Kernel("mla_attention.cu", "dtt_latent_attention", n_ptrs=10, n_ints=7)
# the launches of each form (KERNEL counts them all)
NARROW, WIDE = LaunchCounter(), LaunchCounter()
D_QK, D_V = 576, 512
# the kernel's MLA_SPLIT_KEYS (csrc/mla_attention.cu): keys per split
SPLIT_KEYS = 256
# the most splits a row takes (the merging block keeps 2 floats a (split,
# row) in Q's shared bytes, room for 143): longer rows take longer splits
MAX_SPLITS = 128
# the kernel's MLA_NARROW_ROWS and MLA_WIDE_ROWS: (token, head) pairs a
# block takes in each form
NARROW_ROWS, WIDE_ROWS = 16, 64

# when a list, each launch appends (grid, n_splits): its (x, R) grid and a
# device copy of the [R] int32 split counts the kernel wrote (0 = not split)
split_log = None


def tile_shape(h: int, max_q_len: int) -> Tuple[str, int, int, int]:
    """(form, rows, QS, XS) of a launch: the wide form (64-row wgmma tiles)
    when a row may hold 64 or more (token, head) pairs, else the narrow
    form (16-row mma.sync tiles); the block's rows, the longest row that
    may be split (in tokens: one wide tile's, max(1, 64 // h), in either
    form, so every row of a narrow launch may be split) and the blocks
    such a row takes per split."""
    wide = max_q_len * h >= WIDE_ROWS
    rows = WIDE_ROWS if wide else NARROW_ROWS
    qs = max(1, WIDE_ROWS // h)
    return ("wide" if wide else "narrow"), rows, qs, -(-qs * h // rows)


def split_extent(max_seq_len: int) -> int:
    """S, the most splits a row of at most ``max_seq_len`` keys takes."""
    return min(MAX_SPLITS, max(1, -(-int(max_seq_len) // SPLIT_KEYS)))


def scratch_words(rows: int, h: int, max_q_len: int, max_seq_len: int) -> Tuple[int, int]:
    """(counter words, other words) of a launch over ``rows`` rows: the
    per-(row, tile group) counters, then n_splits (padded to 16 bytes) and
    the partials acc [R, S, QS * h, 512], m and l [R, S, QS * h] f32."""
    _, _, qs, xs = tile_shape(h, max_q_len)
    n = rows * split_extent(max_seq_len) * qs * h
    return rows * xs, -(-rows // 4) * 4 + n * (D_V + 2)


def reserve_words(rows: int, heads: int, max_seq_len: int) -> Tuple[int, int]:
    """scratch_words covering every launch of at most ``rows`` rows bounded
    by ``max_seq_len`` keys in either form (q_len 1 takes the narrow form
    where there is one, 64 the wide)."""
    forms = [scratch_words(rows, heads, q, max_seq_len) for q in (1, WIDE_ROWS)]
    return max(c for c, _ in forms), max(w for _, w in forms)


def reserve(device, rows: int, heads: int, max_seq_len: int) -> None:
    """Size the current stream's scratch for every launch of at most
    ``rows`` rows bounded by ``max_seq_len`` keys, whatever their q_len
    (before a capture)."""
    device = torch.device(device)
    _scratch_for(device, stream_key(device), *reserve_words(rows, heads, max_seq_len))


def latent_paged_attention(
    q: torch.Tensor,             # [Tq, h, 576] bf16 packed ragged queries
    kv_cache: torch.Tensor,      # [num_blocks, bs, 1, 576] bf16: keys, values their first v_dim lanes
    block_tables: torch.Tensor,  # [R, max_blocks] int32
    q_starts: torch.Tensor,      # [R] int32
    q_lens: torch.Tensor,        # [R] int32 (0 = empty row)
    seq_lens: torch.Tensor,      # [R] int32
    *,
    v_dim: int = D_V,
    max_q_len: Optional[int] = None,
    max_seq_len: Optional[int] = None,
) -> torch.Tensor:
    """``ops.attention.ragged_paged_attention(q, kv_cache, kv_cache,
    ...)[..., :v_dim]`` -> [Tq, h, v_dim]: the values are the keys' first
    ``v_dim`` lanes (an MLA cache's V rows equal them there). ``max_q_len``
    and ``max_seq_len`` are host bounds on every ``q_lens[r]`` and
    ``seq_lens[r]`` that pick the form and size the grid (defaults ``Tq``
    and ``max_blocks * block_size``, always safe); a low ``max_seq_len``
    only lengthens a row's splits."""
    if q.device.type == "cpu":
        return att.ragged_paged_attention(q, kv_cache, kv_cache, block_tables, q_starts,
                                          q_lens, seq_lens)[..., :v_dim]
    if is_quantized(kv_cache):
        raise TypeError("the latent kernel takes a bf16 cache (no int8 form yet)")
    check_cuda_tensor("q", q, torch.bfloat16, 3)
    check_cuda_tensor("kv_cache", kv_cache, torch.bfloat16, 4)
    check_cuda_tensor("block_tables", block_tables, torch.int32, 2)
    for name, t in (("q_starts", q_starts), ("q_lens", q_lens), ("seq_lens", seq_lens)):
        check_cuda_tensor(name, t, torch.int32, 1)
    Tq, h, d = q.shape
    _, bs, kvh, dk = kv_cache.shape
    R = block_tables.shape[0]
    if d != D_QK or dk != D_QK or kvh != 1:
        raise ValueError(f"the latent kernel takes q [Tq, h, {D_QK}] and a cache "
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
        form, rows, qs, xs = tile_shape(h, bound)
        S = split_extent(seq_bound)
        stream, capturing = stream_key(q.device), _capturing(q.device)
        counts, n_splits = _scratch_for(q.device, stream,
                                        *scratch_words(R, h, bound, seq_bound),
                                        capturing=capturing)
        part = n_splits + 4 * (-(-R // 4) * 4)
        KERNEL.launch(
            [q, kv_cache, block_tables, q_starts, q_lens, seq_lens, out, part, n_splits,
             counts],
            [h, bs, R, max_blocks, bound, S, rows],
        )
        (WIDE if form == "wide" else NARROW).launches += 1
        if split_log is not None and not capturing:
            buf, have = cuda_attention._scratch[(q.device, stream)]
            grid = (max(-(-bound * h // rows), S * xs), R)
            split_log.append((grid, buf[have:have + R].clone()))
    return out


def latent_verify_attention(
    q: torch.Tensor,             # [B, n, h, 576] bf16: each row's n candidate tokens
    kv_cache: torch.Tensor,      # [num_blocks, bs, 1, 576] bf16
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    total_lens: torch.Tensor,    # [B] int32 context length incl. the candidates
    active: torch.Tensor,        # [B] bool
    *,
    v_dim: int = D_V,
    max_seq_len: Optional[int] = None,
) -> torch.Tensor:
    """The verify pass of speculative decoding on an MLA main -> [B, n, h,
    v_dim]: row b's n tokens at positions ``total_lens[b] - n + i``,
    causal over the row's pages. On CUDA tensors ONE launch of the latent
    kernel over ``q_len = n`` rows built on the device (capturable in a
    CUDA graph; inactive rows read back zeros); on CPU tensors the batched,
    host-read-free ``ops.attention.paged_extend_attention(q, kv, kv,
    ...)[..., :v_dim]`` (inactive rows are garbage there)."""
    B, n, h, d = q.shape
    if q.device.type == "cpu":
        return att.paged_extend_attention(q, kv_cache, kv_cache, block_tables,
                                          total_lens - n, total_lens)[..., :v_dim]
    i32 = torch.int32
    starts = torch.arange(B, dtype=i32, device=q.device) * n
    out = latent_paged_attention(
        q.reshape(B * n, h, d), kv_cache, block_tables, starts, active.to(i32) * n,
        torch.where(active, total_lens, 0).to(i32), v_dim=v_dim, max_q_len=n,
        max_seq_len=max_seq_len)
    return out.reshape(B, n, h, v_dim)


def split_latent_attention(
    q: torch.Tensor, kv_cache, block_tables: torch.Tensor,
    q_starts: torch.Tensor, q_lens: torch.Tensor, seq_lens: torch.Tensor,
    *, max_seq_len: int, max_q_len: int, v_dim: int = D_V, drop_last_split: bool = False,
) -> torch.Tensor:
    """latent_paged_attention computed as the kernel does with split-K
    (plain PyTorch, values from the keys): rows of at most QS tokens
    (tile_shape, by the form ``max_q_len`` picks) whose keys
    span two or more ``SPLIT_KEYS``-key splits go through
    ``ops.attention.attention_partials`` and
    ``merge_attention_partials`` in split order; every other row directly.
    ``drop_last_split``: merge without each split row's last split (a
    mutant that a check must catch)."""
    _, h, _ = q.shape
    _, _, qs, _ = tile_shape(h, max_q_len)
    bs = kv_cache.shape[1]
    acc, m, l, n = att.attention_partials(
        q, kv_cache, kv_cache, block_tables, q_starts, q_lens, seq_lens,
        split_keys=SPLIT_KEYS, align=bs, max_splits=split_extent(max_seq_len),
        tile_tokens=qs)
    split = {r for r, c in enumerate(n.tolist()) if c >= 2}
    R = q_starts.shape[0]
    out = att._ragged_rows(q, kv_cache, kv_cache, block_tables, q_starts, q_lens, seq_lens,
                           [0] * R, None, None, skip=split)
    if drop_last_split:
        n = torch.where(n >= 2, n - 1, n)
    att.merge_attention_partials(acc, m, l, n, q_starts, q_lens, out)
    return out[..., :v_dim].to(q.dtype)
