"""Unified ragged paged attention on the GPU: counterpart of the reference's
ops/pallas_unified.py (``ragged_paged_attention``), row attributes included.

The kernel is ``csrc/unified_attention.cu``: one launch serves any mix of
prefill segments and decode tokens, each row attending over its own pages
with its segment at the tail of its context, at head_dim 64, 128 or 256. One
block per (q tile, kv head, row); blocks past their row's segment exit at
once. Rows may carry a sliding window (pages the window aged out are never
read), the launch per-head sink logits and a logit softcap. ``KERNEL``
reads a bf16 cache, ``KERNEL_INT8`` an int8 ``QuantizedKV`` one (int8 pages
plus f32 scale rows through the same block table). On CPU tensors this
wrapper runs the plain version, ``ops.attention.ragged_paged_attention``;
on CUDA tensors it launches a kernel or raises.

Split-K: a row of one q tile (a decode row, a short segment) whose keys
span more than ``SPLIT_KEYS`` is cut into splits, one block each, that
write their partial softmax state to scratch this wrapper allocates; the
second kernel, ``MERGE``, which the same C entry launches next on the
same stream, combines them (its own entry, ``merge_attention_partials``,
checks it alone; plain version ``ops.attention.merge_attention_partials``). The grid's
split extent comes from ``max_seq_len``, a host-side bound on the rows'
``seq_lens`` (as ``max_q_len`` bounds ``q_lens``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import attention as att
from ._build import Kernel, LaunchCounter, check_cuda_tensor
from .cuda_attention import _capturing, check_caches
from .quant import is_quantized

KERNEL = Kernel("unified_attention.cu", "dtt_unified", n_ptrs=14, n_ints=10, n_floats=1)
KERNEL_INT8 = Kernel("unified_attention.cu", "dtt_unified_i8", n_ptrs=16, n_ints=10,
                     n_floats=1)
MERGE = Kernel("unified_attention.cu", "dtt_merge_partials", n_ptrs=8, n_ints=6)
HEAD_DIMS = (64, 128, 256)
# the kernel's SPLIT_KEYS (csrc/unified_attention.cu): keys per split of a
# one-tile row, 32 pages of 16 (att.SPLIT_PAGES)
SPLIT_KEYS = 512
KEY_STEP = 64   # keys per step of the tile body (csrc/attn_common.cuh TN)

# launches (of either kernel) that carried a sliding window: the serving
# check reads it to show that windowed rows went through the kernel
WINDOWED = LaunchCounter()
# when a list, each launch outside a CUDA-graph capture appends (grid,
# n_splits): its grid and the
# kernel's own split count per row (a device copy of the [R] int32 counts
# it wrote, 0 = not split; None when the launch had no split extent). The
# GPU smoke script reads it to show what split-K did.
split_log = None


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
    max_seq_len: Optional[int] = None,
) -> torch.Tensor:
    """Same semantics as ``ops.attention.ragged_paged_attention``.
    ``max_q_len`` and ``max_seq_len`` are host-side bounds on every
    ``q_lens[r]`` and ``seq_lens[r]`` that size the launch grid (defaults
    ``Tq`` and ``max_blocks * block_size``, always safe); the caller knows
    them without reading the device. A ``max_seq_len`` below a row's
    ``seq_len`` costs that row longer splits, never a wrong result."""
    softcap = float(softcap) if softcap else None
    if q.device.type == "cpu":
        return att.ragged_paged_attention(
            q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens,
            windows=windows, sinks=sinks, softcap=softcap,
        )
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
    max_blocks = block_tables.shape[1]
    bound = Tq if max_q_len is None else min(int(max_q_len), Tq)
    seq_bound = max_blocks * bs if max_seq_len is None else min(int(max_seq_len),
                                                                max_blocks * bs)
    S, QS = split_shape(h, kvh, bound, seq_bound)
    out = torch.zeros_like(q)
    if R and bound > 0 and Tq:
        scratch = [None] * 4
        if S > 1:
            # one buffer, passed by address (this runs once per layer):
            # acc [R, S, QS, h, d], m and l [R, S, QS, h] f32, n_splits [R]
            # int32. Under a CUDA-graph capture it comes from the graph's
            # private pool, which keeps it for the graph's life, so the
            # addresses baked into the captured launches stay valid on
            # every replay.
            n = R * S * QS * h
            part = torch.empty(n * (d + 2) + R, dtype=torch.float32, device=q.device)
            base = part.data_ptr()
            scratch = [part, base + 4 * n * d, base + 4 * n * (d + 1), base + 4 * n * (d + 2)]
        (KERNEL_INT8 if is_quantized(k_cache) else KERNEL).launch(
            [q, *caches, block_tables, q_starts, q_lens, seq_lens, windows, sinks, out,
             *scratch],
            [Tq, h, kvh, d, bs, R, max_blocks, bound, S, QS],
            [softcap or 0.0],
        )
        if windows is not None:
            WINDOWED.launches += 1
        if S > 1:
            # the C entry launched the merge after the kernel (one host call)
            MERGE.launches += 1
        if split_log is not None and not _capturing(q.device):
            grid = (max(-(-bound // (att.TILE_ROWS // (h // kvh))), S), kvh, R)
            # (a copy: a view would keep the whole scratch alive)
            split_log.append((grid, part[-R:].view(torch.int32).clone() if S > 1 else None))
    return out


def split_shape(h: int, kvh: int, max_q_len: int, max_seq_len: int):
    """(S, QS) of a launch: at most S splits per row (1 = no split-K), and
    QS, the longest row that may be split (one q tile of 64 // G tokens,
    at most ``max_q_len``), the token extent of the scratch."""
    S = max(1, -(-max_seq_len // SPLIT_KEYS))
    return S, max(1, min(max_q_len, att.TILE_ROWS // (h // kvh)))


def merge_attention_partials(
    part_acc: torch.Tensor,   # [R, S, QS, h, d] f32
    part_m: torch.Tensor,     # [R, S, QS, h] f32
    part_l: torch.Tensor,     # [R, S, QS, h] f32
    n_splits: torch.Tensor,   # [R] int32
    q_starts: torch.Tensor,   # [R] int32
    q_lens: torch.Tensor,     # [R] int32
    out: torch.Tensor,        # [Tq, h, d] bf16, written in place
    sinks: Optional[torch.Tensor] = None,   # [h] f32
) -> torch.Tensor:
    """The split rows' outputs from their partial states, as
    ``ops.attention.merge_attention_partials`` (run on CPU tensors); on
    CUDA tensors the merge kernel, in place. Returns ``out``."""
    if out.device.type == "cpu":
        return att.merge_attention_partials(part_acc, part_m, part_l, n_splits, q_starts,
                                            q_lens, out, sinks)
    R, S, QS, h, d = part_acc.shape
    check_cuda_tensor("part_acc", part_acc, torch.float32, 5)
    for name, t in (("part_m", part_m), ("part_l", part_l)):
        check_cuda_tensor(name, t, torch.float32, 4)
        if tuple(t.shape) != (R, S, QS, h):
            raise ValueError(f"{name} must be [R, S, QS, h] = {(R, S, QS, h)}")
    for name, t in (("n_splits", n_splits), ("q_starts", q_starts), ("q_lens", q_lens)):
        check_cuda_tensor(name, t, torch.int32, 1)
        if t.shape[0] != R:
            raise ValueError(f"{name} needs one entry per row")
    check_cuda_tensor("out", out, torch.bfloat16, 3)
    if d not in HEAD_DIMS or out.shape[1:] != (h, d):
        raise ValueError(f"out must be [Tq, {h}, {d}] with head_dim in {HEAD_DIMS}")
    if sinks is not None:
        check_cuda_tensor("sinks", sinks, torch.float32, 1)
    MERGE.launch([part_acc, part_m, part_l, n_splits, q_starts, q_lens, sinks, out],
                 [out.shape[0], h, d, R, S, QS])
    return out
