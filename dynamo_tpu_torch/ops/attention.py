"""Attention ops for paged-KV serving: plain PyTorch versions.

Counterpart of the reference package's ops/attention.py, and the numerics
reference of the port's CUDA kernels (ops/cuda_attention, cuda_prefill,
cuda_unified): each kernel wrapper runs these on CPU tensors, the CPU tests
hold them to their JAX twins, and the GPU smoke script holds each kernel to
them on the card.

Layouts are the reference's at every public function:

- the paged KV cache of one layer is ``[num_blocks, block_size, kv_heads,
  head_dim]``; block 0 is reserved as scratch (padding writes land there);
- GQA grouping maps query heads ``[i*g, (i+1)*g)`` to KV head ``i``;
- masked scores are ``NEG_INF = -1e30`` and the softmax runs in float32.

A cache is either a raw tensor or an int8 ``QuantizedKV`` (ops/quant.py:
int8 pages plus f32 ``[num_blocks, kv_heads]`` scale rows). Reads
dequantize (``gather_kv``) or hand the raw pair to a kernel that
dequantizes in registers (``gather_kv_quant``); writes quantize on the way
in, as the reference's do.

The write ops update the cache IN PLACE (the JAX versions return new
arrays) and return the same objects, so a call site reads the same in both
packages.

The attention ops take the reference's optional attributes (gemma,
gpt-oss): ``window``, a sliding window under which key ``j`` is visible to
a query at position ``p`` iff ``p - window < j <= p``; ``sinks``, per-head
attention-sink logits that enter the softmax denominator only; and
``softcap``, ``cap * tanh(s / cap)`` on the scaled scores before the mask.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from .quant import (
    QuantizedKV,
    dequantize_blocks,
    is_quantized,
    quantize_blocks,
    requantize_token,
)

NEG_INF = -1e30

IntLike = Union[int, torch.Tensor]


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 attention-logit softcapping, ``cap * tanh(scores / cap)``,
    on the scaled scores before the mask; None leaves them untouched."""
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def _sink_softmax(scores: torch.Tensor, sinks: torch.Tensor) -> torch.Tensor:
    """Softmax over the key axis with attention-sink logits in the
    DENOMINATOR only (gpt-oss: a virtual key whose probability mass is
    dropped). scores [..., T]; ``sinks`` broadcastable to the leading dims."""
    m = torch.maximum(scores.amax(dim=-1), sinks)
    p = torch.exp(scores - m[..., None])
    denom = p.sum(dim=-1) + torch.exp(sinks - m)
    return p / denom[..., None]


def _softmax(scores: torch.Tensor, sinks: Optional[torch.Tensor]) -> torch.Tensor:
    """scores [S, h, T] -> weights; ``sinks`` [h] or None."""
    if sinks is None:
        return torch.softmax(scores, dim=-1)
    return _sink_softmax(scores, sinks.to(device=scores.device, dtype=torch.float32))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [S,h,d] x k [T,kvh,d] -> scores [S,h,T] (f32) with GQA grouping."""
    S, h, d = q.shape
    T, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(S, kvh, g, d).float()
    return torch.einsum("skgd,tkd->skgt", qg, k.float()).reshape(S, h, T)


def _gqa_values(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weights [S,h,T] x v [T,kvh,d] -> out [S,h,d] (f32)."""
    S, h, T = weights.shape
    _, kvh, d = v.shape
    g = h // kvh
    wg = weights.reshape(S, kvh, g, T)
    return torch.einsum("skgt,tkd->skgd", wg, v.float()).reshape(S, h, d)


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def causal_attention(q, k, v, window: Optional[int] = None,
                     sinks: Optional[torch.Tensor] = None,
                     softcap: Optional[float] = None):
    """Plain causal self-attention over one contiguous sequence.
    q,k,v: [S, heads/kv_heads, head_dim] -> [S, heads, head_dim].
    ``window``: key j visible to query i iff i - window < j <= i;
    ``sinks``: per-head [h] sink logits (denominator only)."""
    S = q.shape[0]
    scores = _softcap(_gqa_scores(q, k) * _scale(q.shape[-1]), softcap)
    idx = torch.arange(S, device=q.device)
    causal = idx[None, :] <= idx[:, None]
    if window is not None:
        causal &= idx[None, :] > idx[:, None] - window
    scores = torch.where(causal[:, None, :], scores, NEG_INF)
    return _gqa_values(_softmax(scores, sinks), v).to(q.dtype)


def extend_attention(
    q: torch.Tensor,            # [S_new, h, d] queries of the new suffix
    k_ctx: torch.Tensor,        # [T_max, kvh, d] gathered context incl. new keys
    v_ctx: torch.Tensor,        # [T_max, kvh, d]
    q_positions: torch.Tensor,  # [S_new] absolute positions of the queries
    total_len: IntLike,         # valid length of the context
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Prefix-extend attention: new tokens attend causally over (cached
    prefix + themselves); key j is visible to a query at position p iff
    ``j < min(p + 1, total_len)`` (and ``j > p - window`` with a window:
    the context layout is positional, so the bound is absolute)."""
    T = k_ctx.shape[0]
    scores = _softcap(_gqa_scores(q, k_ctx) * _scale(q.shape[-1]), softcap)   # [S,h,T]
    key_pos = torch.arange(T, device=q.device)
    pos = q_positions.to(q.device).long()
    lim = torch.clamp(pos + 1, max=int(total_len))
    valid = key_pos[None, :] < lim[:, None]
    if window is not None:
        valid &= key_pos[None, :] > pos[:, None] - window
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    return _gqa_values(_softmax(scores, sinks), v_ctx).to(q.dtype)


def gather_kv(
    k_cache,                    # [num_blocks, block_size, kvh, d] or QuantizedKV
    v_cache,
    block_table: torch.Tensor,  # [max_blocks] int (padded with 0)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequence's pages as contiguous [max_blocks*bs, kvh, d]. Quantized
    caches dequantize during the gather (f32 out)."""
    bs = k_cache.shape[1]
    mb = block_table.shape[0]
    idx = block_table.long()
    if is_quantized(k_cache):
        k = dequantize_blocks(k_cache.data[idx], k_cache.scale[idx])
        v = dequantize_blocks(v_cache.data[idx], v_cache.scale[idx])
    else:
        k, v = k_cache[idx], v_cache[idx]
    return k.reshape(mb * bs, *k.shape[2:]), v.reshape(mb * bs, *v.shape[2:])


def gather_kv_quant(
    k_cache: QuantizedKV,
    v_cache: QuantizedKV,
    block_table: torch.Tensor,  # [max_blocks] int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw-int8 gather for kernels that dequantize in registers
    (ops/cuda_prefill): (k int8 [T, kvh, d], v int8, k_scales f32 [T, kvh],
    v_scales f32 [T, kvh]) with the per-block scales broadcast to positions."""
    bs = k_cache.shape[1]
    mb = block_table.shape[0]
    idx = block_table.long()

    def pick(c):
        kvh = c.shape[2]
        q = c.data[idx].reshape(mb * bs, *c.shape[2:])
        s = c.scale[idx][:, None, :].expand(mb, bs, kvh).reshape(mb * bs, kvh)
        return q, s

    kq, ks = pick(k_cache)
    vq, vs = pick(v_cache)
    return kq, vq, ks, vs


def paged_decode_attention(
    q: torch.Tensor,             # [B, h, d] one query token per sequence
    k_cache,                     # [num_blocks, bs, kvh, d] or QuantizedKV
    v_cache,
    block_tables: torch.Tensor,  # [B, max_blocks] int
    seq_lens: torch.Tensor,      # [B] context length incl. the current token
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode attention, batched: each query attends over its own
    pages, keys ``< seq_lens[b]``. The query sits at position length - 1,
    so a window admits keys ``>= length - window``; windowed calls gather
    only the trailing ``ceil(window / bs) + 1`` table entries of each row,
    the rest gather every row's whole table."""
    B, h, d = q.shape
    _, bs, kvh, _ = k_cache.shape
    mb = block_tables.shape[1]
    lens = seq_lens.to(q.device).long()
    if window is None:
        idx = block_tables.long()
        key_pos = torch.arange(mb * bs, device=q.device).expand(B, -1)
        valid = key_pos < lens[:, None]                                     # [B, T]
    else:
        wb = min(-(-window // bs) + 1, mb)
        nblocks = torch.clamp(-(-lens // bs), min=1)
        start = torch.clamp(nblocks - wb, min=0)                            # [B]
        cols = torch.clamp(start[:, None] + torch.arange(wb, device=q.device), max=mb - 1)
        idx = torch.gather(block_tables.long(), 1, cols)
        key_pos = start[:, None] * bs + torch.arange(wb * bs, device=q.device)
        valid = (key_pos < lens[:, None]) & (key_pos >= lens[:, None] - window)
    n = idx.shape[1]
    if is_quantized(k_cache):
        k = dequantize_blocks(k_cache.data[idx], k_cache.scale[idx])
        v = dequantize_blocks(v_cache.data[idx], v_cache.scale[idx])
    else:
        k, v = k_cache[idx].float(), v_cache[idx].float()
    k = k.reshape(B, n * bs, kvh, d)
    v = v.reshape(B, n * bs, kvh, d)
    g = h // kvh
    qg = q.reshape(B, kvh, g, d).float()
    scores = _softcap(torch.einsum("bkgd,btkd->bkgt", qg, k) * _scale(d), softcap)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    if sinks is None:
        weights = torch.softmax(scores, dim=-1)
    else:
        sk = sinks.to(device=q.device, dtype=torch.float32).reshape(kvh, g)
        weights = _sink_softmax(scores, sk)
    out = torch.einsum("bkgt,btkd->bkgd", weights, v)
    return out.reshape(B, h, d).to(q.dtype)


def write_prefill_kv(
    k_cache,                     # [num_blocks, bs, kvh, d] or QuantizedKV
    v_cache,
    k_new: torch.Tensor,         # [S_pad, kvh, d] (S_pad a multiple of bs)
    v_new: torch.Tensor,
    block_ids: torch.Tensor,     # [S_pad // bs] destination blocks of the span
):
    """Scatter a contiguous span of new KV into its pages, in place. The
    caller pads S to a block multiple; padding blocks point at scratch
    block 0, where duplicate writes are harmless.

    Quantized caches quantize on write: prefill writes whole blocks, so the
    per-block scale comes in one shot. The amax covers EVERY row passed, so
    callers zero bucket-padding rows first (the engine's prefill does), or
    pad activations inflate the real tokens' scale."""
    bs = k_cache.shape[1]
    S = k_new.shape[0]
    idx = block_ids.long()
    k_blocks = k_new.reshape(S // bs, bs, *k_new.shape[1:])
    v_blocks = v_new.reshape(S // bs, bs, *v_new.shape[1:])
    if is_quantized(k_cache):
        for cache, blocks in ((k_cache, k_blocks), (v_cache, v_blocks)):
            q, scale = quantize_blocks(blocks)
            cache.data[idx] = q
            cache.scale[idx] = scale
        return k_cache, v_cache
    k_cache[idx] = k_blocks.to(k_cache.dtype)
    v_cache[idx] = v_blocks.to(v_cache.dtype)
    return k_cache, v_cache


def write_decode_kv(
    k_cache,
    v_cache,
    k_new: torch.Tensor,         # [B, kvh, d]
    v_new: torch.Tensor,
    block_ids: torch.Tensor,     # [B] destination block of each row's position
    offsets: torch.Tensor,       # [B] offset within the block
):
    """Scatter one token per sequence into its page slot, in place.
    Inactive rows all target scratch block 0.

    Quantized caches read-modify-write the ONE destination block of each
    row: its scale grows to cover the new token and its ints rescale once
    (ops/quant.requantize_token). A write at offset 0 is the first row of a
    freshly (re)allocated block, so the inherited scale is a stale leftover
    of the block's previous occupant and is reset; without the reset a
    recycled block that once held large activations would quantize a small
    new token to zero."""
    b, o = block_ids.long(), offsets.long()
    if is_quantized(k_cache):
        rows = torch.arange(b.shape[0], device=b.device)
        fresh = (o == 0)[:, None]                       # [B, 1] over kvh
        for cache, x_new in ((k_cache, k_new), (v_cache, v_new)):
            s_base = torch.where(fresh, 0.0, cache.scale[b])
            blk, s_new, q_new = requantize_token(cache.data[b], s_base, x_new)
            blk[rows, o] = q_new
            cache.data[b] = blk
            cache.scale[b] = s_new
        return k_cache, v_cache
    k_cache[b, o] = k_new.to(k_cache.dtype)
    v_cache[b, o] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def paged_extend_attention(
    q: torch.Tensor,             # [B, S_new, h, d] candidate-token queries
    k_cache,                     # [num_blocks, bs, kvh, d] or QuantizedKV
    v_cache,
    block_tables: torch.Tensor,  # [B, max_blocks] int
    start_pos: torch.Tensor,     # [B] absolute position of each row's q[0]
    total_lens: torch.Tensor,    # [B] context length incl. the S_new candidates
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Batched paged prefix-extend: every row attends its S_new new tokens
    causally over its OWN pages (which already hold the new tokens' KV):
    key j is visible to the row's token at position p iff ``j < min(p + 1,
    total_lens[b])`` (and ``j > p - window`` with a window). The verify
    pass of speculative decoding has this shape; the reference's plain
    engines run this op for it, with the layer's attributes. Batched over
    the rows with no host read, so that it runs inside the spec horizon's
    body on the CPU as it is."""
    B, n, h, d = q.shape
    _, bs, kvh, _ = k_cache.shape
    mb = block_tables.shape[1]
    idx = block_tables.long()
    if is_quantized(k_cache):
        k = dequantize_blocks(k_cache.data[idx], k_cache.scale[idx])
        v = dequantize_blocks(v_cache.data[idx], v_cache.scale[idx])
    else:
        k, v = k_cache[idx].float(), v_cache[idx].float()
    k = k.reshape(B, mb * bs, kvh, d)
    v = v.reshape(B, mb * bs, kvh, d)
    g = h // kvh
    qg = q.reshape(B, n, kvh, g, d).float()
    scores = _softcap(torch.einsum("bnkgd,btkd->bnkgt", qg, k) * _scale(d), softcap)
    pos = start_pos.long()[:, None] + torch.arange(n, device=q.device)
    lim = torch.minimum(pos + 1, total_lens.long()[:, None])                # [B, n]
    key_pos = torch.arange(mb * bs, device=q.device)[None, None, :]
    valid = key_pos < lim[:, :, None]
    if window is not None:
        valid &= key_pos > (pos - window)[:, :, None]
    scores = torch.where(valid[:, :, None, None, :], scores, NEG_INF)
    if sinks is None:
        weights = torch.softmax(scores, dim=-1)
    else:
        weights = _sink_softmax(scores, sinks.to(device=q.device,
                                                 dtype=torch.float32).reshape(kvh, g))
    out = torch.einsum("bnkgt,btkd->bnkgd", weights, v)
    return out.reshape(B, n, h, d).to(q.dtype)


def ragged_paged_attention(
    q: torch.Tensor,             # [Tq, h, d] densely packed ragged queries
    k_cache,                     # [num_blocks, bs, kvh, d] or QuantizedKV
    v_cache,
    block_tables: torch.Tensor,  # [R, max_blocks] int
    q_starts: torch.Tensor,      # [R] offset of row r's segment in q
    q_lens: torch.Tensor,        # [R] segment length (0 = empty row)
    seq_lens: torch.Tensor,      # [R] context length incl. the row's new tokens
    window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
    windows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unified ragged paged attention: row r owns the query tokens
    ``q[q_starts[r] : q_starts[r]+q_lens[r]]``, its new tokens at the TAIL
    of its context (token i of the segment sits at absolute position
    ``seq_lens[r] - q_lens[r] + i``), and attends causally over its own
    pages. Segments are disjoint; tokens outside every segment, and rows
    with ``q_len == 0`` or ``seq_len == 0``, return ZEROS.

    ``window`` bounds every row alike; ``windows`` ([R], ``<= 0`` = full
    attention) bounds each row, the form the kernel takes.
    ``sinks``/``softcap``: see causal_attention.

    Same semantics as the reference twin, computed row by row over each
    row's own segment instead of masking the whole packed buffer per row."""
    wins = _row_windows(q_starts.shape[0], window, windows)
    return _ragged_rows(q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens,
                        wins, sinks, softcap).to(q.dtype)


def _row_windows(R: int, window: Optional[int], windows: Optional[torch.Tensor]):
    """Per-row windows as host ints (<= 0: full attention)."""
    if windows is not None:
        return windows.tolist()
    return [0 if window is None else int(window)] * R


def _ragged_rows(q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens, wins,
                 sinks, softcap, skip=()):
    """ragged_paged_attention's rows in float32, rows in ``skip`` left zero."""
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rows = zip(q_starts.tolist(), q_lens.tolist(), seq_lens.tolist(), wins)
    for r, (qs, ql, sl, w) in enumerate(rows):
        if ql <= 0 or sl <= 0 or r in skip:
            continue
        k, v = gather_kv(k_cache, v_cache, block_tables[r])
        pos = torch.arange(sl - ql, sl, device=q.device)
        seg = extend_attention(q[qs:qs + ql].float(), k, v, pos, sl,
                               window=w if w > 0 else None, sinks=sinks,
                               softcap=softcap)
        out[qs:qs + ql] += seg
    return out


# ---------------------------------------------------------------- split-K
# The unified kernel (csrc/unified_attention.cu) cuts the keys of a row
# that fits one q tile (q_len <= TILE_ROWS // G tokens: decode rows, short
# segments) into splits, computes each split's partial softmax state in its
# own block and merges the partials in a second kernel. These are the plain
# versions of both steps, and of the two together.

TILE_ROWS = 64      # query-head rows of one kernel tile (G heads x TILE_ROWS // G tokens)
SPLIT_PAGES = 32    # pages of 16 keys per split: the kernel's SPLIT_KEYS = 512


def split_plan(q_len: int, seq_len: int, window: int, split_keys: int, align: int,
               max_splits: Optional[int] = None) -> Tuple[int, int, int]:
    """How a one-tile row's keys are split: (first, split, n). The live
    keys are [first, seq_len), ``first`` being the first key the row's
    earliest token sees (window <= 0: 0) floored to ``align``; split s
    covers [first + s * split, first + (s + 1) * split). ``split`` is
    ``split_keys``, or longer where the range would need more than
    ``max_splits`` splits (rounded up to ``align``); ``n`` is the number of
    splits, 0 where one would do (the row is then not split)."""
    lo = max(seq_len - q_len - window + 1, 0) if window > 0 else 0
    first = lo - lo % align
    span = seq_len - first
    split = split_keys
    if max_splits:
        split = max(split, -(-(-(-span // max_splits)) // align) * align)
    n = -(-span // split)
    return first, split, n if n >= 2 else 0


def attention_partials(
    q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
    q_starts: torch.Tensor, q_lens: torch.Tensor, seq_lens: torch.Tensor,
    *, split_keys: int, align: int, windows: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None, max_splits: Optional[int] = None,
    tile_tokens: Optional[int] = None,
):
    """The partial softmax states of ragged_paged_attention's split rows:
    rows of ``0 < q_len <= QS`` tokens whose keys span two or more splits
    (split_plan), QS = ``tile_tokens`` (default TILE_ROWS // G, the
    unified kernel's). Returns (acc [R, S, QS, h, d] unnormalized
    sum of p * v, m [R, S, QS, h] the split's row max over its visible
    keys, l [R, S, QS, h] its sum of exp(s - m), n_splits [R] int32, 0 for
    rows not split), all float32. A split that sees no
    key of a row has m = NEG_INF, l = 0, acc = 0 there; sinks are no
    split's (the merge counts them once)."""
    R = q_starts.shape[0]
    _, h, d = q.shape
    G = h // k_cache.shape[2]
    QS = tile_tokens or TILE_ROWS // G
    wins = _row_windows(R, None, windows)
    rows = list(zip(q_starts.tolist(), q_lens.tolist(), seq_lens.tolist(), wins))
    plans = [split_plan(ql, sl, w, split_keys, align, max_splits)
             if 0 < ql <= QS and sl > 0 else (0, 0, 0) for _, ql, sl, w in rows]
    S = max([1] + [n for _, _, n in plans])
    acc = torch.zeros(R, S, QS, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((R, S, QS, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(R, S, QS, h, dtype=torch.float32, device=q.device)
    for r, ((qs, ql, sl, w), (first, split, n)) in enumerate(zip(rows, plans)):
        if not n:
            continue
        k, v = gather_kv(k_cache, v_cache, block_tables[r])
        scores = _softcap(_gqa_scores(q[qs:qs + ql].float(), k) * _scale(d), softcap)
        key_pos = torch.arange(k.shape[0], device=q.device)
        pos = torch.arange(sl - ql, sl, device=q.device)
        visible = key_pos[None, :] <= pos[:, None]                        # [ql, T]
        if w > 0:
            visible &= key_pos[None, :] > pos[:, None] - w
        for s in range(n):
            a, b = first + s * split, min(first + (s + 1) * split, sl)
            vis = (visible & (key_pos >= a) & (key_pos < b))[:, None, :]  # [ql, 1, T]
            sc = torch.where(vis, scores, NEG_INF)
            mx = sc.amax(dim=-1)                                          # [ql, h]
            p = torch.where(vis, torch.exp(sc - mx[..., None]), 0.0)
            acc[r, s, :ql] = _gqa_values(p, v)
            m[r, s, :ql] = mx
            l[r, s, :ql] = p.sum(dim=-1)
    return acc, m, l, torch.tensor([n for _, _, n in plans], dtype=torch.int32,
                                   device=q.device)


def merge_attention_partials(
    acc: torch.Tensor,       # [R, S, QS, h, d] f32
    m: torch.Tensor,         # [R, S, QS, h]
    l: torch.Tensor,         # [R, S, QS, h]
    n_splits: torch.Tensor,  # [R] int (< 2: the row is not split)
    q_starts: torch.Tensor,  # [R]
    q_lens: torch.Tensor,    # [R]
    out: torch.Tensor,       # [Tq, h, d], written in place at the split rows' tokens
    sinks: Optional[torch.Tensor] = None,   # [h] f32
) -> torch.Tensor:
    """Each split row's tokens from its partial states, taken in split
    order: M = max(sink, m_s over splits with l_s > 0), out = sum_s
    exp(m_s - M) acc_s / max(exp(sink - M) + sum_s exp(m_s - M) l_s, 1e-30).
    The sink enters once; a split that saw no key (l_s = 0) weighs 0.
    Returns ``out``."""
    sk = None if sinks is None else sinks.to(device=acc.device, dtype=torch.float32)
    rows = zip(n_splits.tolist(), q_starts.tolist(), q_lens.tolist())
    for r, (n, qs, ql) in enumerate(rows):
        if n < 2:
            continue
        live = l[r, :n, :ql] > 0                                          # [n, ql, h]
        ms = torch.where(live, m[r, :n, :ql], NEG_INF)
        M = ms.amax(dim=0)
        if sk is not None:
            M = torch.maximum(M, sk)
        L = torch.exp(sk - M) if sk is not None else torch.zeros_like(M)
        o = torch.zeros(acc.shape[2:], dtype=torch.float32, device=acc.device)[:ql]
        for s in range(n):
            w = torch.where(live[s], torch.exp(ms[s] - M), 0.0)
            L = L + l[r, s, :ql] * w
            o = o + w[..., None] * acc[r, s, :ql]
        out[qs:qs + ql] = (o / torch.clamp(L, min=1e-30)[..., None]).to(out.dtype)
    return out


def split_ragged_paged_attention(
    q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
    q_starts: torch.Tensor, q_lens: torch.Tensor, seq_lens: torch.Tensor,
    *, window: Optional[int] = None, windows: Optional[torch.Tensor] = None,
    sinks: Optional[torch.Tensor] = None, softcap: Optional[float] = None,
    split_pages: int = SPLIT_PAGES,
) -> torch.Tensor:
    """ragged_paged_attention computed as the unified kernel does with
    split-K: one-tile rows whose keys span more than ``split_pages`` pages
    go through attention_partials (splits of ``split_pages`` pages, from
    the page holding the row's first live key) and
    merge_attention_partials; every other row directly. The same function
    as ragged_paged_attention."""
    R = q_starts.shape[0]
    bs = k_cache.shape[1]
    wins = torch.tensor(_row_windows(R, window, windows), dtype=torch.int32)
    acc, m, l, n = attention_partials(
        q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens,
        split_keys=split_pages * bs, align=bs, windows=wins, softcap=softcap)
    split = {r for r, c in enumerate(n.tolist()) if c >= 2}
    out = _ragged_rows(q, k_cache, v_cache, block_tables, q_starts, q_lens, seq_lens,
                       wins.tolist(), sinks, softcap, skip=split)
    merge_attention_partials(acc, m, l, n, q_starts, q_lens, out, sinks)
    return out.to(q.dtype)


def split_paged_decode_attention(
    q: torch.Tensor, k_cache, v_cache, block_tables: torch.Tensor,
    seq_lens: torch.Tensor, *, split_keys: int, max_splits: Optional[int] = None,
) -> torch.Tensor:
    """paged_decode_attention computed as the decode kernel
    (csrc/decode_attention.cu) does with split-K: each row's keys are cut
    from key 0 into splits of ``split_keys`` keys (split_plan with the
    page size as the alignment; longer splits where a row would need more
    than ``max_splits``), each split's partial state comes from
    attention_partials (the decode rows as ``q_len = 1`` rows), and
    merge_attention_partials combines them in split order. Rows that fit
    one split go straight through paged_decode_attention. The same
    function as paged_decode_attention for rows with ``seq_len > 0``."""
    B = q.shape[0]
    bs = k_cache.shape[1]
    lens = seq_lens.to(torch.int32)
    starts = torch.arange(B, dtype=torch.int32)
    ones = (lens.cpu() > 0).to(torch.int32)
    acc, m, l, n = attention_partials(
        q, k_cache, v_cache, block_tables, starts, ones, lens.cpu(),
        split_keys=split_keys, align=bs, max_splits=max_splits)
    out = paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens).float()
    merge_attention_partials(acc, m, l, n, starts, ones, out)
    return out.to(q.dtype)
