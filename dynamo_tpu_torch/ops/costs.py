"""Analytic cost models: the bytes a unified-attention step moves, the
roofline floor of an engine step, and the transfer models of the KV wire.

The port's copy of ``_pages``, ``unified_attention_bytes``,
``predict_step_seconds``, ``streamed_transfer_model`` and
``fetch_vs_recompute`` from the reference package's ops/costs.py (its
jaxpr walk waits for ROADMAP Queue 1 item 8). The step floor is the
expectation side of the ``cost_model_drift`` detector (runtime/health.py):
the worker prices each step with the card's memory rate and the model's
weight bytes (engine/__main__.py). ``fetch_vs_recompute`` is the global KV
directory's routing decision (llm/prefill_router.GlobalKvFetchPlanner).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

SCALE_BYTES = 4  # f32 per-block-per-kv-head scale rows (ops/quant.py)


def _pages(seq_len: int, bs: int) -> int:
    return -(-max(int(seq_len), 0) // bs)


def unified_attention_bytes(
    rows: Sequence[Tuple[int, ...]],   # (query_len, seq_len[, window])
    *,
    block_size: int,
    kv_heads: int,
    num_heads: int,
    head_dim: int,
    kv_itemsize: int = 2,              # bf16 pages; 1 for int8
    q_itemsize: int = 2,
    quantized: bool = False,
) -> int:
    """Bytes one unified ragged launch moves: each active row's LIVE pages
    stream once per kv head (total = the full page bytes), plus int8 scale
    rows, plus the packed q read and o write.

    A row may carry a third element, a positive sliding-window bound: the
    pages the window aged out are never read, so live pages start at
    ``max(ctx_start - w + 1, 0) // bs`` (page-granular)."""
    total_q = sum(max(r[0], 0) for r in rows)
    kv = 0
    for row in rows:
        q_len, seq_len = row[0], row[1]
        w = row[2] if len(row) > 2 else 0
        if q_len <= 0 or seq_len <= 0:
            continue
        p = _pages(seq_len, block_size)
        if w and w > 0:
            ctx_start = seq_len - q_len
            p -= max(ctx_start - w + 1, 0) // block_size
        kv += 2 * p * block_size * kv_heads * head_dim * kv_itemsize
        if quantized:
            # the full [kvh] scale row per page per kv head
            kv += 2 * p * kv_heads * kv_heads * SCALE_BYTES
    qo = 2 * total_q * num_heads * head_dim * q_itemsize
    return kv + qo


def predict_step_seconds(
    rows: Sequence[Tuple[int, ...]],   # (query_len, seq_len[, window])
    *,
    block_size: int,
    kv_heads: int,
    num_heads: int,
    head_dim: int,
    hbm_bytes_s: float,
    dispatch_s: float = 0.0,
    weight_bytes: int = 0,
    layers: int = 1,
    kv_itemsize: int = 2,
    q_itemsize: int = 2,
    quantized: bool = False,
) -> float:
    """Roofline floor for one engine forward pass in SECONDS: the pass's
    modeled memory traffic (attention pages via
    :func:`unified_attention_bytes`, once per layer, + one weight stream)
    over the device's memory rate, plus a fixed host dispatch overhead.

    The ``cost_model_drift`` detector compares a step's measured wall time
    with this floor for the same row mix: real steps run a bounded factor
    above it, and the detector trips on the RATIO drifting."""
    att_bytes = unified_attention_bytes(
        rows, block_size=block_size, kv_heads=kv_heads, num_heads=num_heads,
        head_dim=head_dim, kv_itemsize=kv_itemsize, q_itemsize=q_itemsize,
        quantized=quantized,
    )
    bw = max(float(hbm_bytes_s), 1.0)
    total = att_bytes * max(int(layers), 1) + max(int(weight_bytes), 0)
    return total / bw + max(dispatch_s, 0.0)


# ------------------------------------------------- analytic transfer model
def streamed_transfer_model(
    prompt_tokens: int,
    *,
    block_size: int,
    prefill_chunk: int,
    kv_bytes_per_block: int,
    bandwidth_bytes_s: float,
    prefill_chunk_s: float,
    window_blocks: int = 8,
    handshake_s: float = 0.0,
    decode_step_s: float = 0.0,
) -> Dict[str, Any]:
    """Deterministic TTFT model of blocking vs streamed disaggregated KV
    transfer.

    The prefill side computes ``ceil(prompt / chunk)`` chunks of
    ``prefill_chunk_s`` each; a chunk's blocks become transferable when it
    lands. The decode side's first token waits for every prompt block (and
    one decode step).

    - blocking: the pull starts after the LAST chunk, so TTFT pays the
      prefill and then the whole wire transfer;
    - streamed: windows of ``window_blocks`` ship as soon as their blocks
      are committed, one at a time on one wire, overlapping the prefill, so
      TTFT pays the prefill plus the wire's tail that compute could not
      hide.

    A pure function of its arguments."""
    blocks = max(_pages(prompt_tokens, block_size), 0)
    chunks = max(_pages(prompt_tokens, prefill_chunk), 1)
    prefill_s = chunks * prefill_chunk_s
    bw = max(float(bandwidth_bytes_s), 1.0)
    total_bytes = blocks * kv_bytes_per_block
    blocking_ttft = prefill_s + handshake_s + total_bytes / bw + decode_step_s
    # the streamed pipeline: windows in commit order; a window starts once
    # its last block is committed and the wire is free
    blocks_per_chunk = prefill_chunk // block_size
    wire_free = handshake_s
    done_at = handshake_s   # no blocks: the transfer adds nothing
    sent = 0
    while sent < blocks:
        take = min(window_blocks, blocks - sent)
        last_block = sent + take   # 1-based index of the window's last block
        commit_chunk = _pages(last_block, blocks_per_chunk) if blocks_per_chunk else 1
        committed_at = min(commit_chunk, chunks) * prefill_chunk_s
        start = max(wire_free, committed_at)
        wire_free = start + take * kv_bytes_per_block / bw
        done_at = wire_free
        sent += take
    streamed_ttft = max(done_at, prefill_s) + decode_step_s
    transfer_s = total_bytes / bw
    hidden = max(blocking_ttft - streamed_ttft, 0.0)
    return {
        "prompt_tokens": int(prompt_tokens),
        "blocks": int(blocks),
        "prefill_chunks": int(chunks),
        "prefill_s": round(prefill_s, 6),
        "transfer_s": round(transfer_s, 6),
        "bytes": int(total_bytes),
        "bandwidth_bytes_s": round(bw, 1),
        "window_blocks": int(window_blocks),
        "blocking_ttft_s": round(blocking_ttft, 6),
        "streamed_ttft_s": round(streamed_ttft, 6),
        "speedup": round(blocking_ttft / streamed_ttft, 4) if streamed_ttft > 0 else 1.0,
        # the share of the wire time hidden under the prefill's compute
        "overlap_fraction": round(hidden / transfer_s, 4) if transfer_s > 0 else 0.0,
    }


# tier read priors, seconds per block: G2 host memory is a copy, G3 disk a
# file read. The G2 prior is the port's own: the tier stream's read of a
# 2 MiB llama3-8b bf16 block (get_block, the window's stack and bytes, a
# crc32 a block) measured warm on the host of an NVIDIA H100 80GB HBM3,
# 700 W (chip_smoke.py phase global_kv: 1.32 ms; the reference's prior is
# 0.2 ms). G3 keeps the reference's 2 ms, which no run of the port has
# measured.
TIER_READ_S_PER_BLOCK = {"g2": 1.32e-3, "g3": 2e-3}


def fetch_vs_recompute(
    num_blocks: int,
    *,
    block_size: int,
    kv_bytes_per_block: int,
    bandwidth_bytes_s: float,
    prefill_base_s: float,
    prefill_per_token_s: float,
    tier: str = "g2",
    window_blocks: int = 8,
    handshake_s: float = 0.01,
    tier_read_s_per_block: Optional[float] = None,
    margin: float = 1.0,
) -> Dict[str, Any]:
    """The price of onboarding ``num_blocks`` sealed KV blocks from a peer
    worker's G2/G3 tier against recomputing them as local prefill: the
    global directory's routing decision.

    The fetch is pipelined in ``window_blocks`` windows over one wire (the
    peer reads a window from its tier while the previous one is in
    flight), so it pays ``max(wire, tier read)`` a window, plus the first
    window's tier read and the handshake. The recompute pays the local
    prefill model for the same tokens. Fetch wins iff ``fetch_s <= margin
    * recompute_s``, so for ``margin <= 1`` a chosen fetch is never priced
    slower than the recompute. A pure function of its arguments."""
    n = max(int(num_blocks), 0)
    bw = max(float(bandwidth_bytes_s), 1.0)
    read_s = (float(tier_read_s_per_block) if tier_read_s_per_block is not None
              else TIER_READ_S_PER_BLOCK.get(tier, TIER_READ_S_PER_BLOCK["g3"]))
    win = max(int(window_blocks), 1)
    n_windows = -(-n // win) if n else 0
    window_wire_s = win * kv_bytes_per_block / bw
    window_read_s = win * read_s
    # a partial last window is priced full: the model stays monotone in
    # num_blocks (a conservative over-estimate of the fetch)
    fetch_s = (handshake_s + window_read_s + n_windows * max(window_wire_s, window_read_s)
               if n else 0.0)
    recompute_s = prefill_base_s + n * block_size * prefill_per_token_s if n else 0.0
    fetch_wins = n > 0 and fetch_s <= margin * recompute_s
    return {
        "num_blocks": n,
        "tier": tier,
        "bytes": n * int(kv_bytes_per_block),
        "bandwidth_bytes_s": round(bw, 1),
        "window_blocks": win,
        "fetch_s": round(fetch_s, 6),
        "recompute_s": round(recompute_s, 6),
        "fetch_wins": bool(fetch_wins),
        "margin": float(margin),
        "speedup": round(recompute_s / fetch_s, 4) if fetch_s > 0 else 1.0,
    }
