"""Analytic step-cost models: the bytes a unified-attention step moves and
the roofline floor of an engine step.

The port's copy of ``_pages``, ``unified_attention_bytes`` and
``predict_step_seconds`` from the reference package's ops/costs.py (its
jaxpr walk and the transfer models wait for ROADMAP Queue 1 item 8). The
floor is the expectation side of the ``cost_model_drift`` detector
(runtime/health.py): the worker prices each step with the card's memory
rate and the model's weight bytes (engine/__main__.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
