"""Pieces of the routed expert FFN that the mixture-of-experts families
share (gpt-oss, Qwen3-MoE, DeepSeek): the top-k with the reference's tie
rule, the (token, slot) pairs sorted by expert on the device, and the
weighted sum over the slots.

All run without a host sync and with shapes that do not depend on the
routing, so a CUDA graph captures them (the decode horizon).
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index as ``jax.lax.top_k`` breaks them: a stable
    descending sort (``torch.topk`` does not promise an order among equal
    values)."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def expert_offsets(topi: torch.Tensor, num_experts: int):
    """The (token, slot) pairs sorted by expert, on the device and without
    a host sync. Returns (order [T*K]: the pair index t * K + k of each
    sorted row; experts [T*K]: each sorted row's expert; offsets [E] int32:
    where each expert's rows end in the sorted order). Stable: within an
    expert, the pairs keep their token-major order."""
    experts, order = torch.sort(topi.reshape(-1), stable=True)
    bounds = torch.searchsorted(
        experts, torch.arange(num_experts + 1, dtype=experts.dtype, device=experts.device))
    return order, experts, bounds[1:].to(torch.int32)


def unsort_pairs(order: torch.Tensor, rows: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """Rows in expert order [T*K, H] back to pair order, as [T, K, H]."""
    return torch.empty_like(rows).index_copy_(0, order, rows).view(T, K, -1)


def sum_slots(topw: torch.Tensor, pairs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """sum_k topw[:, k] * pairs[:, k] (pairs [T, K, H]) in ``dtype``, slot
    by slot in slot order, as the reference adds them: each weight and
    each pair's row cast to ``dtype`` before its product and its add."""
    y = torch.zeros(pairs.shape[0], pairs.shape[2], dtype=dtype, device=pairs.device)
    for k in range(pairs.shape[1]):
        y = y + topw[:, k, None].to(dtype) * pairs[:, k].to(dtype)
    return y
