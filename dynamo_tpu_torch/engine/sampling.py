"""Batched on-device sampling: greedy / temperature / top-k / top-p / min-p,
frequency / presence / repetition penalties, and top-N logprobs.

Counterpart of the reference's engine/sampling.py with the same semantics
(vLLM/OpenAI penalties):

- repetition_penalty: tokens seen in prompt OR output; logit>0 ? l/r : l*r
- frequency_penalty:  logits -= fp * count(token in output)
- presence_penalty:   logits -= pp * (token in output)

Greedy rows take ``argmax`` (first index among ties, as ``jnp.argmax``), so
greedy matches the reference exactly. Sampled rows take
``argmax(logits / T + gumbel)``. The Gumbel noise comes from a per-row
``torch.Generator`` seeded from ``(seed, step)`` alone
(``gumbel_noise``), so a seeded request reproduces its own stream whatever
else is in the batch; the noise can also be passed in, which is how the
tests feed both packages the same numbers. The bits differ from JAX's
threefry keys for the same seed (a recorded divergence of the port).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30

# top-N logprob rows returned when any request asks for them (OpenAI allows
# top_logprobs up to 20)
TOP_LOGPROBS_K = 20

_MASK64 = (1 << 64) - 1


def apply_penalties(
    logits: torch.Tensor,          # [B, V] float32
    output_counts: torch.Tensor,   # [B, V] int generated-token counts
    prompt_mask: torch.Tensor,     # [B, V] int8/bool tokens present in prompt
    presence: torch.Tensor,        # [B]
    frequency: torch.Tensor,       # [B]
    repetition: torch.Tensor,      # [B]
) -> torch.Tensor:
    """Penalized logits (a new tensor; ``logits`` is left untouched)."""
    counts_f = output_counts.float()
    out_seen = output_counts > 0
    seen = out_seen | (prompt_mask != 0)
    rep = repetition[:, None]
    l = torch.where(seen, torch.where(logits > 0, logits / rep, logits * rep), logits)
    l = l - frequency[:, None] * counts_f
    return l - presence[:, None] * out_seen.float()


def mask_topk_topp(
    logits: torch.Tensor,      # [B, V] (already penalized)
    temp_safe: torch.Tensor,   # [B, 1] clamped temperature
    top_k: torch.Tensor,       # [B] <=0 => disabled
    top_p: torch.Tensor,       # [B] >=1 => disabled
) -> torch.Tensor:
    """One descending sort serves both filters: the top-k cutoff is the kth
    sorted value; top-p is computed over the top-k-surviving prefix of the
    same sorted array (softmax in sorted order, cumulative mass)."""
    B, V = logits.shape
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = torch.where(top_k <= 0, V, torch.clamp(top_k, max=V)).long()
    k_idx = torch.clamp(k_eff - 1, 0, V - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    rank = torch.arange(V, device=logits.device)[None, :]
    in_topk = rank < k_eff[:, None]
    sorted_scaled = torch.where(in_topk, sorted_desc / temp_safe, NEG_INF)
    probs_sorted = torch.softmax(sorted_scaled, dim=-1)
    cumprobs = torch.cumsum(probs_sorted, dim=-1)
    p = torch.where(top_p >= 1.0, 1.0, top_p)[:, None]
    # a disabled top-p keeps every top-k survivor outright (the cumulative
    # mass can round past 1.0 before the last one)
    include = (((cumprobs - probs_sorted) < p) | (top_p >= 1.0)[:, None]) & in_topk
    count = torch.clamp(include.sum(dim=-1), min=1)
    cutoff_p = torch.gather(sorted_desc, 1, (count - 1)[:, None])
    cutoff = torch.maximum(kth, cutoff_p)
    return torch.where(logits >= cutoff, logits, NEG_INF)


def row_seed(seed: int, step: int) -> int:
    """Generator seed of one row at one step: a 64-bit mix of (seed, step)
    (splitmix64 finalizer), independent of batch position and history."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def gumbel_noise(
    seeds: Sequence[int], steps: Sequence[int], vocab: int, device,
    rows: Optional[Sequence[bool]] = None,
) -> torch.Tensor:
    """[B, V] float32 Gumbel(0, 1) noise, row b drawn from a generator
    seeded by ``row_seed(seeds[b], steps[b])``. Rows with ``rows[b]`` False
    (greedy rows) stay zero and draw nothing."""
    device = torch.device(device)
    out = torch.zeros((len(seeds), vocab), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for b, (seed, step) in enumerate(zip(seeds, steps)):
        if rows is not None and not rows[b]:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(row_seed(seed, step))
        u = torch.rand(vocab, generator=gen, device=device).clamp_(min=tiny)
        out[b] = -torch.log(-torch.log(u).clamp_(max=-tiny))
    return out


def sample_tokens(
    logits: torch.Tensor,          # [B, V] float32
    temperature: torch.Tensor,     # [B] 0 => greedy
    top_k: torch.Tensor,           # [B] int, <=0 => disabled
    top_p: torch.Tensor,           # [B] float, >=1 => disabled
    min_p: Optional[torch.Tensor] = None,   # [B] float, <=0 => disabled
    gumbel: Optional[torch.Tensor] = None,  # [B, V] noise for sampled rows
) -> torch.Tensor:
    """Sampled token ids [B] (int64). ``gumbel`` is required as soon as any
    row samples (temperature > 0); callers draw it with ``gumbel_noise``."""
    greedy = torch.argmax(logits, dim=-1)
    if gumbel is None:
        return greedy
    temp_safe = torch.clamp(temperature, min=1e-6)[:, None]
    l = logits
    if bool(((top_k > 0) | (top_p < 1.0)).any()):
        l = mask_topk_topp(l, temp_safe, top_k, top_p)
    if min_p is not None:
        # p_i/p_max >= min_p  <=>  l_i >= l_max + temp*ln(min_p)
        max_l = torch.max(l, dim=-1, keepdim=True).values
        mp = torch.clamp(min_p, 1e-10, 1.0)[:, None]
        thresh = max_l + temp_safe * torch.log(mp)
        l = torch.where((min_p > 0.0)[:, None] & (l < thresh), NEG_INF, l)
    sampled = torch.argmax(l / temp_safe + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def logprobs_of(logits: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Log-probability of each chosen token [B] (from pre-penalty logits)."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, 1, token_ids.long()[:, None])[:, 0]


def top_logprobs(
    logits: torch.Tensor, k: int = TOP_LOGPROBS_K
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (logprobs [B,k] f32, ids [B,k] int64) rows."""
    vals, ids = torch.topk(logits, k, dim=-1)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals - lse, ids


def update_counts(
    output_counts: torch.Tensor,   # [B, V] int32, updated in place
    tokens: torch.Tensor,          # [B] sampled this step
    active: torch.Tensor,          # [B] bool
) -> torch.Tensor:
    """Add the sampled tokens into the per-slot output counts (in place)."""
    rows = torch.arange(output_counts.shape[0], device=output_counts.device)
    output_counts.index_put_(
        (rows, tokens.long()), active.to(output_counts.dtype), accumulate=True
    )
    return output_counts
