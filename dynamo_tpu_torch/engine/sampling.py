"""Batched on-device sampling: greedy / temperature / top-k / top-p / min-p,
frequency / presence / repetition penalties, top-N logprobs, and the
guided-decoding grammar mask and FSM step (``guided_mask`` /
``guided_step``, the reference engine's ``gmask`` / ``gstep``).

Counterpart of the reference's engine/sampling.py with the same semantics
(vLLM/OpenAI penalties):

- repetition_penalty: tokens seen in prompt OR output; logit>0 ? l/r : l*r
- frequency_penalty:  logits -= fp * count(token in output)
- presence_penalty:   logits -= pp * (token in output)

Greedy rows take ``argmax`` (first index among ties, as ``jnp.argmax``), so
greedy matches the reference exactly. Sampled rows take
``argmax(logits / T + gumbel)``. The Gumbel noise is JAX's default PRNG
written out as tensor code (``gumbel_noise``): threefry-2x32 keyed by
``fold_in(PRNGKey(seed), step)``, JAX's partitionable 32-bit
``random_bits``, ``uniform(tiny, 1)`` and ``-log(-log(u))``. Row b of the
noise therefore equals ``jax.random.gumbel(fold_in(PRNGKey(seeds[b]),
steps[b]), (V,))``, and a seeded request streams the tokens it streams on
the reference engine, whatever else is in the batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30

# top-N logprob rows returned when any request asks for them (OpenAI allows
# top_logprobs up to 20)
TOP_LOGPROBS_K = 20

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


# threefry-2x32 on int64 tensors holding uint32 values (torch's uint32
# arithmetic is incomplete): every sum and shift is masked back to 32 bits
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key (k0, k1); broadcasting int64 tensors of uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _gumbel_rows(seed: torch.Tensor, step: torch.Tensor, vocab: int) -> torch.Tensor:
    """[R, V] Gumbel noise for [R, 1] int64 seeds and steps (uint32 values)."""
    # PRNGKey(seed) = (0, seed); fold_in(key, step) = threefry(key, (0, step))
    k0, k1 = threefry2x32(torch.zeros_like(seed), seed, torch.zeros_like(step), step)
    # random_bits (partitionable): element i hashes the counter (0, i)
    count = torch.arange(vocab, dtype=torch.int64, device=seed.device)[None, :]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(count), count)
    bits = b0 ^ b1
    # uniform(minval=tiny, maxval=1): 23 mantissa bits under exponent 0 give
    # [1, 2); minus 1, times (1 - tiny) == 1.0 in f32, plus tiny, floored
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp((mant - 1.0) + tiny, min=tiny)
    return -torch.log(-torch.log(u))


def gumbel_noise(
    seeds: Sequence[int], steps: Sequence[int], vocab: int, device,
    rows: Optional[Sequence[bool]] = None,
) -> torch.Tensor:
    """[B, V] float32 Gumbel(0, 1) noise: row b is
    ``jax.random.gumbel(fold_in(PRNGKey(seeds[b]), steps[b]), (V,))``
    (uint32 seeds and steps, as the reference keys them). Rows with
    ``rows[b]`` False (greedy rows) stay zero and draw nothing."""
    device = torch.device(device)
    out = torch.zeros((len(seeds), vocab), dtype=torch.float32, device=device)
    pick = [b for b in range(len(seeds)) if rows is None or rows[b]]
    if not pick:
        return out
    i64 = dict(dtype=torch.int64, device=device)
    seed = torch.tensor([int(seeds[b]) & _M32 for b in pick], **i64)[:, None]
    step = torch.tensor([int(steps[b]) & _M32 for b in pick], **i64)[:, None]
    out[pick] = _gumbel_rows(seed, step, vocab)
    return out


def gumbel_noise_tensor(
    seeds: torch.Tensor, steps: torch.Tensor, vocab: int,
    rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``gumbel_noise`` from device tensors, with no host round-trip (the
    decode horizon's form): ``seeds`` [B] int64 holding uint32 values,
    ``steps`` [B] int64, ``rows`` [B] bool. Every row draws (static
    shapes); rows with ``rows[b]`` False are zeroed by a ``where``. Row b
    equals ``gumbel_noise``'s bit for bit."""
    noise = _gumbel_rows((seeds & _M32)[:, None], (steps & _M32)[:, None], vocab)
    if rows is None:
        return noise
    return torch.where(rows[:, None], noise, 0.0)


def sample_tokens(
    logits: torch.Tensor,          # [B, V] float32
    temperature: torch.Tensor,     # [B] 0 => greedy
    top_k: torch.Tensor,           # [B] int, <=0 => disabled
    top_p: torch.Tensor,           # [B] float, >=1 => disabled
    min_p: Optional[torch.Tensor] = None,   # [B] float, <=0 => disabled
    gumbel: Optional[torch.Tensor] = None,  # [B, V] noise for sampled rows
    filtered: bool = True,
) -> torch.Tensor:
    """Sampled token ids [B] (int64). ``gumbel`` is required as soon as any
    row samples (temperature > 0); callers draw it with ``gumbel_noise``.
    ``filtered``: whether any row may use top-k or top-p, which the caller
    knows from its host arrays (the sort is skipped when it is False; a
    row whose filters are disabled passes ``mask_topk_topp`` unchanged, so
    True is always right)."""
    greedy = torch.argmax(logits, dim=-1)
    if gumbel is None:
        return greedy
    temp_safe = torch.clamp(temperature, min=1e-6)[:, None]
    l = logits
    if filtered:
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
    """Add the sampled tokens into the per-slot output counts (in place;
    one scatter-add into the flat rows, which a CUDA graph can capture)."""
    B, V = output_counts.shape
    rows = torch.arange(B, device=output_counts.device)
    output_counts.view(-1).scatter_add_(0, rows * V + tokens.long(),
                                        active.to(output_counts.dtype))
    return output_counts


def _guided_rows(g_state: torch.Tensor, g_trans: torch.Tensor) -> torch.Tensor:
    """Each row's transition row ``g_trans[b, g_state[b]]`` [B, C]."""
    B, _, C = g_trans.shape
    idx = g_state.long()[:, None, None].expand(B, 1, C)
    return torch.gather(g_trans, 1, idx)[:, 0]


def guided_mask(
    logits: torch.Tensor,      # [B, V] float32
    g_active: torch.Tensor,    # [B] bool: guided rows
    g_state: torch.Tensor,     # [B] int: each row's FSM state
    g_class: torch.Tensor,     # [B, V] int32: token -> class (guided/tokens.py)
    g_trans: torch.Tensor,     # [B, S, C] int32: next state, -1 = reject
) -> torch.Tensor:
    """Mask each guided row's logits to the tokens legal from its FSM
    state (``NEG_INF`` elsewhere); other rows pass unchanged. Device
    tensors only: one [B, C] row gather and one [B, V] class lookup."""
    ok = torch.gather(_guided_rows(g_state, g_trans), 1, g_class.long()) >= 0
    return torch.where(g_active[:, None] & ~ok, NEG_INF, logits)


def guided_step(
    g_state: torch.Tensor,     # [B]
    tokens: torch.Tensor,      # [B] sampled
    g_active: torch.Tensor,    # [B] bool
    g_class: torch.Tensor,     # [B, V]
    g_trans: torch.Tensor,     # [B, S, C]
) -> torch.Tensor:
    """Advance each guided row's FSM by its sampled token (a rejected
    transition, which the mask never samples, lands in state 0, as the
    reference's ``max(next, 0)``); other rows keep their state."""
    cls = torch.gather(g_class, 1, tokens.long()[:, None])
    nxt = torch.gather(_guided_rows(g_state, g_trans), 1, cls.long())[:, 0]
    return torch.where(g_active, torch.clamp(nxt, min=0).to(g_state.dtype), g_state)
