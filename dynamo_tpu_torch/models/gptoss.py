"""gpt-oss family (OpenAI gpt-oss-20b) in PyTorch.

Counterpart of the reference's models/gptoss.py, as plain functions over a
parameter dictionary with the reference's layout and parameter names
(weights ``[in, out]``, applied as ``x @ W``; the experts stacked
``[E, in, out]``), so a JAX parameter pytree carries across unchanged
(engine/weights.py). What makes gpt-oss not llama:

- biased q/k/v/o projections and **per-head attention sinks**: a learned
  logit per query head joins each softmax as a virtual key whose
  probability mass is dropped. The sinks stay float32 whatever the model
  dtype (``FLOAT32_KEYS``), as in the reference and the checkpoints;
- **alternating sliding-window and full layers** (even layers window
  128): every layer calls ``attend`` with its ``window`` (None on full
  layers) and its ``sinks``, so the engine serves every layer through the
  unified kernel, at head_dim 64;
- **YaRN RoPE**: interpolated and extrapolated frequencies blended over a
  ramp, cos and sin scaled by 0.1 * ln(factor) + 1;
- a **mixture-of-experts FFN in every layer**: the router takes the top
  4 of 32 float32 logits and a softmax over the selected four; each
  expert is a fused, biased gate/up projection with interleaved lanes
  (gate = even lanes, up = odd) and the clamped SwiGLU
  ``(up + 1) * gate * sigmoid(1.702 * gate)``, then a biased down
  projection.

The expert FFN comes in two forms of the reference's ``experts_gather``
(which gathers each (token, slot)'s expert weights, [T, H, 2I] a slot: 33
MB a token at gpt-oss-20b width, and which the port does not copy):

- ``experts_plain``: a loop over the experts, each applied in float32 to
  the (token, slot) pairs routed to it; the yardstick of the card's form;
- ``experts_grouped``, what the engine runs: the T * K pairs sorted by
  expert on the device, one grouped matrix product per projection over the
  sorted rows (``torch._grouped_mm`` with device offsets: it reads only the
  weights of experts that have rows), the biases added by gather and the
  SwiGLU in float32, and the rows brought back through the inverse
  permutation and summed over the slots in slot order. No host sync and
  no shape that depends on the data, so a CUDA graph captures it (the
  decode horizon). The products run in the weights' dtype with float32
  accumulation: exactly the reference's float32 products on a float32
  model, and on a bf16 model the gate/up and down outputs round to bf16
  (as HF's bf16 experts do), the SwiGLU input rounded once.

These products are matrix products that the reference computes with
``einsum`` outside any Pallas kernel; no hand kernel replaces them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .experts import expert_offsets, sum_slots, top_k, unsort_pairs
from .llama import AttendFn, LlamaConfig, Params, _normal, apply_rope, rms_norm

# the per-layer parameter names (engine/weights.py refuses any other)
LAYER_KEYS = (
    "attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo", "sinks",
    "w_router", "b_router", "w_gateup", "b_gateup", "w_edown", "b_edown",
)
# parameters kept in float32 whatever the model dtype
FLOAT32_KEYS = ("sinks",)


@dataclasses.dataclass(frozen=True)
class GptOssConfig(LlamaConfig):
    num_experts: int = 32
    num_experts_per_tok: int = 4
    sliding_window: int = 128
    # per-layer attention kind; () = the released pattern (alternating,
    # even layers sliding). Tuple of "sliding_attention" / "full_attention".
    layer_types: Tuple[str, ...] = ()
    swiglu_alpha: float = 1.702
    swiglu_limit: float = 7.0
    # YaRN (a factor <= 1 disables the scaling)
    rope_scaling_factor: float = 0.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_truncate: bool = False
    rope_original_max_position: int = 4096

    def window_for_layer(self, layer_idx: int) -> Optional[int]:
        if self.layer_types:
            kind = self.layer_types[layer_idx]
        else:
            kind = "sliding_attention" if layer_idx % 2 == 0 else "full_attention"
        return self.sliding_window if kind == "sliding_attention" else None

    @classmethod
    def tiny_gptoss(cls, **kw) -> "GptOssConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=64,
            num_experts=4, num_experts_per_tok=2, sliding_window=8,
            qkv_bias=True, tie_embeddings=False, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gpt_oss_20b(cls, vocab_size: int = 201088) -> "GptOssConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=2880, num_layers=24,
            num_heads=64, num_kv_heads=8, head_dim=64,
            intermediate_size=2880, num_experts=32, num_experts_per_tok=4,
            sliding_window=128, rope_theta=150000.0, qkv_bias=True,
            tie_embeddings=False, max_position=131072,
            rope_scaling_factor=32.0, rope_original_max_position=4096,
        )


# preset name -> config (the reference worker's --preset names; gpt-oss-120b
# waits for tensor and expert parallelism)
PRESETS: Dict[str, Callable[[], GptOssConfig]] = {
    "tiny-gptoss": GptOssConfig.tiny_gptoss,
    "gpt-oss-20b": GptOssConfig.gpt_oss_20b,
}


# ---------------------------------------------------------------------------
# rope (YaRN)
# ---------------------------------------------------------------------------


def yarn_inv_freq(cfg: GptOssConfig, device: DeviceLike = None) -> Tuple[torch.Tensor, float]:
    """(inv_freq [d/2] float32, attention factor), the reference's YaRN
    recipe (transformers' _compute_yarn_parameters): interpolated and
    extrapolated frequencies blended over a linear ramp between the
    beta_fast / beta_slow correction dims; cos and sin scaled by
    0.1 * ln(factor) + 1."""
    d, base = cfg.head_dim, cfg.rope_theta
    pos_freqs = base ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    inv_extra = 1.0 / pos_freqs
    factor = cfg.rope_scaling_factor
    if factor <= 1.0:
        return inv_extra, 1.0
    inv_interp = 1.0 / (factor * pos_freqs)

    def corr_dim(rot):
        return (d * math.log(cfg.rope_original_max_position / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    low, high = corr_dim(cfg.rope_beta_fast), corr_dim(cfg.rope_beta_slow)
    if cfg.rope_truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, d - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp(
        (torch.arange(d // 2, dtype=torch.float32, device=device) - low) / (high - low), 0, 1)
    extra_factor = 1.0 - ramp
    inv_freq = inv_interp * (1 - extra_factor) + inv_extra * extra_factor
    return inv_freq, 0.1 * math.log(factor) + 1.0


def rope_tables(cfg: GptOssConfig, positions: torch.Tensor):
    """positions [...] -> cos, sin [..., d/2] (float32), scaled by the
    YaRN attention factor."""
    inv_freq, att_factor = yarn_inv_freq(cfg, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles) * att_factor, torch.sin(angles) * att_factor


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer_params(cfg: GptOssConfig, generator: torch.Generator, device) -> Params:
    h, qd, kvd = cfg.hidden_size, cfg.q_size, cfg.kv_size
    E, inter = cfg.num_experts, cfg.intermediate_size
    scale = 1.0 / math.sqrt(h)
    dt = cfg.dtype

    def normal(shape, std):
        return _normal(shape, std, generator, device, dt)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dt)

    return {
        "attn_norm": torch.ones(h, device=device, dtype=dt),
        "mlp_norm": torch.ones(h, device=device, dtype=dt),
        "wq": normal((h, qd), scale),
        "wk": normal((h, kvd), scale),
        "wv": normal((h, kvd), scale),
        "wo": normal((qd, h), scale),
        "bq": zeros(qd),
        "bk": zeros(kvd),
        "bv": zeros(kvd),
        "bo": zeros(h),
        "sinks": torch.zeros(cfg.num_heads, device=device, dtype=torch.float32),
        "w_router": normal((h, E), scale),
        "b_router": zeros(E),
        # fused per-expert projections, HF layout: gate/up lanes interleaved
        "w_gateup": normal((E, h, 2 * inter), scale),
        "b_gateup": zeros(E, 2 * inter),
        "w_edown": normal((E, inter, h), 1.0 / math.sqrt(inter)),
        "b_edown": zeros(E, h),
    }


def init_params(
    cfg: GptOssConfig, generator: torch.Generator, device: DeviceLike = None
) -> Params:
    """Random weights with the reference's init scales (unit norms, zero
    biases and sinks), drawn one tensor at a time in the model dtype on
    ``device`` from ``generator``; carry JAX weights across with
    engine/weights.params_from_numpy instead."""
    device = resolve_device(device)
    params: Params = {
        "embed": _normal(
            (cfg.vocab_size, cfg.hidden_size), 0.02, generator, device, cfg.dtype
        ),
        "final_norm": torch.ones(cfg.hidden_size, device=device, dtype=cfg.dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(
            (cfg.hidden_size, cfg.vocab_size), 0.02, generator, device, cfg.dtype
        )
    params["layers"] = [
        init_layer_params(cfg, generator, device) for _ in range(cfg.num_layers)
    ]
    return params


# ---------------------------------------------------------------------------
# router + experts
# ---------------------------------------------------------------------------


def route(p: Params, cfg: GptOssConfig, x: torch.Tensor):
    """gpt-oss router: top-k over the float32 logits, softmax over the
    SELECTED logits (not over all experts). x [T, H] -> (weights [T, K]
    float32, expert ids [T, K] int64). Ties go to the lower expert id, as
    ``jax.lax.top_k`` breaks them (models/experts.top_k)."""
    logits = x.float() @ p["w_router"].float() + p["b_router"].float()
    vals, ids = top_k(logits, cfg.num_experts_per_tok)
    return torch.softmax(vals, dim=-1), ids


def _swiglu(cfg: GptOssConfig, gu: torch.Tensor) -> torch.Tensor:
    """The clamped SwiGLU of the fused gate/up output (float32,
    interleaved lanes: gate even, up odd)."""
    gate, up = gu[..., ::2], gu[..., 1::2]
    gate = torch.clamp(gate, max=cfg.swiglu_limit)
    up = torch.clamp(up, -cfg.swiglu_limit, cfg.swiglu_limit)
    return (up + 1.0) * (gate * torch.sigmoid(gate * cfg.swiglu_alpha))


def _expert_apply(cfg: GptOssConfig, w_gu, b_gu, w_dn, b_dn, x) -> torch.Tensor:
    """One expert ([H, 2I] and [I, H] weights) on the tokens x [T, H]: the
    fused clamped-SwiGLU MLP in float32."""
    act = _swiglu(cfg, x.float() @ w_gu.float() + b_gu.float())
    return act @ w_dn.float() + b_dn.float()


def experts_plain(p: Params, cfg: GptOssConfig, x: torch.Tensor, routed) -> torch.Tensor:
    """The reference's experts_gather as a loop over the experts:
    each applies its float32 weights to the (token, slot) pairs routed to
    it; the slots are then summed in slot order. The yardstick of
    experts_grouped (it syncs the host once per expert)."""
    topw, topi = routed
    T, K = topi.shape
    pairs = torch.zeros(T, K, x.shape[-1], dtype=torch.float32, device=x.device)
    for e in range(p["w_gateup"].shape[0]):
        t, k = torch.nonzero(topi == e, as_tuple=True)
        if t.numel():
            pairs[t, k] = _expert_apply(cfg, p["w_gateup"][e], p["b_gateup"][e],
                                        p["w_edown"][e], p["b_edown"][e], x[t])
    return sum_slots(topw, pairs, torch.float32).to(x.dtype)


def experts_grouped(p: Params, cfg: GptOssConfig, x: torch.Tensor, routed) -> torch.Tensor:
    """The reference's experts_gather as the card runs it (module
    docstring): one grouped product per projection over the pairs sorted
    by expert; no host sync, static shapes."""
    topw, topi = routed
    T, K = topi.shape
    order, experts, offs = expert_offsets(topi, p["w_gateup"].shape[0])
    rows = x.index_select(0, order // K).to(p["w_gateup"].dtype)         # [T*K, H]
    gu = torch._grouped_mm(rows, p["w_gateup"], offs=offs).float()
    act = _swiglu(cfg, gu + p["b_gateup"].index_select(0, experts).float())
    out = torch._grouped_mm(act.to(p["w_edown"].dtype), p["w_edown"], offs=offs).float()
    out = out + p["b_edown"].index_select(0, experts).float()
    return sum_slots(topw, unsort_pairs(order, out, T, K), torch.float32).to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

# expert_fn(p, cfg, x [T, H], (weights [T, K], ids [T, K])) -> [T, H]
ExpertFn = Callable[..., torch.Tensor]


def layer_forward(
    p: Params,
    cfg: GptOssConfig,
    x: torch.Tensor,               # [..., S, hidden]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend: AttendFn,
    layer_idx: int,
    expert_fn: ExpertFn = experts_grouped,
) -> torch.Tensor:
    lead = x.shape[:-1]
    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q = (h @ p["wq"] + p["bq"]).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = (h @ p["wk"] + p["bk"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"] + p["bv"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v, layer_idx,
                  window=cfg.window_for_layer(layer_idx), sinks=p["sinks"])
    x = x + (attn.reshape(*lead, cfg.q_size) @ p["wo"] + p["bo"])
    # MoE FFN in every layer
    hn = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    flat = hn.reshape(-1, hn.shape[-1])
    y = expert_fn(p, cfg, flat, route(p, cfg, flat))
    return x + y.reshape(hn.shape)


def forward(
    params: Params,
    cfg: GptOssConfig,
    token_ids: torch.Tensor,        # [..., S] integer
    positions: torch.Tensor,        # [..., S] integer
    attend: AttendFn,
    lora: Optional[Callable] = None,
    inputs_embeds: Optional[torch.Tensor] = None,   # [..., S, hidden]
    expert_fn: ExpertFn = experts_grouped,
) -> torch.Tensor:
    """Full stack -> final hidden states [..., S, hidden] (pre-lm_head).
    ``inputs_embeds`` replaces the embedding gather when given (the
    multimodal splice)."""
    if lora is not None:
        raise NotImplementedError("LoRA is not supported for the gpt-oss family")
    x = F.embedding(token_ids.long(), params["embed"]) if inputs_embeds is None else inputs_embeds
    cos, sin = rope_tables(cfg, positions)
    cos, sin = cos[..., None, :], sin[..., None, :]
    for i, layer in enumerate(params["layers"]):
        x = layer_forward(layer, cfg, x, cos, sin, attend, i, expert_fn=expert_fn)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def lm_logits(params: Params, cfg: GptOssConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (hidden @ params["embed"].T).float()
    return (hidden @ params["lm_head"]).float()
