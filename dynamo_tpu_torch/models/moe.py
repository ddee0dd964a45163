"""Sparse mixture-of-experts family (Qwen3-MoE / Mixtral style) in PyTorch.

Counterpart of the reference's models/moe.py for one device, as plain
functions over a parameter dictionary with the reference's layout and
names (weights ``[in, out]``; the expert stacks ``w_gate``/``w_up``
``[E, H, I]`` and ``w_down`` ``[E, I, H]``), so a JAX parameter pytree
carries across unchanged (engine/weights.py). Attention is llama's (the
Qwen3 layout: per-head q/k RMSNorm); the MLP is the routed expert SwiGLU:

- ``route``: softmax over the float32 router logits, the top k, and their
  renormalisation when ``norm_topk_prob`` is set (Qwen3-MoE). Ties go to
  the lower expert id, as ``jax.lax.top_k`` breaks them;
- ``moe_ffn``: the reference's dense form (every expert on every token,
  a masked combine). It stays as the plain version and a test oracle;
- ``experts_grouped``, what the engine runs: the reference's
  ``moe_ffn_gather`` as one grouped matrix product per projection (gate,
  up, down) over the (token, slot) pairs sorted by expert on the device
  (``torch._grouped_mm`` with device offsets: only the experts that have
  rows are read), with the reference's rounding: gate and up in the model
  dtype, the SiLU in float32 cast back, times up, then the slot sum in
  the model dtype, slot by slot. No host sync and no shape that depends
  on the data, so a CUDA graph captures it (the decode horizon). The
  reference picks its gather or dense form by token count; both compute
  the same function, so the port runs the grouped form at every T;
- ``experts_plain``: a loop over the experts in float32, the yardstick
  that the GPU smoke script holds the grouped form to.

These are matrix products that the reference computes with ``einsum``
outside any Pallas kernel; no hand kernel replaces them. Expert
parallelism and EPLB's redundant experts wait for the parallelism slice:
``redundant_experts > 0`` is refused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from . import llama
from .experts import expert_offsets, sum_slots, top_k, unsort_pairs
from .llama import AttendFn, Params, _normal, apply_rope, rms_norm, rope_cos_sin

# the per-layer parameter names (engine/weights.py refuses any other)
LAYER_KEYS = (
    "attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "q_norm", "k_norm",
    "w_router", "w_gate", "w_up", "w_down",
)


@dataclasses.dataclass(frozen=True)
class MoeConfig(llama.LlamaConfig):
    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 128
    norm_topk_prob: bool = True
    # the reference's expert-parallel dispatch capacity (unused on one device)
    capacity_factor: float = 2.0
    # EPLB's redundant physical experts: not in this port yet
    redundant_experts: int = 0

    def __post_init__(self):
        if self.redundant_experts > 0:
            raise ValueError("redundant_experts > 0 (EPLB) needs expert parallelism, "
                             "which this port does not have yet")

    @classmethod
    def tiny_moe(cls, **kw) -> "MoeConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
            dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def qwen3_30b_a3b(cls, vocab_size: int = 151936) -> "MoeConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=2048, num_layers=48,
            num_heads=32, num_kv_heads=4, head_dim=128,
            intermediate_size=6144,  # unused (all layers sparse)
            num_experts=128, num_experts_per_tok=8,
            moe_intermediate_size=768, rope_theta=1000000.0, qk_norm=True,
            tie_embeddings=False,
        )


# preset name -> config (the reference worker's --preset names)
PRESETS: Dict[str, Callable[[], MoeConfig]] = {
    "tiny-moe": MoeConfig.tiny_moe,
    "qwen3-30b-a3b": MoeConfig.qwen3_30b_a3b,
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer_params(cfg: MoeConfig, generator: torch.Generator, device) -> Params:
    h, qd, kvd = cfg.hidden_size, cfg.q_size, cfg.kv_size
    E, inter = cfg.num_experts, cfg.moe_intermediate_size
    scale = 1.0 / math.sqrt(h)
    dt = cfg.dtype

    def normal(shape, std):
        return _normal(shape, std, generator, device, dt)

    p: Params = {
        "attn_norm": torch.ones(h, device=device, dtype=dt),
        "mlp_norm": torch.ones(h, device=device, dtype=dt),
        "wq": normal((h, qd), scale),
        "wk": normal((h, kvd), scale),
        "wv": normal((h, kvd), scale),
        "wo": normal((qd, h), scale),
        "w_router": normal((h, E), scale),
        "w_gate": normal((E, h, inter), scale),
        "w_up": normal((E, h, inter), scale),
        "w_down": normal((E, inter, h), 1.0 / math.sqrt(inter)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.head_dim, device=device, dtype=dt)
        p["k_norm"] = torch.ones(cfg.head_dim, device=device, dtype=dt)
    return p


def init_params(cfg: MoeConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random weights with the reference's init scales, drawn one tensor
    at a time in the model dtype on ``device`` from ``generator``; carry
    JAX weights across with engine/weights.params_from_numpy instead."""
    device = resolve_device(device)
    params: Params = {
        "embed": _normal((cfg.vocab_size, cfg.hidden_size), 0.02, generator, device,
                         cfg.dtype),
        "final_norm": torch.ones(cfg.hidden_size, device=device, dtype=cfg.dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((cfg.hidden_size, cfg.vocab_size), 0.02, generator,
                                    device, cfg.dtype)
    params["layers"] = [init_layer_params(cfg, generator, device)
                        for _ in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route(p: Params, cfg: MoeConfig, x: torch.Tensor):
    """softmax-then-top-k router. x [T, H] -> (weights [T, K] float32,
    expert ids [T, K] int64)."""
    logits = (x @ p["w_router"]).float()
    topw, topi = top_k(torch.softmax(logits, dim=-1), cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi


def expert_load(cfg: MoeConfig, topi: torch.Tensor) -> torch.Tensor:
    """Tokens-per-expert counts [E] int32 (the reference's EPLB feed)."""
    return torch.bincount(topi.reshape(-1), minlength=cfg.num_experts).to(torch.int32)


# ---------------------------------------------------------------------------
# expert FFN
# ---------------------------------------------------------------------------


def moe_ffn(p: Params, cfg: MoeConfig, x: torch.Tensor) -> torch.Tensor:
    """The reference's dense form: every expert computed for every token,
    then the masked combine. O(T * E) work: a plain version and oracle."""
    E = cfg.num_experts
    topw, topi = route(p, cfg, x)
    xb = x.expand(E, *x.shape)                                    # [E, T, H]
    gate = torch.einsum("ebh,ehi->ebi", xb, p["w_gate"])
    up = torch.einsum("ebh,ehi->ebi", xb, p["w_up"])
    act = F.silu(gate.float()).to(x.dtype) * up
    out_all = torch.einsum("ebi,eih->ebh", act, p["w_down"])      # [E, T, H]
    oh = F.one_hot(topi, E).float()                               # [T, K, E]
    weights = (topw[..., None] * oh).sum(1)                       # [T, E]
    return torch.einsum("te,eth->th", weights.to(x.dtype), out_all)


def experts_grouped(p: Params, cfg, x: torch.Tensor, routed) -> torch.Tensor:
    """The reference's ``moe_ffn_gather(p, cfg, x, routed)`` as the card
    runs it (module docstring): one grouped product per projection over
    the pairs sorted by expert; no host sync, static shapes."""
    topw, topi = routed
    T, K = topi.shape
    order, _, offs = expert_offsets(topi, p["w_gate"].shape[0])
    rows = x.index_select(0, order // K)                          # [T*K, H]
    gate = torch._grouped_mm(rows, p["w_gate"], offs=offs)
    up = torch._grouped_mm(rows, p["w_up"], offs=offs)
    act = F.silu(gate.float()).to(x.dtype) * up
    out = torch._grouped_mm(act, p["w_down"], offs=offs)
    return sum_slots(topw, unsort_pairs(order, out, T, K), x.dtype)


def experts_plain(p: Params, cfg, x: torch.Tensor, routed) -> torch.Tensor:
    """The routed expert SwiGLU as a loop over the experts, each applying
    its float32 weights to the (token, slot) pairs routed to it; the slots
    summed in float32 in slot order. The yardstick of experts_grouped (it
    syncs the host once per expert)."""
    topw, topi = routed
    T, K = topi.shape
    pairs = torch.zeros(T, K, x.shape[-1], dtype=torch.float32, device=x.device)
    for e in range(p["w_gate"].shape[0]):
        t, k = torch.nonzero(topi == e, as_tuple=True)
        if t.numel():
            xe = x[t].float()
            act = F.silu(xe @ p["w_gate"][e].float()) * (xe @ p["w_up"][e].float())
            pairs[t, k] = act @ p["w_down"][e].float()
    return sum_slots(topw, pairs, torch.float32).to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

# expert_fn(p, cfg, x [T, H], (weights [T, K], ids [T, K])) -> [T, H]
ExpertFn = Callable[..., torch.Tensor]


def layer_forward(
    p: Params,
    cfg: MoeConfig,
    x: torch.Tensor,               # [..., S, hidden]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend: AttendFn,
    layer_idx: int,
    expert_fn: ExpertFn = experts_grouped,
) -> torch.Tensor:
    """llama's attention block (Qwen3 layout), then the routed experts."""
    lead = x.shape[:-1]
    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q = (h @ p["wq"]).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v, layer_idx).reshape(*lead, cfg.q_size)
    x = x + attn @ p["wo"]
    hn = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    flat = hn.reshape(-1, cfg.hidden_size)
    y = expert_fn(p, cfg, flat, route(p, cfg, flat))
    return x + y.reshape(hn.shape)


def forward(
    params: Params,
    cfg: MoeConfig,
    token_ids: torch.Tensor,        # [..., S] integer
    positions: torch.Tensor,        # [..., S] integer
    attend: AttendFn,
    expert_fn: ExpertFn = experts_grouped,
) -> torch.Tensor:
    """Full stack -> final hidden states [..., S, hidden] (pre-lm_head)."""
    x = F.embedding(token_ids.long(), params["embed"])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]
    for i, layer in enumerate(params["layers"]):
        x = layer_forward(layer, cfg, x, cos, sin, attend, i, expert_fn=expert_fn)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


lm_logits = llama.lm_logits
