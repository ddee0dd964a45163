"""Multi-head latent attention family (DeepSeek V2 / V3) in PyTorch.

Counterpart of the reference's models/mla.py, as plain functions over a
parameter dictionary with the reference's layout and names, so a JAX
parameter pytree carries across unchanged (engine/weights.py).

The KV cache holds the compressed latent. MLA projects a token down to a
shared latent ``c`` (``kv_lora_rank`` lanes) plus one decoupled RoPE key
``k_pe`` (``qk_rope_head_dim`` lanes); with the K up-projection folded
into the query (``q_abs = q_nope . W_uk``) and the V up-projection applied
after the softmax, attention is multi-query attention over the latent:

    score_h(i) = concat(q_abs_h, q_pe_h) . concat(c_i, k_pe_i)
    out_h      = W_uv_h (sum_i p_i c_i)

So the engine sees ``num_kv_heads = 1`` and ``head_dim = kv_lora_rank +
qk_rope_head_dim`` (576 for DeepSeek), pinned by ``MlaConfig``: the cached
K is ``[c, k_pe]`` and the cached V is ``[c, 0...]`` (c padded with zeros
to the same width), byte for byte the reference's caches. The attention
op scales by ``1 / sqrt(head_dim)``; MLA wants ``1 / sqrt(nope + rope)``,
so the query is pre-multiplied by the ratio, and the op must not scale a
second time. The model reads the op's first ``kv_lora_rank`` output
lanes; on the GPU the engine serves every attention call of this family
through the latent kernel (ops/cuda_mla.py), which returns exactly those.

The FFN is a dense SwiGLU below ``first_dense_layers`` (and everywhere
when ``num_experts == 0``), else DeepSeek-MoE: sigmoid or softmax
routing, the float32 ``router_bias`` used for selection only, optional
group-limited selection (``n_group`` / ``topk_group``), combine weights
from the unbiased scores scaled by ``routed_scaling_factor``, and the
always-on shared experts; the routed experts run through models/moe.py's
grouped form.

DeepSeek-V3's preset is a configuration only here: 671B parameters do not
fit one card. LoRA and input embeddings are refused, as the reference
refuses LoRA for this family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from . import moe
from .experts import top_k
from .llama import AttendFn, LlamaConfig, Params, _normal, apply_rope, rms_norm, rope_cos_sin

# the per-layer parameter names of dense and MoE layers together
# (engine/weights.py refuses any other)
LAYER_KEYS = (
    "attn_norm", "mlp_norm", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo",
    "w_dq", "q_norm", "w_uq", "wq",
    "w_gate", "w_up", "w_down",
    "w_router", "router_bias", "w_egate", "w_eup", "w_edown",
    "w_shared_gate", "w_shared_up", "w_shared_down",
)
# parameters kept in float32 whatever the model dtype
FLOAT32_KEYS = ("router_bias",)


@dataclasses.dataclass(frozen=True)
class MlaConfig(LlamaConfig):
    # attention (latent) dims
    q_lora_rank: int = 0            # 0 = full-rank q projection (V2-Lite)
    kv_lora_rank: int = 64
    qk_nope_head_dim: int = 32
    qk_rope_head_dim: int = 16
    v_head_dim: int = 32
    # MoE FFN (num_experts == 0 -> dense SwiGLU everywhere)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    moe_scoring: str = "softmax"    # "sigmoid" = DeepSeek-V3 style
    routed_scaling_factor: float = 1.0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    # group-limited routing (V3): the topk_group best of n_group groups
    # (scored by their top-2 sum), then the top k within them
    n_group: int = 1
    topk_group: int = 1
    # checkpoint rope layout (HF rope_interleave); the loader de-interleaves
    rope_interleave: bool = True

    def __post_init__(self):
        # the engine reads num_kv_heads / head_dim as the cache layout; for
        # MLA that layout is the latent
        object.__setattr__(self, "num_kv_heads", 1)
        object.__setattr__(self, "head_dim", self.kv_lora_rank + self.qk_rope_head_dim)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def q_size(self) -> int:
        return self.num_heads * self.qk_head_dim

    @classmethod
    def tiny_mla(cls, **kw) -> "MlaConfig":
        defaults = dict(
            vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
            kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32, intermediate_size=256, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny_mla_moe(cls, **kw) -> "MlaConfig":
        defaults = dict(
            vocab_size=512, hidden_size=128, num_layers=3, num_heads=4,
            kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32, intermediate_size=256, q_lora_rank=96,
            num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
            moe_scoring="sigmoid", routed_scaling_factor=2.0,
            num_shared_experts=1, first_dense_layers=1, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def deepseek_v2_lite(cls, vocab_size: int = 102400) -> "MlaConfig":
        """DeepSeek-V2-Lite (15.7B total / 2.4B active)."""
        return cls(
            vocab_size=vocab_size, hidden_size=2048, num_layers=27,
            num_heads=16, q_lora_rank=0, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            intermediate_size=10944, num_experts=64, num_experts_per_tok=6,
            moe_intermediate_size=1408, num_shared_experts=2,
            norm_topk_prob=False,  # V2-Lite uses unnormalized top-k weights
            first_dense_layers=1, rope_theta=10000.0, tie_embeddings=False,
        )

    @classmethod
    def deepseek_v3(cls, vocab_size: int = 129280) -> "MlaConfig":
        """DeepSeek-V3 / R1 (671B total / 37B active): a configuration only
        in this port (it does not fit one card)."""
        return cls(
            vocab_size=vocab_size, hidden_size=7168, num_layers=61,
            num_heads=128, q_lora_rank=1536, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
            intermediate_size=18432, num_experts=256, num_experts_per_tok=8,
            moe_intermediate_size=2048, moe_scoring="sigmoid",
            routed_scaling_factor=2.5, norm_topk_prob=True,
            num_shared_experts=1, first_dense_layers=3,
            n_group=8, topk_group=4,
            rope_theta=10000.0, tie_embeddings=False,
        )


# preset name -> config (the reference worker's --preset names)
PRESETS: Dict[str, Callable[[], MlaConfig]] = {
    "tiny-mla": MlaConfig.tiny_mla,
    "tiny-mla-moe": MlaConfig.tiny_mla_moe,
    "deepseek-v2-lite": MlaConfig.deepseek_v2_lite,
    "deepseek-v3": MlaConfig.deepseek_v3,
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def is_moe_layer(cfg: MlaConfig, layer_idx: int) -> bool:
    return cfg.num_experts > 0 and layer_idx >= cfg.first_dense_layers


def init_layer_params(cfg: MlaConfig, generator: torch.Generator, device,
                      layer_idx: int) -> Params:
    h, nh, rank = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(h)
    dt = cfg.dtype

    def normal(shape, std):
        return _normal(shape, std, generator, device, dt)

    p: Params = {
        "attn_norm": torch.ones(h, device=device, dtype=dt),
        "mlp_norm": torch.ones(h, device=device, dtype=dt),
        "w_dkv": normal((h, rank + rope), scale),
        "kv_norm": torch.ones(rank, device=device, dtype=dt),
        "w_uk": normal((nh, nope, rank), 1.0 / math.sqrt(rank)),
        "w_uv": normal((nh, rank, vd), 1.0 / math.sqrt(rank)),
        "wo": normal((nh * vd, h), scale),
    }
    if cfg.q_lora_rank > 0:
        p["w_dq"] = normal((h, cfg.q_lora_rank), scale)
        p["q_norm"] = torch.ones(cfg.q_lora_rank, device=device, dtype=dt)
        p["w_uq"] = normal((cfg.q_lora_rank, nh * (nope + rope)),
                           1.0 / math.sqrt(cfg.q_lora_rank))
    else:
        p["wq"] = normal((h, nh * (nope + rope)), scale)
    if is_moe_layer(cfg, layer_idx):
        E, inter = cfg.num_experts, cfg.moe_intermediate_size
        p["w_router"] = normal((h, E), scale)
        if cfg.moe_scoring == "sigmoid":
            p["router_bias"] = torch.zeros(E, device=device, dtype=torch.float32)
        p["w_egate"] = normal((E, h, inter), scale)
        p["w_eup"] = normal((E, h, inter), scale)
        p["w_edown"] = normal((E, inter, h), 1.0 / math.sqrt(inter))
        if cfg.num_shared_experts > 0:
            si = inter * cfg.num_shared_experts
            p["w_shared_gate"] = normal((h, si), scale)
            p["w_shared_up"] = normal((h, si), scale)
            p["w_shared_down"] = normal((si, h), 1.0 / math.sqrt(si))
    else:
        inter = cfg.intermediate_size
        p["w_gate"] = normal((h, inter), scale)
        p["w_up"] = normal((h, inter), scale)
        p["w_down"] = normal((inter, h), 1.0 / math.sqrt(inter))
    return p


def init_params(cfg: MlaConfig, generator: torch.Generator,
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
    params["layers"] = [init_layer_params(cfg, generator, device, i)
                        for i in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# routing + FFN
# ---------------------------------------------------------------------------


def route(p: Params, cfg: MlaConfig, x: torch.Tensor):
    """DeepSeek's top-k router (HF DeepseekV3TopkRouter): sigmoid (V3) or
    softmax (V2) scores; the selection adds the float32 ``router_bias``
    and keeps the ``topk_group`` best groups (by their top-2 sum; the
    others' scores set to 0, HF's masked_fill); the combine weights are the
    unbiased scores at the selected experts, normalised, then scaled. All
    on the device, ties to the lower index as ``jax.lax.top_k``. x [T, H]
    -> (weights [T, K] float32, expert ids [T, K] int64)."""
    logits = x.float() @ p["w_router"].float()
    if cfg.moe_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    sel = scores
    bias = p.get("router_bias")
    if bias is not None:
        sel = sel + bias.float()
    if cfg.n_group > 1:
        T = sel.shape[0]
        G, Eg = cfg.n_group, cfg.num_experts // cfg.n_group
        group_scores = top_k(sel.reshape(T, G, Eg), 2)[0].sum(-1)      # [T, G]
        _, gidx = top_k(group_scores, cfg.topk_group)                  # [T, tg]
        gmask = F.one_hot(gidx, G).sum(1)                                   # [T, G]
        emask = gmask.repeat_interleave(Eg, dim=-1)                         # [T, E]
        sel = torch.where(emask > 0, sel, 0.0)
    _, topi = top_k(sel, cfg.num_experts_per_tok)
    topw = torch.gather(scores, -1, topi)
    if cfg.norm_topk_prob:
        topw = topw / (topw.sum(-1, keepdim=True) + 1e-20)
    return topw * cfg.routed_scaling_factor, topi


def expert_params(p: Params) -> Params:
    """The expert stacks under the names models/moe.py's forms read."""
    return {"w_gate": p["w_egate"], "w_up": p["w_eup"], "w_down": p["w_edown"]}


def _swiglu(x, w_gate, w_up, w_down):
    gate = F.silu((x @ w_gate).float()).to(x.dtype)
    return (gate * (x @ w_up)) @ w_down


def moe_ffn(p: Params, cfg: MlaConfig, x: torch.Tensor,
            expert_fn: moe.ExpertFn = moe.experts_grouped) -> torch.Tensor:
    """The routed experts (``expert_fn``, fed by this module's router)
    plus the always-on shared experts. x [T, H]."""
    y = expert_fn(expert_params(p), cfg, x, route(p, cfg, x))
    if cfg.num_shared_experts > 0:
        y = y + _swiglu(x, p["w_shared_gate"], p["w_shared_up"], p["w_shared_down"])
    return y


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def layer_forward(
    p: Params,
    cfg: MlaConfig,
    x: torch.Tensor,               # [..., S, hidden]
    cos: torch.Tensor,             # [..., S, 1, rope/2]
    sin: torch.Tensor,
    attend: AttendFn,
    layer_idx: int,
    expert_fn: moe.ExpertFn = moe.experts_grouped,
) -> torch.Tensor:
    nh, rank = cfg.num_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    lead = x.shape[:-1]
    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    if cfg.q_lora_rank > 0:
        q = rms_norm(h @ p["w_dq"], p["q_norm"], cfg.rms_norm_eps) @ p["w_uq"]
    else:
        q = h @ p["wq"]
    q = q.reshape(*lead, nh, nope + rope)
    q_nope, q_pe = q[..., :nope], apply_rope(q[..., nope:], cos, sin)
    ckv = h @ p["w_dkv"]                                          # [..., rank + rope]
    c = rms_norm(ckv[..., :rank], p["kv_norm"], cfg.rms_norm_eps)
    k_pe = apply_rope(ckv[..., None, rank:], cos, sin)            # [..., 1, rope]
    # W_uk absorbed into the query: MQA over the latent
    q_abs = torch.einsum("...hn,hnr->...hr", q_nope, p["w_uk"])
    # the op scales by 1/sqrt(rank + rope); MLA wants 1/sqrt(nope + rope)
    q_prime = torch.cat([q_abs, q_pe], dim=-1) * math.sqrt((rank + rope) / (nope + rope))
    k_prime = torch.cat([c[..., None, :], k_pe], dim=-1)          # [..., 1, rank + rope]
    v_prime = F.pad(c[..., None, :], (0, rope))                   # c, then rope zeros
    o = attend(q_prime.to(cfg.dtype), k_prime.to(cfg.dtype), v_prime.to(cfg.dtype),
               layer_idx)
    # W_uv past the softmax, on the first rank lanes
    attn = torch.einsum("...hr,hrv->...hv", o[..., :rank], p["w_uv"])
    x = x + attn.reshape(*lead, nh * cfg.v_head_dim) @ p["wo"]
    h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    if is_moe_layer(cfg, layer_idx):
        flat = h.reshape(-1, h.shape[-1])
        return x + moe_ffn(p, cfg, flat, expert_fn).reshape(h.shape)
    return x + _swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def forward(
    params: Params,
    cfg: MlaConfig,
    token_ids: torch.Tensor,        # [..., S] integer
    positions: torch.Tensor,        # [..., S] integer
    attend: AttendFn,
    lora: Optional[Callable] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    expert_fn: moe.ExpertFn = moe.experts_grouped,
) -> torch.Tensor:
    """Full stack -> final hidden states [..., S, hidden] (pre-lm_head).
    ``inputs_embeds`` replaces the embedding gather when given (the
    multimodal splice)."""
    if lora is not None:
        raise NotImplementedError("LoRA is not supported for the MLA family")
    x = F.embedding(token_ids.long(), params["embed"]) if inputs_embeds is None else inputs_embeds
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]
    for i, layer in enumerate(params["layers"]):
        x = layer_forward(layer, cfg, x, cos, sin, attend, i, expert_fn=expert_fn)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def lm_logits(params: Params, cfg: MlaConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (hidden @ params["embed"].T).float()
    return (hidden @ params["lm_head"]).float()
