"""Gemma 2 / Gemma 3 (text) family in PyTorch.

Counterpart of the reference's models/gemma.py, as plain functions over a
parameter dictionary with the reference's layout (weights ``[in, out]``,
applied as ``x @ W``), so a JAX parameter pytree carries across unchanged
(engine/weights.py). What makes Gemma not llama:

- RMSNorm computes in float32 and scales by (1 + weight) BEFORE the
  downcast (zero-init norms);
- embeddings are scaled by sqrt(hidden_size) CAST TO THE MODEL DTYPE first
  (sqrt(3072) becomes 55.5 in bf16);
- sandwich norms: the attention and MLP outputs are normed before the
  residual add, beside the usual pre-norms;
- the attention scale is query_pre_attn_scalar**-0.5, folded into q (in q's
  dtype) so the attention ops keep their 1/sqrt(head_dim);
- interleaved sliding-window and full layers: every layer calls ``attend``
  with its ``window`` and ``softcap`` (None on full layers and on Gemma 3);
- Gemma 2: attention-logit softcap in the scores, final-logit softcap in
  ``lm_logits`` (in float32);
- Gemma 3: per-head q/k RMSNorm (Gemma convention) and dual RoPE: sliding
  layers use the local theta, full layers rope_theta with a linear
  position factor;
- GeGLU MLP: gelu_tanh(gate) * up.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .llama import AttendFn, LlamaConfig, Params, _normal, apply_rope, rope_cos_sin

LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm",
    "post_attn_norm", "pre_mlp_norm", "post_mlp_norm", "q_norm", "k_norm",
)


@dataclasses.dataclass(frozen=True)
class GemmaConfig(LlamaConfig):
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 4096
    # per-layer kinds: "sliding" | "full"; () = derive from sliding_pattern
    layer_types: Tuple[str, ...] = ()
    # every Nth layer is full attention (gemma2: 2, full on odd layers;
    # gemma3: 6, five sliding then one full)
    sliding_pattern: int = 2
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    # gemma3 dual rope: sliding layers use the local theta (no scaling),
    # full layers use rope_theta / linear factor
    rope_local_theta: Optional[float] = None
    rope_scaling_factor: float = 1.0

    def kind_for_layer(self, layer_idx: int) -> str:
        if self.layer_types:
            return self.layer_types[layer_idx]
        # HF convention for both families: (layer_idx + 1) % pattern == 0
        # -> full
        return "full" if (layer_idx + 1) % self.sliding_pattern == 0 else "sliding"

    def window_for_layer(self, layer_idx: int) -> Optional[int]:
        return self.sliding_window if self.kind_for_layer(layer_idx) == "sliding" else None

    @classmethod
    def tiny_gemma2(cls, **kw) -> "GemmaConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            query_pre_attn_scalar=16.0, sliding_window=16,
            attn_logit_softcap=50.0, final_logit_softcap=30.0,
            tie_embeddings=True, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny_gemma3(cls, **kw) -> "GemmaConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, num_layers=6, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            query_pre_attn_scalar=16.0, sliding_window=16,
            sliding_pattern=3, qk_norm=True, rope_theta=1_000_000.0,
            rope_local_theta=10_000.0, rope_scaling_factor=8.0,
            tie_embeddings=True, dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gemma2_2b(cls, vocab_size: int = 256000) -> "GemmaConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=2304, num_layers=26,
            num_heads=8, num_kv_heads=4, head_dim=256,
            intermediate_size=9216, query_pre_attn_scalar=256.0,
            sliding_window=4096, attn_logit_softcap=50.0,
            final_logit_softcap=30.0, tie_embeddings=True,
            max_position=8192,
        )

    @classmethod
    def gemma3_4b(cls, vocab_size: int = 262208) -> "GemmaConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=2560, num_layers=34,
            num_heads=8, num_kv_heads=4, head_dim=256,
            intermediate_size=10240, query_pre_attn_scalar=256.0,
            sliding_window=1024, sliding_pattern=6, qk_norm=True,
            rope_theta=1_000_000.0, rope_local_theta=10_000.0,
            rope_scaling_factor=8.0, tie_embeddings=True,
            max_position=131072,
        )


# preset name -> config (the reference worker's --preset names)
PRESETS: Dict[str, Callable[[], GemmaConfig]] = {
    "tiny-gemma2": GemmaConfig.tiny_gemma2,
    "tiny-gemma3": GemmaConfig.tiny_gemma3,
    "gemma2-2b": GemmaConfig.gemma2_2b,
    "gemma3-4b": GemmaConfig.gemma3_4b,
}


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def gemma_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma convention: float32 math, scale by (1 + weight) BEFORE the
    downcast ((x * w).to(dtype), not x.to(dtype) * w as llama's rms_norm)."""
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (normed * (1.0 + w.float())).to(x.dtype)


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a tensor times it
    is the reference's product with a scalar of the tensor's dtype (the
    exact product, rounded once), with no device tensor made per call."""
    return float(torch.tensor(value, dtype=dtype))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer_params(cfg: GemmaConfig, generator: torch.Generator, device) -> Params:
    h, qd, kvd, inter = cfg.hidden_size, cfg.q_size, cfg.kv_size, cfg.intermediate_size
    scale = 1.0 / math.sqrt(h)
    dt = cfg.dtype

    def normal(shape, std):
        return _normal(shape, std, generator, device, dt)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dt)

    p: Params = {
        "attn_norm": zeros(h),
        "post_attn_norm": zeros(h),
        "pre_mlp_norm": zeros(h),
        "post_mlp_norm": zeros(h),
        "wq": normal((h, qd), scale),
        "wk": normal((h, kvd), scale),
        "wv": normal((h, kvd), scale),
        "wo": normal((qd, h), scale),
        "w_gate": normal((h, inter), scale),
        "w_up": normal((h, inter), scale),
        "w_down": normal((inter, h), 1.0 / math.sqrt(inter)),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(cfg.head_dim)
        p["k_norm"] = zeros(cfg.head_dim)
    return p


def init_params(
    cfg: GemmaConfig, generator: torch.Generator, device: DeviceLike = None
) -> Params:
    """Random weights with the reference's init scales (zero norms, tied
    embeddings), drawn one tensor at a time in the model dtype on
    ``device`` from ``generator``; carry JAX weights across with
    engine/weights.params_from_numpy instead."""
    device = resolve_device(device)
    params: Params = {
        "embed": _normal(
            (cfg.vocab_size, cfg.hidden_size), 0.02, generator, device, cfg.dtype
        ),
        "final_norm": torch.zeros(cfg.hidden_size, device=device, dtype=cfg.dtype),
    }
    params["layers"] = [
        init_layer_params(cfg, generator, device) for _ in range(cfg.num_layers)
    ]
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def layer_forward(
    p: Params,
    cfg: GemmaConfig,
    x: torch.Tensor,               # [..., S, hidden]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend: AttendFn,
    layer_idx: int,
) -> torch.Tensor:
    lead = x.shape[:-1]
    eps = cfg.rms_norm_eps
    h = gemma_rms_norm(x, p["attn_norm"], eps)
    q = (h @ p["wq"]).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:   # gemma3 per-head norms, gemma convention
        q = gemma_rms_norm(q, p["q_norm"], eps)
        k = gemma_rms_norm(k, p["k_norm"], eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # the attention ops scale by head_dim**-0.5; gemma wants
    # query_pre_attn_scalar**-0.5: fold the ratio into q, in q's dtype
    q = q * _rounded(math.sqrt(cfg.head_dim) / math.sqrt(cfg.query_pre_attn_scalar), q.dtype)
    attn = attend(
        q, k, v, layer_idx,
        window=cfg.window_for_layer(layer_idx),
        softcap=cfg.attn_logit_softcap,
    )
    attn = attn.reshape(*lead, cfg.q_size) @ p["wo"]
    x = x + gemma_rms_norm(attn, p["post_attn_norm"], eps)

    h2 = gemma_rms_norm(x, p["pre_mlp_norm"], eps)
    gate = F.gelu((h2 @ p["w_gate"]).float(), approximate="tanh").to(x.dtype)
    mlp = (gate * (h2 @ p["w_up"])) @ p["w_down"]
    return x + gemma_rms_norm(mlp, p["post_mlp_norm"], eps)


def forward(
    params: Params,
    cfg: GemmaConfig,
    token_ids: torch.Tensor,        # [..., S] integer
    positions: torch.Tensor,        # [..., S] integer
    attend: AttendFn,
    inputs_embeds: Optional[torch.Tensor] = None,   # [..., S, hidden]
) -> torch.Tensor:
    """Full stack -> final hidden states [..., S, hidden] (pre-lm_head).

    ``inputs_embeds`` replaces the embedding gather when given (the
    multimodal splice) and is scaled as the token embeddings are."""
    x = F.embedding(token_ids.long(), params["embed"]) if inputs_embeds is None else inputs_embeds
    # the normalizer is rounded to the model dtype (part of the checkpoint
    # contract: sqrt(3072) is 55.5 in bf16), spliced soft tokens included
    x = x * _rounded(math.sqrt(cfg.hidden_size), x.dtype)
    tables: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope_for(layer_idx: int):
        if cfg.rope_local_theta is None:
            key, theta, scale = "global", cfg.rope_theta, 1.0
        elif cfg.kind_for_layer(layer_idx) == "sliding":
            key, theta, scale = "local", cfg.rope_local_theta, 1.0
        else:
            key, theta, scale = "global", cfg.rope_theta, cfg.rope_scaling_factor
        if key not in tables:
            cos, sin = rope_cos_sin(positions.float() / scale, cfg.head_dim, theta)
            tables[key] = (cos[..., None, :], sin[..., None, :])
        return tables[key]

    for i, layer in enumerate(params["layers"]):
        cos, sin = rope_for(i)
        x = layer_forward(layer, cfg, x, cos, sin, attend, i)
    return gemma_rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def lm_logits(params: Params, cfg: GemmaConfig, hidden: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")   # untied finetunes; released gemma ties
    logits = (hidden @ head if head is not None else hidden @ params["embed"].T).float()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
