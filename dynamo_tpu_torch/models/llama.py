"""Llama-family transformer in PyTorch (Llama 2/3, Qwen 2/3 and the other
dense layouts the reference's models/llama.py covers through config
switches).

Plain functions over a parameter dictionary with the reference's layout, so
a JAX parameter pytree carries across unchanged (engine/weights.py):
weights are ``[in, out]`` and applied as ``x @ W``; ``layers[i]`` holds
``wq/wk/wv/wo/w_gate/w_up/w_down/attn_norm/mlp_norm`` plus the optional
``bq/bk/bv`` (Qwen2) and ``q_norm/k_norm`` (Qwen3). Weights are bf16 on the
card; norms, RoPE and softmax compute in float32.

Attention is pluggable through the same hook as the reference:
``attend(q, k_new, v_new, layer_idx) -> [..., n_heads, head_dim]``, so one
block stack serves contiguous prefill, paged decode and the fused mixed
step (engine/engine.py).

Tensor parallelism (``tp``: a rank's collectives, parallel/comm.py): the
parameters are the rank's shards (parallel/mesh.py) and ``cfg`` its local
config (``num_heads / tp`` over ``num_kv_heads / tp``). Each rank attends
over its own heads; the row-parallel products ``attn_out @ wo`` and
``gu @ w_down`` are summed over the ranks (one all-reduce each, the
reference's GSPMD ``psum``s) before their residual adds; the embedding,
sharded on hidden, is gathered after the lookup; and ``lm_logits`` gathers
the vocabulary shards (or, for tied embeddings, sums the partial products
over the hidden shards), so every rank holds the same logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

Params = Dict[str, Any]

# the per-layer parameter names (engine/weights.py refuses any other)
LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm",
    "mlp_norm", "bq", "bk", "bv", "q_norm", "k_norm",
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 512
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 688
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_position: int = 8192
    qkv_bias: bool = False          # Qwen2-style
    qk_norm: bool = False           # Qwen3-style per-head q/k RMSNorm
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-scale config (byte tokenizer vocab)."""
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, vocab_size: int = 128256) -> "LlamaConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, head_dim=128, intermediate_size=14336,
            rope_theta=500000.0, max_position=8192, tie_embeddings=False,
        )

    @classmethod
    def llama3_70b(cls, vocab_size: int = 128256) -> "LlamaConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=8192, num_layers=80, num_heads=64,
            num_kv_heads=8, head_dim=128, intermediate_size=28672,
            rope_theta=500000.0, max_position=8192, tie_embeddings=False,
        )

    @classmethod
    def qwen3_0_6b(cls, vocab_size: int = 151936) -> "LlamaConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=1024, num_layers=28, num_heads=16,
            num_kv_heads=8, head_dim=128, intermediate_size=3072,
            rope_theta=1000000.0, qk_norm=True, tie_embeddings=True,
        )


# preset name -> config (the reference worker's --preset names)
PRESETS: Dict[str, Callable[[], LlamaConfig]] = {
    "tiny": LlamaConfig.tiny,
    "qwen3-0.6b": LlamaConfig.qwen3_0_6b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama3-70b": LlamaConfig.llama3_70b,
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _normal(shape, std: float, generator: torch.Generator, device, dtype):
    """N(0, std^2) drawn directly in ``dtype`` on ``device``: an 8B model
    never passes through float32 intermediates (they would need 32 GB)."""
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.normal_(0.0, std, generator=generator)


def init_layer_params(cfg: LlamaConfig, generator: torch.Generator, device) -> Params:
    h, qd, kvd, inter = cfg.hidden_size, cfg.q_size, cfg.kv_size, cfg.intermediate_size
    scale = 1.0 / math.sqrt(h)
    iscale = 1.0 / math.sqrt(inter)
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
        "w_gate": normal((h, inter), scale),
        "w_up": normal((h, inter), scale),
        "w_down": normal((inter, h), iscale),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(qd, device=device, dtype=dt)
        p["bk"] = torch.zeros(kvd, device=device, dtype=dt)
        p["bv"] = torch.zeros(kvd, device=device, dtype=dt)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.head_dim, device=device, dtype=dt)
        p["k_norm"] = torch.ones(cfg.head_dim, device=device, dtype=dt)
    return p


def init_params(
    cfg: LlamaConfig, generator: torch.Generator, device: DeviceLike = None
) -> Params:
    """Random weights with the reference's init scales (N(0, 1/hidden) for
    projections, N(0, 0.02^2) for embeddings), drawn one tensor at a time
    on ``device`` from ``generator`` (which must live on that device). The
    numbers differ from JAX's ``init_params`` for the same seed; carry JAX
    weights across with engine/weights.params_from_numpy instead."""
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
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos/sin [..., head_dim//2] (float32)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., n_heads, head_dim], cos/sin broadcastable [..., 1, head_dim//2].
    Rotate-half layout (first/second half pairs, as HF Llama)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# attend(q, k_new, v_new, layer_idx, **extra) -> attention output
# [..., n_heads, head_dim]; ``extra`` carries a family's attention attributes
# (gemma: window, softcap), llama passes none
AttendFn = Callable[..., torch.Tensor]


def layer_forward(
    p: Params,
    cfg: LlamaConfig,
    x: torch.Tensor,               # [..., S, hidden]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attend: AttendFn,
    layer_idx: int,
    lora: Optional[Callable] = None,
    tp: Optional[Any] = None,
) -> torch.Tensor:
    # optional batched LoRA (lora/adapters.make_lora_fn): its delta is added
    # to a projection's output; it returns None for targets without tables
    def _lora(name: str, inp: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        if lora is None:
            return out
        delta = lora(name, layer_idx, inp)
        return out if delta is None else out + delta

    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q = _lora("wq", h, h @ p["wq"])
    k = _lora("wk", h, h @ p["wk"])
    v = _lora("wv", h, h @ p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    lead = h.shape[:-1]
    q = q.reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = k.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn_out = attend(q, k, v, layer_idx).reshape(*lead, cfg.q_size)
    o = _lora("wo", attn_out, attn_out @ p["wo"])
    x = x + (o if tp is None else tp.all_reduce(o))
    h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    gate = F.silu(_lora("w_gate", h, h @ p["w_gate"]).float()).to(x.dtype)
    gu = gate * _lora("w_up", h, h @ p["w_up"])
    down = _lora("w_down", gu, gu @ p["w_down"])
    return x + (down if tp is None else tp.all_reduce(down))


def forward(
    params: Params,
    cfg: LlamaConfig,
    token_ids: torch.Tensor,        # [..., S] integer
    positions: torch.Tensor,        # [..., S] integer
    attend: AttendFn,
    inputs_embeds: Optional[torch.Tensor] = None,   # [..., S, hidden]
    lora: Optional[Callable] = None,
    tp: Optional[Any] = None,
) -> torch.Tensor:
    """Full stack -> final hidden states [..., S, hidden] (pre-lm_head).

    ``inputs_embeds`` replaces the embedding gather when given: the
    multimodal path splices vision soft tokens in (models/vision.py).
    ``lora``: the batched LoRA deltas (lora/adapters.make_lora_fn).
    ``tp``: the rank's collectives when the parameters are its TP shards."""
    if inputs_embeds is not None:
        x = inputs_embeds
    else:
        x = F.embedding(token_ids.long(), params["embed"])
        if tp is not None:
            x = tp.all_gather(x)     # the hidden shards, in rank order
    if tp is not None:
        tp.note_forward()
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]   # broadcast over heads
    for i, layer in enumerate(params["layers"]):
        x = layer_forward(layer, cfg, x, cos, sin, attend, i, lora=lora, tp=tp)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def lm_logits(params: Params, cfg: LlamaConfig, hidden: torch.Tensor,
              tp: Optional[Any] = None) -> torch.Tensor:
    """Float32 logits over the whole vocabulary; at ``tp`` the same on
    every rank."""
    if cfg.tie_embeddings:
        if tp is None:
            return (hidden @ params["embed"].T).float()
        # the embedding holds this rank's hidden columns: a partial product
        n = params["embed"].shape[1]
        part = hidden[..., tp.rank * n:(tp.rank + 1) * n] @ params["embed"].T
        return tp.all_reduce(part.float())
    logits = (hidden @ params["lm_head"]).float()
    return logits if tp is None else tp.all_gather(logits)
