"""Vision encoder for multimodal serving: ViT + projector, in PyTorch.

Counterpart of the reference's models/vision.py: a standard ViT (patchify
-> bidirectional transformer -> per-patch features) and a 2-layer MLP
projector into the language model's hidden space, the LLaVA-style recipe.
Plain functions over a parameter dictionary with the reference's layout
(weights ``[in, out]``, applied as ``x @ W``), so a JAX parameter pytree
carries across unchanged (engine/weights.vision_params_from_numpy).

The reference computes the tower with XLA einsums, outside any Pallas
kernel, so the tower here is plain PyTorch on every device: matmuls in the
model dtype, the attention softmax in float32 (no fused attention call,
so the numerics follow the reference), and GELU in its tanh form, which is
``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .llama import _normal, rms_norm

Params = Dict[str, Any]

# the placeholder token id marking image spans in prompts: one shared
# sentinel well above any real vocab (the engine config defaults to it)
IMAGE_TOKEN_ID = 0x7F_FF_F0


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 256          # encoder width
    num_layers: int = 6
    num_heads: int = 4
    intermediate_size: int = 688
    out_hidden_size: int = 256      # language model hidden (projector out)
    rms_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size * self.patch_size

    @classmethod
    def tiny(cls, out_hidden_size: int = 256, **kw) -> "VisionConfig":
        return cls(
            image_size=28, patch_size=14, hidden_size=64, num_layers=2,
            num_heads=2, intermediate_size=96, out_hidden_size=out_hidden_size, **kw,
        )


def init_params(cfg: VisionConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random weights with the reference's shapes and scales, drawn one
    tensor at a time on ``device`` from ``generator`` (which must live on
    that device). The numbers differ from JAX's for the same seed; carry
    JAX weights across with engine/weights.vision_params_from_numpy."""
    device = resolve_device(device)
    h, inter, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
    s = 1.0 / math.sqrt(h)

    def normal(shape, std):
        return _normal(shape, std, generator, device, dt)

    def layer():
        return {
            "attn_norm": torch.ones(h, device=device, dtype=dt),
            "mlp_norm": torch.ones(h, device=device, dtype=dt),
            "wqkv": normal((h, 3 * h), s),
            "wo": normal((h, h), s),
            "w_up": normal((h, inter), s),
            "w_down": normal((inter, h), 1.0 / math.sqrt(inter)),
        }

    return {
        "patch_embed": normal((cfg.patch_dim, h), 1.0 / math.sqrt(cfg.patch_dim)),
        "pos_embed": normal((cfg.num_patches, h), 0.02),
        "final_norm": torch.ones(h, device=device, dtype=dt),
        "proj_up": normal((h, cfg.out_hidden_size), s),
        "proj_down": normal((cfg.out_hidden_size, cfg.out_hidden_size),
                            1.0 / math.sqrt(cfg.out_hidden_size)),
        "layers": [layer() for _ in range(cfg.num_layers)],
    }


def patchify(cfg: VisionConfig, image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float in [0, 1] -> [num_patches, patch_dim], patches in
    row-major order, each flattened as (row, column, channel)."""
    p = cfg.patch_size
    n = cfg.image_size // p
    x = image.reshape(n, p, n, p, 3)
    return x.permute(0, 2, 1, 3, 4).reshape(n * n, 3 * p * p)


def _attn(lp: Params, cfg: VisionConfig, x: torch.Tensor) -> torch.Tensor:
    S = x.shape[0]
    hd = cfg.hidden_size // cfg.num_heads
    qkv = (x @ lp["wqkv"]).reshape(S, 3, cfg.num_heads, hd)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    scores = torch.einsum("shd,thd->hst", q, k).float() / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1)   # bidirectional: no causal mask
    out = torch.einsum("hst,thd->shd", w, v.float())
    return out.reshape(S, cfg.hidden_size).to(x.dtype) @ lp["wo"]


def encode(params: Params, cfg: VisionConfig, image: torch.Tensor) -> torch.Tensor:
    """[image_size, image_size, 3] -> projected patch features
    [num_patches, out_hidden_size] (the language model's soft tokens)."""
    x = patchify(cfg, image).to(cfg.dtype) @ params["patch_embed"]
    x = x + params["pos_embed"]
    for lp in params["layers"]:
        x = x + _attn(lp, cfg, rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps))
        hmid = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        x = x + F.gelu((hmid @ lp["w_up"]).float(), approximate="tanh").to(x.dtype) @ lp["w_down"]
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    h = F.gelu((x @ params["proj_up"]).float(), approximate="tanh").to(cfg.dtype)
    return h @ params["proj_down"]
