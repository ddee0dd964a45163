"""Int8 paged-KV quantization: the storage format and its numerics.

Counterpart of the reference package's ops/quant.py, bit for bit: the same
functions on the same float32 input give the same int8 payload and the same
float32 scales (``torch.round`` rounds half to even, as ``jnp.rint``).

Format, shared by the device cache, the attention kernels and the KVBM
block codec (kvbm/layout.QuantizedBlockCodec):

    payload : int8  [..., block_size, kv_heads, head_dim]
    scale   : f32   [..., kv_heads]      (amax over the block's positions
                                          and head_dim, divided by 127)

Quantization is symmetric round-to-nearest: q = rint(x / scale) in
[-127, 127]; dequant = q * scale. A fresh block (``quantize_blocks``) has
max|q| == 127, so dequantize -> requantize reproduces (payload, scale)
bit-exactly; int8 <-> int8 moves (KVBM offload and onboard) ship the pair
untouched and are bit-exact always.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Tuple

import numpy as np
import torch

# dtype of the per-block-per-kv-head scale rows everywhere (device, KVBM
# codec): int8 payload + f32 scales is the whole format
SCALE_DTYPE = np.dtype(np.float32)
KV_DTYPES = ("model", "int8")


def resolve_kv_dtype(value: str) -> str:
    """Resolve a config ``kv_dtype`` to one of KV_DTYPES. ``auto`` defers to
    the DTPU_KV_DTYPE env (default: the model dtype)."""
    v = (value or "auto").lower()
    if v == "auto":
        v = os.environ.get("DTPU_KV_DTYPE", "model").lower() or "model"
    if v in ("none", "float", "fp", "cache"):
        v = "model"
    if v not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {value!r} (DTPU_KV_DTYPE?): expected one of "
            f"{KV_DTYPES} or 'auto'"
        )
    return v


@dataclasses.dataclass
class QuantizedKV:
    """One paged KV cache array quantized to int8 + per-block scales.

    data  : int8 [num_blocks, block_size, kv_heads, head_dim]
    scale : f32  [num_blocks, kv_heads]

    ``.shape``/``.dtype`` mirror the payload, so shape-probing call sites
    (``k_cache.shape[1]`` for block_size) read the same as on a raw cache.
    """

    data: Any
    scale: Any

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype


def is_quantized(cache: Any) -> bool:
    return isinstance(cache, QuantizedKV)


# ------------------------------------------------------------ torch versions
def quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., bs, kvh, d] float -> (int8 payload, f32 scale [..., kvh]).

    amax reduces over the block's positions AND head_dim (one scale per kv
    head per block); an all-zero block gets scale 0 and payload 0, and
    dequantizes to exact zeros."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-3, -1))                        # [..., kvh]
    scale = amax / 127.0
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv[..., None, :, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8 [..., bs, kvh, d], f32 [..., kvh]) -> f32 [..., bs, kvh, d]."""
    return q.float() * scale[..., None, :, None]


def requantize_token(
    blk_q: torch.Tensor,      # int8 [..., bs, kvh, d] current block contents
    blk_scale: torch.Tensor,  # f32  [..., kvh] current block scale
    x_new: torch.Tensor,      # [..., kvh, d] the one new row (float)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode-write numerics: grow the block scale to cover the new row and
    rescale the existing ints once (ratio <= 1; when the scale is unchanged,
    the common case, ratio == 1 and the rescale is a bit-exact no-op).
    Returns (rescaled block ints, new scale, the new row quantized)."""
    a_new = x_new.float().abs().amax(dim=-1)                   # [..., kvh]
    s_new = torch.maximum(blk_scale, a_new / 127.0)
    inv = torch.where(s_new > 0, 1.0 / s_new, torch.zeros_like(s_new))
    ratio = blk_scale * inv                                    # <= 1
    blk = torch.round(blk_q.float() * ratio[..., None, :, None]).to(torch.int8)
    q_new = torch.clamp(torch.round(x_new.float() * inv[..., None]), -127.0, 127.0)
    return blk, s_new, q_new.to(torch.int8)


# --------------------------------------------------------------- np mirrors
def quantize_blocks_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side mirror of quantize_blocks (same formula, same rounding)."""
    xf = np.asarray(x, np.float32)
    amax = np.max(np.abs(xf), axis=(-3, -1))
    scale = (amax / 127.0).astype(np.float32)
    inv = np.where(scale > 0, 1.0 / scale, 0.0).astype(np.float32)
    q = np.clip(np.rint(xf * inv[..., None, :, None]), -127.0, 127.0).astype(np.int8)
    return q, scale


def dequantize_blocks_np(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scale, np.float32)[..., None, :, None]
