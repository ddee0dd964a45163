"""Block storage formats of the KVBM tiers.

Counterpart of the reference package's kvbm/layout.py. The LOGICAL block is
``[num_layers, 2, block_size, kv_heads, head_dim]`` (K and V per layer) in
the engine's KV storage format:

- float caches store the model dtype. numpy has no bfloat16 without
  ml_dtypes (which comes with JAX, and the port does not need), so a bf16
  block is held as its raw 16-bit patterns in a ``uint16`` array
  (``BF16_BITS``); the G3 file header still names it ``bfloat16``, so disk
  blocks stay byte-compatible with the reference's. No KV format of the
  port is uint16 otherwise.
- ``kv_dtype="int8"`` stores int8 payload + per-layer-per-K/V per-kv-head
  f32 scales, packed by ``QuantizedBlockCodec`` into ONE flat uint8 buffer,
  so every tier keeps treating a block as a single opaque byte run.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.quant import SCALE_DTYPE

# the host form of a bfloat16 array: its bit patterns
BF16_BITS = np.dtype(np.uint16)

_STORAGE = {
    torch.bfloat16: BF16_BITS,
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
}


def storage_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype of a model dtype's blocks on the host."""
    try:
        return _STORAGE[dtype]
    except KeyError:
        raise ValueError(f"no KV block storage for {dtype}") from None


def dtype_name(dtype: np.dtype) -> str:
    """The name a block's dtype goes by in G3 headers (the reference's
    ``dtype.name``): ``bfloat16`` for the port's bf16 bit patterns."""
    dtype = np.dtype(dtype)
    return "bfloat16" if dtype == BF16_BITS else dtype.name


def dtype_from_name(name: str) -> np.dtype:
    """The one name -> dtype spot for block storage (G3 headers):
    ``bfloat16`` resolves to the bit-pattern dtype ``BF16_BITS``."""
    return BF16_BITS if name == "bfloat16" else np.dtype(name)


def torch_dtype_from_name(name: str) -> torch.dtype:
    """The torch dtype of a block dtype name (a G3 header's or the KV
    transfer wire's, engine/transfer.py): ``bfloat16`` included."""
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def to_host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as its host storage array (bf16 as bit patterns)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def from_host(a: np.ndarray) -> torch.Tensor:
    """A host storage array as a CPU tensor (bit patterns back to bf16)."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16_BITS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@dataclasses.dataclass(frozen=True)
class BlockShape:
    num_layers: int
    block_size: int
    num_kv_heads: int
    head_dim: int
    dtype: np.dtype

    @property
    def logical_shape(self) -> Tuple[int, int, int, int, int]:
        return (self.num_layers, 2, self.block_size, self.num_kv_heads, self.head_dim)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.logical_shape)) * self.dtype.itemsize


def block_shape_for(mcfg, block_size: int, kv_dtype: str = "model") -> BlockShape:
    """THE constructor for KV block shapes: storage dtype from the model
    config (bf16 models store bf16 blocks), or int8 for the quantized
    cache."""
    dtype = np.dtype(np.int8) if kv_dtype == "int8" else storage_dtype(mcfg.dtype)
    return BlockShape(
        num_layers=mcfg.num_layers, block_size=block_size,
        num_kv_heads=mcfg.num_kv_heads, head_dim=mcfg.head_dim, dtype=dtype,
    )


class QuantizedBlockCodec:
    """int8 block <-> one flat uint8 buffer (payload then scales).

    Logical quantized block:
      payload [L, 2, bs, kvh, d] int8
      scales  [L, 2, kvh]        f32  (per layer, per K/V, per kv head)

    encode/decode are pure byte moves: bit-exact round trips by
    construction. ``shape.dtype`` must be int8."""

    def __init__(self, shape: BlockShape):
        assert shape.dtype == np.dtype(np.int8), shape
        self.shape = shape
        self.payload_shape = shape.logical_shape
        self.scales_shape = (shape.num_layers, 2, shape.num_kv_heads)
        self.payload_nbytes = int(np.prod(self.payload_shape))
        self.scales_nbytes = int(np.prod(self.scales_shape)) * SCALE_DTYPE.itemsize
        self.nbytes = self.payload_nbytes + self.scales_nbytes

    def encode(self, payload: np.ndarray, scales: np.ndarray) -> np.ndarray:
        """(payload [L,2,bs,kvh,d] int8, scales [L,2,kvh] f32) -> uint8 [nbytes]."""
        buf = np.empty(self.nbytes, np.uint8)
        buf[: self.payload_nbytes] = np.ascontiguousarray(
            payload.reshape(self.payload_shape).view(np.int8)
        ).view(np.uint8).reshape(-1)
        buf[self.payload_nbytes:] = np.ascontiguousarray(
            np.asarray(scales, SCALE_DTYPE).reshape(self.scales_shape)
        ).view(np.uint8).reshape(-1)
        return buf

    def decode(self, buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 [nbytes] -> (payload, scales). Zero-copy views."""
        flat = np.asarray(buf, np.uint8).reshape(-1)
        payload = flat[: self.payload_nbytes].view(np.int8).reshape(self.payload_shape)
        scales = flat[self.payload_nbytes:].view(SCALE_DTYPE).reshape(self.scales_shape)
        return payload, scales

    def decode_many(self, bufs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 [n, nbytes] -> (payload [n, L, 2, ...], scales [n, L, 2, kvh])."""
        n = bufs.shape[0]
        flat = np.ascontiguousarray(bufs, dtype=np.uint8).reshape(n, -1)
        payload = flat[:, : self.payload_nbytes].view(np.int8).reshape(
            (n,) + self.payload_shape
        )
        scales = np.ascontiguousarray(flat[:, self.payload_nbytes:]).view(
            SCALE_DTYPE
        ).reshape((n,) + self.scales_shape)
        return payload, scales


def kv_bytes_per_token(mcfg, block_size: int, kv_dtype: str = "model") -> float:
    """KV bytes one token occupies in the paged cache: the same number for
    device memory and a KVBM tier block, since both store the identical
    format. int8 amortizes the per-block scale rows over block_size
    positions."""
    shape = block_shape_for(mcfg, block_size, kv_dtype)
    if kv_dtype == "int8":
        return QuantizedBlockCodec(shape).nbytes / block_size
    return shape.nbytes / block_size
