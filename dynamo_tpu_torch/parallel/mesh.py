"""The layout of a tensor-parallel (TP) group: each rank's device, which
part of every parameter and cache it holds, and its model config.

Counterpart of the reference's parallel/mesh.py (``param_specs_llama``)
and models/registry.py (``kv_cache_spec`` / ``kv_scale_spec``). Where the
reference names a ``PartitionSpec`` per array and lets GSPMD place the
shards over its ``tp`` mesh axis, a PyTorch TP group is one process per
rank (runtime/multihost.py), and each rank takes its own part:
``shard(x, dim, rank, tp)`` cuts dimension ``dim`` into ``tp`` equal
contiguous parts and keeps part ``rank``, which is what ``NamedSharding``
puts on the mesh's device ``rank``. A dimension of ``None`` is replicated.

The dense llama family (Llama, Qwen2's qkv biases, Qwen3's qk-norm) in
Megatron's layout, as the reference's:

- column-parallel, the output dimension sharded: ``wq``, ``wk``, ``wv``,
  ``w_gate``, ``w_up``, and the biases ``bq``, ``bk``, ``bv`` with their
  heads;
- row-parallel, the input dimension sharded and the partial products
  summed after (an all-reduce): ``wo``, ``w_down``;
- the embedding sharded on hidden, ``lm_head`` on the vocabulary; the
  norms replicated;
- the paged KV cache ``[num_blocks, block_size, kv_heads, head_dim]`` on
  its kv heads, and the int8 cache's ``[num_blocks, kv_heads]`` scale rows
  on their kv-head dimension with it.

Where the kv heads do not divide by ``tp`` the reference keeps the cache
whole and falls back to its plain attention; the port refuses instead
(``ValueError``), as it does every other shape that does not divide.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..device import DeviceLike

# where the combinations a TP group does not serve yet are queued
QUEUE = "ROADMAP.md Queue 1 item 6"

# parameter -> its sharded dimension (absent: replicated)
TOP_DIMS = {"embed": 1, "lm_head": 1}
LAYER_DIMS = {
    "wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1,
    "bq": 0, "bk": 0, "bv": 0,
    "wo": 0, "w_down": 0,
}
KV_CACHE_DIM = 2   # [num_blocks, block_size, kv_heads, head_dim]
KV_SCALE_DIM = 1   # [num_blocks, kv_heads]


def rank_device(rank: int, device: DeviceLike = None) -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % device_count}`` when the
    caller asks for CUDA (``None`` or ``"cuda"``; ranks share cards when
    there are fewer cards than ranks), else the device asked for
    (``"cpu"``, or an explicit ``cuda:N``)."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "the plain PyTorch path on the CPU")
        return torch.device(f"cuda:{rank % torch.cuda.device_count()}")
    return torch.device(device)


def shard(x: Any, dim: Optional[int], rank: int, tp: int) -> Any:
    """Rank ``rank``'s part of ``x`` (a numpy array or a tensor): a view of
    the ``rank``-th of ``tp`` equal contiguous slices of dimension ``dim``;
    ``x`` itself when ``dim`` is None or ``tp`` is 1."""
    if dim is None or tp == 1:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"dimension {dim} of size {n} does not divide by tp={tp} "
                         f"({QUEUE})")
    size = n // tp
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(rank * size, (rank + 1) * size)
    return x[tuple(index)]


def param_dim(name: str, layer: bool) -> Optional[int]:
    """The sharded dimension of a top-level (``layer`` False) or per-layer
    parameter, None when it is replicated."""
    return (LAYER_DIMS if layer else TOP_DIMS).get(name)


def check_tp(cfg, tp: int) -> None:
    """Refuse a model whose heads, kv heads, FFN width, hidden size or
    vocabulary does not divide by ``tp`` (the reference would replicate a
    non-dividing cache; the port does not serve that yet)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    for field in ("num_heads", "num_kv_heads", "intermediate_size", "hidden_size",
                  "vocab_size"):
        n = getattr(cfg, field)
        if n % tp:
            raise ValueError(f"the model's {field} ({n}) does not divide by tp={tp}: "
                             f"such a TP layout is queued in {QUEUE}")


def local_config(cfg, tp: int):
    """The config one rank computes with: its ``num_heads / tp`` query heads
    over ``num_kv_heads / tp`` kv heads and ``intermediate_size / tp`` FFN
    columns; hidden size and vocabulary stay the model's."""
    if tp == 1:
        return cfg
    check_tp(cfg, tp)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)


def _kv_shard(x: Any, dim: int, cfg, rank: int, tp: int) -> Any:
    if tp > 1 and cfg.num_kv_heads % tp:
        raise ValueError(f"{cfg.num_kv_heads} kv heads do not divide by tp={tp}: a "
                         f"replicated cache is queued in {QUEUE}")
    return shard(x, dim, rank, tp)


def kv_cache_shard(x: Any, cfg, rank: int, tp: int) -> Any:
    """Rank ``rank``'s part of a whole paged cache ``[num_blocks,
    block_size, kv_heads, head_dim]``: its kv heads."""
    return _kv_shard(x, KV_CACHE_DIM, cfg, rank, tp)


def kv_scale_shard(x: Any, cfg, rank: int, tp: int) -> Any:
    """Rank ``rank``'s part of an int8 cache's ``[num_blocks, kv_heads]``
    scale rows: the kv heads of its pages."""
    return _kv_shard(x, KV_SCALE_DIM, cfg, rank, tp)
