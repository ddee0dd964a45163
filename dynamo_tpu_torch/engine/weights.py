"""Parameters from host arrays.

``params_from_numpy`` turns the reference package's parameter pytree, as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's side),
into the port's parameter dictionary: the layouts are identical (weights
``[in, out]``), so each array only changes framework, device and dtype.
Loading HF checkpoints comes with the slice that has real weights to load.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import registry
from ..models.llama import LlamaConfig, Params

_TOP = ("embed", "final_norm", "lm_head")


def _tensor(arr: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch.from_numpy mapping; the widening
        # to float32 is exact
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def params_from_numpy(
    tree: Dict[str, Any], cfg: LlamaConfig, device: DeviceLike = None
) -> Params:
    """Reference pytree of numpy arrays -> port params on ``device`` in
    ``cfg.dtype``. Each family has its own layer keys (gemma: the sandwich
    norms). Unknown keys raise: a parameter this port does not use must not
    be dropped silently."""
    device = resolve_device(device)
    unknown = set(tree) - set(_TOP) - {"layers"}
    if unknown:
        raise ValueError(f"unknown top-level parameters {sorted(unknown)}")
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(
            f"{len(tree['layers'])} layers in the tree, config has {cfg.num_layers}"
        )
    out: Params = {
        name: _tensor(tree[name], cfg.dtype, device) for name in _TOP if name in tree
    }
    layer_keys = set(registry.layer_keys(cfg))
    layers = []
    for i, lp in enumerate(tree["layers"]):
        bad = set(lp) - layer_keys
        if bad:
            raise ValueError(f"layer {i}: unknown parameters {sorted(bad)}")
        layers.append({name: _tensor(w, cfg.dtype, device) for name, w in lp.items()})
    out["layers"] = layers
    return out
