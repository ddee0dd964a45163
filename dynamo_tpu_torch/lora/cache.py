"""LoRA adapter sources + local cache: the port's own copy of the
reference's dynamo_tpu/lora/cache.py (numpy and files).

Adapters are fetched from a source URI into a content-keyed local cache
directory, then loaded as per-layer weight stacks for the adapter table
(lora/adapters.py).

On-disk adapter format (a repack of the HF PEFT layout): one ``.npz``
with arrays ``<target>.A`` [L, in, r] and ``<target>.B`` [L, r, out], plus
optional scalars ``alpha`` and ``rank``. ``from_peft_dir`` converts a HF
PEFT checkpoint (adapter_model.safetensors + adapter_config.json) into this
layout so public adapters load directly.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

from ..engine.safetensors_io import read_safetensors

log = logging.getLogger("dynamo_tpu_torch.lora.cache")

# the cache directory's environment override (the reference's name)
ENV_LORA_CACHE = "DTPU_LORA_CACHE"


class LoRACache:
    """Content-keyed local cache directory (cache.rs analog)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            ENV_LORA_CACHE, os.path.expanduser("~/.cache/dynamo_tpu_torch/lora")
        )
        os.makedirs(self.root, exist_ok=True)

    @staticmethod
    def uri_to_key(uri: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", uri.rstrip("/").rsplit("/", 1)[-1])
        digest = hashlib.sha256(uri.encode()).hexdigest()[:12]
        return f"{safe}-{digest}"

    def path_for(self, uri: str) -> str:
        return os.path.join(self.root, self.uri_to_key(uri) + ".npz")

    def is_cached(self, uri: str) -> bool:
        return os.path.exists(self.path_for(uri))


class LocalLoRASource:
    """file:// / plain-path source (source.rs LocalLoRASource analog; remote
    object-store sources plug in behind the same fetch(uri)->path surface)."""

    def fetch(self, uri: str, cache: LoRACache) -> str:
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        if os.path.isdir(path):
            out = cache.path_for(uri)
            if not os.path.exists(out):
                from_peft_dir(path, out)
            return out
        if not os.path.exists(path):
            raise FileNotFoundError(f"lora adapter not found: {path}")
        if path.endswith(".npz"):
            out = cache.path_for(uri)
            if not os.path.exists(out):
                shutil.copyfile(path, out)
            return out
        raise ValueError(f"unsupported lora artifact {path!r} (need .npz or PEFT dir)")


def load_adapter(path: str) -> Tuple[Dict[str, np.ndarray], Optional[float]]:
    """.npz -> ({"<target>.A"/"<target>.B": array}, alpha)."""
    with np.load(path, allow_pickle=False) as z:
        weights = {k: z[k] for k in z.files if k.endswith((".A", ".B"))}
        alpha = float(z["alpha"]) if "alpha" in z.files else None
    if not weights:
        raise ValueError(f"{path}: no <target>.A/<target>.B arrays")
    return weights, alpha


_PEFT_NAME_MAP = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}


def from_peft_dir(peft_dir: str, out_path: str) -> str:
    """Convert a HF PEFT adapter directory into the stacked .npz layout.

    Reads adapter_config.json (r, lora_alpha) and the safetensors/bin weight
    file with keys like
    ``base_model.model.model.layers.<i>.self_attn.q_proj.lora_A.weight``
    ([r, in] — transposed into [in, r] here; lora_B [out, r] -> [r, out])."""
    cfg_path = os.path.join(peft_dir, "adapter_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    alpha = float(cfg.get("lora_alpha", cfg.get("r", 16)))

    tensors: Dict[str, np.ndarray] = {}
    st_path = os.path.join(peft_dir, "adapter_model.safetensors")
    if os.path.exists(st_path):
        # the port's own reader (no safetensors package needed)
        tensors = {k: v.float().numpy()
                   for k, v in read_safetensors(st_path, device="cpu")}
    else:
        import torch

        bin_path = os.path.join(peft_dir, "adapter_model.bin")
        for k, v in torch.load(bin_path, map_location="cpu", weights_only=True).items():
            tensors[k] = v.float().numpy()

    pat = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_([AB])\.weight")
    per: Dict[Tuple[str, str], Dict[int, np.ndarray]] = {}
    for key, w in tensors.items():
        m = pat.search(key)
        if not m:
            continue
        li, proj, ab = int(m.group(1)), m.group(2), m.group(3)
        tgt = _PEFT_NAME_MAP.get(proj)
        if tgt is None:
            continue
        per.setdefault((tgt, ab), {})[li] = np.asarray(w, np.float32)

    out: Dict[str, np.ndarray] = {"alpha": np.float32(alpha)}
    n_layers = 1 + max((max(d) for d in per.values()), default=0)
    for (tgt, ab), d in per.items():
        sample = next(iter(d.values()))
        stack = np.zeros((n_layers, *sample.shape), np.float32)
        for li, w in d.items():
            stack[li] = w
        if ab == "A":      # [L, r, in] -> [L, in, r]
            out[f"{tgt}.A"] = stack.transpose(0, 2, 1)
        else:              # [L, out, r] -> [L, r, out]
            out[f"{tgt}.B"] = stack.transpose(0, 2, 1)
    if len(out) <= 1:
        raise ValueError(f"{peft_dir}: no recognizable lora_A/lora_B tensors")
    np.savez(out_path, **out)
    log.info("converted PEFT adapter %s -> %s", peft_dir, out_path)
    return out_path
