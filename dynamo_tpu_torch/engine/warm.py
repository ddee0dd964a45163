"""Warm weight cache: fast restarts from a host-local copy of the weights.

Counterpart of the reference's engine/warm.py (``WarmWeightCache``,
``load_params_warm``). The first start parses the HF checkpoint (shards,
dtype casts, transposes, MXFP4 dequant) and writes every resulting tensor
as raw bytes into one directory keyed by a fingerprint, with a JSON
manifest of name, dtype and shape; a restart maps those files and copies
the bytes straight to the device. The format is the port's own: raw
bytes need no numpy dtype, so bf16 needs no ``ml_dtypes``.

The fingerprint covers the checkpoint path and its mtime, the config's
repr, the layout version and the package name, so the reference's cache
and this one never read each other's entries, even under one root. The
root is ``root``, else ``$DTPU_WARM_CACHE`` (as the reference), else
``~/.cache/dynamo_tpu_torch/warm``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import mmap
import os
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from .safetensors_io import tensor_from_buffer
from .weights import load_params

log = logging.getLogger("dynamo_tpu_torch.engine.warm")

PACKAGE = "dynamo_tpu_torch"

# bump when the parameter layout changes (key names, shapes, dtypes), so
# entries written by older code are missed instead of loaded wrong
PARAM_LAYOUT_VERSION = 1

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
    torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)}


def default_root() -> str:
    return os.environ.get("DTPU_WARM_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", PACKAGE, "warm")


def fingerprint(source: str, cfg: Any) -> str:
    """Cache key: checkpoint path, its mtime, the config's repr, the layout
    version and the package name."""
    try:
        mtime = str(os.path.getmtime(source))
    except OSError:
        mtime = "0"
    blob = json.dumps([source, mtime, repr(cfg), PARAM_LAYOUT_VERSION, PACKAGE],
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class WarmWeightCache:
    def __init__(self, root: Optional[str] = None):
        self.root = root or default_root()
        os.makedirs(self.root, exist_ok=True)

    def _dir(self, source: str, cfg: Any) -> str:
        return os.path.join(self.root, fingerprint(source, cfg))

    def has(self, source: str, cfg: Any) -> bool:
        return os.path.exists(os.path.join(self._dir(source, cfg), "MANIFEST.json"))

    def save(self, source: str, cfg: Any, params: Dict[str, Any]) -> str:
        """One raw-bytes file per tensor and a manifest. The manifest lands
        last (write, then rename), so a crashed save is a miss, not a
        half-hit."""
        d = self._dir(source, cfg)
        os.makedirs(d, exist_ok=True)
        manifest = []
        for name, t in _flatten(params).items():
            fname = name.replace("/", "__") + ".bin"
            tmp = os.path.join(d, f"{fname}.tmp{os.getpid()}")
            host = t.detach().contiguous().cpu()
            with open(tmp, "wb") as f:
                if host.numel():
                    f.write(host.reshape(-1).view(torch.uint8).numpy().tobytes())
            os.replace(tmp, os.path.join(d, fname))
            manifest.append({"name": name, "file": fname,
                             "dtype": str(host.dtype).removeprefix("torch."),
                             "shape": list(host.shape)})
        tmp = os.path.join(d, f"MANIFEST.json.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"key": os.path.basename(d), "package": PACKAGE, "tensors": manifest}, f)
        os.replace(tmp, os.path.join(d, "MANIFEST.json"))
        log.info("warm cache saved: %s (%d tensors)", d, len(manifest))
        return d

    def load(self, source: str, cfg: Any, device: DeviceLike = None) -> Optional[Dict[str, Any]]:
        """The cached parameters on ``device``, or None on a miss or an
        unreadable entry (logged: that is corruption, not a miss)."""
        d = self._dir(source, cfg)
        if not os.path.exists(os.path.join(d, "MANIFEST.json")):
            return None
        try:
            return load_manifest_dir(d, device)
        except Exception:
            log.exception("warm cache at %s unreadable; loading the checkpoint", d)
            return None


def load_manifest_dir(d: str, device: DeviceLike = None) -> Dict[str, Any]:
    """Every tensor of one manifest directory, copied to ``device`` from a
    map of its file, as the parameter dictionary."""
    device = resolve_device(device)
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if manifest.get("package") != PACKAGE:
        raise ValueError(f"{d}: not an entry of this package's cache")
    flat: Dict[str, torch.Tensor] = {}
    for t in manifest["tensors"]:
        dtype = _DTYPES[t["dtype"]]
        numel = 1
        for s in t["shape"]:
            numel *= s
        nbytes = numel * dtype.itemsize
        path = os.path.join(d, t["file"])
        if os.path.getsize(path) != nbytes:
            raise ValueError(f"{path}: {os.path.getsize(path)} bytes, manifest says {nbytes}")
        if nbytes == 0:
            flat[t["name"]] = torch.empty(t["shape"], dtype=dtype, device=device)
            continue
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        try:
            flat[t["name"]] = tensor_from_buffer(mm, 0, nbytes, dtype, t["shape"], device)
        finally:
            mm.close()
    return _unflatten(flat)


def _flatten(params: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if k == "layers":
            for i, lp in enumerate(v):
                out.update(_flatten(lp, f"{prefix}layers/{i}/"))
        elif isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    layers: Dict[int, Dict[str, Any]] = {}
    for name, t in flat.items():
        parts = name.split("/")
        if parts[0] == "layers":
            layers.setdefault(int(parts[1]), {})["/".join(parts[2:])] = t
        else:
            node = params
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    if layers:
        params["layers"] = [layers[i] for i in sorted(layers)]
    return params


def load_params_warm(path: str, cfg: Any, cache: Optional[WarmWeightCache] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """``weights.load_params`` through the warm cache: a hit copies the
    cached bytes to ``device``; a miss loads the checkpoint and saves it
    (a failed save is logged and serving goes on)."""
    cache = cache or WarmWeightCache()
    cached = cache.load(path, cfg, device)
    if cached is not None:
        log.info("warm restore: weights from cache (skipping checkpoint parse)")
        return cached
    params = load_params(path, cfg, device)
    try:
        cache.save(path, cfg, params)
    except Exception:
        log.exception("warm cache save failed (serving continues)")
    return params
