"""Encoder cache: content-addressed LRU of vision embeddings.

Counterpart of the reference's llm/encoder_cache.py: maps image content
hashes to the tower's output features (host float32 arrays) with
byte-capacity LRU eviction, so a repeated image (multi-turn chat, shared
system imagery) never runs the vision tower again. Single-threaded by
design: the engine touches it from its step thread only.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np


def content_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:32]


class EncoderCacheManager:
    def __init__(self, capacity_bytes: int = 1 << 30):
        self.capacity_bytes = capacity_bytes
        self._data: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[np.ndarray]:
        arr = self._data.get(key)
        if arr is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return arr

    def set(self, key: str, arr: np.ndarray) -> None:
        if key in self._data:
            self._data.move_to_end(key)
            return
        if arr.nbytes > self.capacity_bytes:
            return  # larger than the whole cache: never admitted
        while self._bytes + arr.nbytes > self.capacity_bytes and self._data:
            _, old = self._data.popitem(last=False)
            self._bytes -= old.nbytes
        self._data[key] = arr
        self._bytes += arr.nbytes

    def __len__(self) -> int:
        return len(self._data)

    @property
    def used_bytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        return {"entries": len(self._data), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses}
