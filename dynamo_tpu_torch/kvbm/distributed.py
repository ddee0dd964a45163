"""Distributed KVBM: a fleet of G4 block stores behind one pool interface.

The port's copy of the reference package's kvbm/distributed.py. N stores
each hold a consistent-hash shard of the content-addressed block space.
Membership is live: stores register in the discovery store under
``v1/kvbm/{namespace}/`` with a lease, and every client watches that
prefix, so a crashed store drops out of the ring at lease expiry and an
added one takes its shard over at once.

Churn costs no correctness: blocks are content-addressed, a re-routed
lookup that misses recomputes the prefill (as on every tier), and
write-through fills a new owner on first use.

The ring gives each member ``VNODES`` virtual nodes (blake2b points), so
shards stay even in a small fleet; a key lands on the same member as the
reference's ring for the same membership.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import threading
from typing import Dict, List, Optional

import numpy as np

from ..runtime.discovery.store import EventType, KVStore
from ..runtime.logging import get_logger
from .remote import RemoteBlockPool

log = get_logger("kvbm.distributed")

VNODES = 64


def fleet_key(namespace: str, address: str) -> str:
    return f"v1/kvbm/{namespace}/{address}"


def fleet_prefix(namespace: str) -> str:
    return f"v1/kvbm/{namespace}/"


async def register_store(store: KVStore, namespace: str, address: str,
                         lease_id: Optional[str]) -> None:
    """Store side: announce this block store's address under a lease."""
    await store.put_obj(fleet_key(namespace, address), {"address": address}, lease_id)


class HashRing:
    def __init__(self):
        self._points: List[int] = []
        self._owner: Dict[int, str] = {}

    @staticmethod
    def _point(s: str) -> int:
        return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")

    def add(self, address: str) -> None:
        for v in range(VNODES):
            p = self._point(f"{address}#{v}")
            if p not in self._owner:
                bisect.insort(self._points, p)
                self._owner[p] = address

    def remove(self, address: str) -> None:
        for v in range(VNODES):
            p = self._point(f"{address}#{v}")
            if self._owner.get(p) == address:
                del self._owner[p]
                i = bisect.bisect_left(self._points, p)
                if i < len(self._points) and self._points[i] == p:
                    del self._points[i]

    def owner(self, h: int) -> Optional[str]:
        if not self._points:
            return None
        # mix the key before placement: structured keys must not all land
        # in one segment
        p = self._point(str(int(h)))
        i = bisect.bisect_right(self._points, p) % len(self._points)
        return self._owner[self._points[i]]

    def members(self) -> List[str]:
        return sorted(set(self._owner.values()))


class DistributedBlockPool:
    """A drop-in for RemoteBlockPool (the same tier interface), sharded
    over the live fleet; pass it to ``KvbmTiers(remote=...)``."""

    def __init__(self, store: KVStore, namespace: str = "dynamo"):
        self._store = store
        self.namespace = namespace
        self._ring = HashRing()
        self._pools: Dict[str, RemoteBlockPool] = {}
        self._lock = threading.Lock()
        self._watch_task: Optional[asyncio.Task] = None
        self._watcher = None
        self.disabled = False   # interface parity with RemoteBlockPool

    async def start(self) -> "DistributedBlockPool":
        watcher = await self._store.watch(fleet_prefix(self.namespace))

        async def consume() -> None:
            async for ev in watcher:
                addr = ev.key.rsplit("/", 1)[-1]
                with self._lock:
                    if ev.type is EventType.PUT:
                        if addr not in self._pools:
                            log.info("kvbm fleet: + %s", addr)
                            self._ring.add(addr)
                            self._pools[addr] = RemoteBlockPool(addr)
                    else:
                        log.info("kvbm fleet: - %s", addr)
                        self._ring.remove(addr)
                        pool = self._pools.pop(addr, None)
                        if pool is not None:
                            pool.close()

        self._watch_task = asyncio.create_task(consume())
        self._watcher = watcher
        return self

    async def stop(self) -> None:
        if self._watch_task is not None:
            self._watcher.cancel()
            self._watch_task.cancel()
        # close the member clients' sockets, so that the stores' stop()
        # does not wait on them
        with self._lock:
            pools = list(self._pools.values())
        for p in pools:
            p.close()

    # -- tier interface ------------------------------------------------------
    def _pool_for(self, h: int) -> Optional[RemoteBlockPool]:
        with self._lock:
            addr = self._ring.owner(int(h))
            return self._pools.get(addr) if addr else None

    def __contains__(self, h: int) -> bool:
        p = self._pool_for(h)
        return bool(p and h in p)

    def contains_many(self, hashes: List[int]) -> List[bool]:
        # one batched query per owner
        by_pool: Dict[int, List[int]] = {}
        pools: Dict[int, RemoteBlockPool] = {}
        for i, h in enumerate(hashes):
            p = self._pool_for(h)
            if p is None:
                continue
            by_pool.setdefault(id(p), []).append(i)
            pools[id(p)] = p
        out = [False] * len(hashes)
        for pid, idxs in by_pool.items():
            have = pools[pid].contains_many([int(hashes[i]) for i in idxs])
            for i, got in zip(idxs, have):
                out[i] = bool(got)
        return out

    def store(self, h: int, block: np.ndarray) -> None:
        p = self._pool_for(h)
        if p is not None:
            p.store(h, block)

    def get(self, h: int) -> Optional[np.ndarray]:
        p = self._pool_for(h)
        return p.get(h) if p is not None else None

    def members(self) -> List[str]:
        with self._lock:
            return self._ring.members()
