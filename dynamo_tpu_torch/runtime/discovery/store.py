"""Lease-based KV store for discovery: memory and file backends.

The port's copy of the reference package's runtime/discovery/store.py,
with the port's own MessagePack codec (runtime/codec.py): records are
byte-identical to the reference's, so a store directory written by either
package reads back in the other. The file backend keeps one file per key
plus lease heartbeat files; watchers poll and synthesize PUT/DELETE
events, and keys whose lease heartbeat has gone stale are reaped as if
their owner died (etcd's lease-expiry semantics). The networked store is
discovery/netstore.py, and discovery/etcd.py speaks to a real etcd.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import os
import re
import time
import urllib.parse
import uuid
from typing import AsyncIterator, Dict, List, Optional, Tuple

from .. import codec
from ..config import default_store_path
from ..logging import get_logger

log = get_logger("runtime.discovery")

DEFAULT_LEASE_TTL_S = 10.0
_WATCH_POLL_S = 0.1
_TMP_RE = re.compile(r"\.__tmp__\.\d+\.[0-9a-f]{6}$")


class EventType(enum.Enum):
    PUT = "put"
    DELETE = "delete"


@dataclasses.dataclass
class WatchEvent:
    type: EventType
    key: str
    value: Optional[bytes]


@dataclasses.dataclass
class Lease:
    id: str
    ttl_s: float


class KVStore:
    """Interface: put/get/delete/list_prefix/watch + lease lifecycle."""

    async def put(self, key: str, value: bytes, lease_id: Optional[str] = None) -> None:
        raise NotImplementedError

    async def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    async def delete(self, key: str) -> None:
        raise NotImplementedError

    async def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        raise NotImplementedError

    async def watch(self, prefix: str) -> "Watcher":
        """Snapshot-then-stream: the watcher first yields PUT events for every
        existing key under the prefix, then live events."""
        raise NotImplementedError

    # -- leases -------------------------------------------------------------
    async def create_lease(self, ttl_s: float = DEFAULT_LEASE_TTL_S) -> Lease:
        raise NotImplementedError

    async def keep_alive(self, lease_id: str) -> bool:
        raise NotImplementedError

    async def revoke_lease(self, lease_id: str) -> None:
        """Revoking deletes every key attached to the lease (etcd semantics)."""
        raise NotImplementedError

    async def close(self) -> None:
        pass

    # convenience -----------------------------------------------------------
    async def put_obj(self, key: str, obj, lease_id: Optional[str] = None) -> None:
        await self.put(key, codec.packb(obj), lease_id)

    async def get_obj(self, key: str):
        raw = await self.get(key)
        return None if raw is None else codec.unpackb(raw)

    async def list_obj(self, prefix: str) -> Dict[str, object]:
        """``list_prefix`` with the codec's decode; keys whose bytes do not
        decode are skipped (a foreign writer under the prefix must not
        break every scan: the global KV directory's lookup path)."""
        out: Dict[str, object] = {}
        for k, raw in (await self.list_prefix(prefix)).items():
            try:
                out[k] = codec.unpackb(raw)
            except ValueError:   # CodecError, a bad utf-8 string
                continue
        return out


class Watcher:
    """Async stream of WatchEvents with explicit cancel."""

    def __init__(self):
        self._queue: asyncio.Queue = asyncio.Queue()
        self._closed = False

    def _emit(self, ev: WatchEvent) -> None:
        if not self._closed:
            self._queue.put_nowait(ev)

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self

    async def __anext__(self) -> WatchEvent:
        if self._closed and self._queue.empty():
            raise StopAsyncIteration
        ev = await self._queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev

    def cancel(self) -> None:
        self._closed = True
        self._queue.put_nowait(None)


# ---------------------------------------------------------------------------
# In-memory backend
# ---------------------------------------------------------------------------


class MemKVStore(KVStore):
    """Single-process store; watchers get events synchronously on mutation."""

    def __init__(self):
        self._data: Dict[str, Tuple[bytes, Optional[str]]] = {}
        self._leases: Dict[str, float] = {}  # lease_id -> deadline (monotonic)
        self._lease_ttl: Dict[str, float] = {}
        self._watchers: List[Tuple[str, Watcher]] = []
        self._reaper: Optional[asyncio.Task] = None

    def _notify(self, ev: WatchEvent) -> None:
        for prefix, w in list(self._watchers):
            if ev.key.startswith(prefix):
                w._emit(ev)

    async def put(self, key: str, value: bytes, lease_id: Optional[str] = None) -> None:
        self._data[key] = (value, lease_id)
        self._notify(WatchEvent(EventType.PUT, key, value))

    async def get(self, key: str) -> Optional[bytes]:
        item = self._data.get(key)
        return None if item is None else item[0]

    async def delete(self, key: str) -> None:
        if key in self._data:
            del self._data[key]
            self._notify(WatchEvent(EventType.DELETE, key, None))

    async def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        return {k: v for k, (v, _) in self._data.items() if k.startswith(prefix)}

    async def watch(self, prefix: str) -> Watcher:
        w = Watcher()
        for k, (v, _) in sorted(self._data.items()):
            if k.startswith(prefix):
                w._emit(WatchEvent(EventType.PUT, k, v))
        self._watchers.append((prefix, w))
        return w

    async def create_lease(self, ttl_s: float = DEFAULT_LEASE_TTL_S) -> Lease:
        lease_id = uuid.uuid4().hex
        self._leases[lease_id] = time.monotonic() + ttl_s
        self._lease_ttl[lease_id] = ttl_s
        if self._reaper is None or self._reaper.done():
            self._reaper = asyncio.create_task(self._reap_loop())
        return Lease(lease_id, ttl_s)

    async def keep_alive(self, lease_id: str) -> bool:
        if lease_id not in self._leases:
            return False
        self._leases[lease_id] = time.monotonic() + self._lease_ttl[lease_id]
        return True

    async def revoke_lease(self, lease_id: str) -> None:
        self._leases.pop(lease_id, None)
        self._lease_ttl.pop(lease_id, None)
        for key in [k for k, (_, lid) in self._data.items() if lid == lease_id]:
            await self.delete(key)

    async def _reap_loop(self) -> None:
        try:
            while self._leases:
                now = time.monotonic()
                expired = [lid for lid, dl in self._leases.items() if dl < now]
                for lid in expired:
                    log.debug("lease %s expired", lid[:8])
                    await self.revoke_lease(lid)
                await asyncio.sleep(0.2)
        except asyncio.CancelledError:
            pass

    async def close(self) -> None:
        if self._reaper is not None:
            self._reaper.cancel()
        for _, w in self._watchers:
            w.cancel()


# ---------------------------------------------------------------------------
# File backend (cross-process, no external services)
# ---------------------------------------------------------------------------


def _enc(key: str) -> str:
    return urllib.parse.quote(key, safe="")


def _dec(name: str) -> str:
    return urllib.parse.unquote(name)


class FileKVStore(KVStore):
    """Directory-backed store. Layout::

        <root>/keys/<urlencoded-key>    MessagePack {v: bytes, lease: str|None}
        <root>/leases/<lease_id>        MessagePack {hb: float, ttl: float}

    Liveness: a key with a lease is visible only while its lease file's
    heartbeat is fresh (hb + ttl + grace > now, wall clock — all participants
    share the host/filesystem). Watchers poll and diff.
    """

    GRACE_S = 1.0

    def __init__(self, root: str):
        self.root = root
        self._keys_dir = os.path.join(root, "keys")
        self._leases_dir = os.path.join(root, "leases")
        os.makedirs(self._keys_dir, exist_ok=True)
        os.makedirs(self._leases_dir, exist_ok=True)
        self._watch_tasks: List[asyncio.Task] = []
        self._own_leases: Dict[str, float] = {}

    # -- low level ----------------------------------------------------------
    def _write_atomic(self, path: str, data: bytes) -> None:
        tmp = f"{path}.__tmp__.{os.getpid()}.{uuid.uuid4().hex[:6]}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def _lease_alive(self, lease_id: Optional[str]) -> bool:
        if lease_id is None:
            return True
        path = os.path.join(self._leases_dir, lease_id)
        try:
            with open(path, "rb") as f:
                rec = codec.unpackb(f.read())
        except (FileNotFoundError, ValueError):
            return False
        return rec["hb"] + rec["ttl"] + self.GRACE_S > time.time()

    def _read_key(self, key: str) -> Optional[bytes]:
        path = os.path.join(self._keys_dir, _enc(key))
        try:
            with open(path, "rb") as f:
                rec = codec.unpackb(f.read())
        except (FileNotFoundError, ValueError):
            return None
        if not self._lease_alive(rec.get("lease")):
            try:
                os.unlink(path)  # reap key owned by a dead lease
            except FileNotFoundError:
                pass
            return None
        return rec["v"]

    # -- KVStore ------------------------------------------------------------
    async def put(self, key: str, value: bytes, lease_id: Optional[str] = None) -> None:
        rec = codec.packb({"v": value, "lease": lease_id})
        self._write_atomic(os.path.join(self._keys_dir, _enc(key)), rec)

    async def get(self, key: str) -> Optional[bytes]:
        return self._read_key(key)

    async def delete(self, key: str) -> None:
        try:
            os.unlink(os.path.join(self._keys_dir, _enc(key)))
        except FileNotFoundError:
            pass

    async def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        for name in os.listdir(self._keys_dir):
            # skip only our own in-flight temp files (pattern from
            # _write_atomic: "<encoded-key>.tmp.<pid>.<hex6>"), not any key
            # whose decoded name happens to contain ".tmp"
            if _TMP_RE.search(name):
                continue
            key = _dec(name)
            if key.startswith(prefix):
                val = self._read_key(key)
                if val is not None:
                    out[key] = val
        return out

    async def watch(self, prefix: str) -> Watcher:
        w = Watcher()

        async def poll() -> None:
            known: Dict[str, bytes] = {}
            try:
                while True:
                    current = await self.list_prefix(prefix)
                    for k, v in sorted(current.items()):
                        if k not in known or known[k] != v:
                            w._emit(WatchEvent(EventType.PUT, k, v))
                    for k in list(known):
                        if k not in current:
                            w._emit(WatchEvent(EventType.DELETE, k, None))
                    known = current
                    await asyncio.sleep(_WATCH_POLL_S)
            except asyncio.CancelledError:
                pass

        task = asyncio.create_task(poll())
        self._watch_tasks.append(task)
        orig_cancel = w.cancel

        def cancel() -> None:
            task.cancel()
            orig_cancel()

        w.cancel = cancel  # type: ignore[method-assign]
        return w

    async def create_lease(self, ttl_s: float = DEFAULT_LEASE_TTL_S) -> Lease:
        lease_id = uuid.uuid4().hex
        self._own_leases[lease_id] = ttl_s
        rec = codec.packb({"hb": time.time(), "ttl": ttl_s})
        self._write_atomic(os.path.join(self._leases_dir, lease_id), rec)
        return Lease(lease_id, ttl_s)

    async def keep_alive(self, lease_id: str) -> bool:
        # A lease whose heartbeat already went stale must NOT be resurrected:
        # other processes may have reaped its keys, so the owner needs to see
        # the loss (return False) and re-register, matching etcd semantics.
        path = os.path.join(self._leases_dir, lease_id)
        try:
            with open(path, "rb") as f:
                prev = codec.unpackb(f.read())
        except (FileNotFoundError, ValueError):
            self._own_leases.pop(lease_id, None)
            return False
        if prev["hb"] + prev["ttl"] + self.GRACE_S <= time.time():
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            self._own_leases.pop(lease_id, None)
            return False
        ttl = self._own_leases.get(lease_id, DEFAULT_LEASE_TTL_S)
        rec = codec.packb({"hb": time.time(), "ttl": ttl})
        self._write_atomic(path, rec)
        return True

    async def revoke_lease(self, lease_id: str) -> None:
        self._own_leases.pop(lease_id, None)
        try:
            os.unlink(os.path.join(self._leases_dir, lease_id))
        except FileNotFoundError:
            pass
        # eagerly delete keys attached to this lease
        for name in os.listdir(self._keys_dir):
            path = os.path.join(self._keys_dir, name)
            try:
                with open(path, "rb") as f:
                    rec = codec.unpackb(f.read())
            except (FileNotFoundError, ValueError):
                continue
            if rec.get("lease") == lease_id:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass

    async def close(self) -> None:
        for t in self._watch_tasks:
            t.cancel()


def make_store(kind: str, path: Optional[str] = None) -> KVStore:
    if kind == "mem":
        return MemKVStore()
    if kind == "file":
        return FileKVStore(path or default_store_path())
    if kind == "tcp":
        # networked store service (push watch, shared leases): path is
        # HOST:PORT of a `python -m dynamo_tpu_torch.runtime.discovery.netstore`
        from .netstore import TcpKVStore

        return TcpKVStore(path)
    if kind == "etcd":
        # a real etcd cluster through its v3 JSON gateway; path is the
        # client endpoint, e.g. http://etcd:2379 (discovery/etcd.py)
        from .etcd import EtcdKVStore

        return EtcdKVStore(path or "http://127.0.0.1:2379")
    raise ValueError(f"unknown store kind: {kind!r} (expected mem|file|tcp|etcd)")
