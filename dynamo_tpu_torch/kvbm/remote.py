"""G4 remote KV block tier: a shared content-addressed block store.

The port's copy of the reference package's kvbm/remote.py. A standalone
block-store service that many workers share, so that a prefix one worker
prefilled can be onboarded by every other worker of the fleet, even after
it fell out of their local tiers.

Protocol (framed TCP: a ``!II`` header of (header length, payload length),
a MessagePack header through the port's byte-identical runtime/codec.py,
then the raw block payload; the reference's frames byte for byte, so a
port client talks to a reference store and back). The sockets block: tier
calls run on the engine's offload thread, never on the event loop.

    {op: "store", hash: H, shape: [...], dtype: "bfloat16"} + payload
    {op: "get", hash: H}        -> {ok, shape, dtype} + payload
    {op: "has", hashes: [...]}  -> {have: [bool, ...]}
    {op: "stats"}               -> {blocks, bytes, hits, misses}

A bf16 block travels under the name ``bfloat16`` as the reference's does;
the port holds it as its 16-bit patterns (kvbm/layout.BF16_BITS). The
server (``python -m dynamo_tpu_torch.kvbm``) keeps an LRU bounded by bytes,
optionally with the payloads on disk (a RAM index over disk payloads).
"""

from __future__ import annotations

import asyncio
import os
import socket
import struct
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..runtime import codec
from ..runtime.logging import get_logger
from .layout import dtype_from_name, dtype_name

log = get_logger("kvbm.remote")

_HDR = struct.Struct("!II")  # (header_len, payload_len)


def _pack(obj: dict, payload: bytes = b"") -> bytes:
    head = codec.packb(obj)
    return _HDR.pack(len(head), len(payload)) + head + payload


async def _read_frame(reader: asyncio.StreamReader):
    raw = await reader.readexactly(_HDR.size)
    hlen, plen = _HDR.unpack(raw)
    head = codec.unpackb(await reader.readexactly(hlen))
    payload = await reader.readexactly(plen) if plen else b""
    return head, payload


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionError("remote block store closed connection")
        got += k
    return bytes(buf)


class RemoteBlockStoreServer:
    """The shared G4 service: a content-addressed LRU of KV blocks."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0, capacity_bytes: int = 1 << 31,
                 disk_path: Optional[str] = None):
        self.host = host
        self.port = port
        self.capacity_bytes = capacity_bytes
        self.disk_path = disk_path
        if disk_path:
            os.makedirs(disk_path, exist_ok=True)
        # hash -> (shape, dtype, payload or None when on disk, nbytes)
        self._blocks: OrderedDict[int, tuple] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()

    # -- storage -------------------------------------------------------------
    def _disk_file(self, h: int) -> str:
        return os.path.join(self.disk_path, f"{h:016x}.kv")

    def _evict_until(self, needed: int) -> None:
        while self._bytes + needed > self.capacity_bytes and self._blocks:
            victim, (_, _, _, nbytes) = self._blocks.popitem(last=False)
            self._bytes -= nbytes
            if self.disk_path:
                try:
                    os.unlink(self._disk_file(victim))
                except FileNotFoundError:
                    pass

    def _store(self, h: int, shape, dtype: str, payload: bytes) -> None:
        if h in self._blocks:
            self._blocks.move_to_end(h)
            return
        self._evict_until(len(payload))
        if self.disk_path:
            tmp = self._disk_file(h) + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, self._disk_file(h))
            self._blocks[h] = (shape, dtype, None, len(payload))
        else:
            self._blocks[h] = (shape, dtype, payload, len(payload))
        self._bytes += len(payload)

    def _get(self, h: int):
        entry = self._blocks.get(h)
        if entry is None:
            self.misses += 1
            return None
        self._blocks.move_to_end(h)
        shape, dtype, payload, nbytes = entry
        if payload is None:
            try:
                with open(self._disk_file(h), "rb") as f:
                    payload = f.read()
            except FileNotFoundError:
                self._blocks.pop(h, None)
                self._bytes -= nbytes
                self.misses += 1
                return None
        self.hits += 1
        return shape, dtype, payload

    # -- wire ----------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        try:
            while True:
                try:
                    head, payload = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                op = head.get("op")
                if op == "store":
                    self._store(head["hash"], head["shape"], head["dtype"], payload)
                    writer.write(_pack({"ok": True}))
                elif op == "get":
                    got = self._get(head["hash"])
                    if got is None:
                        writer.write(_pack({"ok": False}))
                    else:
                        shape, dtype, data = got
                        writer.write(_pack({"ok": True, "shape": list(shape), "dtype": dtype},
                                           data))
                elif op == "has":
                    writer.write(_pack({"have": [h in self._blocks for h in head["hashes"]]}))
                elif op == "stats":
                    writer.write(_pack({"blocks": len(self._blocks), "bytes": self._bytes,
                                        "hits": self.hits, "misses": self.misses}))
                else:
                    writer.write(_pack({"ok": False, "error": f"bad op {op!r}"}))
                await writer.drain()
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            writer.close()

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("remote block store listening on %s:%d", self.host, self.port)
        return f"{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # wait_closed() waits for every connection handler, and pooled
            # clients hold their connections open: cancel the handlers
            for t in list(self._conn_tasks):
                t.cancel()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass


class RemoteBlockPool:
    """The G4 client inside KvbmTiers: a blocking socket per calling
    thread, reconnect on error, disabled (every call a miss) after
    ``max_failures`` failures in a row."""

    def __init__(self, address: str, timeout_s: float = 5.0, max_failures: int = 3):
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.timeout_s = timeout_s
        self.max_failures = max_failures
        self._failures = 0
        self._local = threading.local()
        self._all_socks: set = set()   # every live socket across threads
        self._socks_lock = threading.Lock()
        self.disabled = False

    # -- sockets -------------------------------------------------------------
    def _sock(self) -> socket.socket:
        s = getattr(self._local, "sock", None)
        if s is None:
            s = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._socks_lock:
                if self.disabled:   # close() raced us: leak no live connection
                    s.close()
                    raise ConnectionError("remote block pool closed")
                self._all_socks.add(s)
            self._local.sock = s
        return s

    def _drop_sock(self) -> None:
        s = getattr(self._local, "sock", None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
            with self._socks_lock:
                self._all_socks.discard(s)
            self._local.sock = None

    def close(self) -> None:
        """Close every socket this pool opened, across all threads (a
        store's ``stop`` waits for its clients to drop their connections)."""
        with self._socks_lock:
            self.disabled = True
            socks, self._all_socks = self._all_socks, set()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)   # wakes a recv blocked elsewhere
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def _call(self, obj: dict, payload: bytes = b""):
        if self.disabled:
            return None
        try:
            s = self._sock()
            s.sendall(_pack(obj, payload))
            hlen, plen = _HDR.unpack(_recv_exact(s, _HDR.size))
            head = codec.unpackb(_recv_exact(s, hlen))
            data = _recv_exact(s, plen) if plen else b""
            self._failures = 0
            return head, data
        except (OSError, ConnectionError) as e:
            self._drop_sock()
            self._failures += 1
            if self._failures >= self.max_failures:
                self.disabled = True
                log.warning("remote block store unreachable (%r); G4 disabled", e)
            return None

    # -- tier interface ------------------------------------------------------
    def __contains__(self, h: int) -> bool:
        got = self._call({"op": "has", "hashes": [int(h)]})
        return bool(got and got[0]["have"][0])

    def contains_many(self, hashes: List[int]) -> List[bool]:
        got = self._call({"op": "has", "hashes": [int(h) for h in hashes]})
        return got[0]["have"] if got else [False] * len(hashes)

    def store(self, h: int, block: np.ndarray) -> None:
        block = np.ascontiguousarray(block)
        self._call({"op": "store", "hash": int(h), "shape": list(block.shape),
                    "dtype": dtype_name(block.dtype)},
                   block.tobytes())

    def get(self, h: int) -> Optional[np.ndarray]:
        got = self._call({"op": "get", "hash": int(h)})
        if not got or not got[0].get("ok"):
            return None
        head, data = got
        return np.frombuffer(data, dtype_from_name(head["dtype"])).reshape(head["shape"]).copy()

    def stats(self) -> Dict[str, int]:
        got = self._call({"op": "stats"})
        return got[0] if got else {}
