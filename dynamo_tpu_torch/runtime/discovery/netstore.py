"""Networked discovery KV store: the etcd-analog backend.

The port's copy of the reference package's runtime/discovery/netstore.py,
on the port's own MessagePack codec (runtime/codec.py), so its wire is the
reference's: a ``KVStoreServer`` wraps the in-memory store (leases, TTL
reaping, prefix watch) behind a framed TCP protocol, and a ``TcpKVStore``
client implements the KVStore interface. Watch events are **pushed**: a
mutation reaches every connected watcher in one network hop.

Protocol: every frame is ``!I``-length-prefixed MessagePack. Client requests
carry ``rid`` (request id); the server answers with the same ``rid``. Watch
registration pins a server-side task that streams ``{"watch": wid, ...}``
frames interleaved with responses on the same connection.

Run the service with ``python -m dynamo_tpu_torch.runtime.discovery.netstore`` and
point components at it with ``--store tcp --store-path HOST:PORT``.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Dict, Optional

from .. import codec
from ..faults import FAULTS
from ..logging import get_logger
from ..resilience import retry_policy
from .store import (
    DEFAULT_LEASE_TTL_S,
    EventType,
    KVStore,
    Lease,
    MemKVStore,
    Watcher,
    WatchEvent,
)

log = get_logger("runtime.netstore")

_LEN = struct.Struct("!I")


def _frame(obj: dict) -> bytes:
    body = codec.packb(obj)
    return _LEN.pack(len(body)) + body


async def _read(reader: asyncio.StreamReader) -> dict:
    raw = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(raw)
    return codec.unpackb(await reader.readexactly(n))


class KVStoreServer:
    """The store service: MemKVStore state + framed TCP front."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.host = host
        self.port = port
        self.store = MemKVStore()
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("kv store server on %s:%d", self.host, self.port)
        return f"{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # py3.12 wait_closed() blocks until every connection handler
            # returns, and clients hold connections open — cancel them
            for t in list(self._conn_tasks):
                t.cancel()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass
        await self.store.close()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        watch_tasks: Dict[int, asyncio.Task] = {}
        watchers: Dict[int, Watcher] = {}
        send_lock = asyncio.Lock()

        async def send(obj: dict) -> None:
            async with send_lock:
                writer.write(_frame(obj))
                await writer.drain()

        async def pump(wid: int, w: Watcher) -> None:
            try:
                async for ev in w:
                    await send({
                        "watch": wid,
                        "type": ev.type.value,
                        "key": ev.key,
                        "value": ev.value,
                    })
            except (ConnectionResetError, asyncio.CancelledError):
                pass

        try:
            while True:
                try:
                    req = await _read(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                rid, op = req.get("rid"), req.get("op")
                s = self.store
                try:
                    if op == "put":
                        await s.put(req["key"], req["value"], req.get("lease_id"))
                        await send({"rid": rid, "ok": True})
                    elif op == "get":
                        await send({"rid": rid, "value": await s.get(req["key"])})
                    elif op == "delete":
                        await s.delete(req["key"])
                        await send({"rid": rid, "ok": True})
                    elif op == "list":
                        await send({"rid": rid, "items": await s.list_prefix(req["prefix"])})
                    elif op == "lease_create":
                        lease = await s.create_lease(req.get("ttl", DEFAULT_LEASE_TTL_S))
                        await send({"rid": rid, "lease_id": lease.id, "ttl": lease.ttl_s})
                    elif op == "lease_keepalive":
                        await send({"rid": rid, "ok": await s.keep_alive(req["lease_id"])})
                    elif op == "lease_revoke":
                        await s.revoke_lease(req["lease_id"])
                        await send({"rid": rid, "ok": True})
                    elif op == "watch":
                        wid = req["wid"]
                        w = await s.watch(req["prefix"])
                        watchers[wid] = w
                        watch_tasks[wid] = asyncio.create_task(pump(wid, w))
                        await send({"rid": rid, "ok": True})
                    elif op == "unwatch":
                        wid = req["wid"]
                        w = watchers.pop(wid, None)
                        if w is not None:
                            w.cancel()
                        t = watch_tasks.pop(wid, None)
                        if t is not None:
                            t.cancel()
                        await send({"rid": rid, "ok": True})
                    else:
                        await send({"rid": rid, "error": f"bad op {op!r}"})
                except Exception as e:  # per-op isolation
                    log.exception("store op %r failed", op)
                    await send({"rid": rid, "error": repr(e)})
        finally:
            for w in watchers.values():
                w.cancel()
            for t in watch_tasks.values():
                t.cancel()
            if task is not None:
                self._conn_tasks.discard(task)
            writer.close()


class TcpKVStore(KVStore):
    """KVStore over one multiplexed connection to a KVStoreServer."""

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._rx_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._watchers: Dict[int, Watcher] = {}
        self._rid = 0
        self._wid = 0
        self._lock = asyncio.Lock()          # write ordering on the one connection
        self._connect_lock = asyncio.Lock()  # connect dedup ONLY — never held for sends

    async def _ensure(self) -> None:
        """Connect (once) OUTSIDE the send lock: when the store is down,
        every pending op used to queue single-file behind one OS-timeout-
        scale connect attempt under self._lock — a dead store serialized
        the whole discovery plane. The dedicated connect lock's entire job
        is deduplicating the dial; it guards no request traffic."""
        if self._writer is not None:
            return
        async with self._connect_lock:
            if self._writer is not None:
                return  # lost the race: the winner's connection serves us
            # the connect lock exists to hold exactly this await; senders
            # are not behind it
            reader, writer = await asyncio.open_connection(self.host, self.port)
            self._reader, self._writer = reader, writer
            self._rx_task = asyncio.create_task(self._rx_loop())

    async def _rx_loop(self) -> None:
        try:
            while True:
                msg = await _read(self._reader)
                if "watch" in msg:
                    w = self._watchers.get(msg["watch"])
                    if w is not None:
                        w._emit(WatchEvent(
                            EventType(msg["type"]), msg["key"], msg["value"]
                        ))
                    continue
                fut = self._pending.pop(msg.get("rid"), None)
                if fut is not None and not fut.done():
                    if "error" in msg:
                        fut.set_exception(RuntimeError(msg["error"]))
                    else:
                        fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionResetError, asyncio.CancelledError):
            # sever every consumer so nobody awaits a dead connection, and
            # drop the transport so the next op reconnects (watchers do not
            # auto-resubscribe: their cancel tells consumers to re-watch)
            for fut in list(self._pending.values()):
                if not fut.done():
                    fut.set_exception(ConnectionError("kv store connection lost"))
            self._pending.clear()
            # snapshot: a watcher's wrapped cancel() pops itself from the dict
            for w in list(self._watchers.values()):
                w.cancel()
            self._watchers.clear()
            if self._writer is not None:
                try:
                    self._writer.close()
                except Exception:
                    pass
            self._reader = self._writer = None
            self._rx_task = None

    async def _call(self, obj: dict) -> dict:
        await FAULTS.ainject("discovery.call")
        await self._ensure()
        async with self._lock:
            if self._writer is None:
                # severed between _ensure and the lock: surface as the same
                # transport loss a mid-drain sever raises; _call_retry's
                # policy reconnects on the next attempt
                raise ConnectionError("kv store connection lost")
            self._rid += 1
            rid = self._rid
            obj["rid"] = rid
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending[rid] = fut
            self._writer.write(_frame(obj))
            await self._writer.drain()
        return await fut

    async def _call_retry(self, obj: dict) -> dict:
        """Idempotent ops replay through the shared policy: a severed
        connection reconnects in ``_ensure`` on the next attempt instead of
        surfacing every blip to discovery consumers."""
        return await retry_policy(
            "discovery.call", max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
        ).acall(self._call, dict(obj))

    # -- KVStore interface ---------------------------------------------------
    async def put(self, key: str, value: bytes, lease_id: Optional[str] = None) -> None:
        await self._call_retry({"op": "put", "key": key, "value": value, "lease_id": lease_id})

    async def get(self, key: str) -> Optional[bytes]:
        return (await self._call_retry({"op": "get", "key": key}))["value"]

    async def delete(self, key: str) -> None:
        await self._call_retry({"op": "delete", "key": key})

    async def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        return (await self._call_retry({"op": "list", "prefix": prefix}))["items"]

    async def watch(self, prefix: str) -> Watcher:
        await self._ensure()
        async with self._lock:
            self._wid += 1
            wid = self._wid
        w = Watcher()
        orig_cancel = w.cancel

        def cancel() -> None:
            orig_cancel()
            self._watchers.pop(wid, None)
            if self._writer is not None:
                try:
                    self._writer.write(_frame({"op": "unwatch", "wid": wid, "rid": 0}))
                except ConnectionError:
                    pass

        w.cancel = cancel  # type: ignore[method-assign]
        self._watchers[wid] = w
        await self._call({"op": "watch", "prefix": prefix, "wid": wid})
        return w

    async def create_lease(self, ttl_s: float = DEFAULT_LEASE_TTL_S) -> Lease:
        resp = await self._call({"op": "lease_create", "ttl": ttl_s})
        return Lease(resp["lease_id"], resp["ttl"])

    async def keep_alive(self, lease_id: str) -> bool:
        try:
            return bool((await self._call({"op": "lease_keepalive", "lease_id": lease_id}))["ok"])
        except (ConnectionError, RuntimeError):
            return False

    async def revoke_lease(self, lease_id: str) -> None:
        await self._call({"op": "lease_revoke", "lease_id": lease_id})

    async def close(self) -> None:
        if self._rx_task is not None:
            self._rx_task.cancel()
        if self._writer is not None:
            self._writer.close()
        for w in list(self._watchers.values()):
            w.cancel()


def main() -> None:  # python -m dynamo_tpu_torch.runtime.discovery.netstore
    import argparse
    import signal

    from ..logging import init_logging

    p = argparse.ArgumentParser("dynamo_tpu_torch.netstore")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7460)
    args = p.parse_args()

    async def run() -> None:
        init_logging()
        server = KVStoreServer(args.host, args.port)
        addr = await server.start()
        print(f"KVSTORE_READY {addr}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
