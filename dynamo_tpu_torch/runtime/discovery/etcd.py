"""etcd v3 backend for the discovery KV store.

The port's copy of the reference package's runtime/discovery/etcd.py:
leases with keepalive, key-per-instance registration, prefix watches, over
the etcd gRPC-JSON gateway (the ``/v3/*`` HTTP API every etcd >= 3.3 serves
on its client port), so no etcd client library is needed. The reference
sends its calls through aiohttp; the port through its own HTTP/1.1 client
(runtime/http_client.py), which reads the gateway's chunked replies:

    POST /v3/kv/put | /v3/kv/range | /v3/kv/deleterange
    POST /v3/lease/grant | /v3/lease/keepalive | /v3/lease/revoke
    POST /v3/watch          (chunked stream of JSON watch responses)

Keys and values travel base64-encoded per the gateway spec. Watches follow
the store interface's snapshot-then-stream contract: one range call emits
PUT events for the existing keys, then the live stream starts at the
snapshot revision + 1, so nothing is missed or duplicated. The fault points
``discovery.call`` (each gateway call) and ``discovery.watch`` (each watch
connection) are wired here.

Selected with ``DTPU_STORE=etcd`` and ``DTPU_STORE_PATH=http://host:2379``
(runtime/config.py).
"""

from __future__ import annotations

import asyncio
import base64
import codecs
import json
import math
from typing import Dict, Optional

from ..faults import FAULTS
from ..http_client import HttpClient, HttpClientError
from ..logging import get_logger
from ..resilience import retry_policy
from .store import (
    DEFAULT_LEASE_TTL_S,
    EventType,
    KVStore,
    Lease,
    WatchEvent,
    Watcher,
)

log = get_logger("runtime.discovery.etcd")


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _b64bytes(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _prefix_range_end(prefix: str) -> str:
    """etcd prefix query: range_end = prefix with its last byte + 1."""
    raw = bytearray(prefix.encode())
    for i in reversed(range(len(raw))):
        if raw[i] < 0xFF:
            raw[i] += 1
            del raw[i + 1:]
            return base64.b64encode(bytes(raw)).decode()
        del raw[i]
    return base64.b64encode(b"\x00").decode()  # whole keyspace


class EtcdKVStore(KVStore):
    def __init__(self, endpoint: str):
        if not endpoint.startswith("http"):
            endpoint = "http://" + endpoint
        self.endpoint = endpoint.rstrip("/")
        self._http = HttpClient()
        self._watch_tasks: list = []

    async def _call(self, path: str, body: dict) -> dict:
        async def once() -> dict:
            await FAULTS.ainject("discovery.call")

            async def exchange() -> dict:
                r = await self._http.post_json(self.endpoint + path, body)
                if r.status != 200:
                    err = ConnectionError(f"etcd {path} -> {r.status}: {(await r.text())[:200]}")
                    if 400 <= r.status < 500 and r.status not in (408, 429):
                        # a deterministic gateway rejection (bad op, auth):
                        # still a ConnectionError for existing catchers, but
                        # marked terminal so the policy does not replay it
                        err.code = "invalid_request"  # type: ignore[attr-defined]
                    raise err
                return await r.json()

            try:
                return await asyncio.wait_for(exchange(), 30.0)
            except asyncio.TimeoutError:
                raise ConnectionError(f"etcd {path}: timed out") from None
            except HttpClientError as e:
                raise ConnectionError(f"etcd {path}: {e}") from e

        # every gateway op here is idempotent (put/range/deleterange/lease
        # grant+revoke), so the shared policy may replay a dropped call
        return await retry_policy(
            "discovery.call", max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
        ).acall(once)

    # ------------------------------------------------------------------- kv
    async def put(self, key: str, value: bytes, lease_id: Optional[str] = None) -> None:
        body = {"key": _b64(key), "value": _b64bytes(value)}
        if lease_id is not None:
            body["lease"] = lease_id
        await self._call("/v3/kv/put", body)

    async def get(self, key: str) -> Optional[bytes]:
        out = await self._call("/v3/kv/range", {"key": _b64(key)})
        kvs = out.get("kvs") or []
        return _unb64(kvs[0]["value"]) if kvs else None

    async def delete(self, key: str) -> None:
        await self._call("/v3/kv/deleterange", {"key": _b64(key)})

    async def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        out = await self._call("/v3/kv/range", {
            "key": _b64(prefix), "range_end": _prefix_range_end(prefix),
        })
        return {
            _unb64(kv["key"]).decode(): _unb64(kv.get("value", ""))
            for kv in (out.get("kvs") or [])
        }

    # --------------------------------------------------------------- leases
    async def create_lease(self, ttl_s: float = DEFAULT_LEASE_TTL_S) -> Lease:
        out = await self._call("/v3/lease/grant", {
            "TTL": max(1, math.ceil(ttl_s)), "ID": 0,
        })
        return Lease(id=str(out["ID"]), ttl_s=float(out.get("TTL", ttl_s)))

    async def keep_alive(self, lease_id: str) -> bool:
        # /v3/lease/keepalive is a STREAM on a real etcd: the connection
        # stays open after the first response, so read exactly one line
        # (waiting for the end would hang every heartbeat)
        try:
            r = await self._http.post_json(self.endpoint + "/v3/lease/keepalive",
                                           {"ID": lease_id}, timeout=10)
            async with r:
                if r.status != 200:
                    return False
                line = await asyncio.wait_for(r.readline(), 10)
        except (HttpClientError, asyncio.TimeoutError, ConnectionError):
            return False
        if not line.strip():
            return False
        first = json.loads(line)
        result = first.get("result", first)
        return int(result.get("TTL", 0) or 0) > 0

    async def revoke_lease(self, lease_id: str) -> None:
        try:
            await self._call("/v3/lease/revoke", {"ID": lease_id})
        except ConnectionError:
            pass  # already expired/revoked

    # ---------------------------------------------------------------- watch
    async def watch(self, prefix: str) -> Watcher:
        watcher = Watcher()
        # snapshot first (the store contract), remembering the revision so
        # the live stream starts exactly after it
        out = await self._call("/v3/kv/range", {
            "key": _b64(prefix), "range_end": _prefix_range_end(prefix),
        })
        for kv in out.get("kvs") or []:
            watcher._emit(WatchEvent(
                EventType.PUT, _unb64(kv["key"]).decode(),
                _unb64(kv.get("value", "")),
            ))
        rev = int(out.get("header", {}).get("revision", 0))
        task = asyncio.create_task(self._watch_stream(prefix, rev + 1, watcher))
        self._watch_tasks.append(task)
        # Watcher.cancel must also kill the stream task and its open HTTP
        # connection (the file backend sets the same convention)
        orig_cancel = watcher.cancel

        def cancel() -> None:
            task.cancel()
            orig_cancel()

        watcher.cancel = cancel  # type: ignore[method-assign]
        return watcher

    async def _watch_stream(self, prefix: str, start_rev: int, watcher: Watcher) -> None:
        """Long-lived watch with reconnect: a dropped connection (etcd
        restart, idle proxy) resumes from the last delivered revision —
        terminating the watcher on a transient error would freeze the
        client's view of discovery forever. Reconnect pacing comes from the
        shared policy (scope discovery.watch): exponential backoff with
        jitter on consecutive failures, reset once a stream delivers."""
        next_rev = start_rev
        policy = retry_policy(
            "discovery.watch", max_attempts=2, base_delay_s=0.25, max_delay_s=5.0,
        )
        prev_delay = None
        try:
            while not watcher._closed:
                try:
                    await FAULTS.ainject("discovery.watch")
                    next_rev = await self._watch_once(prefix, next_rev, watcher)
                    prev_delay = None  # the stream delivered: backoff resets
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    prev_delay = policy.next_delay(prev_delay)
                    log.warning(
                        "etcd watch for %r dropped (%s); reconnecting in %.2fs",
                        prefix, e, prev_delay,
                    )
                    await asyncio.sleep(prev_delay)
        except asyncio.CancelledError:
            pass
        finally:
            watcher.cancel()

    async def _watch_once(self, prefix: str, start_rev: int, watcher: Watcher) -> int:
        body = {"create_request": {
            "key": _b64(prefix),
            "range_end": _prefix_range_end(prefix),
            "start_revision": start_rev,
        }}
        next_rev = start_rev
        r = await self._http.post_json(self.endpoint + "/v3/watch", body, timeout=30)
        async with r:
            if r.status != 200:
                raise ConnectionError(f"etcd /v3/watch -> {r.status}")
            # Frame-robust parse: the gateway usually emits one JSON object
            # per line, but nothing in HTTP chunking guarantees a frame
            # boundary per read; raw_decode consumes complete objects
            # wherever they end and an incomplete tail waits for more bytes.
            # The incremental UTF-8 decoder keeps a code point split across
            # chunks whole.
            udec = codecs.getincrementaldecoder("utf-8")()
            jdec = json.JSONDecoder()
            # an unparsed tail larger than any sane watch frame is garbage,
            # not a split frame: raise so the watch loop reconnects
            max_frame = 8 * 1024 * 1024
            text = ""
            async for chunk in r.iter_chunks():
                text += udec.decode(chunk)
                idx = 0
                while True:
                    while idx < len(text) and text[idx] in " \t\r\n":
                        idx += 1
                    if idx >= len(text):
                        break
                    try:
                        msg, idx = jdec.raw_decode(text, idx)
                    except json.JSONDecodeError:
                        if text[idx] not in "{[":
                            raise ValueError(
                                f"non-JSON watch data: {text[idx:idx + 80]!r}"
                            )
                        if len(text) - idx > max_frame:
                            raise ValueError(
                                f"unparseable watch frame ({len(text) - idx} "
                                "buffered bytes with no JSON object)"
                            )
                        break  # incomplete object: need more bytes
                    result = msg.get("result", msg)
                    for ev in result.get("events") or []:
                        kind = (
                            EventType.DELETE
                            if ev.get("type") == "DELETE" else EventType.PUT
                        )
                        kv = ev.get("kv", {})
                        key = _unb64(kv.get("key", "")).decode()
                        val = (
                            _unb64(kv["value"])
                            if kind is EventType.PUT and "value" in kv
                            else None
                        )
                        mod = int(kv.get("mod_revision", 0) or 0)
                        next_rev = max(next_rev, mod + 1)
                        watcher._emit(WatchEvent(kind, key, val))
                text = text[idx:]
        return next_rev

    async def close(self) -> None:
        for t in self._watch_tasks:
            t.cancel()
        await self._http.close()
