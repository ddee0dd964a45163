"""TCP request plane: multiplexed, streaming, cancellable RPC.

The port's copy of the reference package's runtime/request_plane/tcp.py, on
the port's own MessagePack codec (runtime/codec.py), so its frames are the
reference's byte for byte. One TCP connection carries many concurrent
requests; each frame is ``u32 length || MessagePack map``. Response streams are sequences of
``item`` frames terminated by ``end`` / ``err``; the client can send ``cancel``
mid-stream and the server propagates it into the handler's Context.

Frame schema::

    {"t": "req",    "id": str, "hdr": {..}, "body": any}
    {"t": "item",   "id": str, "body": any}
    {"t": "end",    "id": str}
    {"t": "err",    "id": str, "error": str, "code": str}
    {"t": "cancel", "id": str}
    {"t": "ping"} / {"t": "pong"}   (the canary's probe, ``TcpClient.ping``)

MessagePack carries ``bytes`` natively, so tensor payloads ride as binary
fields without a separate framing layer.
"""

from __future__ import annotations

import asyncio
import struct
import uuid
from typing import Any, AsyncIterator, Callable, Dict, Optional

from .. import codec
from ..engine import Context
from ..faults import FAULTS
from ..logging import get_logger
from ..resilience import retry_policy
from ..tasks import spawn_bg

log = get_logger("runtime.tcp")

_LEN = struct.Struct(">I")
MAX_FRAME = 512 * 1024 * 1024  # 512 MB: KV-block payloads can be large


class RequestPlaneError(Exception):
    def __init__(self, message: str, code: str = "internal"):
        super().__init__(message)
        self.code = code


class NoResponders(RequestPlaneError):
    """Target instance is gone (connection refused / reset before reply).

    The migration operator retries on this."""

    def __init__(self, message: str = "no responders"):
        super().__init__(message, code="no_responders")


async def _read_frame(reader: asyncio.StreamReader) -> Optional[Dict[str, Any]]:
    try:
        hdr = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(hdr)
    if length > MAX_FRAME:
        raise RequestPlaneError(f"frame too large: {length}")
    try:
        payload = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return codec.unpackb(payload)


def _write_frame(writer: asyncio.StreamWriter, msg: Dict[str, Any]) -> None:
    payload = codec.packb(msg)
    # two writes, not a concatenation: a KV transfer frame is hundreds of MiB
    writer.write(_LEN.pack(len(payload)))
    writer.write(payload)


Handler = Callable[[Any, Context], AsyncIterator[Any]]


class TcpRequestServer:
    """Serves a single handler; one instance per (endpoint, worker)."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._host = host
        self._port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._inflight: Dict[str, Context] = {}
        self._conn_tasks: set = set()

    @property
    def address(self) -> str:
        assert self._server is not None, "server not started"
        sock = self._server.sockets[0]
        host, port = sock.getsockname()[:2]
        return f"{host}:{port}"

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._on_conn, self._host, self._port)
        log.debug("tcp request server listening on %s", self.address)
        return self.address

    async def stop(self, graceful_timeout_s: float = 5.0) -> None:
        if self._server is not None:
            self._server.close()
        deadline = asyncio.get_event_loop().time() + graceful_timeout_s
        while self._inflight and asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(0.05)
        for ctx in self._inflight.values():
            ctx.kill()
        # py3.12 Server.wait_closed() blocks until every connection handler
        # returns, and pooled clients hold connections open — cancel them first
        for t in list(self._conn_tasks):
            t.cancel()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        write_lock = asyncio.Lock()
        req_tasks: Dict[str, asyncio.Task] = {}

        async def send(msg: Dict[str, Any]) -> None:
            async with write_lock:
                _write_frame(writer, msg)
                await writer.drain()

        async def run_request(rid: str, body: Any) -> None:
            ctx = Context(rid)
            self._inflight[rid] = ctx
            try:
                async for item in self._handler(body, ctx):
                    if ctx.is_killed():
                        break
                    await send({"t": "item", "id": rid, "body": item})
                await send({"t": "end", "id": rid})
            except (ConnectionResetError, BrokenPipeError):
                ctx.kill()
            except Exception as e:  # handler error -> err frame
                log.exception("handler error for request %s", rid[:8])
                code = getattr(e, "code", "internal")
                try:
                    await send({"t": "err", "id": rid, "error": str(e), "code": code})
                except (ConnectionResetError, BrokenPipeError):
                    pass
            finally:
                self._inflight.pop(rid, None)
                req_tasks.pop(rid, None)

        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        try:
            while True:
                msg = await _read_frame(reader)
                if msg is None:
                    break
                t = msg.get("t")
                if t == "req":
                    rid = msg["id"]
                    req_tasks[rid] = asyncio.create_task(run_request(rid, msg.get("body")))
                elif t == "cancel":
                    ctx = self._inflight.get(msg["id"])
                    if ctx is not None:
                        ctx.stop_generating()
                elif t == "ping":
                    await send({"t": "pong"})
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            # client went away: kill everything it had in flight on this conn
            for rid, rt in list(req_tasks.items()):
                ctx = self._inflight.get(rid)
                if ctx is not None:
                    ctx.kill()
                rt.cancel()
            if task is not None:
                self._conn_tasks.discard(task)
            writer.close()


class _Conn:
    """One multiplexed client connection."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.write_lock = asyncio.Lock()
        self.streams: Dict[str, asyncio.Queue] = {}
        self.reader_task: Optional[asyncio.Task] = None
        self.closed = False
        self.pong_waiters: list = []  # futures resolved in order by pong frames
        # pongs owed to pings that already timed out: discarded instead of
        # resolving the NEXT ping's future (a wedged server would otherwise
        # look healthy forever on one late pong's credit)
        self.stale_pongs = 0

    async def send(self, msg: Dict[str, Any]) -> None:
        async with self.write_lock:
            _write_frame(self.writer, msg)
            await self.writer.drain()

    async def read_loop(self) -> None:
        try:
            while True:
                msg = await _read_frame(self.reader)
                if msg is None:
                    break
                if msg.get("t") == "pong":
                    if self.stale_pongs > 0:
                        self.stale_pongs -= 1
                        continue
                    while self.pong_waiters:
                        fut = self.pong_waiters.pop(0)
                        if not fut.done():
                            fut.set_result(True)
                            break
                    continue
                rid = msg.get("id")
                q = self.streams.get(rid)
                if q is not None:
                    q.put_nowait(msg)
        except asyncio.CancelledError:
            pass
        finally:
            self.closed = True
            for q in self.streams.values():
                q.put_nowait({"t": "err", "error": "connection lost", "code": "no_responders"})
            for fut in self.pong_waiters:
                if not fut.done():
                    fut.set_result(False)
            self.pong_waiters.clear()
            self.writer.close()


class TcpClient:
    """Connection-pooled client; one shared instance per process is typical."""

    def __init__(self):
        self._conns: Dict[str, _Conn] = {}
        self._conn_locks: Dict[str, asyncio.Lock] = {}

    async def _get_conn(self, address: str) -> _Conn:
        conn = self._conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and not conn.closed:
                return conn
            host, port_s = address.rsplit(":", 1)

            async def connect():
                await FAULTS.ainject("request_plane.connect")
                return await asyncio.open_connection(host, int(port_s))

            try:
                # shared policy (scope request_plane.connect): one quick
                # retry absorbs a worker restarting its listener; a truly
                # dead target still surfaces as NoResponders in ~base delay
                reader, writer = await retry_policy(
                    "request_plane.connect",
                    max_attempts=2, base_delay_s=0.02, max_delay_s=0.2,
                ).acall(connect)
            except (ConnectionRefusedError, OSError) as e:
                raise NoResponders(f"connect {address}: {e}") from e
            conn = _Conn(reader, writer)
            conn.reader_task = asyncio.create_task(conn.read_loop())
            self._conns[address] = conn
            return conn

    async def call(
        self, address: str, request: Any, context: Optional[Context] = None
    ) -> AsyncIterator[Any]:
        """Issue a request; yields response items as they stream back."""
        ctx = context or Context()
        conn = await self._get_conn(address)
        rid = uuid.uuid4().hex
        q: asyncio.Queue = asyncio.Queue()
        conn.streams[rid] = q

        cancelled_sent = False

        async def send_cancel() -> None:
            nonlocal cancelled_sent
            if not cancelled_sent and not conn.closed:
                cancelled_sent = True
                try:
                    await conn.send({"t": "cancel", "id": rid})
                except (ConnectionResetError, BrokenPipeError, RuntimeError):
                    pass

        def on_cancel() -> None:
            spawn_bg(send_cancel())

        ctx.on_cancel(on_cancel)
        try:
            await FAULTS.ainject("request_plane.send")
            await conn.send({"t": "req", "id": rid, "body": request})
        except ConnectionError as e:  # covers reset/broken-pipe/injected drop
            conn.streams.pop(rid, None)
            raise NoResponders(f"send {address}: {e}") from e

        async def stream() -> AsyncIterator[Any]:
            try:
                while True:
                    msg = await q.get()
                    t = msg.get("t")
                    if t == "item":
                        yield msg.get("body")
                    elif t == "end":
                        return
                    elif t == "err":
                        code = msg.get("code", "internal")
                        if code == "no_responders":
                            raise NoResponders(msg.get("error", ""))
                        raise RequestPlaneError(msg.get("error", ""), code)
            finally:
                conn.streams.pop(rid, None)

        return stream()

    async def ping(self, address: str, timeout: float = 2.0) -> float:
        """Round-trip a ping through the whole request-plane path (connect,
        frame codec, the server's read loop): the canary's probe. Returns
        the RTT in seconds; raises NoResponders on a failed connect or a
        pong that does not come within ``timeout``."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        conn = await self._get_conn(address)
        fut: asyncio.Future = loop.create_future()
        conn.pong_waiters.append(fut)
        sent = False
        try:
            await conn.send({"t": "ping"})
            sent = True
            ok = await asyncio.wait_for(fut, timeout)
        except (asyncio.TimeoutError, ConnectionResetError, BrokenPipeError) as e:
            if fut in conn.pong_waiters:
                conn.pong_waiters.remove(fut)
                if sent and isinstance(e, asyncio.TimeoutError):
                    # this ping's pong may still come: discard it then
                    conn.stale_pongs += 1
            raise NoResponders(f"ping {address}: {e!r}") from e
        if not ok:
            raise NoResponders(f"ping {address}: connection lost")
        return loop.time() - t0

    async def close(self) -> None:
        for conn in self._conns.values():
            if conn.reader_task is not None:
                conn.reader_task.cancel()
            conn.writer.close()
        self._conns.clear()
