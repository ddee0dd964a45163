"""HTTP request plane: the alternative transport to request_plane/tcp.py.

The port's copy of the reference package's runtime/request_plane/http.py,
the same streaming-RPC contract as the TCP plane: one POST per request,
the response streamed as ``u32 length || codec`` frames (the port's codec,
runtime/codec.py) over chunked transfer encoding:

    POST /rpc          body: codec request             -> frame stream
    POST /cancel/{id}                                  -> {"ok": true}
    GET  /ping                                         -> {"ok": true}

Request ids ride the ``x-dtpu-request-id`` header, so a cancel is
addressable mid-stream from a second connection (HTTP has no in-band
reverse channel). Addresses are ``http://host:port``; the component layer
picks this plane by the address's scheme (component.py), and
``DTPU_REQUEST_PLANE=http`` serves a worker's endpoints on it. The reference
runs it on aiohttp; the port on its own HTTP server (llm/http/server.py)
and client (runtime/http_client.py).
"""

from __future__ import annotations

import asyncio
import struct
import uuid
from typing import Any, AsyncIterator, Dict, Optional

from ...llm.http.server import HttpServer, Request, StreamResponse, json_response
from .. import codec
from ..engine import Context
from ..faults import FAULTS
from ..http_client import HttpClient as _Http1, HttpClientError
from ..logging import get_logger
from ..tasks import spawn_bg
from .tcp import Handler, NoResponders, RequestPlaneError

log = get_logger("runtime.http_plane")

_LEN = struct.Struct(">I")

REQUEST_ID_HEADER = "x-dtpu-request-id"


def _frame(obj: Dict[str, Any]) -> bytes:
    body = codec.packb(obj)
    return _LEN.pack(len(body)) + body


class HttpRequestServer:
    """Same surface as TcpRequestServer (start/stop/address/inflight)."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._host = host
        self._port = port
        self._inflight: Dict[str, Context] = {}
        self._server = HttpServer(host, port, max_body_bytes=512 * 1024 * 1024)
        self._server.add_route("POST", "/rpc", self._rpc)
        self._server.add_prefix_route("POST", "/cancel/", self._cancel)
        self._server.add_route("GET", "/ping", self._ping)

    @property
    def address(self) -> str:
        return f"http://{self._host}:{self._port}"

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    async def start(self) -> str:
        self._port = await self._server.start()
        log.debug("http request server listening on %s", self.address)
        return self.address

    async def stop(self, graceful_timeout_s: float = 5.0) -> None:
        deadline = asyncio.get_running_loop().time() + graceful_timeout_s
        while self._inflight and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.05)
        for ctx in self._inflight.values():
            ctx.kill()
        await self._server.stop()

    async def _ping(self, request: Request):
        return json_response({"ok": True})

    async def _cancel(self, request: Request):
        ctx = self._inflight.get(request.path[len("/cancel/"):])
        if ctx is not None:
            ctx.stop_generating()
        return json_response({"ok": ctx is not None})

    async def _rpc(self, request: Request):
        rid = request.headers.get(REQUEST_ID_HEADER) or uuid.uuid4().hex
        body = codec.unpackb(request.body)
        ctx = Context(rid)
        self._inflight[rid] = ctx
        resp = StreamResponse(request, headers={"Content-Type": "application/x-dtpu-frames"})
        try:
            await resp.prepare()
            # a client that goes away kills its request at once
            request.on_disconnect(ctx.kill)
            async for item in self._handler(body, ctx):
                if ctx.is_killed():
                    break
                await resp.write(_frame({"t": "item", "body": item}))
            await resp.write(_frame({"t": "end"}))
        except (ConnectionResetError, BrokenPipeError):
            ctx.kill()
        except asyncio.CancelledError:
            ctx.kill()
            raise
        except Exception as e:
            log.exception("handler error for request %s", rid[:8])
            try:
                await resp.write(_frame({
                    "t": "err", "error": str(e), "code": getattr(e, "code", "internal"),
                }))
            except (ConnectionResetError, BrokenPipeError):
                pass
        finally:
            self._inflight.pop(rid, None)
        try:
            await resp.write_eof()
        except (ConnectionResetError, BrokenPipeError):
            pass
        return resp


class HttpClient:
    """Same surface as TcpClient (call/ping/close)."""

    def __init__(self):
        self._http = _Http1()

    async def call(
        self, address: str, request: Any, context: Optional[Context] = None
    ) -> AsyncIterator[Any]:
        ctx = context or Context()
        rid = uuid.uuid4().hex
        try:
            await FAULTS.ainject("request_plane.send")
        except ConnectionError as e:
            raise NoResponders(f"send {address}: {e}") from e
        try:
            resp = await self._http.request(
                "POST", address.rstrip("/") + "/rpc", codec.packb(request),
                {REQUEST_ID_HEADER: rid, "Content-Type": "application/x-dtpu-frames"})
        except (HttpClientError, OSError) as e:
            raise NoResponders(f"connect {address}: {e}") from e

        def on_cancel() -> None:
            spawn_bg(self._send_cancel(address, rid))

        ctx.on_cancel(on_cancel)

        async def stream() -> AsyncIterator[Any]:
            buf = b""
            try:
                async for chunk in resp.iter_chunks():
                    buf += chunk
                    while len(buf) >= _LEN.size:
                        (n,) = _LEN.unpack(buf[:_LEN.size])
                        if len(buf) < _LEN.size + n:
                            break
                        msg = codec.unpackb(buf[_LEN.size:_LEN.size + n])
                        buf = buf[_LEN.size + n:]
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
                # the server closed without an end frame: treat as gone
                raise NoResponders(f"{address}: stream ended prematurely")
            except (HttpClientError, ConnectionResetError) as e:
                raise NoResponders(f"{address}: {e}") from e
            finally:
                resp.close()

        return stream()

    async def _send_cancel(self, address: str, rid: str) -> None:
        try:
            r = await self._http.request("POST", address.rstrip("/") + f"/cancel/{rid}",
                                         b"", timeout=5.0)
            await r.read()
        except (HttpClientError, OSError):
            pass

    async def ping(self, address: str, timeout: float = 2.0) -> float:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        try:
            async def go() -> None:
                r = await self._http.request("GET", address.rstrip("/") + "/ping")
                body = await r.read()
                if r.status != 200:
                    raise NoResponders(f"{address}: ping {r.status} {body[:80]!r}")
            await asyncio.wait_for(go(), timeout)
        except (HttpClientError, OSError, asyncio.TimeoutError) as e:
            raise NoResponders(f"ping {address}: {e!r}") from e
        return loop.time() - t0

    async def close(self) -> None:
        await self._http.close()
