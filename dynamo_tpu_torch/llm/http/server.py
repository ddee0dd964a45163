"""A small HTTP/1.1 server on asyncio streams, standard library only.

What the OpenAI frontend (service.py) needs of aiohttp's server, which the
reference package uses and the machine the port serves on lacks: the
request line with its query parameters, headers and a ``Content-Length`` body (``Expect:
100-continue`` answered), keep-alive between non-streamed responses, and
streamed responses in chunked transfer encoding (server-sent events). A
streamed response ends its connection; while it streams, the client's
side is watched, and a client that closes it fires the request's
disconnect callbacks at once (the frontend kills the request's contexts
there, as the reference does on aiohttp's disconnect), not only at the
next write. Given an ``ssl.SSLContext`` the listener serves HTTPS.
"""

from __future__ import annotations

import asyncio
import json
from http import HTTPStatus
from typing import Awaitable, Callable, Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qsl, urlsplit

from ...runtime.logging import get_logger

log = get_logger("llm.http.server")

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024   # the reference's client_max_size

# a write to a client that went away
DISCONNECT = (ConnectionResetError, BrokenPipeError)


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Request:
    """One parsed request; ``disconnected`` is set when the client closes
    its side while a streamed response is being written."""

    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], body: bytes):
        self.method = method
        url = urlsplit(target)
        self.path = url.path
        # the query string's parameters (the last value of a repeated one)
        self.query: Dict[str, str] = dict(parse_qsl(url.query))
        self.version = version
        self.headers = headers
        self.body = body
        self.disconnected = asyncio.Event()
        self._on_disconnect: List[Callable[[], None]] = []
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader: Optional[asyncio.StreamReader] = None

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    def json(self):
        return json.loads(self.body.decode("utf-8"))

    def on_disconnect(self, cb: Callable[[], None]) -> None:
        self._on_disconnect.append(cb)
        if self.disconnected.is_set():
            cb()

    def _fire_disconnect(self) -> None:
        if not self.disconnected.is_set():
            self.disconnected.set()
            for cb in self._on_disconnect:
                try:
                    cb()
                except Exception:
                    log.exception("disconnect callback failed")


class Response:
    def __init__(self, body: Union[bytes, str] = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}


def json_response(obj, status: int = 200, headers: Optional[Dict[str, str]] = None
                  ) -> Response:
    return Response(json.dumps(obj), status, "application/json; charset=utf-8", headers)


def _status_line(status: int) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = "Unknown"
    return f"HTTP/1.1 {status} {reason}\r\n".encode()


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [_status_line(status)]
    lines += [f"{k}: {v}\r\n".encode() for k, v in headers.items()]
    return b"".join(lines) + b"\r\n"


class StreamResponse:
    """A chunked response: ``prepare()`` sends the head, ``write()`` one
    chunk each, ``write_eof()`` the last chunk. A write after the client
    went away raises ConnectionResetError."""

    def __init__(self, request: Request, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.request = request
        self.status = status
        self.headers = dict(headers or {})
        self.prepared = False
        self._watch: Optional[asyncio.Task] = None

    async def prepare(self) -> None:
        writer = self.request._writer
        self.headers["Transfer-Encoding"] = "chunked"
        self.headers["Connection"] = "close"
        writer.write(_head(self.status, self.headers))
        await writer.drain()
        self.prepared = True
        self._watch = asyncio.ensure_future(self._watch_client())

    async def _watch_client(self) -> None:
        """The client's side of the connection: EOF or a reset is a
        disconnect (anything it sends meanwhile is discarded: the
        connection closes after this response)."""
        reader = self.request._reader
        try:
            while await reader.read(65536):
                pass
        except (ConnectionError, OSError):
            pass
        self.request._fire_disconnect()

    async def write(self, data: bytes) -> None:
        if self.request.disconnected.is_set():
            raise ConnectionResetError("client disconnected")
        if not data:
            return
        writer = self.request._writer
        writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
        await writer.drain()

    async def write_eof(self) -> None:
        if self.request.disconnected.is_set():
            raise ConnectionResetError("client disconnected")
        writer = self.request._writer
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    def close(self) -> None:
        if self._watch is not None:
            self._watch.cancel()


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class HttpServer:
    """Routes ``(method, path)`` to handlers; unknown paths 404, a known
    path asked with another method 405."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8000, ssl_context=None,
                 max_body_bytes: int = MAX_BODY_BYTES):
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self.max_body_bytes = max_body_bytes
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._prefix_routes: List[Tuple[str, str, Handler]] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method, path)] = handler

    def add_prefix_route(self, method: str, prefix: str, handler: Handler) -> None:
        """Route every path under ``prefix`` (e.g. ``/cancel/``); the
        handler reads the rest from ``request.path``."""
        self._prefix_routes.append((method, prefix, handler))

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port,
                                                  limit=MAX_HEADER_BYTES,
                                                  ssl=self.ssl_context)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        # Server.wait_closed() waits for every connection handler, and
        # keep-alive clients hold theirs open: cancel them first
        for t in list(self._conns):
            t.cancel()
        try:
            await asyncio.wait_for(self._server.wait_closed(), 2.0)
        except asyncio.TimeoutError:
            pass
        self._server = None

    async def _read_request(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if e.partial.strip():
                raise HttpError(400, "incomplete request head") from None
            return None
        except asyncio.LimitOverrunError:
            raise HttpError(431, "request head too large") from None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise HttpError(400, f"bad request line {lines[0]!r}")
        method, target, version = parts
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep or not name.strip():
                raise HttpError(400, f"bad header line {line!r}")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise HttpError(411, "chunked request bodies are not supported; send "
                                 "Content-Length")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HttpError(400, "bad Content-Length") from None
        if length < 0:
            raise HttpError(400, "bad Content-Length")
        if length > self.max_body_bytes:
            raise HttpError(413, f"request body of {length} bytes exceeds "
                                 f"{self.max_body_bytes}")
        if length and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(length) if length else b""
        req = Request(method, target, version, headers, body)
        req._reader, req._writer = reader, writer
        return req

    async def _dispatch(self, req: Request) -> Union[Response, StreamResponse]:
        handler = self._routes.get((req.method, req.path))
        if handler is None:
            handler = next((h for m, p, h in self._prefix_routes
                            if m == req.method and req.path.startswith(p)), None)
        if handler is None:
            if any(path == req.path for _, path in self._routes) or any(
                    req.path.startswith(p) for _, p, _ in self._prefix_routes):
                return Response("405: Method Not Allowed", 405)
            return Response("404: Not Found", 404)
        try:
            return await handler(req)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("handler for %s %s failed", req.method, req.path)
            return Response("500 Internal Server Error", 500)

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    req = await self._read_request(reader, writer)
                except HttpError as e:
                    writer.write(_head(e.status, {
                        "Content-Type": "text/plain; charset=utf-8",
                        "Content-Length": str(len(str(e).encode())),
                        "Connection": "close"}) + str(e).encode())
                    await writer.drain()
                    return
                if req is None:
                    return
                resp = await self._dispatch(req)
                if isinstance(resp, StreamResponse):
                    resp.close()
                    if not resp.prepared:
                        # a stream that failed before its head went out
                        writer.write(_head(500, {"Content-Length": "0",
                                                 "Connection": "close"}))
                        await writer.drain()
                    return
                keep = req.keep_alive
                headers = dict(resp.headers)
                headers["Content-Length"] = str(len(resp.body))
                headers["Connection"] = "keep-alive" if keep else "close"
                writer.write(_head(resp.status, headers) + resp.body)
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass
        finally:
            self._conns.discard(task)
            try:
                writer.close()
            except Exception:
                pass
