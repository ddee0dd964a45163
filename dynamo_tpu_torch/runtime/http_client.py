"""A small asyncio HTTP/1.1 client, standard library only.

What the port's etcd store (discovery/etcd.py) and HTTP request plane
(request_plane/http.py) need of aiohttp's client, which the reference
package uses and the machine the port serves on lacks: requests with a
``Content-Length`` body, replies with a ``Content-Length`` body, a chunked
body (read whole, chunk by chunk as it arrives, or line by line) or a body
that runs to the connection's end, and keep-alive connections pooled per
host for replies read whole. ``https://`` URLs take an ``ssl.SSLContext``.
"""

from __future__ import annotations

import asyncio
import json
import ssl as ssl_mod
from typing import AsyncIterator, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

MAX_HEAD_BYTES = 64 * 1024


class HttpClientError(ConnectionError):
    """The connection failed, or the reply is not valid HTTP/1.1."""


class Response:
    """A reply whose head has been read; its body is read with ``read()``,
    ``iter_chunks()`` or ``readline()``."""

    def __init__(self, client: "HttpClient", key: tuple, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, status: int, headers: Dict[str, str]):
        self._client, self._key = client, key
        self._reader, self._writer = reader, writer
        self.status = status
        self.headers = headers
        te = headers.get("transfer-encoding", "").lower()
        self._chunked = "chunked" in te
        length = headers.get("content-length")
        self._remaining = int(length) if length is not None and not self._chunked else None
        self._done = False
        self._reusable = headers.get("connection", "").lower() != "close"
        self._line_buf = b""

    async def _next_chunk(self) -> bytes:
        """The next piece of the body, b"" at its end."""
        if self._done:
            return b""
        r = self._reader
        if self._chunked:
            line = await r.readline()
            if not line:
                raise HttpClientError("connection closed inside a chunked body")
            size = int(line.split(b";")[0].strip() or b"0", 16)
            if size == 0:
                while (await r.readline()) not in (b"\r\n", b"\n", b""):
                    pass     # trailers
                self._finish()
                return b""
            data = await r.readexactly(size)
            await r.readexactly(2)
            return data
        if self._remaining is not None:
            if self._remaining == 0:
                self._finish()
                return b""
            data = await r.read(min(self._remaining, 65536))
            if not data:
                raise HttpClientError("connection closed inside the body")
            self._remaining -= len(data)
            return data
        data = await r.read(65536)
        if not data:
            self._reusable = False
            self._finish()
        return data

    def _finish(self) -> None:
        self._done = True
        if self._reusable:
            self._client._release(self._key, self._reader, self._writer)
        else:
            self._writer.close()
        self._reader = self._writer = None

    async def iter_chunks(self) -> AsyncIterator[bytes]:
        try:
            while True:
                data = await self._next_chunk()
                if not data:
                    return
                yield data
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self.close()
            raise HttpClientError(str(e)) from e

    async def read(self) -> bytes:
        out = bytearray(self._line_buf)
        self._line_buf = b""
        async for data in self.iter_chunks():
            out += data
        return bytes(out)

    async def text(self) -> str:
        return (await self.read()).decode("utf-8", "replace")

    async def json(self):
        return json.loads(await self.read())

    async def readline(self) -> bytes:
        """One line of the body (with its newline), b"" at its end; for
        replies that stream one JSON object a line and stay open."""
        while b"\n" not in self._line_buf:
            try:
                data = await self._next_chunk()
            except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
                self.close()
                raise HttpClientError(str(e)) from e
            if not data:
                line, self._line_buf = self._line_buf, b""
                return line
            self._line_buf += data
        line, _, rest = self._line_buf.partition(b"\n")
        self._line_buf = rest
        return line + b"\n"

    def close(self) -> None:
        """Drop the connection (a body left unread cannot be reused)."""
        if self._writer is not None:
            self._writer.close()
            self._reader = self._writer = None
        self._done = True

    async def __aenter__(self) -> "Response":
        return self

    async def __aexit__(self, *exc) -> None:
        if not self._done:
            self.close()


class HttpClient:
    """Requests over pooled keep-alive connections."""

    def __init__(self, ssl: Optional[ssl_mod.SSLContext] = None, connect_timeout: float = 5.0):
        self.ssl = ssl
        self.connect_timeout = connect_timeout
        self._pool: Dict[tuple, List[Tuple[asyncio.StreamReader, asyncio.StreamWriter]]] = {}
        self.closed = False

    def _release(self, key: tuple, reader, writer) -> None:
        if self.closed:
            writer.close()
            return
        self._pool.setdefault(key, []).append((reader, writer))

    async def _connect(self, key: tuple):
        scheme, host, port = key
        pool = self._pool.get(key) or []
        while pool:
            reader, writer = pool.pop()
            if not reader.at_eof() and not writer.is_closing():
                return reader, writer, True
            writer.close()
        ctx = None
        if scheme == "https":
            ctx = self.ssl or ssl_mod.create_default_context()
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port, ssl=ctx, limit=MAX_HEAD_BYTES),
                self.connect_timeout)
        except asyncio.TimeoutError:
            raise HttpClientError(f"connect {host}:{port}: timed out") from None
        except OSError as e:
            raise HttpClientError(f"connect {host}:{port}: {e}") from e
        return reader, writer, False

    async def request(self, method: str, url: str, body: Optional[bytes] = None,
                      headers: Optional[Dict[str, str]] = None,
                      timeout: Optional[float] = None) -> Response:
        """Send one request and read the reply's head; ``timeout`` bounds
        the connect, the send and the head."""
        u = urlsplit(url)
        scheme = u.scheme or "http"
        port = u.port or (443 if scheme == "https" else 80)
        key = (scheme, u.hostname or "127.0.0.1", port)
        target = u.path or "/"
        if u.query:
            target += "?" + u.query
        head = [f"{method} {target} HTTP/1.1", f"Host: {key[1]}:{port}"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        payload = body or b""
        if body is not None or method in ("POST", "PUT"):
            head.append(f"Content-Length: {len(payload)}")
        raw = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + payload

        async def send(reuse_ok: bool):
            reader, writer, reused = await self._connect(key)
            try:
                writer.write(raw)
                await writer.drain()
                status_line = await reader.readline()
                if not status_line:
                    raise HttpClientError("connection closed before the reply")
                return reader, writer, status_line
            except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
                writer.close()
                if reused and reuse_ok:
                    return None   # a pooled connection the server closed: retry fresh
                raise HttpClientError(str(e)) from e

        async def go() -> Response:
            got = await send(True)
            if got is None:
                got = await send(False)
            reader, writer, status_line = got
            try:
                parts = status_line.decode("latin-1").split(" ", 2)
                status = int(parts[1])
                hdrs: Dict[str, str] = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n"):
                        break
                    if not line:
                        raise HttpClientError("connection closed inside the reply head")
                    name, _, value = line.decode("latin-1").partition(":")
                    hdrs[name.strip().lower()] = value.strip()
            except (ValueError, IndexError):
                writer.close()
                raise HttpClientError(f"bad reply head {status_line[:80]!r}") from None
            except (ConnectionError, OSError) as e:
                writer.close()
                raise HttpClientError(str(e)) from e
            resp = Response(self, key, reader, writer, status, hdrs)
            if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
                resp._remaining = 0
            return resp

        if timeout is None:
            return await go()
        try:
            return await asyncio.wait_for(go(), timeout)
        except asyncio.TimeoutError:
            raise HttpClientError(f"{method} {url}: timed out after {timeout}s") from None

    async def post_json(self, url: str, obj, timeout: Optional[float] = None) -> Response:
        return await self.request("POST", url, json.dumps(obj).encode(),
                                  {"Content-Type": "application/json"}, timeout)

    async def close(self) -> None:
        self.closed = True
        for conns in self._pool.values():
            for _, writer in conns:
                writer.close()
        self._pool.clear()
