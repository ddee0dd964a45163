"""HTTP/2 over cleartext TCP (h2c, prior knowledge) and gRPC on top of it.

The reference package serves its KServe gRPC frontend on grpcio; the
machine the port serves on has no grpcio, so this module carries the two
layers the frontend needs, on asyncio streams and hpack.py:

- ``H2Connection``: one HTTP/2 connection, either side. The connection
  preface, SETTINGS and their ACK, HEADERS with CONTINUATION (HPACK, the
  dynamic table and Huffman strings decoded), DATA with flow control in
  both directions (connection and stream windows; received data is
  credited back with WINDOW_UPDATE as the stream's reader takes it, so a
  connection buffers at most LOCAL_WINDOW bytes its reader has not taken;
  sends wait for the peer's credit), PING answered with its ACK (grpcio
  sends BDP pings), RST_STREAM and GOAWAY. PRIORITY and unknown frames are
  ignored. Its bounds: a frame over MAX_FRAME_SIZE is a FRAME_SIZE_ERROR,
  data past a window a FLOW_CONTROL_ERROR, a header block over
  MAX_HEADER_BLOCK bytes (a CONTINUATION flood) ends the connection with
  ENHANCE_YOUR_CALM, a header list over MAX_HEADER_LIST_SIZE (advertised)
  resets its stream with ENHANCE_YOUR_CALM (RESOURCE_EXHAUSTED to a gRPC
  client), and a stream past MAX_CONCURRENT_STREAMS is refused.
- ``GrpcServer``: unary-unary and unary-stream methods over length-prefixed
  messages; a reply ends with trailers carrying ``grpc-status`` and a
  percent-encoded ``grpc-message``, an error before the first message is a
  trailers-only response, a request message over grpcio's default 4 MiB
  receive limit is RESOURCE_EXHAUSTED with grpcio's words (read no further
  than its length prefix), ``grpc-timeout`` bounds the call
  (DEADLINE_EXCEEDED), and a client's RST_STREAM cancels the handler's task
  (its ``finally`` blocks stop the request's context). A stock grpcio
  client talks to it.
- ``GrpcChannel``: the same framing turned around, the client that
  chip_smoke.py and the tests use.

Messages are bytes here: the caller passes serializers, as grpcio's method
handlers take them (llm/grpc/kserve.py is the port's protobuf codec).
"""

from __future__ import annotations

import asyncio
import enum
import struct
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple

from . import hpack
from .logging import get_logger
from .tasks import spawn_bg

log = get_logger("runtime.http2")

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
END_STREAM, ACK, END_HEADERS, PADDED, PRIORITY_FLAG = 0x1, 0x1, 0x4, 0x8, 0x20

S_HEADER_TABLE_SIZE, S_ENABLE_PUSH, S_MAX_CONCURRENT_STREAMS, S_INITIAL_WINDOW_SIZE, \
    S_MAX_FRAME_SIZE, S_MAX_HEADER_LIST_SIZE = range(1, 7)

# the error codes this side sends or reads (RFC 9113 section 7)
NO_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, \
    COMPRESSION_ERROR, ENHANCE_YOUR_CALM = 0, 2, 3, 6, 7, 8, 9, 11

DEFAULT_WINDOW = 65535
LOCAL_WINDOW = 1 << 24          # what this side lets a peer send ahead
MAX_FRAME_SIZE = 16384          # the protocol's default, which this side keeps
MAX_HEADER_LIST_SIZE = 16384    # decoded, as RFC 9113 counts it (grpcio's hard limit)
MAX_HEADER_BLOCK = 1 << 16      # encoded bytes of one header block
MAX_CONCURRENT_STREAMS = 1000
# grpcio's default receive limit for one message
MAX_MESSAGE = 4 << 20

Header = Tuple[str, str]


class H2Error(ConnectionError):
    """The connection failed or was closed under a stream."""


class H2Stream:
    """One stream's received events and its send window. ``events`` yields
    ("headers", [(name, value)], end_stream), ("data", bytes, end_stream)
    and ("reset", error code)."""

    def __init__(self, conn: "H2Connection", stream_id: int):
        self.conn = conn
        self.id = stream_id
        self.events: asyncio.Queue = asyncio.Queue()
        self.send_window = conn.peer_settings[S_INITIAL_WINDOW_SIZE]
        self.recv_window = LOCAL_WINDOW
        self.remote_closed = False
        self.local_closed = False
        self.reset = False

    async def next_event(self) -> tuple:
        event = await self.events.get()
        if event[0] == "data" and event[1]:
            # the reader took the bytes: the peer may send as many again
            self.conn._credit(self, len(event[1]))
        return event

    async def send_headers(self, headers: List[Header], end_stream: bool = False) -> None:
        await self.conn.send_headers(self, headers, end_stream)

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        await self.conn.send_data(self, data, end_stream)

    def send_reset(self, code: int = CANCEL) -> None:
        self.conn.send_reset(self, code)


class H2Connection:
    """One HTTP/2 connection. ``on_stream`` (server side) is called with
    each stream the peer opens, once its first header block arrived."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, on_stream: Optional[Callable[[H2Stream], None]] = None):
        self.reader, self.writer = reader, writer
        self.client = client
        self.on_stream = on_stream
        self.peer_settings = {S_HEADER_TABLE_SIZE: 4096, S_INITIAL_WINDOW_SIZE: DEFAULT_WINDOW,
                              S_MAX_FRAME_SIZE: 16384}
        self.decoder = hpack.Decoder()
        self.streams: Dict[int, H2Stream] = {}
        self.send_window = DEFAULT_WINDOW
        self.recv_window = LOCAL_WINDOW
        self._window = asyncio.Condition()
        self._next_id = 1 if client else 2
        self._last_peer_id = 0
        self._reader_task: Optional[asyncio.Task] = None
        self.closed = asyncio.Event()
        self.goaway = False
        # a header block in progress: (stream id, end_stream, fragments)
        self._block: Optional[Tuple[int, bool, List[bytes]]] = None
        self._block_bytes = 0

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "H2Connection":
        if self.client:
            self.writer.write(PREFACE)
        else:
            got = await self.reader.readexactly(len(PREFACE))
            if got != PREFACE:
                raise H2Error("not an HTTP/2 connection preface")
        settings = b"".join(struct.pack(">HI", k, v) for k, v in (
            (S_ENABLE_PUSH, 0), (S_INITIAL_WINDOW_SIZE, LOCAL_WINDOW),
            (S_MAX_CONCURRENT_STREAMS, MAX_CONCURRENT_STREAMS),
            (S_MAX_HEADER_LIST_SIZE, MAX_HEADER_LIST_SIZE)))
        self._frame(SETTINGS, 0, 0, settings)
        self._frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", LOCAL_WINDOW - DEFAULT_WINDOW))
        await self.writer.drain()
        self._reader_task = asyncio.ensure_future(self._read_loop())
        return self

    def close(self, code: int = NO_ERROR) -> None:
        if not self.closed.is_set():
            try:
                self._frame(GOAWAY, 0, 0, struct.pack(">II", self._last_peer_id, code))
            except (H2Error, RuntimeError, OSError):
                pass      # the transport is already gone
        self._shutdown()
        if self._reader_task is not None and self._reader_task is not asyncio.current_task():
            self._reader_task.cancel()

    def _shutdown(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        for st in list(self.streams.values()):
            if not st.reset:
                st.reset = True
                st.events.put_nowait(("reset", CANCEL))
        self.streams.clear()
        try:
            self.writer.close()
        except (RuntimeError, OSError):
            pass
        # senders waiting for window credit see the close
        spawn_bg(self._wake_senders())

    async def _wake_senders(self) -> None:
        async with self._window:
            self._window.notify_all()

    # -- sending -------------------------------------------------------------
    def _frame(self, ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> None:
        if self.closed.is_set():
            raise H2Error("connection closed")
        self.writer.write(struct.pack(">I", len(payload))[1:] + bytes([ftype, flags])
                          + struct.pack(">I", stream_id) + payload)

    def open_stream(self) -> H2Stream:
        if self.goaway or self.closed.is_set():
            raise H2Error("connection is going away")
        st = H2Stream(self, self._next_id)
        self._next_id += 2
        self.streams[st.id] = st
        return st

    async def send_headers(self, st: H2Stream, headers: List[Header], end_stream: bool) -> None:
        block = hpack.encode(headers)
        size = self.peer_settings[S_MAX_FRAME_SIZE]
        parts = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        for i, part in enumerate(parts):
            flags = END_HEADERS if i == len(parts) - 1 else 0
            if i == 0:
                self._frame(HEADERS, flags | (END_STREAM if end_stream else 0), st.id, part)
            else:
                self._frame(CONTINUATION, flags, st.id, part)
        if end_stream:
            self._local_end(st)
        await self.writer.drain()

    async def send_data(self, st: H2Stream, data: bytes, end_stream: bool) -> None:
        view = memoryview(data)
        while True:
            if st.reset or self.closed.is_set():
                raise H2Error(f"stream {st.id} reset")
            if not view:
                if end_stream:
                    self._frame(DATA, END_STREAM, st.id)
                    self._local_end(st)
                break
            async with self._window:
                await self._window.wait_for(lambda: (
                    min(self.send_window, st.send_window) > 0 or st.reset
                    or self.closed.is_set()))
                if st.reset or self.closed.is_set():
                    continue
                n = min(len(view), self.send_window, st.send_window,
                        self.peer_settings[S_MAX_FRAME_SIZE])
                self.send_window -= n
                st.send_window -= n
            last = n == len(view)
            self._frame(DATA, END_STREAM if (last and end_stream) else 0, st.id,
                        bytes(view[:n]))
            view = view[n:]
            if last:
                if end_stream:
                    self._local_end(st)
                break
        await self.writer.drain()

    def send_reset(self, st: H2Stream, code: int = CANCEL) -> None:
        if st.reset or self.closed.is_set():
            return
        st.reset = True
        try:
            self._frame(RST_STREAM, 0, st.id, struct.pack(">I", code))
        except H2Error:
            pass
        self.streams.pop(st.id, None)

    def _credit(self, st: Optional[H2Stream], n: int) -> None:
        """Give ``n`` received bytes back to the connection's window and,
        while the peer may still send on it, to ``st``'s."""
        if self.closed.is_set():
            return
        try:
            self._frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", n))
            self.recv_window += n
            if st is not None and not st.remote_closed and not st.reset:
                self._frame(WINDOW_UPDATE, 0, st.id, struct.pack(">I", n))
                st.recv_window += n
        except H2Error:
            pass

    def _local_end(self, st: H2Stream) -> None:
        st.local_closed = True
        if st.remote_closed:
            self.streams.pop(st.id, None)

    # -- receiving -----------------------------------------------------------
    async def _read_loop(self) -> None:
        try:
            while True:
                head = await self.reader.readexactly(9)
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                sid = struct.unpack(">I", head[5:])[0] & 0x7FFFFFFF
                if length > MAX_FRAME_SIZE:
                    log.warning("HTTP/2 frame of %d bytes over the %d advertised", length,
                                MAX_FRAME_SIZE)
                    self.close(FRAME_SIZE_ERROR)
                    return
                payload = await self.reader.readexactly(length) if length else b""
                await self._on_frame(ftype, flags, sid, payload)
                if self.closed.is_set():
                    return
                await self.writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        except hpack.HpackError as e:
            log.warning("HTTP/2 header block does not decode: %s", e)
            self.close(COMPRESSION_ERROR)
        except Exception:
            log.exception("HTTP/2 connection failed")
            self.close(INTERNAL_ERROR)
        finally:
            self._shutdown()

    @staticmethod
    def _unpad(flags: int, payload: bytes) -> bytes:
        if flags & PADDED:
            pad = payload[0]
            return payload[1:len(payload) - pad]
        return payload

    async def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self._block is not None and ftype != CONTINUATION:
            raise H2Error("header block interrupted")
        if ftype == DATA:
            await self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            frag = self._unpad(flags, payload)
            if flags & PRIORITY_FLAG:
                frag = frag[5:]
            self._block = (sid, bool(flags & END_STREAM), [frag])
            self._block_bytes = len(frag)
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == CONTINUATION:
            if self._block is None or self._block[0] != sid:
                raise H2Error("CONTINUATION without its HEADERS")
            self._block[2].append(payload)
            self._block_bytes += len(payload)
            if self._block_bytes > MAX_HEADER_BLOCK:
                log.warning("HTTP/2 header block past %d bytes: closing", MAX_HEADER_BLOCK)
                self.close(ENHANCE_YOUR_CALM)
                return
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == SETTINGS:
            if not flags & ACK:
                await self._on_settings(payload)
                self._frame(SETTINGS, ACK, 0)
        elif ftype == PING:
            if not flags & ACK:
                self._frame(PING, ACK, 0, payload)
        elif ftype == WINDOW_UPDATE:
            inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
            async with self._window:
                if sid == 0:
                    self.send_window += inc
                elif sid in self.streams:
                    self.streams[sid].send_window += inc
                self._window.notify_all()
        elif ftype == RST_STREAM:
            st = self.streams.pop(sid, None)
            if st is not None:
                st.reset = True
                st.events.put_nowait(("reset", struct.unpack(">I", payload)[0]))
                async with self._window:
                    self._window.notify_all()
        elif ftype == GOAWAY:
            self.goaway = True
            last = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            for st_id in [i for i in self.streams if i > last and (i % 2 == 1) == self.client]:
                st = self.streams.pop(st_id)
                st.reset = True
                st.events.put_nowait(("reset", REFUSED_STREAM))
        # PRIORITY, PUSH_PROMISE (refused by ENABLE_PUSH 0) and unknown
        # frame types are ignored

    async def _on_settings(self, payload: bytes) -> None:
        for i in range(0, len(payload) - 5, 6):
            key, value = struct.unpack(">HI", payload[i:i + 6])
            if key == S_INITIAL_WINDOW_SIZE:
                delta = value - self.peer_settings[S_INITIAL_WINDOW_SIZE]
                async with self._window:
                    for st in self.streams.values():
                        st.send_window += delta
                    self._window.notify_all()
            self.peer_settings[key] = value

    async def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        data = self._unpad(flags, payload)
        end = bool(flags & END_STREAM)
        self.recv_window -= len(payload)
        if self.recv_window < 0:
            log.warning("HTTP/2 peer sent past the connection's window")
            self.close(FLOW_CONTROL_ERROR)
            return
        st = self.streams.get(sid)
        if st is None or st.remote_closed:
            # a stream this side closed or reset: its bytes go nowhere
            if payload:
                self._credit(None, len(payload))
            return
        st.recv_window -= len(payload)
        if st.recv_window < 0:
            self._credit(None, len(payload))
            st.events.put_nowait(("reset", FLOW_CONTROL_ERROR))
            self.send_reset(st, FLOW_CONTROL_ERROR)
            return
        if len(payload) > len(data):
            self._credit(st, len(payload) - len(data))       # padding
        st.events.put_nowait(("data", data, end))
        if end:
            self._remote_end(st)

    def _remote_end(self, st: H2Stream) -> None:
        st.remote_closed = True
        if st.local_closed:
            self.streams.pop(st.id, None)

    def _end_block(self) -> None:
        sid, end, frags = self._block
        self._block = None
        # decoded in full whatever its size: the table must stay in step
        headers = self.decoder.decode(b"".join(frags))
        too_large = sum(len(k) + len(v) + 32 for k, v in headers) > MAX_HEADER_LIST_SIZE
        st = self.streams.get(sid)
        if st is None:
            if self.client or sid % 2 == 0 or sid <= self._last_peer_id:
                return       # a stream this side already closed
            self._last_peer_id = sid
            opened = sum(1 for i in self.streams if i % 2 == 1)
            if too_large or opened >= MAX_CONCURRENT_STREAMS:
                self._frame(RST_STREAM, 0, sid, struct.pack(
                    ">I", ENHANCE_YOUR_CALM if too_large else REFUSED_STREAM))
                return
            st = self.streams[sid] = H2Stream(self, sid)
            st.events.put_nowait(("headers", headers, end))
            if end:
                self._remote_end(st)
            if self.on_stream is not None:
                self.on_stream(st)
            return
        if too_large:
            st.events.put_nowait(("reset", ENHANCE_YOUR_CALM))
            self.send_reset(st, ENHANCE_YOUR_CALM)
            return
        st.events.put_nowait(("headers", headers, end))
        if end:
            self._remote_end(st)


# ---------------------------------------------------------------------------
# gRPC

class StatusCode(enum.IntEnum):
    """gRPC status codes, with grpcio's names."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class GrpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class AbortError(Exception):
    """Raised by ``ServicerContext.abort``: ends the call with a status."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


def percent_encode(text: str) -> str:
    """grpc-message: UTF-8, with bytes outside 0x20-0x7E and '%' escaped."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode("utf-8"))


def percent_decode(text: str) -> str:
    raw = text.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(raw):
        if raw[i] == 0x25 and i + 3 <= len(raw):
            try:
                out.append(int(raw[i + 1:i + 3], 16))
                i += 3
                continue
            except ValueError:
                pass
        out.append(raw[i])
        i += 1
    return out.decode("utf-8", "replace")


_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


def parse_timeout(value: str) -> Optional[float]:
    """``grpc-timeout`` (digits and a unit) -> seconds, None if malformed."""
    if len(value) < 2 or value[-1] not in _TIMEOUT_UNITS or not value[:-1].isdigit():
        return None
    return int(value[:-1]) * _TIMEOUT_UNITS[value[-1]]


def frame_message(body: bytes) -> bytes:
    return b"\x00" + struct.pack(">I", len(body)) + body


class MessageReader:
    """Length-prefixed gRPC messages out of a byte stream split anyhow; a
    message whose prefix announces more than MAX_MESSAGE bytes is refused
    before its bytes are kept, in grpcio's words (``side`` is who read it)."""

    def __init__(self, side: str = "SERVER"):
        self.buf = bytearray()
        self.side = side

    def feed(self, data: bytes) -> List[bytes]:
        self.buf += data
        out = []
        while len(self.buf) >= 5:
            if self.buf[0] != 0:
                raise GrpcError(StatusCode.UNIMPLEMENTED, "compressed messages are not supported")
            n = struct.unpack(">I", self.buf[1:5])[0]
            if n > MAX_MESSAGE:
                raise GrpcError(StatusCode.RESOURCE_EXHAUSTED,
                                f"{self.side}: Received message larger than max "
                                f"({n} vs. {MAX_MESSAGE})")
            if len(self.buf) < 5 + n:
                break
            out.append(bytes(self.buf[5:5 + n]))
            del self.buf[:5 + n]
        return out


class ServicerContext:
    """What a handler gets beside its request: ``abort``, with grpcio's
    signature."""

    async def abort(self, code: StatusCode, details: str = ""):
        raise AbortError(code, details)


class _Method:
    def __init__(self, handler, streaming: bool, deserializer, serializer):
        self.handler = handler
        self.streaming = streaming
        self.deserializer = deserializer
        self.serializer = serializer


class GrpcServer:
    """Serves unary-unary and unary-stream methods by path
    (``/package.Service/Method``) on h2c."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.host, self.port = host, port
        self._methods: Dict[str, _Method] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()
        self._tasks: set = set()

    def add_unary(self, path: str, handler: Callable[[Any, ServicerContext], Awaitable[Any]],
                  deserializer: Callable[[bytes], Any], serializer: Callable[[Any], bytes]
                  ) -> None:
        self._methods[path] = _Method(handler, False, deserializer, serializer)

    def add_stream(self, path: str, handler: Callable[[Any, ServicerContext], AsyncIterator[Any]],
                   deserializer: Callable[[bytes], Any], serializer: Callable[[Any], bytes]
                   ) -> None:
        self._methods[path] = _Method(handler, True, deserializer, serializer)

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self, grace: float = 1.0) -> None:
        if self._server is None:
            return
        self._server.close()
        if self._tasks and grace > 0:
            await asyncio.wait(list(self._tasks), timeout=grace)
        for t in list(self._tasks):
            t.cancel()
        for conn in list(self._conns):
            conn.close()
        try:
            await asyncio.wait_for(self._server.wait_closed(), 2.0)
        except asyncio.TimeoutError:
            pass
        self._server = None

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = H2Connection(reader, writer, client=False, on_stream=self._on_stream)
        try:
            await conn.start()
        except (H2Error, asyncio.IncompleteReadError, ConnectionError, OSError):
            writer.close()
            return
        self._conns.add(conn)
        await conn.closed.wait()
        self._conns.discard(conn)

    def _on_stream(self, st: H2Stream) -> None:
        task = asyncio.ensure_future(self._serve_stream(st))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    @staticmethod
    def _response_headers() -> List[Header]:
        return [(":status", "200"), ("content-type", "application/grpc")]

    @staticmethod
    def _status(code: StatusCode, details: str) -> List[Header]:
        out = [("grpc-status", str(int(code)))]
        if details:
            out.append(("grpc-message", percent_encode(details)))
        return out

    async def _serve_stream(self, st: H2Stream) -> None:
        sent_headers = False

        async def finish(code: StatusCode, details: str) -> None:
            if st.reset:
                return
            if sent_headers:
                await st.send_headers(self._status(code, details), end_stream=True)
            else:     # trailers-only
                await st.send_headers(self._response_headers() + self._status(code, details),
                                      end_stream=True)

        try:
            kind, headers, end = await st.next_event()
            if kind != "headers":
                return
            h = dict(headers)
            method = self._methods.get(h.get(":path", ""))
            if h.get(":method") != "POST" or not h.get("content-type", "").startswith(
                    "application/grpc"):
                await st.send_headers([(":status", "415")], end_stream=True)
                return
            # the request body: one message, up to the client's END_STREAM
            reader = MessageReader()
            msgs: List[bytes] = []
            try:
                while not end:
                    kind, data, end = await st.next_event()
                    if kind == "reset":
                        return
                    if kind == "data":
                        msgs += reader.feed(data)
            except GrpcError as e:
                # the status, then a reset so that the client stops sending
                await finish(e.code(), e.details())
                if not st.remote_closed:
                    st.send_reset(NO_ERROR)
                return
            if method is None:
                await finish(StatusCode.UNIMPLEMENTED, "Method not found!")
                return
            if len(msgs) != 1:
                await finish(StatusCode.INTERNAL, f"expected one request message, got {len(msgs)}")
                return
            timeout = parse_timeout(h.get("grpc-timeout", "")) if "grpc-timeout" in h else None
            ctx = ServicerContext()
            request = method.deserializer(msgs[0])

            async def run() -> None:
                nonlocal sent_headers
                if method.streaming:
                    async for item in method.handler(request, ctx):
                        if not sent_headers:
                            await st.send_headers(self._response_headers())
                            sent_headers = True
                        await st.send_data(frame_message(method.serializer(item)))
                else:
                    reply = await method.handler(request, ctx)
                    body = frame_message(method.serializer(reply))
                    await st.send_headers(self._response_headers())
                    sent_headers = True
                    await st.send_data(body)

            work = asyncio.ensure_future(run())
            reset = asyncio.ensure_future(self._wait_reset(st))
            try:
                done, _ = await asyncio.wait({work, reset}, timeout=timeout,
                                             return_when=asyncio.FIRST_COMPLETED)
            finally:
                reset.cancel()
                if not work.done():
                    # a client's RST_STREAM, the deadline or the server's
                    # stop: the handler's task is cancelled (its finally
                    # blocks stop the request)
                    work.cancel()
                    await asyncio.gather(work, return_exceptions=True)
            if work not in done:
                if reset not in done:
                    await finish(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
                return
            try:
                work.result()
            except AbortError as e:
                await finish(e.code, e.details)
                return
            except (H2Error, ConnectionError):
                return
            except Exception as e:
                log.exception("gRPC handler for %s failed", h.get(":path"))
                await finish(StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}")
                return
            await finish(StatusCode.OK, "")
        except (H2Error, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("gRPC stream failed")

    @staticmethod
    async def _wait_reset(st: H2Stream) -> None:
        while True:
            kind, *_ = await st.next_event()
            if kind == "reset":
                return


class _Call:
    """One client call's stream: sends the request, then reads the reply's
    messages and its status."""

    def __init__(self, channel: "GrpcChannel", path: str, request: bytes,
                 timeout: Optional[float]):
        self.channel = channel
        self.path = path
        self.request = request
        self.timeout = timeout
        self.stream: Optional[H2Stream] = None

    async def start(self) -> None:
        conn = await self.channel._connection()
        self.stream = conn.open_stream()
        headers = [(":method", "POST"), (":scheme", "http"), (":path", self.path),
                   (":authority", self.channel.authority), ("content-type", "application/grpc"),
                   ("te", "trailers"), ("user-agent", "dynamo-tpu-torch-grpc")]
        if self.timeout is not None:
            headers.append(("grpc-timeout", f"{max(1, int(self.timeout * 1000))}m"))
        await self.stream.send_headers(headers)
        await self.stream.send_data(frame_message(self.request), end_stream=True)

    async def messages(self) -> AsyncIterator[bytes]:
        reader = MessageReader(side="CLIENT")
        status: Optional[Tuple[StatusCode, str]] = None
        got_headers = False
        while status is None:
            kind, data, *rest = await self.stream.next_event()
            if kind == "reset":
                raise GrpcError({CANCEL: StatusCode.CANCELLED,
                                 ENHANCE_YOUR_CALM: StatusCode.RESOURCE_EXHAUSTED}.get(
                                     data, StatusCode.UNAVAILABLE), f"stream reset (code {data})")
            if kind == "headers":
                h = dict(data)
                if not got_headers:
                    got_headers = True
                    if h.get(":status", "200") != "200":
                        raise GrpcError(StatusCode.UNKNOWN, f"HTTP status {h.get(':status')}")
                if "grpc-status" in h:
                    status = (StatusCode(int(h["grpc-status"])),
                              percent_decode(h.get("grpc-message", "")))
                elif rest and rest[0]:
                    status = (StatusCode.INTERNAL, "stream ended without a grpc-status")
            elif kind == "data":
                for msg in reader.feed(data):
                    yield msg
                if rest and rest[0]:
                    status = (StatusCode.INTERNAL, "stream ended without trailers")
        if status[0] != StatusCode.OK:
            raise GrpcError(*status)

    def cancel(self) -> None:
        if self.stream is not None:
            self.stream.send_reset(CANCEL)


class StreamCall:
    """A unary-stream call: iterate it for the replies; ``cancel()`` resets
    its stream."""

    def __init__(self, call: _Call, deserializer):
        self._call = call
        self._deserializer = deserializer

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        await self._call.start()
        async for msg in self._call.messages():
            yield self._deserializer(msg)

    def cancel(self) -> None:
        self._call.cancel()


class GrpcChannel:
    """A client connection to one gRPC server over h2c; calls multiplex on
    one HTTP/2 connection, opened on the first call."""

    def __init__(self, target: str):
        host, _, port = target.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.authority = target
        self._conn: Optional[H2Connection] = None
        self._lock = asyncio.Lock()

    async def _connection(self) -> H2Connection:
        async with self._lock:
            if self._conn is None or self._conn.closed.is_set() or self._conn.goaway:
                reader, writer = await asyncio.open_connection(self.host, self.port)
                self._conn = await H2Connection(reader, writer, client=True).start()
            return self._conn

    def unary_unary(self, path: str, request_serializer, response_deserializer):
        async def call(request, timeout: Optional[float] = None):
            c = _Call(self, path, request_serializer(request), timeout)

            async def run():
                await c.start()
                out = [response_deserializer(m) async for m in c.messages()]
                if len(out) != 1:
                    raise GrpcError(StatusCode.INTERNAL, f"expected one reply, got {len(out)}")
                return out[0]

            if timeout is None:
                return await run()
            try:
                return await asyncio.wait_for(run(), timeout)
            except asyncio.TimeoutError:
                c.cancel()
                raise GrpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        return call

    def unary_stream(self, path: str, request_serializer, response_deserializer):
        def call(request, timeout: Optional[float] = None) -> StreamCall:
            return StreamCall(_Call(self, path, request_serializer(request), timeout),
                              response_deserializer)
        return call

    async def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
