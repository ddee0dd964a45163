"""The cross-process event plane: a forwarding broker on asyncio sockets.

The port's counterpart of the reference package's
runtime/event_plane/zmq_plane.py, with the standard library in place of
ZeroMQ (the machine the port serves on has no pyzmq). It is selected by
the reference's value, ``DTPU_EVENT_PLANE=zmq`` / ``--event-plane zmq``,
so the reference's launch lines work unchanged; it is not wire-compatible
with ZeroMQ.

Many publishers and many subscribers meet at one small broker whose
address lives in the discovery store under ``v1/event_broker``; the first
runtime to come up starts it on its lease (``event_plane_from_store``).

Wire: each frame is ``u32 big-endian length || MessagePack array`` on the
port's codec (runtime/codec.py):

    [topic: str, payload: bytes]   an event (publisher -> broker -> subscriber)
    [prefix: str]                  a subscription (subscriber -> broker; the
                                   broker echoes it once it is registered)

A subscriber receives every event whose topic starts with its prefix, in
the order each publisher sent them. Publishing never waits on the network:
``publish`` queues the frame and returns, and one writer task per plane
sends the queue, so a slow or dead broker or subscriber never delays the
caller (an engine's step loop). The broker likewise gives each subscriber
its own queue and writer. As in ZeroMQ pub/sub, delivery is best-effort:
a subscriber sees only events published after its subscription, a full
queue drops its oldest frames, and a lost connection is re-dialled (a
subscriber re-subscribes) to the same address until the plane closes.
"""

from __future__ import annotations

import asyncio
import collections
import struct
from typing import Deque, List, Optional, Set, Tuple

from .. import codec
from ..discovery.store import KVStore
from ..faults import FAULTS
from ..logging import get_logger
from ..tasks import spawn_bg
from .base import EventPlane, Subscription

log = get_logger("runtime.event_plane.tcp")

BROKER_KEY = "v1/event_broker"

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024
# frames a queue holds before it drops its oldest (ZeroMQ's default high
# water mark is 1000 messages; a KV event batch is a few hundred bytes)
QUEUE_FRAMES = 65536
RECONNECT_S = (0.05, 1.0)   # first and largest re-dial delay


def _frame(obj) -> bytes:
    body = codec.packb(obj)
    return _LEN.pack(len(body)) + body


async def _read_frame(reader: asyncio.StreamReader):
    """The next frame, or None at end of stream."""
    try:
        (n,) = _LEN.unpack(await reader.readexactly(_LEN.size))
        if n > MAX_FRAME:
            raise ConnectionError(f"event frame of {n} bytes")
        return codec.unpackb(await reader.readexactly(n))
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return None


def _parse_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host, int(port)


class _Outbox:
    """A bounded frame queue drained by one writer task: ``put`` never
    blocks; past ``QUEUE_FRAMES`` the oldest frame is dropped."""

    def __init__(self, name: str):
        self.name = name
        self._frames: Deque[bytes] = collections.deque()
        self._ready = asyncio.Event()
        self.dropped = 0

    def put(self, frame: bytes) -> None:
        if len(self._frames) >= QUEUE_FRAMES:
            self._frames.popleft()
            self.dropped += 1
            if self.dropped == 1 or self.dropped % 10000 == 0:
                log.warning("%s: event queue full, %d frames dropped", self.name, self.dropped)
        self._frames.append(frame)
        self._ready.set()

    async def take(self) -> bytes:
        while not self._frames:
            self._ready.clear()
            await self._ready.wait()
        return self._frames.popleft()

    def __len__(self) -> int:
        return len(self._frames)


class _Peer:
    """One connection at the broker: its subscriptions and its outbox."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.prefixes: List[str] = []
        self.outbox = _Outbox("broker -> subscriber")
        self.task: Optional[asyncio.Task] = None

    async def pump(self) -> None:
        try:
            while True:
                frame = await self.outbox.take()
                self.writer.write(frame)
                await self.writer.drain()
        except (ConnectionError, OSError):
            pass


class TcpBroker:
    """The forwarder every plane of a deployment connects to."""

    def __init__(self, host: str = "127.0.0.1"):
        self._host = host
        self._server: Optional[asyncio.AbstractServer] = None
        self._peers: Set[_Peer] = set()
        self.addr = ""
        self.forwarded = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve, self._host, 0)
        port = self._server.sockets[0].getsockname()[1]
        self.addr = f"{self._host}:{port}"
        log.debug("event broker up at %s", self.addr)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        peer = _Peer(writer)
        peer.task = spawn_bg(peer.pump())
        self._peers.add(peer)
        try:
            while True:
                frame = await _read_frame(reader)
                if not isinstance(frame, list):
                    break
                if len(frame) == 2:
                    topic, payload = frame
                    data = _frame([topic, payload])
                    for p in self._peers:
                        if any(topic.startswith(pre) for pre in p.prefixes):
                            p.outbox.put(data)
                    self.forwarded += 1
                elif len(frame) == 1:
                    peer.prefixes.append(frame[0])
                    peer.outbox.put(_frame([frame[0]]))   # the acknowledgement
        except asyncio.CancelledError:
            pass
        finally:
            self._peers.discard(peer)
            peer.task.cancel()
            writer.close()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for p in list(self._peers):
            p.task.cancel()
            p.writer.close()
        self._peers.clear()


class TcpEventPlane(EventPlane):
    def __init__(self, addr: str, broker: Optional[TcpBroker] = None):
        self.addr = addr
        self._broker = broker  # set if this plane founded the broker
        self._outbox = _Outbox(f"events -> {addr}")
        self._writer_task: Optional[asyncio.Task] = None
        self._subs: List[Tuple[Subscription, asyncio.Task]] = []
        self._closed = False

    async def _dial(self, what: str):
        """Connect to the broker, re-dialling with backoff until it answers;
        None once the plane closes."""
        delay = RECONNECT_S[0]
        host, port = _parse_addr(self.addr)
        while not self._closed:
            try:
                return await asyncio.open_connection(host, port)
            except OSError as e:
                log.debug("%s: broker %s unreachable (%s); re-dialling", what, self.addr, e)
            await asyncio.sleep(delay)
            delay = min(delay * 2, RECONNECT_S[1])
        return None

    async def _write_loop(self) -> None:
        while True:
            conn = await self._dial("publisher")
            if conn is None:
                return
            writer = conn[1]
            try:
                while True:
                    frame = await self._outbox.take()
                    writer.write(frame)
                    await writer.drain()
            except (ConnectionError, OSError) as e:
                log.warning("event publish connection to %s lost: %s", self.addr, e)
            finally:
                writer.close()

    async def publish(self, topic: str, payload: bytes) -> None:
        if self._closed:
            return
        try:
            await FAULTS.ainject("event_plane.publish")
        except ConnectionError as e:
            # best-effort pub/sub: a dropped publish loses the event (the
            # routers resync from later events), never the publisher's loop;
            # the writer task re-dials a lost broker on its own, so there is
            # no send here to retry
            log.warning("event publish dropped (%s): %s", topic, e)
            return
        payload = FAULTS.mangle("event_plane.publish", payload)
        self._outbox.put(_frame([topic, payload]))
        if self._writer_task is None:
            self._writer_task = spawn_bg(self._write_loop())

    async def subscribe(self, topic_prefix: str) -> Subscription:
        sub = Subscription()
        acked = asyncio.get_running_loop().create_future()

        async def recv_loop() -> None:
            try:
                while True:
                    conn = await self._dial("subscriber")
                    if conn is None:
                        return
                    reader, writer = conn
                    try:
                        writer.write(_frame([topic_prefix]))
                        await writer.drain()
                        while True:
                            frame = await _read_frame(reader)
                            if frame is None:
                                break
                            if len(frame) == 2:
                                sub._emit(frame[0], frame[1])
                            elif not acked.done():
                                acked.set_result(None)
                    except (ConnectionError, OSError):
                        pass
                    finally:
                        writer.close()
                    log.warning("event subscription %r: broker %s connection lost",
                                topic_prefix, self.addr)
            except asyncio.CancelledError:
                pass

        task = spawn_bg(recv_loop())
        self._subs.append((sub, task))
        orig_cancel = sub.cancel

        def cancel() -> None:
            task.cancel()
            orig_cancel()

        sub.cancel = cancel  # type: ignore[method-assign]
        try:
            # the broker echoes the subscription once it is registered: every
            # event published after this returns reaches the subscriber
            await asyncio.wait_for(asyncio.shield(acked), 10.0)
        except asyncio.TimeoutError:
            log.warning("event subscription %r: no acknowledgement from %s yet",
                        topic_prefix, self.addr)
        return sub

    async def close(self) -> None:
        if self._closed:
            return
        # give the writer a moment to send what is queued
        for _ in range(50):
            if not len(self._outbox) or self._writer_task is None:
                break
            await asyncio.sleep(0.01)
        self._closed = True
        if self._writer_task is not None:
            self._writer_task.cancel()
        for sub, task in self._subs:
            task.cancel()
            sub.cancel()
        if self._broker is not None:
            await self._broker.stop()


async def event_plane_from_store(store: KVStore, lease_id: Optional[str] = None) -> EventPlane:
    """Join (or found) the process-shared event plane via the store.

    Founding is racy (no compare-and-swap in the store interface), so after
    publishing our broker we re-read: if another founder's record won, we
    tear our broker down and join theirs — everyone converges on one broker.
    """
    rec = await store.get_obj(BROKER_KEY)
    if rec is not None:
        return TcpEventPlane(rec["addr"])
    broker = TcpBroker()
    await broker.start()
    ours = {"addr": broker.addr}
    await store.put_obj(BROKER_KEY, ours, lease_id)
    await asyncio.sleep(0.05)  # let a concurrent founder's put land
    rec = await store.get_obj(BROKER_KEY) or ours
    if rec != ours:
        await broker.stop()
        return TcpEventPlane(rec["addr"])
    return TcpEventPlane(rec["addr"], broker=broker)
