"""Event plane interface: fire-and-forget pub/sub for KV events + metrics.

The port's copy of the reference package's runtime/event_plane/base.py:
topics are dot-separated strings, subscriptions match by prefix, payloads
are opaque bytes. ``InProcEventPlane`` serves one process; tcp_plane.py is
the cross-process plane. Both carry the ``event_plane.publish`` fault point
(runtime/faults.py): an armed drop loses the event with a warning, never
the publisher's loop, and an armed corrupt flips the payload's first byte.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional, Tuple

from ..faults import FAULTS
from ..logging import get_logger

log = get_logger("runtime.event_plane")


class Subscription:
    def __init__(self):
        self._queue: asyncio.Queue = asyncio.Queue()
        self._closed = False

    def _emit(self, topic: str, payload: bytes) -> None:
        if not self._closed:
            self._queue.put_nowait((topic, payload))

    def __aiter__(self) -> AsyncIterator[Tuple[str, bytes]]:
        return self

    async def __anext__(self) -> Tuple[str, bytes]:
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    async def next(self, timeout: Optional[float] = None) -> Optional[Tuple[str, bytes]]:
        try:
            item = await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None
        return item

    def cancel(self) -> None:
        self._closed = True
        self._queue.put_nowait(None)


class EventPlane:
    async def publish(self, topic: str, payload: bytes) -> None:
        raise NotImplementedError

    async def subscribe(self, topic_prefix: str) -> Subscription:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class InProcEventPlane(EventPlane):
    """Same-process pub/sub: deterministic and instant, the test default."""

    def __init__(self):
        self._subs: list = []  # (prefix, Subscription)

    async def publish(self, topic: str, payload: bytes) -> None:
        try:
            await FAULTS.ainject("event_plane.publish")
        except ConnectionError as e:
            # events are fire-and-forget: a dropped publish degrades
            # (consumers resync from snapshots), it must not crash the
            # publisher's loop
            log.warning("event publish dropped (%s): %s", topic, e)
            return
        payload = FAULTS.mangle("event_plane.publish", payload)
        for prefix, sub in list(self._subs):
            if topic.startswith(prefix):
                sub._emit(topic, payload)

    async def subscribe(self, topic_prefix: str) -> Subscription:
        sub = Subscription()
        self._subs.append((topic_prefix, sub))
        return sub

    async def close(self) -> None:
        for _, sub in self._subs:
            sub.cancel()
        self._subs.clear()
