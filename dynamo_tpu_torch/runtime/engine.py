"""Streaming engine protocol and cancellation contexts.

The port's copy of the reference package's runtime/engine.py. Every unit
of work (preprocessor, router, engine) is an async callable
``generate(request, context) -> AsyncIterator[response]``. Cancellation is
cooperative: ``Context.stop_generating()`` asks the producer to wind down
gracefully, ``kill()`` demands immediate teardown; contexts form a tree so
cancelling a parent cancels its children.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, AsyncIterator, Callable, List, Optional, Protocol, runtime_checkable


class Context:
    """Cancellation + identity context for one in-flight request."""

    __slots__ = ("id", "_stopped", "_killed", "_children", "_parent", "_callbacks")

    def __init__(self, request_id: Optional[str] = None, parent: Optional["Context"] = None):
        self.id: str = request_id or uuid.uuid4().hex
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._children: List["Context"] = []
        self._parent = parent
        self._callbacks: List[Callable[[], None]] = []

    # -- tree ---------------------------------------------------------------
    def child(self, request_id: Optional[str] = None) -> "Context":
        c = Context(request_id or self.id, parent=self)
        if self.is_stopped():
            c._stopped.set()
        if self.is_killed():
            c._killed.set()
        self._children.append(c)
        return c

    def detach(self) -> None:
        if self._parent is not None and self in self._parent._children:
            self._parent._children.remove(self)
        self._parent = None

    # -- cancellation -------------------------------------------------------
    def stop_generating(self) -> None:
        """Graceful stop: producer should finish the current token and end."""
        self._stopped.set()
        for cb in self._callbacks:
            cb()
        for c in self._children:
            c.stop_generating()

    def kill(self) -> None:
        """Hard cancel: producer must abandon in-flight work."""
        self._killed.set()
        self._stopped.set()
        for cb in self._callbacks:
            cb()
        for c in self._children:
            c.kill()

    def on_cancel(self, cb: Callable[[], None]) -> None:
        self._callbacks.append(cb)
        if self.is_stopped():
            cb()

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def stopped(self) -> None:
        await self._stopped.wait()

    async def killed(self) -> None:
        await self._killed.wait()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Context(id={self.id!r}, stopped={self.is_stopped()}, killed={self.is_killed()})"


@runtime_checkable
class AsyncEngine(Protocol):
    """Anything that turns a request into an async stream of responses."""

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        ...


class FnEngine:
    """Wrap a plain async-generator function as an AsyncEngine."""

    def __init__(self, fn: Callable[[Any, Context], AsyncIterator[Any]], name: str = "fn"):
        self._fn = fn
        self.name = name

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        return self._fn(request, context)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FnEngine({self.name})"


class Operator:
    """A pipeline stage wrapping the next engine: transforms a request on
    the way in and the response stream on the way out."""

    def __init__(self, downstream: AsyncEngine):
        self.downstream = downstream

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        async for item in self.downstream.generate(request, context):
            yield item


async def collect(stream: AsyncIterator[Any]) -> List[Any]:
    """Drain a response stream into a list (test/batch helper)."""
    out = []
    async for item in stream:
        out.append(item)
    return out
