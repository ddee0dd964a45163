"""EngineWatchdog: deregister a worker the moment its engine dies.

The port's copy of the reference package's engine/monitor.py: watches
engine health and, on a step-loop crash, pulls the worker's registration
(model card + instance key) out of discovery BEFORE new requests can be
routed to it. In-flight requests already got their error frames from the
crashed loop, and the frontend's Migration operator replays them
elsewhere.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, List, Optional

from ..runtime.component import ServedEndpoint
from ..runtime.health import HealthState
from ..runtime.logging import get_logger

log = get_logger("engine.monitor")


class EngineWatchdog:
    def __init__(
        self,
        engine,                             # anything with .healthy: bool
        served: List[ServedEndpoint],
        state: Optional[HealthState] = None,
        poll_s: float = 0.25,
        on_down: Optional[Callable[[], Awaitable[None]]] = None,
    ):
        self.engine = engine
        self.served = served
        self.state = state or HealthState()
        self.poll_s = poll_s
        self.on_down = on_down
        self.fired = False
        self._task: Optional[asyncio.Task] = None
        self.state.set("engine", True)

    async def _trip(self) -> None:
        if self.fired:
            return
        self.fired = True
        self.state.set("engine", False, "engine loop crashed")
        log.error("engine unhealthy: deregistering %d endpoints", len(self.served))
        for s in self.served:
            try:
                # deletes the instance + model-card keys first, so discovery
                # drops the model before the request server stops answering
                await s.stop(graceful_timeout_s=0.5)
            except Exception:
                log.exception("deregistering %s failed", s.endpoint.path)
        if self.on_down is not None:
            await self.on_down()

    def start(self) -> "EngineWatchdog":
        # push path: the engine invokes on_crash from its crash handler, so
        # deregistration starts immediately; the poll below is the fallback
        # for engines without the hook (and for healthy flipped elsewhere)
        if hasattr(self.engine, "on_crash"):
            async def on_crash(exc: BaseException) -> None:
                await self._trip()

            self.engine.on_crash = on_crash

        async def loop() -> None:
            try:
                while True:
                    if not getattr(self.engine, "healthy", True):
                        await self._trip()
                        return
                    await asyncio.sleep(self.poll_s)
            except asyncio.CancelledError:
                pass

        self._task = asyncio.create_task(loop())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
