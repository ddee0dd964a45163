"""The injectable time source for pace-and-stamp code.

The port's copy of the reference package's runtime/clock.py. ``Clock`` is
the funnel the KV router takes for metric staleness, approximate-index TTLs
and the replica-sync answer jitter; the default ``WALL`` instance is live
time (``time.monotonic`` + ``asyncio.sleep``), and a simulator or a test
injects its own clock instead.
"""

from __future__ import annotations

import asyncio
import time


class Clock:
    """Wall-clock time source: ``time()`` seconds + async ``sleep``.

    Intervals only — ``time()`` is monotonic, not epoch-anchored, so callers
    must treat values as differences.
    """

    def time(self) -> float:
        return time.monotonic()

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(max(dt, 0.0))


WALL = Clock()
