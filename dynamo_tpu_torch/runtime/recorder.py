"""Generic JSONL event recorder with rotation, limits, and replay.

The port's copy of the reference package's runtime/recorder.py, the
counterpart of Dynamo's ``Recorder<T>`` (lib/llm/src/recorder.rs): producers
send events to a queue; a background task streams them to a JSONL file as
``{"timestamp": <unix_ns>, "event": ...}`` lines, rotating at
``max_lines_per_file`` and shutting down after ``max_count`` events or
``max_time_s`` seconds. ``load()``/``replay()`` re-read a recording — the
standalone router records its ingested KV-event stream this way
(``python -m dynamo_tpu_torch.router --record-events PATH``). The lines are
the reference's, field for field, so either package reads the other's.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Any, AsyncIterator, List, Optional, Tuple


class Recorder:
    def __init__(
        self,
        output_path: str,
        max_lines_per_file: Optional[int] = None,
        max_count: Optional[int] = None,
        max_time_s: Optional[float] = None,
    ):
        self.output_path = output_path
        self.max_lines_per_file = max_lines_per_file
        self.max_count = max_count
        self.max_time_s = max_time_s
        self.event_count = 0
        self._file_index = 0
        self._lines_in_file = 0
        self._first_event_at: Optional[float] = None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()

    # -- producer side --------------------------------------------------------
    def record(self, event: Any) -> bool:
        """Enqueue one event; False once limits hit (recorder draining)."""
        if self._stopped.is_set():
            return False
        self._queue.put_nowait(event)
        return True

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> "Recorder":
        self._task = asyncio.create_task(self._run())
        return self

    async def stop(self) -> None:
        self._stopped.set()
        self._queue.put_nowait(None)  # wake the writer
        if self._task is not None:
            await self._task

    def _path_for_index(self) -> str:
        if self._file_index == 0:
            return self.output_path
        base, ext = os.path.splitext(self.output_path)
        return f"{base}.{self._file_index}{ext}"

    async def _run(self) -> None:
        f = open(self._path_for_index(), "w")
        try:
            while True:
                if self._stopped.is_set() and self._queue.empty():
                    break
                try:
                    event = await asyncio.wait_for(self._queue.get(), timeout=0.25)
                except asyncio.TimeoutError:
                    f.flush()
                    if self._deadline_passed():
                        break
                    continue
                if event is None:
                    continue
                if self._first_event_at is None:
                    self._first_event_at = time.monotonic()
                f.write(json.dumps({"timestamp": time.time_ns(), "event": event}) + "\n")
                self.event_count += 1
                self._lines_in_file += 1
                if (
                    self.max_lines_per_file is not None
                    and self._lines_in_file >= self.max_lines_per_file
                ):
                    f.close()
                    self._file_index += 1
                    self._lines_in_file = 0
                    f = open(self._path_for_index(), "w")
                if self.max_count is not None and self.event_count >= self.max_count:
                    break
                if self._deadline_passed():
                    break
        finally:
            f.close()
            self._stopped.set()

    def _deadline_passed(self) -> bool:
        return (
            self.max_time_s is not None
            and self._first_event_at is not None
            and time.monotonic() - self._first_event_at >= self.max_time_s
        )

    # -- replay ---------------------------------------------------------------
    @staticmethod
    def load(path: str) -> List[Tuple[int, Any]]:
        """[(timestamp_ns, event), ...] from one recording file."""
        out: List[Tuple[int, Any]] = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                out.append((obj["timestamp"], obj["event"]))
        return out

    @staticmethod
    async def replay(
        path: str, speedup: float = 1.0
    ) -> AsyncIterator[Any]:
        """Yield events with their original pacing (scaled by ``speedup``)."""
        entries = Recorder.load(path)
        prev_ts: Optional[int] = None
        for ts, event in entries:
            if prev_ts is not None and speedup > 0:
                await asyncio.sleep((ts - prev_ts) / 1e9 / speedup)
            prev_ts = ts
            yield event
