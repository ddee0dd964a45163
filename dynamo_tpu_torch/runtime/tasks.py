"""Background tasks that are neither lost nor silent.

The port's copy of ``spawn_bg`` and ``TaskTracker`` from the reference
package's runtime/tasks.py, the tracker cut to what the port's one user,
``DistributedRuntime``, needs: its tasks cancelled and awaited at
shutdown. The reference's scheduling and error policies, retries and
child trackers wait for a caller (ROADMAP item 4b).
"""

from __future__ import annotations

import asyncio

from .logging import get_logger

log = get_logger("runtime.tasks")


# fire-and-forget background tasks: the event loop holds tasks only by WEAK
# reference, so a task whose handle is discarded can be garbage-collected
# mid-flight and silently die. spawn_bg pins the task until it completes.
_BG_TASKS: set = set()


def _bg_done(task: "asyncio.Task") -> None:
    _BG_TASKS.discard(task)
    if not task.cancelled() and task.exception() is not None:
        log.error("background task failed: %r", task.exception())


def spawn_bg(coro) -> "asyncio.Task":
    task = asyncio.ensure_future(coro)
    _BG_TASKS.add(task)
    task.add_done_callback(_bg_done)
    return task


class TaskTracker:
    """Tasks spawned as ``spawn_bg`` spawns them, and cancelled and awaited
    together by ``shutdown``."""

    def __init__(self):
        self._tasks: set = set()

    def spawn(self, coro) -> "asyncio.Task":
        task = spawn_bg(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def shutdown(self) -> None:
        tasks = list(self._tasks)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
