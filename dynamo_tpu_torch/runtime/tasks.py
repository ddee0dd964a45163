"""Hierarchical task management: tracked spawn, policies, graceful drain.

The port's copy of the reference package's runtime/tasks.py:

- ``spawn_bg(coro)`` pins a fire-and-forget task until it completes and
  logs its failure;
- ``TaskTracker.spawn(fn)`` runs a coroutine factory under a scheduling
  policy (unlimited or a concurrency-limited semaphore) and an error
  policy;
- error policies: ``FAIL`` (log + record), ``SHUTDOWN`` (a failure cancels
  the whole tracker tree: a critical task), or a custom
  ``on_error(exc, task_id) -> "fail" | "shutdown" | "retry"`` callable with
  bounded retries;
- ``child()`` trackers inherit cancellation from the parent (shutting down a
  parent drains the entire subtree);
- ``graceful_shutdown(timeout)`` stops intake, waits for in-flight work,
  then cancels stragglers: the drain ``DistributedRuntime.shutdown``
  performs (``RuntimeConfig.graceful_shutdown_timeout_s``) on the runtime's
  tracker, whose tasks in a worker are its health-event publishes
  (engine/__main__.py ``health_publisher``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import uuid
from typing import Any, Awaitable, Callable, Dict, List, Optional

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


class ErrorPolicy(enum.Enum):
    FAIL = "fail"          # record + continue
    SHUTDOWN = "shutdown"  # any failure cancels the tracker tree


@dataclasses.dataclass
class TaskMetrics:
    issued: int = 0
    started: int = 0
    ok: int = 0
    failed: int = 0
    cancelled: int = 0
    rejected: int = 0

    @property
    def active(self) -> int:
        return self.started - self.ok - self.failed - self.cancelled


class TaskHandle:
    """Await-able handle with cancellation."""

    def __init__(self, task_id: str, task: asyncio.Task):
        self.task_id = task_id
        self._task = task

    def cancel(self) -> None:
        self._task.cancel()

    @property
    def done(self) -> bool:
        return self._task.done()

    def __await__(self):
        return self._task.__await__()


class TaskTracker:
    def __init__(
        self,
        max_concurrency: Optional[int] = None,
        error_policy: Any = ErrorPolicy.FAIL,
        max_retries: int = 0,
        name: str = "root",
        parent: Optional["TaskTracker"] = None,
    ):
        self.name = name
        self.parent = parent
        self.error_policy = error_policy
        self.max_retries = max_retries
        self.metrics = TaskMetrics()
        self._sem = (
            asyncio.Semaphore(max_concurrency) if max_concurrency else None
        )
        self._tasks: Dict[str, asyncio.Task] = {}
        self._children: List["TaskTracker"] = []
        self._closed = False
        self.last_error: Optional[BaseException] = None

    # -- hierarchy -----------------------------------------------------------
    def child(self, name: str, **kw) -> "TaskTracker":
        c = TaskTracker(name=f"{self.name}/{name}", parent=self, **kw)
        self._children.append(c)
        return c

    @property
    def closed(self) -> bool:
        return self._closed or (self.parent is not None and self.parent.closed)

    # -- spawning ------------------------------------------------------------
    def spawn(
        self,
        fn: Callable[[], Awaitable[Any]],
        name: Optional[str] = None,
    ) -> TaskHandle:
        """Run ``fn()`` (a coroutine factory, so retries can re-invoke it)
        under the tracker's policies. Raises RuntimeError once closed."""
        if self.closed:
            self.metrics.rejected += 1
            raise RuntimeError(f"tracker {self.name} is shut down")
        task_id = name or uuid.uuid4().hex[:8]
        self.metrics.issued += 1
        task = asyncio.create_task(self._run(task_id, fn))
        self._tasks[task_id] = task

        def _cleanup(t: asyncio.Task) -> None:
            # only evict OUR entry: a later spawn under the same name must
            # not lose tracking when the earlier task finishes
            if self._tasks.get(task_id) is t:
                self._tasks.pop(task_id, None)

        task.add_done_callback(_cleanup)
        return TaskHandle(task_id, task)

    async def _run(self, task_id: str, fn: Callable[[], Awaitable[Any]]) -> Any:
        attempt = 0
        while True:
            if self._sem is not None:
                await self._sem.acquire()
            self.metrics.started += 1
            try:
                result = await fn()
                self.metrics.ok += 1
                return result
            except asyncio.CancelledError:
                self.metrics.cancelled += 1
                raise
            except Exception as e:
                self.metrics.failed += 1
                self.last_error = e
                decision = self._decide(e, task_id)
                if decision == "retry" and attempt < self.max_retries:
                    attempt += 1
                    log.warning(
                        "task %s/%s failed (%r); retry %d/%d",
                        self.name, task_id, e, attempt, self.max_retries,
                    )
                    continue
                if decision == "shutdown":
                    log.error(
                        "critical task %s/%s failed (%r); shutting tracker down",
                        self.name, task_id, e,
                    )
                    self.shutdown()
                else:
                    log.exception("task %s/%s failed", self.name, task_id)
                raise
            finally:
                if self._sem is not None:
                    self._sem.release()

    def _decide(self, exc: Exception, task_id: str) -> str:
        if callable(self.error_policy):
            try:
                return self.error_policy(exc, task_id)
            except Exception:
                log.exception("error policy itself failed; treating as FAIL")
                return "fail"
        if self.error_policy is ErrorPolicy.SHUTDOWN:
            return "shutdown"
        return "retry" if self.max_retries else "fail"

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        """Immediate: cancel everything in this tracker and its subtree."""
        self._closed = True
        for t in list(self._tasks.values()):
            t.cancel()
        for c in self._children:
            c.shutdown()

    async def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for in-flight tasks (and children). True if all finished."""
        tasks = list(self._tasks.values())
        done_all = True
        if tasks:
            done, pending = await asyncio.wait(
                tasks, timeout=timeout,
                return_when=asyncio.ALL_COMPLETED,
            )
            done_all = not pending
        for c in self._children:
            done_all = await c.join(timeout) and done_all
        return done_all

    async def graceful_shutdown(self, timeout: float = 10.0) -> bool:
        """Drain: stop intake, wait up to ``timeout``, then cancel stragglers.
        Returns True when everything finished within the deadline."""
        self._closed = True
        for c in self._children:
            c._closed = True
        finished = await self.join(timeout)
        if not finished:
            log.warning(
                "tracker %s drain timed out after %.1fs; cancelling %d tasks",
                self.name, timeout, self.metrics.active,
            )
            self.shutdown()
            await self.join(2.0)
        return finished
