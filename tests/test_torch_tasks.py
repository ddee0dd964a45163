"""The port's TaskTracker (dynamo_tpu_torch/runtime/tasks.py): each case of
tests/test_tasks.py (policies, hierarchy, graceful drain), then the
DistributedRuntime's own tracker: named "runtime", drained by ``shutdown``
for ``RuntimeConfig.graceful_shutdown_timeout_s`` (its layering as the
reference's config), with the keepalive outside it, and its caller in the
worker: the health-event publisher, whose events in flight at shutdown
reach the event plane's subscribers before it closes.
"""

import asyncio
import json

import pytest

from dynamo_tpu.runtime.config import RuntimeConfig as JRuntimeConfig
from dynamo_tpu_torch.engine.__main__ import health_publisher
from dynamo_tpu_torch.runtime import DistributedRuntime, MemKVStore, RuntimeConfig
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.health import HealthEvent
from dynamo_tpu_torch.runtime.tasks import ErrorPolicy, TaskHandle, TaskTracker, spawn_bg
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module


def test_spawn_and_metrics():
    async def run():
        tr = TaskTracker()

        async def work(x):
            await asyncio.sleep(0.01)
            return x * 2

        handles = [tr.spawn(lambda x=i: work(x)) for i in range(5)]
        results = await asyncio.gather(*handles)
        assert sorted(results) == [0, 2, 4, 6, 8]
        assert tr.metrics.ok == 5 and tr.metrics.failed == 0
        assert tr.metrics.active == 0

    asyncio.run(run())


def test_concurrency_limit_is_enforced():
    async def run():
        tr = TaskTracker(max_concurrency=2)
        running = [0]
        peak = [0]

        async def work():
            running[0] += 1
            peak[0] = max(peak[0], running[0])
            await asyncio.sleep(0.02)
            running[0] -= 1

        await asyncio.gather(*[tr.spawn(work) for _ in range(8)])
        assert peak[0] <= 2

    asyncio.run(run())


def test_fail_policy_records_and_continues():
    async def run():
        tr = TaskTracker(error_policy=ErrorPolicy.FAIL)

        async def boom():
            raise ValueError("x")

        with pytest.raises(ValueError):
            await tr.spawn(boom)
        assert tr.metrics.failed == 1
        assert not tr.closed  # FAIL does not close the tracker
        ok = await tr.spawn(lambda: _ret(7))
        assert ok == 7

    async def _ret(v):
        return v

    asyncio.run(run())


def test_shutdown_policy_cancels_tree():
    """A critical task failing takes down the tracker AND its children."""

    async def run():
        tr = TaskTracker(error_policy=ErrorPolicy.SHUTDOWN)
        child = tr.child("sub")
        child_cancelled = asyncio.Event()

        async def long_lived():
            try:
                await asyncio.sleep(30)
            except asyncio.CancelledError:
                child_cancelled.set()
                raise

        child.spawn(long_lived)

        async def boom():
            raise RuntimeError("critical")

        with pytest.raises(RuntimeError):
            await tr.spawn(boom)
        await asyncio.wait_for(child_cancelled.wait(), 2.0)
        assert tr.closed and child.closed
        with pytest.raises(RuntimeError):
            tr.spawn(long_lived)  # intake refused after shutdown
        assert tr.metrics.rejected == 1

    asyncio.run(run())


def test_retry_policy():
    async def run():
        attempts = [0]
        tr = TaskTracker(
            error_policy=lambda e, tid: "retry", max_retries=3
        )

        async def flaky():
            attempts[0] += 1
            if attempts[0] < 3:
                raise ValueError("flaky")
            return "ok"

        assert await tr.spawn(flaky) == "ok"
        assert attempts[0] == 3

    asyncio.run(run())


def test_graceful_shutdown_drains_then_cancels():
    async def run():
        tr = TaskTracker()
        finished = []

        async def quick():
            await asyncio.sleep(0.02)
            finished.append("quick")

        async def stuck():
            await asyncio.sleep(60)

        tr.spawn(quick)
        tr.spawn(stuck)
        ok = await tr.graceful_shutdown(timeout=0.2)
        assert not ok               # the stuck task forced a cancel
        assert finished == ["quick"]  # the quick one drained cleanly
        assert tr.metrics.cancelled == 1

    asyncio.run(run())


def test_handles_children_and_join():
    async def run():
        tr = TaskTracker(name="root")
        child = tr.child("sub", max_concurrency=1)
        assert child.name == "root/sub" and child.parent is tr
        gate = asyncio.Event()

        async def wait_gate():
            await gate.wait()
            return "opened"

        h = child.spawn(wait_gate, name="w")
        assert isinstance(h, TaskHandle) and h.task_id == "w" and not h.done
        assert not await tr.join(0.05)       # the child's task is still in flight
        gate.set()
        assert await tr.join(1.0) and await h == "opened" and h.done
        h2 = tr.spawn(lambda: asyncio.sleep(30))
        await asyncio.sleep(0)   # started, then cancelled
        h2.cancel()
        with pytest.raises(asyncio.CancelledError):
            await h2
        assert tr.metrics.cancelled == 1 and child.metrics.ok == 1
        assert await tr.graceful_shutdown(timeout=1.0)
        assert tr.closed and child.closed
        with pytest.raises(RuntimeError):
            child.spawn(wait_gate)

    asyncio.run(run())


def test_error_policy_that_raises_counts_as_fail():
    async def run():
        def policy(exc, task_id):
            raise KeyError("policy broke")

        tr = TaskTracker(error_policy=policy, max_retries=3)
        calls = [0]

        async def boom():
            calls[0] += 1
            raise ValueError("x")

        with pytest.raises(ValueError):
            await tr.spawn(boom)
        assert calls[0] == 1 and not tr.closed and isinstance(tr.last_error, ValueError)

    asyncio.run(run())


def test_spawn_bg_pins_and_logs():
    async def run():
        done = []

        async def work():
            await asyncio.sleep(0)
            done.append(1)

        t = spawn_bg(work())
        await t
        assert done == [1]

    asyncio.run(run())


def test_graceful_shutdown_timeout_layers_as_the_reference(monkeypatch, tmp_path):
    assert RuntimeConfig().graceful_shutdown_timeout_s == JRuntimeConfig().graceful_shutdown_timeout_s == 30.0
    cfg = tmp_path / "rt.json"
    cfg.write_text('{"graceful_shutdown_timeout_s": 7}')
    monkeypatch.setenv("DTPU_CONFIG", str(cfg))
    assert RuntimeConfig.from_env().graceful_shutdown_timeout_s == 7.0
    monkeypatch.setenv("DTPU_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT", "2.5")
    got = RuntimeConfig.from_env().graceful_shutdown_timeout_s
    assert got == JRuntimeConfig.from_env().graceful_shutdown_timeout_s == 2.5
    assert RuntimeConfig.from_env(graceful_shutdown_timeout_s=1.0).graceful_shutdown_timeout_s == 1.0


def test_runtime_shutdown_drains_its_tracker():
    """The runtime's tracker is named "runtime"; shutdown lets in-flight work
    finish within the timeout (the old form cancelled it at once), cancels
    what outlives it, and stops the keepalive, which lives outside the
    tracker."""

    async def run():
        rt = await DistributedRuntime(RuntimeConfig(
            store="mem", event_plane="inproc", lease_ttl_s=1.0,
            graceful_shutdown_timeout_s=0.5), store=MemKVStore()).start()
        assert rt.tasks.name == "runtime"
        finished = []

        async def quick():
            await asyncio.sleep(0.05)
            finished.append("quick")

        async def stuck():
            await asyncio.sleep(60)

        rt.tasks.spawn(quick)
        rt.tasks.spawn(stuck)
        keepalive = rt._keepalive_task
        t0 = asyncio.get_running_loop().time()
        await rt.shutdown()
        took = asyncio.get_running_loop().time() - t0
        assert finished == ["quick"] and rt.tasks.metrics.cancelled == 1
        assert 0.5 <= took < 3.0 and keepalive.done() and rt.tasks.closed

    asyncio.run(run())


def test_health_events_in_flight_reach_subscribers_at_shutdown():
    """The worker's health publisher spawns each publish under the runtime's
    tracker. An armed delay holds a publish in flight; ``shutdown`` right
    after waits for it, so the subscriber gets the event before the plane
    closes. A fire-and-forget publish would have met a closed plane and
    lost the event. An event after the drain began is dropped, not raised."""

    async def run():
        rt = await DistributedRuntime(RuntimeConfig(
            store="mem", event_plane="inproc", graceful_shutdown_timeout_s=5.0),
            store=MemKVStore()).start()
        sub = await rt.event_plane.subscribe("dtpu.health.")
        publish = health_publisher(rt, asyncio.get_running_loop())
        ev = HealthEvent(detector="cost_model_drift", subject="worker/1", kind="degraded",
                         value=2.5, expected=1.0, ratio=2.5, t=0.0)
        FAULTS.arm("event_plane.publish:delay=0.2")
        try:
            publish(ev)
            await asyncio.sleep(0)  # the loop runs the scheduled spawn
            assert rt.tasks.metrics.issued == 1 and rt.tasks.metrics.ok == 0
            await rt.shutdown()
            publish(ev)
            await asyncio.sleep(0)
        finally:
            FAULTS.disarm()
        got = await sub.next(timeout=1.0)
        assert got is not None and got[0] == "dtpu.health.cost_model_drift"
        assert json.loads(got[1]) == ev.to_dict()
        assert await sub.next(timeout=0.1) is None  # the close, not a second event
        assert rt.tasks.metrics.ok == 1 and rt.tasks.metrics.rejected == 1

    asyncio.run(run())
