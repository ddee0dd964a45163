"""The port's cross-process event plane (runtime/event_plane/tcp_plane.py,
selected as ``zmq``) against the reference's ZeroMQ plane, on the CPU.

- Topic prefixes: the same publishes reach the same subscriptions, in the
  same order, on both planes; a subscription set up in another process
  receives a publisher's events in order.
- Founding: two runtimes started together on one store converge on one
  broker, one of them its founder, on both planes. The broker lives on its
  founder's lease: once the founder stops, its key is gone, a survivor's
  publish still returns at once and reaches nobody, and a runtime started
  afterwards founds a new broker the survivors do not join. That is what
  the reference's plane does, and the test holds both to it.
- Never blocking: ``publish`` completes without suspending (it queues the
  frame); a subscriber that never reads, or a dead broker, does not stop
  the publisher, and a live subscriber still receives every event.
"""

import asyncio
import os
import socket
import sys
import time


from dynamo_tpu.runtime import DistributedRuntime as JRuntime
from dynamo_tpu.runtime import MemKVStore as JMemKVStore
from dynamo_tpu.runtime import RuntimeConfig as JConfig
from dynamo_tpu.runtime.event_plane import zmq_plane
from dynamo_tpu_torch.runtime import DistributedRuntime, MemKVStore, RuntimeConfig
from dynamo_tpu_torch.runtime.event_plane import tcp_plane
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPICS = ["kv.events.ns.backend", "kv.metrics.ns.backend", "kv.events.ns.prefill",
          "kv.sync.ns.backend", "kv.events.other.backend", "health.ns"]
PREFIXES = ["kv.events.ns.", "kv.metrics.", "kv.", "health", "nothing.here"]


class Side:
    """One package's runtime class, store class, config class and plane module."""

    def __init__(self, name, runtime, store, config, plane):
        self.name, self.runtime, self.store, self.config, self.plane = (
            name, runtime, store, config, plane)

    async def runtimes(self, n, store=None):
        store = store or self.store()
        rts = [self.runtime(self.config(event_plane="zmq"), store=store) for _ in range(n)]
        await asyncio.gather(*(rt.start() for rt in rts))
        return store, rts


PORT = Side("port", DistributedRuntime, MemKVStore, RuntimeConfig, tcp_plane)
REF = Side("reference", JRuntime, JMemKVStore, JConfig, zmq_plane)


async def drain(sub, timeout=0.5):
    out = []
    while True:
        item = await sub.next(timeout)
        if item is None:
            return out
        out.append(item)


async def prefix_deliveries(side: Side):
    _, (a, b) = await side.runtimes(2)
    try:
        subs = [await b.event_plane.subscribe(p) for p in PREFIXES]
        for i in range(30):
            await a.event_plane.publish(TOPICS[i % len(TOPICS)], b"%d" % i)
        return [await drain(s) for s in subs]
    finally:
        await a.shutdown()
        await b.shutdown()


async def test_topic_prefixes_deliver_as_the_reference_does():
    got = await prefix_deliveries(PORT)
    want = await prefix_deliveries(REF)
    assert got == want
    assert [len(g) for g in got] == [10, 5, 25, 5, 0]
    assert got[2][0] == ("kv.events.ns.backend", b"0")


async def test_a_publisher_in_another_process_reaches_a_subscriber_in_order():
    _, (rt,) = await PORT.runtimes(1)
    try:
        sub = await rt.event_plane.subscribe("kv.events.")
        code = (
            "import asyncio, sys\n"
            "from dynamo_tpu_torch.runtime.event_plane.tcp_plane import TcpEventPlane\n"
            "async def main():\n"
            f"    plane = TcpEventPlane({rt.event_plane.addr!r})\n"
            "    for i in range(200):\n"
            "        await plane.publish('kv.events.ns.c' if i % 2 else 'kv.metrics.ns.c',\n"
            "                            i.to_bytes(4, 'big'))\n"
            "    await plane.close()\n"
            "asyncio.run(main())\n")
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-c", code, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
        assert await proc.wait() == 0
        got = await drain(sub, timeout=2.0)
        assert [int.from_bytes(p, "big") for _, p in got] == list(range(1, 200, 2))
        assert {t for t, _ in got} == {"kv.events.ns.c"}
    finally:
        await rt.shutdown()


async def founding(side: Side):
    """Two runtimes started together; then the founder stops; then a third
    runtime starts. What each step leaves behind."""
    store, (a, b) = await side.runtimes(2)
    planes = [a.event_plane, b.event_plane]
    founders = [p._broker is not None for p in planes]
    rec = await store.get_obj(side.plane.BROKER_KEY)
    same = (planes[0].addr == planes[1].addr if side is PORT
            else planes[0]._sub_addr == planes[1]._sub_addr)
    founder, survivor = (a, b) if founders[0] else (b, a)
    sub = await survivor.event_plane.subscribe("kv.")
    await founder.event_plane.publish("kv.events.x", b"before")
    before = await drain(sub)
    await founder.shutdown()
    key_after_stop = await store.get_obj(side.plane.BROKER_KEY)
    t0 = time.perf_counter()
    await survivor.event_plane.publish("kv.events.x", b"after")
    publish_s = time.perf_counter() - t0
    after = await drain(sub)
    _, (late,) = await side.runtimes(1, store)
    late_founded = late.event_plane._broker is not None
    await late.event_plane.publish("kv.events.x", b"late")
    late_reached_survivor = await drain(sub)
    for rt in (survivor, late):
        await rt.shutdown()
    return {"founders": sorted(founders), "one_record": rec is not None, "same_broker": same,
            "before": before, "key_after_stop": key_after_stop, "publish_s": publish_s,
            "after": after, "late_founded": late_founded,
            "late_reached_survivor": late_reached_survivor}


async def test_founding_race_and_founder_stop_match_the_reference():
    got = await founding(PORT)
    want = await founding(REF)
    for r in (got, want):
        # the reference's first publish waits out a 0.15 s slow-joiner
        # beat; the port's queues at once
        assert r["publish_s"] < 0.5, r
        r.pop("publish_s")
    assert got == want
    assert got["founders"] == [False, True] and got["same_broker"]
    assert got["before"] == [("kv.events.x", b"before")]
    assert got["key_after_stop"] is None
    assert got["after"] == [] and got["late_founded"] and got["late_reached_survivor"] == []


def test_publish_never_suspends():
    """``publish`` returns on its first step: it queues the frame, so an
    engine tick that publishes never waits on a socket (here: a broker
    address nobody listens on)."""

    async def main():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = f"127.0.0.1:{s.getsockname()[1]}"
        plane = tcp_plane.TcpEventPlane(dead)
        for i in range(1000):
            coro = plane.publish("kv.events.ns.c", b"x" * 100)
            try:
                coro.send(None)
            except StopIteration:
                pass
            else:  # pragma: no cover - the failure being tested for
                coro.close()
                raise AssertionError(f"publish {i} suspended")
        assert len(plane._outbox) == 1000
        await plane.close()

    asyncio.run(main())


async def test_a_subscriber_that_never_reads_blocks_no_one():
    """A raw connection subscribes and never reads; 20 MB of events later
    the publisher never suspended, a live subscriber received every event
    in order, and the broker kept forwarding."""
    _, (rt,) = await PORT.runtimes(1)
    try:
        host, port = tcp_plane._parse_addr(rt.event_plane.addr)
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(tcp_plane._frame(["kv."]))
        await writer.drain()
        live = await rt.event_plane.subscribe("kv.")
        payload = b"y" * 4096
        n = 5000
        got = []

        async def consume():
            while len(got) < n:
                item = await live.next(10.0)
                assert item is not None, f"live subscriber stalled after {len(got)}"
                got.append(item)

        task = asyncio.ensure_future(consume())
        for i in range(n):
            coro = rt.event_plane.publish("kv.events.ns.c", i.to_bytes(4, "big") + payload)
            try:
                coro.send(None)
            except StopIteration:
                pass
            else:  # pragma: no cover
                raise AssertionError("publish suspended")
            if i % 100 == 0:
                await asyncio.sleep(0)
        await asyncio.wait_for(task, 30.0)
        assert [int.from_bytes(p[:4], "big") for _, p in got] == list(range(n))
        assert rt.event_plane._broker.forwarded == n
        writer.close()
    finally:
        await rt.shutdown()
