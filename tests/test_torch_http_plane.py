"""The port's HTTP request plane (dynamo_tpu_torch/runtime/request_plane/
http.py) held to the reference's contract: tests/test_http_plane.py's cases
on the port, each beside the reference plane on the same handler, with the
same items, errors and cancellation; the runtime served on
``request_plane="http"``; workers on both planes behind one client."""

import asyncio

import pytest

from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.request_plane import http as jhttp
from dynamo_tpu.runtime.request_plane.tcp import NoResponders as JNoResponders
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.discovery.store import MemKVStore
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.request_plane import http as thttp
from dynamo_tpu_torch.runtime.request_plane.tcp import NoResponders

from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

PLANES = {"port": (thttp, Context, NoResponders), "reference": (jhttp, JContext, JNoResponders)}


async def _echo(request, context):
    for i in range(request.get("n", 3)):
        if context.is_stopped():
            return
        yield {"i": i, "x": request.get("x")}
        await asyncio.sleep(0)


@pytest.mark.parametrize("body", [{"n": 4, "x": "v"}, {"n": 0}, {"n": 2, "x": b"\x00\xff" * 40000},
                                  {"n": 3, "x": {"nested": [1, 2.5, None, True]}}])
async def test_http_stream_roundtrip(body):
    got = {}
    for name, (mod, _, _) in PLANES.items():
        server = mod.HttpRequestServer(_echo, host="127.0.0.1")
        addr = await server.start()
        assert addr.startswith("http://")
        client = mod.HttpClient()
        try:
            got[name] = [it async for it in await client.call(addr, body)]
            assert await client.ping(addr) < 2.0
        finally:
            await client.close()
            await server.stop()
    assert got["port"] == got["reference"]
    assert got["port"] == [{"i": i, "x": body.get("x")} for i in range(body["n"])]


async def test_http_handler_error_propagates():
    async def boom(request, context):
        yield {"ok": 1}
        raise RuntimeError("kaput")

    for name, (mod, _, _) in PLANES.items():
        server = mod.HttpRequestServer(boom, host="127.0.0.1")
        addr = await server.start()
        client = mod.HttpClient()
        try:
            stream = await client.call(addr, {})
            got = [await stream.__anext__()]
            with pytest.raises(Exception, match="kaput") as err:
                await stream.__anext__()
            assert got == [{"ok": 1}]
            assert getattr(err.value, "code", None) == "internal", name
        finally:
            await client.close()
            await server.stop()


async def test_http_cancel_mid_stream():
    async def slow(request, context):
        for i in range(1000):
            if context.is_stopped():
                return
            yield {"i": i}
            await asyncio.sleep(0.01)

    for name, (mod, ctx_cls, _) in PLANES.items():
        server = mod.HttpRequestServer(slow, host="127.0.0.1")
        addr = await server.start()
        client = mod.HttpClient()
        ctx = ctx_cls("cancel-me")
        try:
            stream = await client.call(addr, {}, context=ctx)
            assert await stream.__anext__() == {"i": 0}
            ctx.stop_generating()
            got = [it async for it in stream]
            # the server saw the cancel and ended well before 1000 items
            assert len(got) < 100, name
            assert server.inflight == 0
        finally:
            await client.close()
            await server.stop()


async def test_a_client_that_goes_away_kills_its_request():
    killed = asyncio.Event()

    async def forever(request, context):
        i = 0
        while not context.is_killed():
            yield {"i": i}
            i += 1
            await asyncio.sleep(0.01)
        killed.set()

    server = thttp.HttpRequestServer(forever, host="127.0.0.1")
    addr = await server.start()
    client = thttp.HttpClient()
    try:
        stream = await client.call(addr, {})
        await stream.__anext__()
        await stream.aclose()          # drops the connection
        await asyncio.wait_for(killed.wait(), 5)
        for _ in range(50):
            if server.inflight == 0:
                break
            await asyncio.sleep(0.02)
        assert server.inflight == 0
    finally:
        await client.close()
        await server.stop()


async def test_http_no_responders():
    for name, (mod, _, no_responders) in PLANES.items():
        client = mod.HttpClient()
        try:
            with pytest.raises(no_responders):
                await client.call("http://127.0.0.1:1", {})
            with pytest.raises(no_responders):
                await client.ping("http://127.0.0.1:1", timeout=1.0)
        finally:
            await client.close()


async def test_runtime_served_over_http_plane():
    """request_plane='http' end to end through Endpoint.serve + Client."""
    store = MemKVStore()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", request_plane="http",
                        lease_ttl_s=2.0)
    rt1 = await DistributedRuntime(cfg, store=store).start()
    rt2 = await DistributedRuntime(cfg, store=store).start()
    try:
        served = await rt1.namespace("n").component("c").endpoint("e").serve(_echo)
        assert served.instance.address.startswith("http://")
        client = await rt2.namespace("n").component("c").endpoint("e").client()
        await client.wait_for_instances(1, timeout=5.0)
        out = [it async for it in await client.generate({"n": 2, "x": 9}, context=Context())]
        assert out == [{"i": 0, "x": 9}, {"i": 1, "x": 9}]
    finally:
        await rt1.shutdown()
        await rt2.shutdown()


async def test_workers_on_both_planes_behind_one_client(monkeypatch):
    """One worker on the TCP plane, one on the HTTP plane (DTPU_REQUEST_PLANE
    read by RuntimeConfig.from_env), one client that reaches both."""
    store = MemKVStore()
    monkeypatch.setenv("DTPU_REQUEST_PLANE", "http")
    http_cfg = RuntimeConfig.from_env(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    monkeypatch.delenv("DTPU_REQUEST_PLANE")
    tcp_cfg = RuntimeConfig.from_env(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    assert (http_cfg.request_plane, tcp_cfg.request_plane) == ("http", "tcp")
    rts = [await DistributedRuntime(c, store=store).start() for c in (http_cfg, tcp_cfg, tcp_cfg)]
    try:
        addrs = []
        for rt in rts[:2]:
            served = await rt.namespace("n").component("c").endpoint("e").serve(_echo)
            addrs.append(served.instance.address)
        assert addrs[0].startswith("http://") and not addrs[1].startswith("http")
        client = await rts[2].namespace("n").component("c").endpoint("e").client()
        await client.wait_for_instances(2, timeout=5.0)
        for iid in client.instance_ids():
            out = [it async for it in await client.generate({"n": 2, "x": iid},
                                                            instance_id=iid)]
            assert out == [{"i": 0, "x": iid}, {"i": 1, "x": iid}]
    finally:
        for rt in rts:
            await rt.shutdown()
