"""The port's etcd store (dynamo_tpu_torch/runtime/discovery/etcd.py) held
to the reference's contract (tests/test_etcd_store.py) against the
in-process mock gateway (tests/etcd_gateway_mock.py): KV and prefix reads,
leases and their expiry, revoke, snapshot-then-stream watches, fragmented
watch frames, the runtime served through it. Each test runs the
reference's EtcdKVStore beside it on a gateway of its own and the two
must see the same values and the same watch events."""

import asyncio

import pytest
from etcd_gateway_mock import MockEtcdGateway

from dynamo_tpu.runtime.discovery import etcd as jetcd
from dynamo_tpu_torch.runtime.discovery import etcd as tetcd
from dynamo_tpu_torch.runtime.discovery.store import EventType, make_store
from dynamo_tpu_torch.runtime.faults import FAULTS

from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

STORES = {"port": tetcd.EtcdKVStore, "reference": jetcd.EtcdKVStore}


async def _both(fn, **gw_kwargs):
    """Run ``fn(store, gateway)`` on each package's store, each against a
    fresh gateway; return {name: result}."""
    out = {}
    for name, cls in STORES.items():
        gw = MockEtcdGateway(**gw_kwargs)
        url = await gw.start()
        store = cls(url)
        try:
            out[name] = await fn(store, gw)
        finally:
            await store.close()
            await gw.stop()
    return out


def _ev(ev):
    return (ev.type.name, ev.key, ev.value)


async def test_kv_roundtrip_and_prefix():
    async def run(store, gw):
        await store.put("v1/a/x", b"1")
        await store.put("v1/a/y", b"2")
        await store.put("v1/b/z", b"3")
        await store.put("v1/bin", bytes(range(256)))
        got = [await store.get("v1/a/x"), await store.get("v1/missing"),
               await store.list_prefix("v1/a/"), await store.get("v1/bin")]
        await store.delete("v1/a/x")
        got.append(await store.get("v1/a/x"))
        await store.put_obj("v1/obj", {"n": 7, "b": b"\x00"})
        got.append(await store.get_obj("v1/obj"))
        got.append(sorted(await store.list_prefix("v1/")))
        return got

    out = await _both(run)
    assert out["port"] == out["reference"]
    assert out["port"][:3] == [b"1", None, {"v1/a/x": b"1", "v1/a/y": b"2"}]


async def test_lease_expiry_deletes_keys():
    async def run(store, gw):
        lease = await store.create_lease(ttl_s=1.0)
        await store.put("v1/inst/1", b"alive", lease_id=lease.id)
        alive = await store.keep_alive(lease.id)
        gw.leases[int(lease.id)] = (0.0, 1.0)      # force expiry
        after = await store.keep_alive(lease.id)
        gone = await store.get("v1/inst/1")
        await store.revoke_lease(lease.id)         # unknown lease: benign
        return lease.ttl_s, alive, after, gone

    out = await _both(run)
    assert out["port"] == out["reference"] == (1.0, True, False, None)


async def test_revoke_deletes_keys():
    async def run(store, gw):
        lease = await store.create_lease(ttl_s=30.0)
        await store.put("v1/inst/2", b"x", lease_id=lease.id)
        await store.revoke_lease(lease.id)
        return await store.get("v1/inst/2")

    out = await _both(run)
    assert out["port"] is None and out["reference"] is None


@pytest.mark.parametrize("fragment", [False, True])
async def test_watch_snapshot_then_stream(fragment):
    async def run(store, gw):
        await store.put("v1/w/a", b"1")
        await store.put("v1/w/b", b"old")
        watcher = await store.watch("v1/w/")
        evs = [_ev(await asyncio.wait_for(watcher.__anext__(), 5)) for _ in range(2)]
        await asyncio.sleep(0.1)
        await store.put("v1/w/b", b"2")
        await store.put("v1/other", b"-")
        await store.delete("v1/w/a")
        for i in range(5):
            await store.put(f"v1/w/{i}", "é".encode() * i)
        for _ in range(7):
            evs.append(_ev(await asyncio.wait_for(watcher.__anext__(), 5)))
        watcher.cancel()
        return evs

    out = await _both(run, fragment_frames=fragment)
    assert out["port"] == out["reference"]
    assert out["port"][:4] == [("PUT", "v1/w/a", b"1"), ("PUT", "v1/w/b", b"old"),
                               ("PUT", "v1/w/b", b"2"), ("DELETE", "v1/w/a", None)]


async def test_watch_reconnects_through_a_dropped_stream():
    """A fault at ``discovery.watch`` drops the stream's first connection:
    the watch reconnects from the last revision it delivered and misses
    nothing."""
    gw = MockEtcdGateway()
    url = await gw.start()
    store = tetcd.EtcdKVStore(url)
    FAULTS.arm("discovery.watch:fail@1")
    try:
        watcher = await store.watch("v1/r/")
        await asyncio.sleep(0.1)
        await store.put("v1/r/a", b"1")
        ev = await asyncio.wait_for(watcher.__anext__(), 10)
        assert (ev.type, ev.key, ev.value) == (EventType.PUT, "v1/r/a", b"1")
        assert FAULTS.calls("discovery.watch") >= 2
        watcher.cancel()
    finally:
        FAULTS.disarm()
        await store.close()
        await gw.stop()


async def test_a_call_dropped_once_is_replayed():
    gw = MockEtcdGateway()
    url = await gw.start()
    store = tetcd.EtcdKVStore(url)
    FAULTS.arm("discovery.call:drop@1")
    try:
        await store.put("v1/k", b"v")
        assert await store.get("v1/k") == b"v"
        assert [f[0] for f in FAULTS.fired] == ["discovery.call"]
    finally:
        FAULTS.disarm()
        await store.close()
        await gw.stop()


async def test_serves_through_etcd_discovery():
    """An echo worker registers through make_store("etcd", url); a client
    discovers it and streams through it: the whole runtime on etcd."""
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    gw = MockEtcdGateway()
    url = await gw.start()
    store = make_store("etcd", url)
    assert isinstance(store, tetcd.EtcdKVStore)
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    rt = await DistributedRuntime(cfg, store=store).start()
    try:
        async def handler(req, ctx):
            yield {"echo": req["msg"]}

        await rt.namespace("ns").component("svc").endpoint("e").serve(handler)
        client = await rt.namespace("ns").component("svc").endpoint("e").client()
        await client.wait_for_instances(1, timeout=5.0)
        out = [item async for item in await client.generate({"msg": "hi"})]
        assert out == [{"echo": "hi"}]
    finally:
        await rt.shutdown()
        await store.close()
        await gw.stop()


def test_the_store_kind_is_read_from_the_environment(monkeypatch):
    from dynamo_tpu_torch.runtime.config import RuntimeConfig

    monkeypatch.setenv("DTPU_STORE", "etcd")
    monkeypatch.setenv("DTPU_STORE_PATH", "http://127.0.0.1:2379")
    cfg = RuntimeConfig.from_env()
    assert (cfg.store, cfg.store_path) == ("etcd", "http://127.0.0.1:2379")
    store = make_store(cfg.store, cfg.store_path)
    assert isinstance(store, tetcd.EtcdKVStore) and store.endpoint == "http://127.0.0.1:2379"
