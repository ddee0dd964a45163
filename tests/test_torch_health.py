"""The port's health subsystem against the reference's, on the CPU.

Mirrors tests/test_health.py one case a test: the canary over each
package's own TCP request plane and status server (the port's on its own
HTTP server), a canary whose unhealthy callback raises, a stale pong
discarded, an engine crash (a TorchEngine whose step raises, beside a
TpuEngine whose device programs raise) that deregisters the model before
requests fail, and a graceful stop that drains the stream in flight. Each
scenario runs on both packages, and the health snapshots, HTTP statuses
and bodies must be equal, the canary's RTT masked.
"""

import asyncio
import re

import aiohttp
import pytest

from dynamo_tpu import llm as jllm
from dynamo_tpu import runtime as jrt
from dynamo_tpu.engine.monitor import EngineWatchdog as JWatchdog
from dynamo_tpu.llm.http.service import HttpService as JHttpService
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    StopConditions as JStop,
)
from dynamo_tpu_torch.engine.monitor import EngineWatchdog
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.engines import EchoEngine
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.runtime import (
    Context,
    DistributedRuntime,
    InProcEventPlane,
    MemKVStore,
    NoResponders,
    RuntimeConfig,
    TcpClient,
)
from dynamo_tpu_torch.runtime.health import EndpointCanary, HealthState, StatusServer
from torch_feature_engines import Weights
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, alive by its name in this module

MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64, 128, 256))


class Side:
    """One package's runtime, canary, status server and engine classes."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            self.store, self.plane = MemKVStore, InProcEventPlane
            self.rt_cls, self.cfg = DistributedRuntime, RuntimeConfig
            self.echo, self.state, self.canary = EchoEngine, HealthState, EndpointCanary
            self.status, self.client = StatusServer, TcpClient
            self.watchdog, self.card = EngineWatchdog, ModelDeploymentCard
            self.register, self.manager, self.watcher = register_llm, ModelManager, ModelWatcher
            self.service, self.ctx = HttpService, Context
            self.req, self.stop = PreprocessedRequest, StopConditions
            self.no_responders = NoResponders
        else:
            self.store, self.plane = jrt.MemKVStore, jrt.InProcEventPlane
            self.rt_cls, self.cfg = jrt.DistributedRuntime, jrt.RuntimeConfig
            self.echo, self.state, self.canary = jllm.EchoEngine, jrt.HealthState, jrt.EndpointCanary
            self.status, self.client = jrt.StatusServer, jrt.TcpClient
            self.watchdog, self.card = JWatchdog, jllm.ModelDeploymentCard
            self.register, self.manager = jllm.register_llm, jllm.ModelManager
            self.watcher, self.service, self.ctx = jllm.ModelWatcher, JHttpService, jrt.Context
            self.req, self.stop = JRequest, JStop
            self.no_responders = jrt.NoResponders

    def runtime(self, store):
        cfg = self.cfg(store="mem", event_plane="inproc", lease_ttl_s=2.0)
        return self.rt_cls(cfg, store=store, event_plane=self.plane())


SIDES = (Side(False), Side(True))


def masked(snapshot: dict) -> dict:
    """A health snapshot with the canary's RTT masked."""
    return {**snapshot, "subsystems": {
        name: {**sub, "detail": re.sub(r"rtt=[0-9.]+ms", "rtt=<ms>", sub["detail"])}
        for name, sub in snapshot["subsystems"].items()}}


async def poll(cond, timeout=5.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            return False
        await asyncio.sleep(0.02)
    return True


async def http(method, url, **kw):
    async with aiohttp.ClientSession() as s:
        async with s.request(method, url, **kw) as r:
            return r.status, await r.json(content_type=None)


async def dead_endpoint(side: Side) -> list:
    """test_health.py::test_canary_detects_dead_endpoint_and_status_server_reports
    on one package: what the state and the status server said, in order."""
    rt = await side.runtime(side.store()).start()
    served = await rt.namespace("ns").component("c").endpoint("gen").serve(
        side.echo().generate)
    state, down = side.state(), []

    async def on_unhealthy(name):
        down.append(name)

    canary = side.canary({"c/gen": served.address}, state=state, interval_s=0.05,
                         timeout_s=0.5, fail_threshold=2, on_unhealthy=on_unhealthy)
    status = side.status(state, metadata_fn=lambda: {"model": "m"}, host="127.0.0.1")
    await status.start()
    base = f"http://127.0.0.1:{status.port}"
    seen = []
    try:
        await canary.probe_once()
        assert canary.last_rtt["c/gen"] > 0
        seen.append(masked(state.snapshot()))
        status_code, answer = await http("GET", base + "/health")
        seen.append((status_code, masked(answer)))
        seen.append(await http("GET", base + "/metadata"))
        alive = await http("GET", base + "/live")
        seen.append((alive[0], sorted(alive[1])))
        seen.append(await http("GET", base + "/v1/loras"))
        seen.append(await http("POST", base + "/drain", json={}))
        # the endpoint's server dies: two probes flip it unhealthy
        await served.server.stop(0.1)
        await canary.probe_once()
        seen.append(state.healthy)
        await canary.probe_once()
        state_now = state.snapshot()
        seen.append((state_now["status"], state_now["subsystems"]["c/gen"]["healthy"], list(down)))
        status_code, answer = await http("GET", base + "/health")
        seen.append((status_code, answer["status"]))
    finally:
        await canary.stop()
        await status.stop()
        await served.stop()
        await rt.shutdown()
    return seen


async def test_canary_detects_dead_endpoint_and_status_server_reports():
    ref, port = [await dead_endpoint(side) for side in SIDES]
    assert port == ref
    assert port[-1] == (503, "unhealthy")
    assert port[5] == (409, {"error": "no drain handler on this component"})


async def raising_callback(side: Side) -> list:
    """test_health.py::test_canary_survives_raising_unhealthy_callback."""
    rt = await side.runtime(side.store()).start()
    served = await rt.namespace("ns").component("c").endpoint("gen").serve(
        side.echo().generate)
    state, calls = side.state(), []

    async def exploding(name):
        calls.append(name)
        raise RuntimeError("deregister hit the same dead store")

    canary = side.canary({"live": served.address, "dead": "127.0.0.1:1"}, state=state,
                         interval_s=0.05, timeout_s=0.5, fail_threshold=2,
                         on_unhealthy=exploding)
    try:
        await canary.probe_once()
        await canary.probe_once()
        out = [list(calls), state.snapshot()["subsystems"]["dead"]["healthy"]]
        # the loop keeps probing after the callback failed
        canary.start()
        canary.last_rtt.pop("live", None)
        out.append(await poll(lambda: "live" in canary.last_rtt))
        out.append(not canary._task.done())
        out.append(state.snapshot()["subsystems"]["live"]["healthy"])
    finally:
        await canary.stop()
        await served.stop()
        await rt.shutdown()
    return out


async def test_canary_survives_raising_unhealthy_callback():
    ref, port = [await raising_callback(side) for side in SIDES]
    assert port == ref == [["dead"], False, True, True, True]


async def stale_pong(side: Side) -> list:
    """test_health.py::test_stale_pong_not_credited_to_next_ping."""
    rt = await side.runtime(side.store()).start()
    served = await rt.namespace("ns").component("c").endpoint("gen").serve(
        side.echo().generate)
    client = side.client()
    try:
        with pytest.raises(side.no_responders):
            await client.ping(served.address, timeout=0.000001)
        conn = client._conns[served.address]
        out = [conn.stale_pongs]
        await asyncio.sleep(0.1)   # the owed pong arrives and is discarded
        rtt = await client.ping(served.address, timeout=2.0)
        out += [rtt < 1.0, conn.stale_pongs, list(conn.pong_waiters)]
    finally:
        await client.close()
        await served.stop()
        await rt.shutdown()
    return out


async def test_stale_pong_not_credited_to_next_ping():
    ref, port = [await stale_pong(side) for side in SIDES]
    assert port == ref == [1, True, 0, []]


def boom(*a, **k):
    raise RuntimeError("injected device failure")


def poison(engine) -> None:
    """The next step of ``engine`` raises in its loop."""
    if hasattr(engine, "_run_prefill_chunk") and hasattr(engine, "_dispatch_horizon"):
        for name in ("_run_prefill_chunk", "_run_mixed_step", "_run_decode",
                     "_dispatch_horizon"):
            setattr(engine, name, boom)
    else:
        engine._prefill_fn = engine._decode_fn = engine._decode_multi_fn = boom


async def engine_crash(side: Side) -> list:
    """test_health.py::test_engine_crash_deregisters_model_before_requests_fail."""
    w = Weights(MODEL)
    engine = w.torch_engine(ENGINE, decode_steps=1) if side.port else w.jax_engine(ENGINE)
    store = side.store()
    worker_rt = await side.runtime(store).start()
    frontend_rt = await side.runtime(store).start()
    card = side.card(name="crashy", tokenizer="byte", context_length=256, kv_block_size=4)
    served = await side.register(worker_rt, engine, card)
    watchdog = side.watchdog(engine, [served], poll_s=0.02).start()
    manager = side.manager()
    watcher = await side.watcher(frontend_rt, manager).start()
    service = side.service(manager, host="127.0.0.1", port=0)
    await service.start()
    url = f"http://127.0.0.1:{service.port}/v1/chat/completions"
    out = []
    try:
        assert await poll(lambda: manager.get("crashy") is not None
                          and manager.get("crashy").client.instances)
        status, answer = await http("POST", url, json={
            "model": "crashy", "messages": [{"role": "user", "content": "ok"}],
            "max_tokens": 2, "ignore_eos": True})
        out.append((status, answer["usage"]["completion_tokens"]))
        poison(engine)
        status, answer = await http("POST", url, json={
            "model": "crashy", "messages": [{"role": "user", "content": "x"}],
            "max_tokens": 2, "ignore_eos": True})
        # the request in flight fails: an HTTP error or an error finish
        out.append(status != 200 or answer["choices"][0]["finish_reason"] == "error")
        out.append(await poll(lambda: not engine.healthy))
        out.append(await poll(lambda: watchdog.fired))
        out.append(watchdog.state.snapshot())
        # the model leaves discovery, so new requests fail clean: a 404
        out.append(await poll(lambda: manager.get("crashy") is None))
        status, answer = await http("POST", url, json={
            "model": "crashy", "messages": [{"role": "user", "content": "y"}]})
        out.append((status, answer))
    finally:
        await watchdog.stop()
        await service.stop()
        await watcher.stop()
        engine.stop()
        await worker_rt.shutdown()
        await frontend_rt.shutdown()
    return out


async def test_engine_crash_deregisters_model_before_requests_fail():
    ref, port = [await engine_crash(side) for side in SIDES]
    assert port == ref
    assert port[0] == (200, 2) and port[1:4] == [True, True, True]
    assert port[4]["subsystems"]["engine"] == {"healthy": False,
                                               "detail": "engine loop crashed"}
    assert port[-1][0] == 404


async def graceful_stop(side: Side) -> int:
    """test_health.py::test_graceful_stop_drains_inflight_stream."""
    store = side.store()
    rt = await side.runtime(store).start()
    echo = side.echo(delay_s=0.02)

    async def handler(req, ctx):
        async for out in echo.generate(req, ctx):
            yield out.to_obj()

    served = await rt.namespace("ns").component("c").endpoint("gen").serve(handler)
    client_rt = await side.runtime(store).start()
    client = await client_rt.namespace("ns").component("c").endpoint("gen").client()
    try:
        await client.wait_for_instances(1, timeout=5)
        req = side.req(request_id="r", model="m", token_ids=list(range(20)),
                       stop=side.stop(max_tokens=20, ignore_eos=True))
        stream = await client.generate(req.to_obj(), side.ctx())
        got = []

        async def consume():
            async for item in stream:
                got.append(item)

        consumer = asyncio.create_task(consume())
        await asyncio.sleep(0.05)   # a few tokens in flight
        await served.stop(graceful_timeout_s=5.0)   # must not cut the stream
        await asyncio.wait_for(consumer, timeout=5)
        return sum(len(o.get("token_ids", [])) for o in got)
    finally:
        await client.stop()
        await client_rt.shutdown()
        await rt.shutdown()


async def test_graceful_stop_drains_inflight_stream():
    ref, port = [await graceful_stop(side) for side in SIDES]
    assert port == ref == 20
