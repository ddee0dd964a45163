"""The port's /debug/fleet fan-out and /debug/worker against the reference's.

llm/fleet.py of both packages over the same discovery records and worker
documents (injected fetches that answer, raise, hang or are missing; the
merged KV, global-KV, restore-mode and health rollups; draining workers;
the frontend's section), then the default fetch over real sockets (the
port's standard-library GET against the port's StatusServer, the
reference's aiohttp GET against the reference's), the /debug/worker
fallback and a snapshot function that raises, and a TorchEngine worker's
``/debug/worker`` document merged by the port's frontend.
"""

import asyncio

import aiohttp
import pytest

from dynamo_tpu.llm import fleet as jfleet
from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu_torch.llm import fleet as tfleet
from dynamo_tpu_torch.runtime import health as thealth
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, alive by its name in this module

FLEETS = pytest.mark.parametrize("fleet,health", [(jfleet, jhealth), (tfleet, thealth)],
                                 ids=["reference", "port"])


class Inst:
    def __init__(self, address=None, state="ready"):
        extra = {} if address is None else {"status_address": address}
        if state != "ready":
            extra["state"] = state
        self.metadata = dict(data_parallel_size=1, **extra)


class Card:
    name = "m"


class Breaker:
    def __init__(self, state="closed"):
        self.state = state


class Client:
    def __init__(self, instances):
        self.instances = instances


class Pipeline:
    def __init__(self, instances, breakers=None):
        self.card = Card()
        self.client = Client(instances)
        self._worker_breakers = breakers or {}


WORKER_DOC = {
    "kv": {"active_blocks": 10, "free_blocks": 22, "total_blocks": 32},
    "global_kv": {"published": 4, "inflight_fetches": 1, "dedupe_skipped": 2},
    "restore_mode": "warm",
    "health": {"active": [{"detector": "cost_model_drift", "subject": "worker/1"}]},
}


async def fetch(address):
    if address.startswith("good"):
        return dict(WORKER_DOC)
    if address == "dead:1":
        raise ConnectionError("connection refused")
    if address == "empty:1":
        return {"kv": "not a dict", "health": {"active": None}}
    await asyncio.sleep(3600)   # a wedged worker: the timeout cuts it


SCENARIOS = {
    "partial": ({1: Inst("good:1"), 2: Inst("dead:1"), 3: Inst("hung:1"), 4: Inst()},
                {2: Breaker("open"), 1: Breaker()}),
    "merge": ({1: Inst("good:1"), 2: Inst("good:2"), 3: Inst("empty:1")}, None),
    "draining": ({1: Inst("good:1", state="draining"), 2: Inst("good:2")}, None),
    "none": ({}, None),
    "dead": ({i: Inst("dead:1") for i in range(5)}, None),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
async def test_fleet_snapshot_equals_the_references(scenario):
    instances, breakers = SCENARIOS[scenario]
    docs = []
    for fleet in (jfleet, tfleet):
        docs.append(await fleet.fleet_snapshot(
            [Pipeline(instances, breakers)], fetch=fetch, timeout_s=0.05,
            frontend={"slo": {"models": {}}, "attribution": {"models": {}}},
            clock=lambda: 123.0))
    assert docs[1] == docs[0]
    fleet_doc = docs[1]
    assert fleet_doc["generated_at"] == 123.0 and set(fleet_doc["frontend"]) == {"slo", "attribution"}
    if scenario == "partial":
        assert fleet_doc["fleet"] == {"workers_total": 4, "workers_live": 1, "workers_stale": 3,
                                "draining": 0}
        assert fleet_doc["models"]["m"]["open_circuits"] == 1
        errors = {wk["worker_id"]: wk.get("error") for wk in fleet_doc["workers"]}
        assert "timed out" in errors[f"{3:016x}"]
        assert errors[f"{4:016x}"] == "no status_address advertised"
    if scenario == "merge":
        assert fleet_doc["kv"] == {"active_blocks": 20, "free_blocks": 44, "total_blocks": 64}
        assert fleet_doc["restore_modes"] == {"warm": 2} and len(fleet_doc["health_active"]) == 2
    if scenario == "draining":
        assert fleet_doc["fleet"]["draining"] == 1


async def test_env_knobs_bound_fanout_and_timeout(monkeypatch):
    monkeypatch.setenv("DTPU_FLEET_FANOUT", "2")
    monkeypatch.setenv("DTPU_FLEET_TIMEOUT_S", "0.05")
    inflight, peak = [0], [0]

    async def slow(address):
        inflight[0] += 1
        peak[0] = max(peak[0], inflight[0])
        await asyncio.sleep(0.01 if address.startswith("good") else 10)
        inflight[0] -= 1
        return {}

    fleet_doc = await tfleet.fleet_snapshot(
        [Pipeline({i: Inst(f"good:{i}") for i in range(6)} | {9: Inst("hung:9")})],
        fetch=slow)
    assert peak[0] == 2
    assert fleet_doc["fleet"]["workers_live"] == 6 and fleet_doc["fleet"]["workers_stale"] == 1


@FLEETS
async def test_fleet_snapshot_over_real_sockets(fleet, health):
    status = health.StatusServer(health.HealthState(), host="127.0.0.1", port=0,
                                 worker_snapshot_fn=lambda: dict(WORKER_DOC))
    addr = await status.start()
    try:
        fleet_doc = await fleet.fleet_snapshot(
            [Pipeline({1: Inst(addr), 2: Inst("127.0.0.1:1")})], timeout_s=5.0)
    finally:
        await status.stop()
    assert fleet_doc["fleet"]["workers_live"] == 1 and fleet_doc["fleet"]["workers_stale"] == 1
    alive = next(wk for wk in fleet_doc["workers"] if not wk["stale"])
    assert alive["snapshot"]["kv"]["active_blocks"] == 10 and "uptime_s" in alive["snapshot"]
    assert fleet_doc["restore_modes"] == {"warm": 1}
    dead = next(wk for wk in fleet_doc["workers"] if wk["stale"])
    assert dead["error"]


async def get_json(addr, path):
    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://{addr}{path}") as r:
            return r.status, await r.json()


@FLEETS
async def test_debug_worker_fallback_and_a_raising_snapshot(fleet, health):
    state = health.HealthState()
    state.set("engine", True, "ok")
    plain = health.StatusServer(state, host="127.0.0.1", port=0)

    def boom():
        raise RuntimeError("section assembly exploded")

    broken = health.StatusServer(health.HealthState(), host="127.0.0.1", port=0,
                                 worker_snapshot_fn=boom)
    try:
        code, fleet_doc = await get_json(await plain.start(), "/debug/worker")
        assert code == 200 and fleet_doc["health"]["subsystems"]["engine"]["healthy"]
        code, fleet_doc = await get_json(await broken.start(), "/debug/worker")
        assert code == 200 and "section assembly exploded" in fleet_doc["error"]
    finally:
        await plain.stop()
        await broken.stop()


async def test_a_worker_document_through_the_frontend(tmp_path):
    """The worker's ``serve_status`` document (TorchEngine on the CPU) is
    found through its advertised ``status_address`` and merged by the
    port's frontend ``/debug/fleet``."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine.__main__ import serve_status
    from dynamo_tpu_torch.engine.telemetry import EngineTelemetry
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.serve import register_llm
    from dynamo_tpu_torch.runtime import (
        DistributedRuntime,
        InProcEventPlane,
        MemKVStore,
        RuntimeConfig,
    )
    from torch_feature_engines import Weights

    model = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                 head_dim=16, intermediate_size=128)
    engine = Weights(model).torch_engine(dict(num_blocks=64, block_size=4, max_batch_size=4,
                                              max_context=256, prefill_buckets=(16, 32)),
                                         decode_steps=1)
    store = MemKVStore()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    worker_rt = await DistributedRuntime(cfg, store=store, event_plane=InProcEventPlane()).start()
    front_rt = await DistributedRuntime(cfg, store=store, event_plane=InProcEventPlane()).start()
    served = await register_llm(worker_rt, engine, ModelDeploymentCard(
        name="m", tokenizer="byte", context_length=256, kv_block_size=4))
    telemetry = EngineTelemetry(worker_rt.metrics.child(dp_rank="0"))
    engine.stats_hook = telemetry.on_step
    monitor = thealth.HealthMonitor()
    state = thealth.HealthState()
    canary = SimpleNamespace(last_rtt={})
    args = SimpleNamespace(model="m", system_port=0)
    status = await serve_status(args, worker_rt, engine, served, 7, telemetry, monitor, state,
                                canary, {"decode": [1.5, 2.5, 3.0]})
    manager = ModelManager()
    watcher = await ModelWatcher(front_rt, manager).start()
    service = HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    try:
        for _ in range(100):
            pipe = manager.get("m")
            if pipe and pipe.client.instances and all(
                    "status_address" in i.metadata for i in pipe.client.instances.values()):
                break
            await asyncio.sleep(0.05)
        base = f"127.0.0.1:{service.port}"
        async with aiohttp.ClientSession() as s:
            r = await s.post(f"http://{base}/v1/completions",
                             json={"model": "m", "prompt": "hi there", "max_tokens": 3})
            assert r.status == 200
        code, fleet_doc = await get_json(base, "/debug/fleet")
        assert code == 200 and fleet_doc["fleet"]["workers_live"] == 1
        worker = fleet_doc["workers"][0]
        assert not worker["stale"] and worker["status_address"].endswith(f":{status.port}")
        wdoc = worker["snapshot"]
        assert {"telemetry", "slo", "attribution", "health", "engine", "kv",
                "drift"} <= set(wdoc)
        assert wdoc["instance_id"] == f"{7:016x}"
        assert wdoc["drift"] == {"decode": {"steps": 3, "median_ratio": 2.5}}
        assert wdoc["telemetry"][0]["steps_total"] >= 2
        assert wdoc["kv"]["total_blocks"] == 64
        assert set(fleet_doc["frontend"]) == {"slo", "attribution", "model_breakers"}
        # the request's outcome recorded on the model's and its worker's breakers
        assert fleet_doc["frontend"]["model_breakers"] == {"m": "closed"}
        assert fleet_doc["models"]["m"]["worker_breakers"] == {
            f"{served.instance_id:016x}": "closed"}
        assert fleet_doc["models"]["m"]["open_circuits"] == 0
        code, meta_doc = await get_json(f"127.0.0.1:{status.port}", "/metadata")
        assert code == 200 and meta_doc["engine"]["steps"]["prefill"] >= 1
    finally:
        await service.stop()
        await watcher.stop()
        await status.stop()
        engine.stop()
        await served.stop()
        await worker_rt.shutdown()
        await front_rt.shutdown()
