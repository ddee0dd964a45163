"""Chaos on the port's planes, as tests/test_resilience_chaos.py drives the
reference's: in-process frontend stacks (echo workers, round-robin
routing) under armed, deterministic fault injection, each case run on both
packages with each package's own ``FAULTS`` registry.

- ``request_plane.send`` drops on a seeded schedule: the same seed replays
  the same fired log and the same status vector, in both packages alike;
  a failure is a typed 503, never a raw 500 and never a hang; total loss
  with no migration budget fails every request with a typed 503.
- ``discovery.lease_keepalive`` failing on every beat: the runtime
  re-acquires a lease, re-registers its endpoints, and serves again.
- ``event_plane.publish`` drops: the publisher never raises, the survivors
  all land.
- The frontend's per-model circuit breaker trips on worker-loss 503s,
  sheds with ``Retry-After``, and closes after the reset probe, each step
  visible on /metrics; the transitions equal the reference's.
- ``engine.step:fail@1``: a TorchEngine's loop takes the real crash path
  (the request in flight finishes with an error, ``on_crash`` fires the
  watchdog, which deregisters the model), as the reference's TpuEngine.

The reference's transfer-pull case waits for the port's KV transfer
(ROADMAP item 5).
"""

import asyncio

import aiohttp
import pytest

from dynamo_tpu import llm as jllm
from dynamo_tpu import runtime as jrt
from dynamo_tpu.engine.monitor import EngineWatchdog as JWatchdog
from dynamo_tpu.llm.http.service import HttpService as JHttpService
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import resilience as jres
from dynamo_tpu_torch.engine.monitor import EngineWatchdog
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.engines import EchoEngine
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    InProcEventPlane,
    MemKVStore,
    RouterMode,
    RuntimeConfig,
)
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import resilience as tres
from torch_feature_engines import Weights
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, alive by its name in this module

MODEL = "chaos-model"


class Side:
    """One package's stack parts and fault registry."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            self.store, self.plane = MemKVStore, InProcEventPlane
            self.rt_cls, self.cfg, self.card = DistributedRuntime, RuntimeConfig, ModelDeploymentCard
            self.echo, self.register = EchoEngine, register_llm
            self.manager, self.watcher, self.service = ModelManager, ModelWatcher, HttpService
            self.mode, self.faults, self.res = RouterMode, tfaults, tres
            self.watchdog = EngineWatchdog
        else:
            self.store, self.plane = jrt.MemKVStore, jrt.InProcEventPlane
            self.rt_cls, self.cfg, self.card = (jrt.DistributedRuntime, jrt.RuntimeConfig,
                                                jllm.ModelDeploymentCard)
            self.echo, self.register = jllm.EchoEngine, jllm.register_llm
            self.manager, self.watcher, self.service = (jllm.ModelManager, jllm.ModelWatcher,
                                                        JHttpService)
            self.mode, self.faults, self.res = jrt.RouterMode, jfaults, jres
            self.watchdog = JWatchdog

    @property
    def FAULTS(self):
        return self.faults.FAULTS

    def runtime(self, store, lease_ttl_s=2.0):
        cfg = self.cfg(store="mem", event_plane="inproc", lease_ttl_s=lease_ttl_s)
        return self.rt_cls(cfg, store=store, event_plane=self.plane())


SIDES = (Side(False), Side(True))
IDS = ("reference", "port")


async def start_stack(side, n_workers=2, migration_limit=3, lease_ttl_s=2.0, engine=None):
    store = side.store()
    worker_rts, serveds = [], []
    for _ in range(n_workers):
        rt = await side.runtime(store, lease_ttl_s).start()
        card = side.card(name=MODEL, tokenizer="byte", context_length=4096,
                         migration_limit=migration_limit)
        serveds.append(await side.register(rt, engine or side.echo(), card))
        worker_rts.append(rt)
    frontend_rt = await side.runtime(store).start()
    manager = side.manager()
    watcher = await side.watcher(frontend_rt, manager, side.mode.ROUND_ROBIN).start()
    service = side.service(manager, host="127.0.0.1", port=0)
    await service.start()
    for _ in range(200):
        entry = manager.get(MODEL)
        if entry and len(entry.client.instances) == n_workers:
            break
        await asyncio.sleep(0.05)
    else:
        raise AssertionError("workers never discovered")
    base = f"http://127.0.0.1:{service.port}"
    return worker_rts, serveds, frontend_rt, watcher, service, base


async def stop_stack(worker_rts, serveds, frontend_rt, watcher, service):
    await service.stop()
    await watcher.stop()
    for s in serveds:
        await s.stop()
    for rt in worker_rts:
        await rt.shutdown()
    await frontend_rt.shutdown()


async def _chat(session, base, text="hello chaos", deadline=10.0, max_tokens=8):
    """One request bounded by a hard deadline: a hang fails the test, it
    never wedges the suite."""
    async def go():
        r = await session.post(f"{base}/v1/chat/completions", json={
            "model": MODEL, "messages": [{"role": "user", "content": text}],
            "max_tokens": max_tokens})
        body = await r.json(content_type=None)
        return r.status, r.headers, body

    return await asyncio.wait_for(go(), timeout=deadline)


@pytest.fixture(autouse=True)
def clean_faults():
    for side in SIDES:
        side.FAULTS.disarm()
    yield
    for side in SIDES:
        side.FAULTS.disarm()
        side.res.reset_registries()


# -- request plane drops: retry / migration or a typed failure, never a hang --

async def _drive_requests(side, n=10):
    *handles, base = await start_stack(side, n_workers=2, migration_limit=3)
    statuses = []
    try:
        async with aiohttp.ClientSession() as s:
            for i in range(n):
                status, _headers, body = await _chat(s, base, f"req {i}")
                statuses.append(status)
                if status != 200:
                    # a TYPED failure (the OpenAI envelope, service_unavailable),
                    # not a raw 500 from an unhandled injected exception
                    assert status == 503, body
                    assert body["error"]["type"] == "service_unavailable", body
    finally:
        await stop_stack(*handles)
    return statuses


async def test_chaos_request_plane_drop_schedule_is_deterministic():
    """Same seed => the same fired log and the same outcome vector across
    two stack incarnations, and in both packages; another seed diverges."""
    runs = {}
    for side, name in zip(SIDES, IDS):
        for seed in (7, 7, 8):
            side.FAULTS.disarm()
            side.FAULTS.arm(f"request_plane.send:drop@p=0.4@seed={seed}")
            try:
                statuses = await _drive_requests(side, n=10)
            finally:
                fired = list(side.FAULTS.fired)
                calls = side.FAULTS.calls("request_plane.send")
                plan = side.FAULTS.plan("request_plane.send", calls)
                side.FAULTS.disarm()
            assert [(i, a) for _, a, i in fired] == plan
            assert any(st == 200 for st in statuses)  # migration keeps serving
            runs.setdefault(name, []).append((fired, statuses))
    for name in IDS:
        assert runs[name][0] == runs[name][1], "same seed must replay the same schedule"
        assert runs[name][0][0] != runs[name][2][0], "another seed must differ"
        assert runs[name][0][0], "the armed fault never fired"
    assert runs["port"] == runs["reference"]


@pytest.mark.parametrize("side", SIDES, ids=IDS)
async def test_chaos_request_plane_total_loss_fails_typed(side):
    """drop on EVERY send and no migration budget: every request fails fast
    with a typed 503; none hangs, none surfaces a raw injected exception."""
    side.FAULTS.arm("request_plane.send:drop@1+")
    *handles, base = await start_stack(side, n_workers=1, migration_limit=0)
    try:
        async with aiohttp.ClientSession() as s:
            for i in range(3):
                status, _h, body = await _chat(s, base, f"doomed {i}")
                assert status == 503, body
                assert body["error"]["type"] == "service_unavailable"
    finally:
        await stop_stack(*handles)
    assert [i for _, _, i in side.FAULTS.fired] == [1, 2, 3]


# -- lease keepalive loss: re-acquire + re-register, serving resumes ---------

@pytest.mark.parametrize("side", SIDES, ids=IDS)
async def test_chaos_lease_keepalive_loss_recovers(side):
    stack = await start_stack(side, n_workers=1, migration_limit=0, lease_ttl_s=1.0)
    worker_rts, serveds, frontend_rt, watcher, service, base = stack
    try:
        lease_before = worker_rts[0].lease_id
        side.FAULTS.arm("discovery.lease_keepalive:fail@1+")
        # heartbeats under failing keepalives: the loop must re-acquire a
        # fresh lease and re-register the served endpoints, not die
        for _ in range(100):
            await asyncio.sleep(0.05)
            if worker_rts[0].lease_id != lease_before:
                break
        assert worker_rts[0].lease_id != lease_before, "lease never re-acquired"
        assert side.FAULTS.fired and side.FAULTS.fired[0][:2] == (
            "discovery.lease_keepalive", "fail")
        side.FAULTS.disarm()
        await asyncio.sleep(1.0)  # settle: healthy beats, re-registration
        async with aiohttp.ClientSession() as s:
            status = None
            for _ in range(20):
                status, _h, _b = await _chat(s, base)
                if status == 200:
                    break
                await asyncio.sleep(0.2)
            assert status == 200, "service did not recover after lease loss"
    finally:
        side.FAULTS.disarm()
        await stop_stack(worker_rts, serveds, frontend_rt, watcher, service)


# -- event plane: dropped publishes degrade, never crash the publisher --------

async def _publish_drops(side):
    plane = side.plane()
    sub = await plane.subscribe("chaos.")
    side.FAULTS.arm("event_plane.publish:drop@p=0.5@seed=3;event_plane.publish:corrupt@4")
    got = []
    try:
        for i in range(30):
            # must NOT raise: drops are absorbed and logged
            await plane.publish("chaos.topic", b"payload-%d" % i)
        fired = list(side.FAULTS.fired)
        while True:
            item = await sub.next(timeout=0.1)
            if item is None:
                break
            got.append(item[1])
    finally:
        side.FAULTS.disarm()
    # disarmed: delivery is whole again
    await plane.publish("chaos.topic", b"after")
    assert (await sub.next(timeout=1.0)) == ("chaos.topic", b"after")
    await plane.close()
    return fired, got


async def test_chaos_event_publish_drops_degrade():
    ref, port = [await _publish_drops(side) for side in SIDES]
    assert port == ref
    fired, got = port
    dropped = sum(1 for _, a, _ in fired if a == "drop")
    assert 0 < dropped < 30 and len(got) == 30 - dropped  # the survivors all landed
    assert sum(1 for p in got if not p.startswith(b"payload")) == 1   # one corrupted


async def test_chaos_broker_plane_publish_drops_and_corrupts(tmp_path):
    """The port's cross-process plane (tcp_plane.py) under the same point:
    a dropped publish is lost with a warning, a corrupt one arrives
    flipped, the rest arrive in order."""
    from dynamo_tpu_torch.runtime.event_plane.tcp_plane import event_plane_from_store

    store = MemKVStore()
    pub = await event_plane_from_store(store, "lease-a")
    sub_plane = await event_plane_from_store(store, "lease-b")
    sub = await sub_plane.subscribe("chaos.")
    tfaults.FAULTS.arm("event_plane.publish:drop@2;event_plane.publish:drop@5;"
                       "event_plane.publish:corrupt@1")
    try:
        for i in range(6):
            await pub.publish("chaos.topic", b"p%d" % i)
        got = []
        while len(got) < 4:
            item = await sub.next(timeout=5.0)
            assert item is not None, got
            got.append(item[1])
        assert tfaults.FAULTS.fired == [("event_plane.publish", "corrupt", 1),
                                        ("event_plane.publish", "drop", 2),
                                        ("event_plane.publish", "drop", 5)]
        assert got == [bytes([ord("p") ^ 0xFF]) + b"0", b"p2", b"p3", b"p5"]
    finally:
        tfaults.FAULTS.disarm()
        await sub_plane.close()
        await pub.close()


# -- circuit breaker: trip + Retry-After + reset, all visible on /metrics ----

def _circuit_lines(text: str) -> list:
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith("dtpu_circuit") and "_created" not in ln)


async def _breaker_drill(side, monkeypatch):
    monkeypatch.setenv("DTPU_CB_FRONTEND", "threshold=3,rate=0.5,window=5,reset=0.5")
    *handles, base = await start_stack(side, n_workers=1, migration_limit=0)
    out = []
    try:
        side.FAULTS.arm("request_plane.send:drop@1+")
        async with aiohttp.ClientSession() as s:
            for i in range(3):  # three worker-loss 503s trip the breaker
                status, headers, _b = await _chat(s, base, f"trip {i}")
                out.append((status, "Retry-After" in headers))
            # open circuit: shed at once with Retry-After, no send
            status, headers, body = await _chat(s, base, "shed")
            out.append((status, headers.get("Retry-After"), body["error"]["type"],
                        "circuit open" in body["error"]["message"]))
            out.append(side.FAULTS.calls("request_plane.send"))
            metrics = await (await s.get(f"{base}/metrics")).text()
            out.append(_circuit_lines(metrics))
            # heal the plane, wait out the reset window: the half-open
            # probe closes the circuit and serving resumes
            side.FAULTS.disarm()
            await asyncio.sleep(0.6)
            status, _h, _b = await _chat(s, base, "probe")
            out.append(status)
            metrics = await (await s.get(f"{base}/metrics")).text()
            out.append(_circuit_lines(metrics))
            status, _h, _b = await _chat(s, base, "steady")
            out.append(status)
            out.append(sorted(ln for ln in metrics.splitlines()
                              if ln.startswith("dtpu_requests_total{")))
    finally:
        side.FAULTS.disarm()
        await stop_stack(*handles)
    return out


async def test_chaos_circuit_breaker_trip_and_reset_via_metrics(monkeypatch):
    ref, port = [await _breaker_drill(side, monkeypatch) for side in SIDES]
    assert port == ref
    assert port[:3] == [(503, False)] * 3
    assert port[3] == (503, "1", "service_unavailable", True)
    assert port[4] == 3                 # the shed request made no send
    policy = f'policy="frontend.{MODEL}"'
    opened = [ln for ln in port[5] if policy in ln]
    assert any('state="open"' in ln and ln.endswith(" 1.0") for ln in opened)
    assert any(ln.startswith("dtpu_circuit_state") and ln.endswith(" 2.0") for ln in opened)
    assert port[6] == 200 and port[8] == 200
    closed = [ln for ln in port[7] if policy in ln]
    for state in ("open", "half_open", "closed"):
        assert any(f'state="{state}"' in ln and ln.endswith(" 1.0") for ln in closed), closed
    assert any(ln.startswith("dtpu_circuit_state") and ln.endswith(" 0.0") for ln in closed)


# -- engine.step: the real crash path ----------------------------------------

ENGINE_MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                    head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64, 128, 256))


async def _engine_step_fault(side) -> list:
    w = Weights(ENGINE_MODEL)
    engine = w.torch_engine(ENGINE, decode_steps=1) if side.port else w.jax_engine(ENGINE)
    *handles, base = await start_stack(side, n_workers=1, migration_limit=0, engine=engine)
    worker_rts, serveds, frontend_rt, watcher, service = handles
    watchdog = side.watchdog(engine, serveds, poll_s=0.02).start()
    manager = watcher.manager
    out = []
    try:
        async with aiohttp.ClientSession() as s:
            status, _h, body = await _chat(s, base, "ok", max_tokens=2)
            out.append((status, body["usage"]["completion_tokens"]))
            # the loop is idle: its next tick is the next request's first
            side.FAULTS.arm("engine.step:fail@1")
            status, _h, body = await _chat(s, base, "x", max_tokens=2)
            out.append(status != 200 or body["choices"][0]["finish_reason"] == "error")
            out.append(list(side.FAULTS.fired))
            for _ in range(250):
                if watchdog.fired and manager.get(MODEL) is None:
                    break
                await asyncio.sleep(0.02)
            out.append((engine.healthy, watchdog.fired, manager.get(MODEL) is None))
            status, _h, body = await _chat(s, base, "y", max_tokens=2)
            out.append(status)
    finally:
        side.FAULTS.disarm()
        await watchdog.stop()
        engine.stop()
        await stop_stack(*handles)
    return out


async def test_armed_engine_step_takes_the_crash_path():
    ref, port = [await _engine_step_fault(side) for side in SIDES]
    assert port == ref
    assert port == [(200, 2), True, [("engine.step", "fail", 1)], (False, True, True), 404]
