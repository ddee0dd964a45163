"""The port's audit bus and stream recorder against the reference's.

llm/audit.py of both packages: the policy from ``DTPU_AUDIT_SINKS`` /
``DTPU_AUDIT_FORCE_LOGGING``, handles that emit once with the request and
the response, the ``store`` flag gate, the ``jsonl:`` sink's lines, the
``event`` sink's records on each package's in-process event plane (the
port's packed by its own codec, the reference's by msgpack: the decoded
records must be equal), and audit records of requests through the port's
frontend. llm/perf.py: the stream recording's analysis (clock injected)
and the logprob sensitivity of a seeded corpus, equal to the reference's.
"""

import asyncio
import json

import aiohttp
import msgpack
import numpy as np
import pytest

from dynamo_tpu.llm import audit as jaudit
from dynamo_tpu.llm import perf as jperf
from dynamo_tpu.llm.protocols.common import BackendOutput as JOutput
from dynamo_tpu.runtime.event_plane.base import InProcEventPlane as JPlane
from dynamo_tpu_torch.llm import audit as taudit
from dynamo_tpu_torch.llm import perf as tperf
from dynamo_tpu_torch.llm.protocols.common import BackendOutput
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.event_plane.base import InProcEventPlane
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

AUDITS = pytest.mark.parametrize("audit", [jaudit, taudit], ids=["reference", "port"])


@pytest.mark.parametrize("sinks,force", [(None, None), ("stderr", "1"), ("jsonl:/x, event,",
                                                                         "off"),
                                         ("bogus,stderr", "yes")])
def test_policy_from_env_as_the_reference(sinks, force, monkeypatch):
    for name, val in (("DTPU_AUDIT_SINKS", sinks), ("DTPU_AUDIT_FORCE_LOGGING", force)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    ref, port = jaudit.AuditPolicy.from_env(), taudit.AuditPolicy.from_env()
    assert (port.enabled, port.force_logging, port.sinks) == (
        ref.enabled, ref.force_logging, ref.sinks)
    bus = taudit.AuditBus(port)
    assert [s.name for s in bus.sinks] == [s.name for s in jaudit.AuditBus(ref).sinks]


def audit_run(audit, path: str) -> list:
    policy = audit.AuditPolicy(enabled=True, force_logging=False, sinks=[f"jsonl:{path}"])
    bus = audit.AuditBus(policy)
    assert bus.create_handle({"model": "m"}, "r0", "m", False) is None
    for i, streaming in enumerate((False, True)):
        h = bus.create_handle({"model": "m", "store": True, "messages": [i]}, f"r{i + 1}",
                              "m", streaming)
        if i == 0:
            h.set_response({"id": "r1", "choices": []})
        h.emit()
        h.emit()   # once only
    off = audit.AuditBus(audit.AuditPolicy(enabled=False))
    assert off.create_handle({"store": True}, "r", "m", False) is None
    return [json.loads(line) for line in open(path)]


def test_handles_and_the_jsonl_sink_as_the_reference(tmp_path):
    ref = audit_run(jaudit, str(tmp_path / "ref.jsonl"))
    port = audit_run(taudit, str(tmp_path / "port.jsonl"))
    assert port == ref
    assert [r["request_id"] for r in port] == ["r1", "r2"]
    assert port[0]["response"] == {"id": "r1", "choices": []} and "response" not in port[1]


async def event_sink(audit, plane, unpack) -> list:
    got = []
    sub = await plane.subscribe("dynamo.audit.v1")

    async def consume():
        async for _, payload in sub:
            got.append(unpack(payload))
            if len(got) == 2:
                break

    task = asyncio.create_task(consume())
    await asyncio.sleep(0.01)
    bus = audit.AuditBus(audit.AuditPolicy(enabled=True, force_logging=True, sinks=["event"]),
                         event_plane=plane)
    for rid in ("r9", "r10"):
        h = bus.create_handle({"model": "m", "n": [1, 2.5, None, "x"]}, rid, "m", True)
        h.set_response({"ok": True})
        h.emit()
    await bus.drain_async_sinks()
    await asyncio.wait_for(task, timeout=2.0)
    await plane.close()
    return got


async def test_event_sink_records_as_the_reference():
    ref = await event_sink(jaudit, JPlane(), lambda b: msgpack.unpackb(b, raw=False))
    port = await event_sink(taudit, InProcEventPlane(), codec.unpackb)
    assert port == ref and [r["request_id"] for r in port] == ["r9", "r10"]
    bus = taudit.AuditBus(taudit.AuditPolicy(enabled=True, sinks=["event"]))
    assert bus.sinks == []   # no event plane wired: the sink is left out


async def test_requests_through_the_frontend_are_audited(tmp_path):
    """The port's frontend audits a request that sets ``store`` (chat,
    whole) and, with force_logging, every one (completions, streamed)."""
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.engines import EchoEngine
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.serve import register_llm
    from dynamo_tpu_torch.runtime import (
        DistributedRuntime,
        MemKVStore,
        RuntimeConfig,
    )

    store = MemKVStore()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    worker_rt = await DistributedRuntime(cfg, store=store, event_plane=InProcEventPlane()).start()
    front_rt = await DistributedRuntime(cfg, store=store, event_plane=InProcEventPlane()).start()
    served = await register_llm(worker_rt, EchoEngine(), ModelDeploymentCard(
        name="echo", tokenizer="byte", context_length=256))
    manager = ModelManager()
    watcher = await ModelWatcher(front_rt, manager).start()
    records, chat_ids = {}, {}
    try:
        for force in (False, True):
            path = str(tmp_path / f"audit{force}.jsonl")
            bus = taudit.AuditBus(taudit.AuditPolicy(enabled=True, force_logging=force,
                                                     sinks=[f"jsonl:{path}"]))
            service = HttpService(manager, host="127.0.0.1", port=0, audit_bus=bus)
            await service.start()
            try:
                for _ in range(100):
                    pipe = manager.get("echo")
                    if pipe and pipe.client.instances:
                        break
                    await asyncio.sleep(0.05)
                base = f"http://127.0.0.1:{service.port}"
                async with aiohttp.ClientSession() as s:
                    r = await s.post(f"{base}/v1/chat/completions", json={
                        "model": "echo", "messages": [{"role": "user", "content": "hi"}],
                        "max_tokens": 2, "store": True})
                    chat_ids[force] = (await r.json())["id"]
                    r = await s.post(f"{base}/v1/completions", json={
                        "model": "echo", "prompt": "abc", "max_tokens": 3, "stream": True})
                    await r.read()
            finally:
                await service.stop()
            records[force] = [json.loads(line) for line in open(path)]
    finally:
        await watcher.stop()
        await served.stop()
        await worker_rt.shutdown()
        await front_rt.shutdown()
    assert [r["request_id"] for r in records[False]] == [chat_ids[False]]
    assert [r["request_id"] for r in records[True]][0] == chat_ids[True]
    whole = records[False][0]
    assert whole["requested_streaming"] is False and whole["request"]["store"] is True
    assert whole["response"]["id"] == chat_ids[False]
    assert whole["response"]["usage"]["completion_tokens"] == 2
    streamed = records[True][1]
    assert streamed["requested_streaming"] is True
    assert streamed["response"] == {"streamed": True, "completion_tokens": 3,
                                    "prompt_tokens": 3}


def recorded(perf, out_cls, stamps) -> dict:
    """A stream recorded with its arrival times injected."""

    class Clock:
        def __init__(self):
            self.times = iter(stamps)

        def monotonic(self):
            return next(self.times)

    async def run():
        async def gen():
            yield out_cls(token_ids=[1])
            for _ in range(3):
                yield out_cls(token_ids=[2, 3])
            yield {"token_ids": [4]}

        rec = perf.RecordedStream()
        got = [o async for o in perf.record_stream(gen(), rec)]
        return rec, got

    real = perf.time
    perf.time = Clock()
    try:
        rec, got = asyncio.run(run())
    finally:
        perf.time = real
    return {"analysis": rec.analyze(), "count": rec.response_count, "items": len(got),
            "sequence": [r.sequence_number for r in rec.responses],
            "duration": rec.total_duration_s}


def test_stream_recording_analyzes_as_the_reference():
    stamps = [10.0, 10.03, 10.04, 10.045, 10.07, 10.08, 10.09]
    ref = recorded(jperf, JOutput, stamps)
    port = recorded(tperf, BackendOutput, stamps)
    assert port == ref
    assert port["analysis"]["tokens"] == 8 and port["analysis"]["ttft_s"] == 0.03
    assert jperf.RecordedStream().analyze() == tperf.RecordedStream().analyze() == {"tokens": 0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logprob_sensitivity_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    entries = []
    for _ in range(40):
        tok = int(rng.integers(0, 50))
        lp = -float(rng.exponential(1.0))
        alts = [{"token_id" if rng.random() < 0.5 else "token": int(rng.integers(0, 50)),
                 "logprob": lp - float(rng.exponential(1.0))}
                for _ in range(int(rng.integers(0, 4)))]
        if rng.random() < 0.5:
            alts.append({"token_id": tok, "logprob": lp})
        entries.append({"token_id": tok, "logprob": lp, "top_logprobs": alts})
    a, b = jperf.analyze_logprobs(entries), tperf.analyze_logprobs(entries)
    assert b.summary() == a.summary()
    assert [(p.position, p.selected_token, p.runner_up_token, p.margin, p.prob_ratio)
            for p in b.positions] == [(p.position, p.selected_token, p.runner_up_token,
                                       p.margin, p.prob_ratio) for p in a.positions]
    assert len(b.close_calls) == len(a.close_calls)
