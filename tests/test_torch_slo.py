"""The port's SLO accounting plane against the reference's.

runtime/slo.py of both packages on the same inputs: the class table under
``DTPU_SLA_CLASSES`` (good and bad specs), ``resolve_sla`` with model
overrides, a seeded corpus of ``sla`` annotations, one seeded record stream
on an injected clock (snapshots, attainment by kind, burn rates and the
exported gauges in every window), the ``/debug/requests?id=`` budget
breakdown of timeline timelines, and ``debug_slo_payload``. Then the serving
path: a class named by the cls_doc or the header reaches the worker's
annotation with the card's override, the frontend's ledger and /metrics
count it under its class, an unknown class is a 400, TorchEngine feeds the
worker's ledger and its violation event as TpuEngine does, and a request
that fails before its first token lands in the frontend's ledger.
"""

import asyncio
import re

import aiohttp
import numpy as np
import pytest

from dynamo_tpu.runtime import flight_recorder as jflight
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu.runtime import slo as jslo
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, ModelRuntimeConfig
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.runtime import (
    Context,
    DistributedRuntime,
    InProcEventPlane,
    MemKVStore,
    RuntimeConfig,
)
from dynamo_tpu_torch.runtime import flight_recorder as tflight
from dynamo_tpu_torch.runtime import metrics as tmetrics
from dynamo_tpu_torch.runtime import slo as tslo
from dynamo_tpu_torch.runtime.request_plane.tcp import NoResponders
from torch_feature_engines import Weights
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def as_tuple(spec):
    return None if spec is None else (spec.sla_class, spec.ttft_target_s, spec.itl_target_s,
                                      spec.deadline_s)


@pytest.mark.parametrize("env", [None, "interactive:ttft=0.3;gold:ttft=0.1,itl=0.02,deadline=9",
                                 "batch:itl=3", "bad:nope=1", ":ttft=1", "x:ttft=abc",
                                 "standard:ttft=4;;"])
def test_class_table_and_default_as_the_reference(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("DTPU_SLA_CLASSES", raising=False)
    else:
        monkeypatch.setenv("DTPU_SLA_CLASSES", env)
    ref = {k: as_tuple(v) for k, v in jslo.sla_classes().items()}
    assert {k: as_tuple(v) for k, v in tslo.sla_classes().items()} == ref
    for default in (None, "batch", "typo"):
        if default is None:
            monkeypatch.delenv("DTPU_SLA_DEFAULT", raising=False)
        else:
            monkeypatch.setenv("DTPU_SLA_DEFAULT", default)
        assert tslo.default_class() == jslo.default_class()
        for name in (None, "", "interactive", "gold", "nope"):
            for ov in (None, {"interactive": {"ttft_target_s": 0.4}},
                       {"gold": {"itl_target_s": "x"}}, {"nope": {"deadline_s": 3}}):
                assert (as_tuple(tslo.resolve_sla(name, ov))
                        == as_tuple(jslo.resolve_sla(name, ov))), (name, ov)


def annotations(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = [None, {}, {"sla": "interactive"}, {"sla": {}}, {"sla": {"class": "b"}},
           {"sla": {"class": "b", "ttft_target_s": "x"}}, {"sla": {"class": 3, "t0_ns": "7"}},
           {"sla": {"class": "b", "t0_ns": None}}]
    for _ in range(60):
        annot = {"class": str(rng.choice(["interactive", "batch", "gold"]))}
        for key in ("ttft_target_s", "itl_target_s", "deadline_s", "t0_ns"):
            if rng.random() < 0.7:
                annot[key] = (float(rng.uniform(0, 5)) if key != "t0_ns"
                            else int(rng.integers(0, 2**62)))
        out.append({"sla": annot, "traceparent": "00-x"})
    return out


def test_annotations_parse_as_the_reference():
    for annot in annotations(0):
        assert as_tuple(tslo.spec_from_annotations(annot)) == as_tuple(
            jslo.spec_from_annotations(annot)), annot
        assert tslo.sla_t0_ns(annot) == jslo.sla_t0_ns(annot)
    spec = tslo.SlaSpec("gold", 0.1, 0.02, 9.0)
    annot = spec.to_annotation(t0_ns=123)
    assert annot == jslo.SlaSpec("gold", 0.1, 0.02, 9.0).to_annotation(t0_ns=123)
    assert as_tuple(tslo.spec_from_annotations({"sla": annot})) == as_tuple(spec)


def records(seed: int) -> list:
    """(dt, model, class, ttft, itl, tokens, e2e) over two hours."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(700):
        out.append((float(rng.exponential(10.0)), str(rng.choice(["m1", "m2"])),
                    str(rng.choice(["interactive", "batch", "gold"])),
                    None if rng.random() < 0.05 else float(rng.exponential(0.6)),
                    None if rng.random() < 0.2 else float(rng.exponential(0.05)),
                    int(rng.integers(0, 300)), float(rng.uniform(0.1, 40))))
    return out


def ledger(slo, metrics, recs) -> list:
    clock = Clock()
    scope = metrics.MetricsScope()
    acct = slo.SloAccountant(clock=clock, objective=0.95, metrics=scope)
    specs = {"interactive": slo.SlaSpec("interactive", 0.5, 0.05),
             "batch": slo.SlaSpec("batch", 30.0, 1.0),
             "gold": slo.SlaSpec("gold", 0.3, 0.03, deadline_s=20.0)}
    seen = []
    for i, (dt, model, cls, ttft, itl, n, e2e) in enumerate(recs):
        clock.t += dt
        seen.append(acct.record(model, specs[cls], ttft_s=ttft, itl_s=itl, output_tokens=n,
                                e2e_s=e2e))
        if i % 97 == 0:
            seen.append(acct.snapshot())
            seen.append([(k, w, kind, acct.attainment(*k, w, kind), acct.burn_rate(*k, w))
                         for k in acct.keys() for w in ("1m", "5m", "1h", "total")
                         for kind in ("ttft", "itl", "combined")])
    acct.export_metrics()
    text = re.sub(r"_created(\{[^}]*\})? \S+", r"_created\1 <t>", scope.expose().decode())
    seen.append(sorted(text.splitlines()))
    seen.append(slo.debug_slo_payload(acct))
    # drained windows export the neutral values
    clock.t += 7200
    acct.export_metrics()
    seen.append(sorted(ln for ln in scope.expose().decode().splitlines()
                       if ln.startswith("dtpu_slo_")))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accountant_ledger_equals_the_references(seed):
    recs = records(seed)
    assert ledger(tslo, tmetrics, recs) == ledger(jslo, jmetrics, recs)
    assert tslo.debug_slo_payload(None) == jslo.debug_slo_payload(None)
    assert tslo.burn_rate(None, 0.99) is None
    assert tslo.attainment([], 1.0) == jslo.attainment([], 1.0) == 0.0


def timelines(fl) -> list:
    """Flight timelines with and without the queued event's sla fields."""
    rec = fl.FlightRecorder(capacity=16)
    now = [1_000_000_000]

    def at(rid, kind, ms, **kw):
        now[0] += int(ms * 1e6)
        rec.record(rid, kind, **kw)
        rec._flights[rid]["events"][-1]["timestamp"] = now[0]
        rec._flights[rid]["started_ns"] = rec._flights[rid]["events"][0]["timestamp"]

    sla = dict(sla_class="interactive", ttft_target_s=0.5, itl_target_s=0.05, deadline_s=2.0)
    at("a", "queued", 0, prompt_tokens=5, **sla)
    at("a", "admitted", 30)
    at("a", "first_token", 250)
    at("a", "finish", 900)
    at("b", "queued", 0, prompt_tokens=5)
    at("b", "finish", 10)
    at("c", "queued", 0, **{**sla, "ttft_target_s": 0.0, "deadline_s": 0.0})
    at("c", "admitted", 5)
    at("d", "received", 0)
    at("e", "queued", 0, **sla)
    at("e", "admitted", 1)
    at("e", "first_token", 900)
    at("e", "abort", 100)
    return [rec.timeline(r) for r in "abcde"]


def test_budget_breakdown_and_debug_requests_as_the_reference():
    ref, port = timelines(jflight), timelines(tflight)
    assert port == ref
    for a, b in zip(ref, port):
        assert tslo.budget_breakdown(b) == jslo.budget_breakdown(a)
    got = tslo.budget_breakdown(port[0])
    assert got["ttft_met"] is True and got["budget_shares"] == {"queue": 0.06, "prefill": 0.5}
    assert tslo.budget_breakdown(port[4])["ttft_met"] is False
    assert tslo.budget_breakdown(port[1]) is None


class CaptureEngine:
    """An engine that records each request's annotations and echoes."""

    def __init__(self):
        self.seen = []

    async def generate(self, request, context):
        req = (request if isinstance(request, tcommon.PreprocessedRequest)
               else tcommon.PreprocessedRequest.from_obj(request))
        self.seen.append(dict(req.annotations))
        for i, tid in enumerate(req.token_ids[:4]):
            yield tcommon.BackendOutput(token_ids=[tid], cumulative_tokens=i + 1)
        yield tcommon.BackendOutput(finish_reason="length", cumulative_tokens=4)


async def test_sla_class_propagates_frontend_to_worker_e2e():
    store = MemKVStore()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    worker_rt = await DistributedRuntime(cfg, store=store, event_plane=InProcEventPlane()).start()
    frontend_rt = await DistributedRuntime(cfg, store=store,
                                           event_plane=InProcEventPlane()).start()
    engine = CaptureEngine()
    card = ModelDeploymentCard(
        name="echo-model", tokenizer="byte", context_length=4096,
        runtime_config=ModelRuntimeConfig(sla_classes={"interactive": {"ttft_target_s": 0.4}}))
    served = await register_llm(worker_rt, engine, card)
    manager = ModelManager()
    watcher = await ModelWatcher(frontend_rt, manager).start()
    service = HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    try:
        for _ in range(100):
            pipe = manager.get("echo-model")
            if pipe and pipe.client.instances:
                break
            await asyncio.sleep(0.05)
        base = f"http://127.0.0.1:{service.port}"
        async with aiohttp.ClientSession() as s:
            r = await s.post(f"{base}/v1/completions",
                             json={"model": "echo-model", "prompt": "hello world",
                                   "max_tokens": 8},
                             headers={"x-dtpu-sla": "interactive"})
            assert r.status == 200, await r.text()
            spec = tslo.spec_from_annotations(engine.seen[-1])
            assert as_tuple(spec) == ("interactive", 0.4, 0.05, 0.0)
            assert tslo.sla_t0_ns(engine.seen[-1]) is not None
            assert "traceparent" in engine.seen[-1]
            async with s.get(f"{base}/metrics") as mr:
                text = await mr.text()
            for name in ("dtpu_time_to_first_token_seconds_count{",
                         "dtpu_inter_token_latency_seconds_count{",
                         "dtpu_request_duration_seconds_count{"):
                line = next(ln for ln in text.splitlines() if ln.startswith(name))
                assert 'sla_class="interactive"' in line and 'model="echo-model"' in line
            async with s.get(f"{base}/debug/slo") as dr:
                ledger_doc = await dr.json()
            win = ledger_doc["models"]["echo-model"]["interactive"]["windows"]
            assert win["total"]["requests"] == 1
            # the body's class beats the header's; an unknown class is a 400
            r2 = await s.post(f"{base}/v1/chat/completions",
                              json={"model": "echo-model", "max_tokens": 4, "sla": "batch",
                                    "messages": [{"role": "user", "content": "x"}]},
                              headers={"x-dtpu-sla": "interactive"})
            assert r2.status == 200
            assert tslo.spec_from_annotations(engine.seen[-1]).sla_class == "batch"
            for path in ("/v1/completions", "/v1/chat/completions"):
                r3 = await s.post(base + path, json={
                    "model": "echo-model", "prompt": "x", "sla": "nope",
                    "messages": [{"role": "user", "content": "x"}]})
                assert r3.status == 400
                assert "unknown SLA class" in (await r3.json())["error"]["message"]
            # no class: the default one
            r4 = await s.post(f"{base}/v1/completions",
                              json={"model": "echo-model", "prompt": "x", "max_tokens": 2})
            assert r4.status == 200
            assert tslo.spec_from_annotations(engine.seen[-1]).sla_class == "standard"
            async with s.get(f"{base}/debug/requests?id={(await r4.json())['id']}") as rr:
                timeline = await rr.json()
            kinds = [e["event"]["kind"] for e in timeline["events"]]
            assert kinds[:3] == ["received", "tokenized", "routed"] and kinds[-1] == "finish"
            assert timeline["events"][0]["event"]["sla_class"] == "standard"
    finally:
        await service.stop()
        await watcher.stop()
        await served.stop()
        await worker_rt.shutdown()
        await frontend_rt.shutdown()


MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64))


async def engine_ledger(engine, port: bool) -> tuple:
    """Two classed requests (one met, one whose 1 ns TTFT target it misses)
    and one unclassed through an engine: the process's ledger requests,
    verdicts and the violation events."""
    from dynamo_tpu.llm.protocols import common as jcommon
    from dynamo_tpu.runtime.engine import Context as JContext

    slo, timeline, common, ctx = ((tslo, tflight, tcommon, Context) if port
                                else (jslo, jflight, jcommon, JContext))
    acct = slo.SloAccountant()
    slo.set_slo_accountant(acct)
    rec = timeline.FlightRecorder(capacity=16)
    timeline.set_flight_recorder(rec)
    try:
        for rid, spec in (("met", slo.SlaSpec("batch", 60.0, 5.0)),
                          ("missed", slo.SlaSpec("interactive", 1e-9, 5.0)), ("none", None)):
            annot = {"sla": spec.to_annotation()} if spec is not None else {}
            req = common.PreprocessedRequest(
                request_id=rid, model="m", token_ids=list(range(30, 50)),
                stop=common.StopConditions(max_tokens=4, ignore_eos=True),
                sampling=common.SamplingOptions(temperature=0.0), annotations=annot)
            async for _ in engine.generate(req, ctx(rid)):
                pass
        snap = acct.snapshot()["models"]["m"]
        totals = {cls: (cls_doc["windows"]["total"]["requests"],
                        cls_doc["windows"]["total"]["attainment"],
                        cls_doc["windows"]["total"]["goodput_tokens"])
                  for cls, cls_doc in snap.items()}
        violations = {}
        for rid in ("met", "missed", "none"):
            evs = [e["event"] for e in rec.timeline(rid)["events"]]
            violations[rid] = [sorted(k for k in e if not k.endswith("_ms"))
                               for e in evs if e["kind"] == "slo_violation"]
            queued = next(e for e in evs if e["kind"] == "queued")
            violations[rid].append(sorted(queued))
        return totals, violations
    finally:
        engine.stop()
        slo.set_slo_accountant(None)
        timeline.set_flight_recorder(None)


async def test_engine_feeds_the_workers_ledger_as_the_reference():
    w = Weights(MODEL)
    ref = await engine_ledger(w.jax_engine(ENGINE), False)
    port = await engine_ledger(w.torch_engine(ENGINE, decode_steps=1), True)
    assert port == ref
    assert port[0] == {"batch": (1, 1.0, 4), "interactive": (1, 0.0, 0)}
    assert len(port[1]["missed"]) == 2 and len(port[1]["met"]) == 1


async def test_failure_before_first_token_lands_in_frontend_ledger():
    class DeadPipeline:
        async def generate_tokens(self, preq, ctx):
            raise NoResponders("nobody home")
            yield  # pragma: no cover

    from dynamo_tpu_torch.llm.http.server import Request
    from dynamo_tpu_torch.llm.protocols.delta import (
        CompletionDeltaGenerator,
        aggregate_completion,
    )

    service = HttpService(ModelManager(), host="127.0.0.1", port=0)
    preq = tcommon.PreprocessedRequest(request_id="dead-1", model="m", token_ids=[1, 2, 3])
    req = Request("POST", "/v1/completions", "HTTP/1.1", {}, b"")
    resp = await service._run(
        req, [preq], DeadPipeline(), "m", False,
        [CompletionDeltaGenerator("dead-1", "m", False)],
        lambda ss: aggregate_completion("dead-1", "m", ss[0], ""),
        sla=tslo.SlaSpec("interactive", 0.5, 0.05))
    assert resp.status == 503
    win = service.slo.snapshot()["models"]["m"]["interactive"]["windows"]
    assert win["total"]["requests"] == 1
    assert win["total"]["attainment"] == 0.0 and win["total"]["ttft_attainment"] is None
    timeline = tflight.get_flight_recorder().timeline("dead-1")
    assert timeline["error"] == "no workers available"
    assert timeline["events"][-1]["event"]["kind"] == "abort"
