"""The port's tracing and flight recorder against the reference's.

Mirrors tests/test_tracing.py (not its disaggregated hop, which waits for
the port's KV transfer): traceparent parsing and formatting on a seeded
corpus of headers, span nesting and the parenting precedence of ``span``
and ``emit``, JSONL lines equal to the reference exporter's on one script
of spans (ids and times masked), the worker span parented on the
frontend's across a request-plane round trip, TorchEngine's engine-phase
spans and flight timeline beside TpuEngine's on the same weights and
request, the step-stats hook, the flight recorder's ring, caps, failure
dump and ``/debug/requests`` answers on each package's status server, the
OTLP exporter off the request path, and a frontend + worker trace across
three ``python -m`` processes.
"""

import asyncio
import json
import os
import re
import string
import subprocess
import sys
import time

import aiohttp
import numpy as np
import pytest

from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm.backend import Backend as JBackend
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.llm.tokenizer import load_tokenizer as jload_tokenizer
from dynamo_tpu.runtime import flight_recorder as jflight
from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu.runtime.engine import Context as JContext, FnEngine as JFnEngine
from dynamo_tpu.runtime.recorder import Recorder as JRecorder
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime import flight_recorder as tflight
from dynamo_tpu_torch.runtime import health as thealth
from dynamo_tpu_torch.runtime import tracing as ttracing
from dynamo_tpu_torch.runtime.engine import Context, FnEngine
from dynamo_tpu_torch.runtime.recorder import Recorder
from torch_feature_engines import Weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACING = pytest.mark.parametrize("tr", [jtracing, ttracing], ids=["reference", "port"])


def headers(seed: int, n: int = 300) -> list:
    """Valid, upper-case, truncated, non-hex and mis-split traceparents."""
    rng = np.random.default_rng(seed)
    hexd = "0123456789abcdefABCDEF"
    out = []
    for _ in range(n):
        tid = "".join(rng.choice(list(hexd), 32))
        sid = "".join(rng.choice(list(hexd), 16))
        kind = int(rng.integers(0, 6))
        if kind == 1:
            tid = tid[: int(rng.integers(0, 32))]
        elif kind == 2:
            sid = sid[:-1] + str(rng.choice(list("xyz-")))
        elif kind == 3:
            out.append("".join(rng.choice(list(string.printable), int(rng.integers(0, 60)))))
            continue
        elif kind == 4:
            out.append(f"  00-{tid}-{sid}-01 ")
            continue
        out.append(f"00-{tid}-{sid}-{rng.choice(['01', '00'])}")
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_traceparent_parse_and_format_round_trip_as_the_reference(seed):
    for h in headers(seed):
        got = ttracing.parse_traceparent(h)
        assert got == jtracing.parse_traceparent(h), h
        if got[0] is not None:
            hdr = ttracing.format_traceparent(*got)
            assert hdr == jtracing.format_traceparent(*got)
            assert ttracing.parse_traceparent(hdr) == got
    ids = ttracing.new_trace_id(), ttracing.new_span_id()
    assert [len(i) for i in ids] == [32, 16] and all(int(i, 16) >= 0 for i in ids)


def script(tr, tracer) -> None:
    """One script of spans: nesting, explicit and malformed parents, emit,
    an error, attributes of every OTLP value type."""
    with tracer.span("http.generate", request_id="r1", model="m", streaming=True,
                     n=2) as root:
        with tracer.span("router.schedule", request_id="r1") as route:
            route.set(worker="00000000000000aa", overlap_blocks=3, share=0.25)
            hdr = route.traceparent()
        tracer.emit("engine.queue", 100, 200, traceparent=hdr, request_id="r1")
        tracer.emit("engine.decode", 300, 900, traceparent="garbage", request_id="r1",
                    status="ERROR", finish="error")
        try:
            with tracer.span("failing", traceparent=root.traceparent()):
                raise ValueError("boom")
        except ValueError:
            pass
    tracer.emit("orphan", 5, 6)
    with tracer.span("second.root", traceparent="00-zz-yy-01", flag=False):
        pass


def masked_lines(path: str) -> list:
    """JSONL spans with ids replaced by their order of appearance and times
    by their order (emit's explicit times kept)."""
    names = {}

    def alias(v):
        return names.setdefault(v, f"id{len(names)}")

    out = []
    for line in open(path):
        sp = json.loads(line)
        for k in ("traceId", "spanId", "parentSpanId"):
            if k in sp:
                sp[k] = alias(sp[k])
        if int(sp["startTimeUnixNano"]) > 10**12:
            sp["startTimeUnixNano"] = sp["endTimeUnixNano"] = "<now>"
        out.append(sp)
    return out


def test_jsonl_lines_equal_the_reference_exporters(tmp_path):
    lines = {}
    for name, tr in (("ref", jtracing), ("port", ttracing)):
        path = str(tmp_path / f"{name}.jsonl")
        tracer = tr.Tracer(tr.JsonlExporter(path), batch_size=3)
        script(tr, tracer)
        tracer.shutdown()
        lines[name] = masked_lines(path)
    assert lines["port"] == lines["ref"]
    assert len(lines["port"]) == 7
    by_name = {sp["name"]: sp for sp in lines["port"]}
    assert by_name["router.schedule"]["parentSpanId"] == by_name["http.generate"]["spanId"]
    assert by_name["engine.queue"]["parentSpanId"] == by_name["router.schedule"]["spanId"]
    assert by_name["failing"]["status"] == {"code": 2}


@TRACING
def test_nesting_and_parent_precedence(tr):
    exp = tr.InMemoryExporter()
    tracer = tr.Tracer(exp, batch_size=1)
    assert tr.current_span() is None and tr.current_traceparent() is None
    with tracer.span("a") as a:
        assert tr.current_span() is a
        with tracer.span("b") as b:
            assert tr.current_traceparent() == b.traceparent()
            sp = tracer.emit("e", 1, 2)
        other = tracer.span("c", traceparent=tr.format_traceparent("1" * 32, "2" * 16))
    assert tr.current_span() is None
    assert (b.trace_id, b.parent_id) == (a.trace_id, a.span_id)
    assert (sp.trace_id, sp.parent_id) == (b.trace_id, b.span_id)
    assert (other.trace_id, other.parent_id) == ("1" * 32, "2" * 16)
    assert [s.name for s in exp.spans] == ["e", "b", "a"]


async def worker_parents_on_frontend(port: bool):
    tr, common = (ttracing, tcommon) if port else (jtracing, jcommon)
    exp = tr.InMemoryExporter()
    tracer = tr.Tracer(exp, batch_size=1)
    tr.set_tracer(tracer)
    try:
        async def fake_engine(req, ctx):
            yield common.BackendOutput(token_ids=[65], finish_reason="stop").to_obj()

        backend = (Backend(FnEngine(fake_engine), load_tokenizer("byte")) if port
                   else JBackend(JFnEngine(fake_engine), jload_tokenizer("byte")))
        with tracer.span("http.generate", request_id="r1") as frontend:
            preq = common.PreprocessedRequest(
                request_id="r1", model="m", token_ids=[1, 2, 3],
                annotations={"traceparent": frontend.traceparent()})
            wire = common.PreprocessedRequest.from_obj(preq.to_obj())
            async for _ in backend.generate(wire, (Context if port else JContext)("r1")):
                pass
        worker = next(s for s in exp.spans if s.name == "worker.generate")
        return (worker.trace_id == frontend.trace_id, worker.parent_id == frontend.span_id,
                worker.attributes)
    finally:
        tr.set_tracer(None)


async def test_worker_span_parents_on_frontend_span():
    ref, port = await worker_parents_on_frontend(False), await worker_parents_on_frontend(True)
    assert port == ref == (True, True, {"request_id": "r1"})


MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64))


async def engine_lifecycle(engine, port: bool) -> dict:
    tr, flight, common = ((ttracing, tflight, tcommon) if port
                          else (jtracing, jflight, jcommon))
    exp = tr.InMemoryExporter()
    tracer = tr.Tracer(exp, batch_size=1)
    tr.set_tracer(tracer)
    rec = flight.FlightRecorder(capacity=16)
    flight.set_flight_recorder(rec)
    steps = []
    engine.stats_hook = steps.append
    try:
        with tracer.span("http.generate", request_id="tr1") as frontend:
            hdr = frontend.traceparent()
        req = common.PreprocessedRequest(
            request_id="tr1", model="m", token_ids=list(range(40, 92)),
            stop=common.StopConditions(max_tokens=4, ignore_eos=True),
            sampling=common.SamplingOptions(temperature=0.0),
            annotations={"traceparent": hdr})
        toks = []
        async for out in engine.generate(req, (Context if port else JContext)("tr1")):
            toks.extend(out.token_ids)
        spans = {}
        for s in exp.spans:
            if s.name.startswith("engine."):
                assert s.trace_id == frontend.trace_id and s.parent_id == frontend.span_id
                assert s.end_ns >= s.start_ns
                spans[s.name] = (s.status, s.attributes)
        timeline = rec.timeline("tr1")
        events = [{k: v for k, v in e["event"].items() if k != "waiting"}
                  for e in timeline["events"]]
        stamps = [e["timestamp"] for e in timeline["events"]]
        assert stamps == sorted(stamps)
        return {"tokens": toks, "spans": spans, "events": events,
                "done": timeline["done"], "error": timeline["error"],
                "phases": sorted({s.phase for s in steps}),
                "prefill_tokens": sum(s.tokens for s in steps if s.phase == "prefill")}
    finally:
        engine.stop()
        tr.set_tracer(None)
        flight.set_flight_recorder(None)


async def test_engine_phase_spans_and_flight_timeline_as_the_reference():
    """One request through TpuEngine and through TorchEngine: the same
    engine.queue / prefill / decode spans (attributes and status) in the
    caller's trace, the same flight timeline (queued, admitted,
    first_token, finish with their fields), the same step phases."""
    w = Weights(MODEL)
    ref = await engine_lifecycle(w.jax_engine(ENGINE), False)
    port = await engine_lifecycle(w.torch_engine(ENGINE, decode_steps=1), True)
    assert port == ref
    assert [e["kind"] for e in port["events"]] == ["queued", "admitted", "first_token",
                                                   "finish"]
    assert set(port["spans"]) == {"engine.queue", "engine.prefill", "engine.decode"}
    assert port["phases"] == ["decode", "prefill"] and port["prefill_tokens"] == 52


async def test_engine_step_stats_hook_fires():
    engine = Weights(MODEL).torch_engine(ENGINE, decode_steps=1)
    seen = []
    engine.stats_hook = seen.append
    try:
        req = tcommon.PreprocessedRequest(
            request_id="ss1", model="m", token_ids=list(range(30, 42)),
            stop=tcommon.StopConditions(max_tokens=4, ignore_eos=True),
            sampling=tcommon.SamplingOptions(temperature=0.0))
        async for _ in engine.generate(req, Context("ss1")):
            pass
        pre = next(s for s in seen if s.phase == "prefill")
        assert pre.tokens == 12 and pre.kv_total_blocks == 64 and pre.passes == 1
        dec = [s for s in seen if s.phase == "decode"]
        assert dec and all(s.tokens == 1 and s.duration_s >= 0 for s in dec)
        assert any(s.batch_occupancy >= 1 for s in seen)
    finally:
        engine.stop()


FLIGHT = pytest.mark.parametrize("fl", [jflight, tflight], ids=["reference", "port"])


class Ticks:
    """A stand-in for the time module: time_ns advances 1 ms a call."""

    def __init__(self):
        self.now = 1_700_000_000_000_000_000

    def time_ns(self):
        self.now += 1_000_000
        return self.now


@pytest.fixture
def ticks(monkeypatch):
    """Both recorders on their own deterministic clock."""
    for fl in (jflight, tflight):
        monkeypatch.setattr(fl, "time", Ticks())


def flight_script(fl, dump_path=None):
    rec = fl.FlightRecorder(capacity=3, dump_path=dump_path)
    for i in range(5):
        rec.record(f"r{i}", "received", model="m")
    for i in range(100):
        rec.record("r4", "migration", attempt=i)
    rec.record("r3", "routed", worker="w1")
    rec.finish("r3", error="worker exploded" * 60, error_class="internal_error")
    rec.finish("r4", error="boom")
    rec.finish("r2", status="200")
    rec.record(None, "ignored")
    return rec


def test_flight_recorder_ring_caps_and_snapshot_as_the_reference(ticks):
    ref, port = flight_script(jflight), flight_script(tflight)
    for limit in (64, 2, 0, -3):
        assert port.snapshot(limit) == ref.snapshot(limit)
    for rid in ("r0", "r2", "r3", "r4", "nope"):
        assert port.timeline(rid) == ref.timeline(rid)
    assert len(port) == 3 and port.timeline("r0") is None
    r4 = port.timeline("r4")
    assert len(r4["events"]) == 65 and r4["dropped_events"] == 37
    assert r4["events"][-1]["event"]["kind"] == "abort"


def test_flight_recorder_failure_dump_as_the_reference(tmp_path, ticks):
    dumps = {}
    for name, fl, rec_cls in (("ref", jflight, JRecorder), ("port", tflight, Recorder)):
        path = str(tmp_path / f"{name}.jsonl")
        flight_script(fl, dump_path=path)
        dumps[name] = rec_cls.load(path)
    assert dumps["port"] == dumps["ref"]
    assert {e["request_id"] for _, e in dumps["port"]} == {"r3", "r4"}
    assert dumps["port"][-1][1]["kind"] == "abort"


@pytest.mark.parametrize("query", [("r3", None), ("nope", None), (None, "2"), (None, "x"),
                                   (None, None), ("r4", None)])
def test_debug_requests_payload_as_the_reference(query, ticks):
    ref, port = flight_script(jflight), flight_script(tflight)
    a = jflight.debug_requests_payload(ref, *query)
    b = tflight.debug_requests_payload(port, *query)
    assert b == a


@pytest.mark.parametrize("health,fl", [(jhealth, jflight), (thealth, tflight)],
                         ids=["reference", "port"])
async def test_status_server_debug_requests_endpoint(health, fl, ticks):
    rec = fl.FlightRecorder(capacity=8)
    rec.record("req-ok", "received", model="m")
    rec.finish("req-ok", status="200")
    rec.record("req-bad", "received", model="m")
    rec.finish("req-bad", error="boom", error_class="internal_error")
    server = health.StatusServer(health.HealthState(), host="127.0.0.1", flight_recorder=rec)
    await server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        async with aiohttp.ClientSession() as s:
            async with s.get(base + "/debug/requests") as r:
                assert r.status == 200
                answer = await r.json()
            assert {fl["request_id"] for fl in answer["requests"]} == {"req-ok", "req-bad"}
            async with s.get(base + "/debug/requests?limit=1") as r:
                assert [fl["request_id"] for fl in (await r.json())["requests"]] == ["req-bad"]
            async with s.get(base + "/debug/requests?id=req-ok") as r:
                one = await r.json()
            assert r.status == 200 and one["request_id"] == "req-ok" and one["done"]
            # received -> finish: the gap is the decode phase's
            assert one["attribution"]["dominant"] == "decode"
            async with s.get(base + "/debug/requests?id=nope") as r:
                assert r.status == 404
    finally:
        await server.stop()


def test_global_flight_recorder_env(monkeypatch):
    tflight.set_flight_recorder(None)
    monkeypatch.setenv("DTPU_FLIGHT_CAPACITY", "7")
    monkeypatch.setenv("DTPU_FLIGHT_DUMP", "/nonexistent/dump.jsonl")
    try:
        rec = tflight.get_flight_recorder()
        assert rec.capacity == 7 and rec.dump_path == "/nonexistent/dump.jsonl"
        assert tflight.get_flight_recorder() is rec
    finally:
        tflight.set_flight_recorder(None)


def test_tracer_from_env(monkeypatch, tmp_path):
    for var in ("DTPU_OTLP_ENDPOINT", "DYN_OTLP_ENDPOINT", "DTPU_TRACE_JSONL",
                "DYN_TRACE_JSONL"):
        monkeypatch.delenv(var, raising=False)
    assert not ttracing.Tracer.from_env().enabled
    monkeypatch.setenv("DTPU_TRACE_JSONL", str(tmp_path / "s.jsonl"))
    assert isinstance(ttracing.Tracer.from_env().exporter, ttracing.JsonlExporter)
    monkeypatch.setenv("DTPU_OTLP_ENDPOINT", "http://127.0.0.1:9")
    assert isinstance(ttracing.Tracer.from_env().exporter, ttracing.OtlpHttpExporter)


def test_otlp_export_does_not_block_and_stays_bounded():
    exp = ttracing.OtlpHttpExporter("http://127.0.0.1:9", timeout_s=0.2, queue_max=1)
    tracer = ttracing.Tracer(exp, batch_size=1)
    t0 = time.monotonic()
    with tracer.span("a"):
        pass
    for _ in range(50):
        exp.export([ttracing.Span("s", ttracing.new_trace_id(), ttracing.new_span_id())])
    assert time.monotonic() - t0 < 1.0
    exp.flush(timeout_s=5.0)
    assert exp.dropped_spans > 0


def test_logging_stamps_the_request_and_the_span(capsys):
    """The port's JSONL log records carry the request id and the current
    span's trace and span ids."""
    import logging

    from dynamo_tpu_torch.runtime import logging as tlog

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(tlog._JsonlFormatter())
    logger = tlog.get_logger("test.stamp")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        tracer = ttracing.Tracer(None)
        tlog.set_request_id("req-42")
        with tracer.span("s") as sp:
            logger.info("inside")
        tlog.set_request_id(None)
        logger.info("outside")
    finally:
        logger.removeHandler(handler)
    recs = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("{")]
    inside = next(r for r in recs if r["message"] == "inside")
    outside = next(r for r in recs if r["message"] == "outside")
    assert (inside["request_id"], inside["trace_id"], inside["span_id"]) == (
        "req-42", sp.trace_id, sp.span_id)
    assert not {"request_id", "trace_id"} & set(outside)


def test_a_trace_across_frontend_and_worker_processes(tmp_path):
    """netstore, a tiny CPU worker and the frontend as ``python -m``
    processes, each frontend and worker with its own DTPU_TRACE_JSONL: one
    completion's spans share a trace, parented frontend -> router ->
    worker and engine phases, as the reference parents them."""
    env = {**os.environ, "PYTHONPATH": REPO}
    files = {n: str(tmp_path / f"{n}.jsonl") for n in ("frontend", "worker")}
    procs = []

    def start(name, *args, extra=None):
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env={**env, **(extra or {})},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    def wait(p, prefix, timeout=90):
        deadline = time.monotonic() + timeout
        for line in p.stdout:
            if line.startswith(prefix):
                return line.split()[1]
            if time.monotonic() > deadline:
                break
        raise AssertionError(f"no {prefix}")

    try:
        store = start("netstore", "dynamo_tpu_torch.runtime.discovery.netstore", "--port", "0")
        addr = wait(store, "KVSTORE_READY")
        common = ("--store", "tcp", "--store-path", addr)
        worker = start("worker", "dynamo_tpu_torch.engine", *common, "--preset", "tiny",
                       "--device", "cpu", "--model", "tiny", "--decode-steps", "1",
                       "--decode-pipeline", "1", extra={"DTPU_TRACE_JSONL": files["worker"]})
        front = start("frontend", "dynamo_tpu_torch.frontend", *common, "--host",
                      "127.0.0.1", "--port", "0",
                      extra={"DTPU_TRACE_JSONL": files["frontend"]})
        port = int(wait(front, "TORCH_FRONTEND_READY").rsplit(":", 1)[1])
        wait(worker, "TORCH_ENGINE_READY")

        async def go():
            async with aiohttp.ClientSession() as s:
                for _ in range(200):
                    async with s.get(f"http://127.0.0.1:{port}/v1/models") as r:
                        if (await r.json())["data"]:
                            break
                    await asyncio.sleep(0.05)
                tp = ttracing.format_traceparent("ab" * 16, "cd" * 8)
                async with s.post(f"http://127.0.0.1:{port}/v1/completions",
                                  headers={"traceparent": tp},
                                  json={"model": "tiny", "prompt": "hello", "max_tokens": 3,
                                        "ignore_eos": True}) as r:
                    return (await r.json())["id"]

        rid = asyncio.run(go())
    finally:
        for p in reversed(procs):
            p.terminate()
        for p in procs:
            p.wait(30)
    spans = {}
    for path in files.values():
        for line in open(path):
            sp = json.loads(line)
            attrs = {a["key"]: next(iter(a["value"].values())) for a in sp["attributes"]}
            if attrs.get("request_id") == rid:
                spans[sp["name"]] = sp
    parents = {"http.generate": None, "router.schedule": "http.generate",
               "worker.generate": "router.schedule", "engine.queue": "router.schedule",
               "engine.prefill": "router.schedule", "engine.decode": "router.schedule"}
    assert set(spans) == set(parents)
    assert {sp["traceId"] for sp in spans.values()} == {"ab" * 16}
    assert spans["http.generate"]["parentSpanId"] == "cd" * 8
    for name, parent in parents.items():
        if parent is not None:
            assert spans[name]["parentSpanId"] == spans[parent]["spanId"], name
    assert re.fullmatch(r"[0-9a-fl]{16}", spans["router.schedule"]["spanId"])
