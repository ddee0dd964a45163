"""The port's serving plane end to end on the CPU, against the reference's.

Two stacks on the same tiny float32 llama weights (JAX ``init_params``
carried across through numpy), each wired as tests/test_frontend_e2e.py
wires the reference: a DistributedRuntime for the worker and one for the
frontend on a MemKVStore with an InProcEventPlane, ``register_llm`` over
the engine, a ModelWatcher and the HTTP service on a free port. The
reference stack serves TpuEngine, the port's TorchEngine(device="cpu");
both at one decode step a tick, so that each output carries one token and
the SSE chunks line up. The same corpus of requests goes to both over
HTTP (aiohttp's client), and the bodies must be equal, ignoring ``id``
and ``created`` and floats within 1e-4: streamed and unstreamed chat and
completions, stop strings, ``max_tokens``, logprobs with
``top_logprobs``, ``n = 2`` with a seed, ``guided_json`` and
``response_format``, a logits processor, a LoRA adapter loaded through the
``load_lora`` endpoint, embeddings, /v1/responses whole and streamed (the
Responses SSE events), /v1/models, 404 and 400; and through a second
service on the same models with a request template, chat and
completions bodies that omit the model, max tokens or temperature, or set
them. Then a second worker instance joins and a streamed request's worker
dies after three outputs: the frontend replays it on the other instance
(the card's ``migration_limit`` is 1), and the stream equals the
reference's and the undisturbed one. Last, each package's fault registry
drops every send: five requests get the worker-loss 503, which trips the
model's circuit, and the sixth gets the circuit-open 503 with its
``Retry-After`` header, without a send.

Then the port alone: a client that disconnects mid-stream frees the
engine's slot and leaves the in-flight gauge at 0; a worker that stops
leaves /v1/models, and so does one whose lease lapses (its keepalive
stopped, as a killed process's); and the three ``python -m`` entry points
over a tcp store stream one completion and drain on SIGTERM.
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time

import aiohttp
import numpy as np
import pytest

from dynamo_tpu import guided as jguided
from dynamo_tpu import logits_processing as jlp
from dynamo_tpu import llm as jllm
from dynamo_tpu import lora as jlora
from dynamo_tpu.llm.http.service import HttpService as JHttpService
from dynamo_tpu.llm.request_template import RequestTemplate as JRequestTemplate
from dynamo_tpu import runtime as jrt
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu_torch import guided as tguided
from dynamo_tpu_torch import logits_processing as tlp
from dynamo_tpu_torch.engine.__main__ import serve_lora_endpoints
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.request_template import RequestTemplate
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    InProcEventPlane,
    MemKVStore,
    RuntimeConfig,
)
from dynamo_tpu_torch.runtime import faults as tfaults
from test_torch_lora import _adapter_weights
from torch_feature_engines import Weights
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=256, block_size=4, max_batch_size=4, max_context=512,
              prefill_buckets=(16, 32, 64), lora_max_adapters=2, lora_rank=4,
              guided_max_states=256, guided_max_classes=128)
BANNED = list(range(0, 256, 2))
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"}, "mood": {"enum": ["happy", "sad"]}},
          "required": ["ok", "mood"]}
M = "tiny"


def _chat(content, **kw):
    return {"model": M, "messages": [{"role": "user", "content": content}], **kw}


def _cmpl(prompt, **kw):
    return {"model": M, "prompt": prompt, **kw}


# (name, method, path, body); "STOP" in a body is replaced by a stop string
# cut from the greedy text of the request named by "stop_from"
CORPUS = [
    ("chat", "POST", "/v1/chat/completions", _chat("hello there", max_tokens=8)),
    ("chat_stream", "POST", "/v1/chat/completions",
     _chat("hello there", max_tokens=8, stream=True, stream_options={"include_usage": True})),
    ("cmpl", "POST", "/v1/completions", _cmpl("Once upon a time", max_tokens=10)),
    ("cmpl_stream", "POST", "/v1/completions",
     _cmpl("Once upon a time", max_tokens=10, stream=True)),
    ("cmpl_stop", "POST", "/v1/completions",
     _cmpl("Once upon a time", max_tokens=10, stop=["STOP"])),
    ("chat_stop_stream", "POST", "/v1/chat/completions",
     _chat("hello there", max_tokens=8, stop="STOP", stream=True)),
    ("chat_logprobs", "POST", "/v1/chat/completions",
     _chat("pick a word", max_tokens=6, logprobs=True, top_logprobs=3)),
    ("chat_logprobs_stream", "POST", "/v1/chat/completions",
     _chat("pick a word", max_tokens=6, logprobs=True, top_logprobs=2, stream=True)),
    ("cmpl_logprobs", "POST", "/v1/completions", _cmpl("The cat", max_tokens=5, logprobs=2)),
    ("cmpl_n2", "POST", "/v1/completions",
     _cmpl("abc", max_tokens=6, n=2, seed=11, temperature=0.8)),
    ("cmpl_n2_stream", "POST", "/v1/completions",
     _cmpl("xyz", max_tokens=6, n=2, seed=5, temperature=0.9, stream=True,
           stream_options={"include_usage": True})),
    ("chat_guided_json", "POST", "/v1/chat/completions",
     _chat("answer in JSON", max_tokens=160, guided_json=SCHEMA)),
    ("chat_response_format", "POST", "/v1/chat/completions",
     _chat("answer in JSON", max_tokens=160, stream=True,
           response_format={"type": "json_schema", "json_schema": {"schema": SCHEMA}})),
    ("cmpl_processor", "POST", "/v1/completions",
     _cmpl("Once upon a time", max_tokens=10, logits_processors=["ban"])),
    ("cmpl_lora", "POST", "/v1/completions",
     _cmpl("Qz adapter prompt", max_tokens=10, lora="ad")),
    ("embed", "POST", "/v1/embeddings", {"model": M, "input": "hello there"}),
    ("responses", "POST", "/v1/responses",
     {"model": M, "input": "hello there", "max_output_tokens": 8,
      "instructions": "be brief"}),
    ("responses_stream", "POST", "/v1/responses",
     {"model": M, "input": "hello there", "max_output_tokens": 8, "stream": True,
      "temperature": 0.0}),
    ("chat_greedy", "POST", "/v1/chat/completions",
     _chat("hello there", max_tokens=8, temperature=0.0)),
    ("responses_items", "POST", "/v1/responses",
     {"model": M, "max_output_tokens": 6, "temperature": 0.0,
      "input": [{"role": "user", "content": [{"type": "input_text", "text": "part one"},
                                             {"type": "input_image", "text": "skip"}]},
                {"role": "critic", "content": "as a user"}]}),
    ("responses_unknown_model", "POST", "/v1/responses", {"model": "nope", "input": "x"}),
    ("responses_invalid", "POST", "/v1/responses", {"model": M, "max_output_tokens": 0,
                                                    "input": "x"}),
    ("embed_batch", "POST", "/v1/embeddings",
     {"model": M, "input": ["first input", "a second input"], "dimensions": 16}),
    ("models", "GET", "/v1/models", None),
    ("unknown_model", "POST", "/v1/chat/completions", {**_chat("hi"), "model": "nope"}),
    ("invalid_body", "POST", "/v1/chat/completions", {"model": M, "messages": []}),
    ("invalid_field", "POST", "/v1/completions", _cmpl("hi", max_tokens=0)),
    ("unknown_processor", "POST", "/v1/completions",
     _cmpl("hi", max_tokens=3, logits_processors=["nope"])),
]
STOP_FROM = {"cmpl_stop": "cmpl", "chat_stop_stream": "chat"}
# sent to a second service whose request template fills model, temperature
# and max_completion_tokens where a body leaves them unset
TEMPLATE = dict(model=M, temperature=0.0, max_completion_tokens=6)
TEMPLATE_CORPUS = [
    ("template_chat", "POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hello there"}]}),
    ("template_cmpl_stream", "POST", "/v1/completions",
     {"prompt": "Once upon a time", "stream": True, "model": ""}),
    ("template_request_wins", "POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 3,
      "temperature": 0.5, "seed": 4}),
    ("template_unknown_model", "POST", "/v1/chat/completions",
     {"model": "nope", "messages": [{"role": "user", "content": "hi"}]}),
]
# each package's fault registry drops every send: TRIPS worker-loss 503s
# open the model's circuit (the frontend breaker's threshold is 5). Its
# window is cut to CB_WINDOW s, and the trips start once the corpus's
# successes have left it, so that the failure rate is 1
TRIPS = 5
DROP_ALL = "request_plane.send:drop@1+"
CB_WINDOW = 1.0
NAMES = ([c[0] for c in CORPUS] + [c[0] for c in TEMPLATE_CORPUS]
         + [f"trip_{i}" for i in range(TRIPS)] + ["circuit_open"])


async def _send(session, base, method, path, body, headers=None):
    """(status, body); a server-sent event stream's body is its data chunks,
    its event names and whether it ended (``[DONE]``, or a Responses
    stream's ``response.completed``). With ``headers`` (a dict), the
    response's headers are copied into it."""
    async with session.request(method, base + path, json=body) as r:
        if headers is not None:
            headers.update(r.headers)
        if r.headers.get("Content-Type", "").startswith("text/event-stream"):
            chunks, events, done = [], [], False
            async for line in r.content:
                line = line.decode().strip()
                if line.startswith("event: "):
                    events.append(line[7:])
                    done = line == "event: response.completed"
                if not line.startswith("data: "):
                    continue
                if line == "data: [DONE]":
                    done = True
                    continue
                chunks.append(json.loads(line[6:]))
            return r.status, {"stream": chunks, "done": done, "events": events}
        return r.status, await r.json(content_type=None)


def _stop_string(body) -> str:
    """Two characters from the middle of a greedy answer's text."""
    ch = body["choices"][0]
    text = ch["text"] if "text" in ch else ch["message"]["content"]
    assert len(text) >= 4, text
    return text[len(text) // 2: len(text) // 2 + 2]


def _fill(body, stop):
    return json.loads(json.dumps(body).replace('"STOP"', json.dumps(stop)))


async def _load_lora_via_endpoint(rt, path):
    client = await rt.namespace("dynamo").component("backend").endpoint("load_lora").client()
    await client.wait_for_instances(1)
    out = [item async for item in await client.generate({"name": "ad", "uri": path})]
    await client.stop()
    assert out and out[0]["ok"], out
    return out[0]


async def _ref_lora_endpoints(rt, engine):
    """The reference worker's load_lora handler (dynamo_tpu/engine/__main__.py)."""
    cache, source = jlora.LoRACache(), jlora.LocalLoRASource()

    async def handle_load(request, context):
        weights, alpha = jlora.load_adapter(source.fetch(request["uri"], cache))
        yield {"ok": True, "name": request["name"],
               "slot": engine.lora.load(request["name"], weights, alpha)}

    comp = rt.namespace("dynamo").component("backend")
    return [await comp.endpoint("load_lora").serve(handle_load)]


def _card(mod):
    return mod.ModelDeploymentCard(name=M, tokenizer="byte", context_length=512,
                                   kv_block_size=4, migration_limit=1)


MIGRATED = _cmpl("Once upon a time", max_tokens=10, stream=True, temperature=0.0,
                 stream_options={"include_usage": True})


class _DiesOnce:
    """The worker's engine, except that once ``state["armed"]`` is set the
    next request it serves ends after ``after`` outputs with no finish, as
    the stream of a worker that dies mid-request; ``state["calls"]`` logs
    which worker served each request and whether it died."""

    def __init__(self, engine, state, name, after=3):
        self.engine, self.state, self.name, self.after = engine, state, name, after

    def __getattr__(self, attr):
        return getattr(self.engine, attr)

    async def generate(self, request, context):
        die, self.state["armed"] = self.state["armed"], False
        self.state["calls"].append((self.name, die))
        n = 0
        async for out in self.engine.generate(request, context):
            yield out
            n += 1
            if die and n == self.after:
                context.stop_generating()   # the engine frees the slot
                return


async def _run_stack(port: bool, engine, adapter_path):
    """Serve ``engine`` behind one package's plane and send the corpus."""
    if port:
        card, reg, mgr, watcher_cls, svc_cls = (
            ModelDeploymentCard(name=M, tokenizer="byte", context_length=512,
                                kv_block_size=4, migration_limit=1),
            register_llm, ModelManager, ModelWatcher, HttpService)
        template, faults = RequestTemplate(**TEMPLATE), tfaults.FAULTS
        make_rt = lambda store: DistributedRuntime(  # noqa: E731
            RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0),
            store=store, event_plane=InProcEventPlane())
        store = MemKVStore()
    else:
        card, reg, mgr, watcher_cls, svc_cls = (
            _card(jllm), jllm.register_llm, jllm.ModelManager, jllm.ModelWatcher, JHttpService)
        template, faults = JRequestTemplate(**TEMPLATE), jfaults.FAULTS
        make_rt = lambda store: jrt.DistributedRuntime(  # noqa: E731
            jrt.RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0),
            store=store, event_plane=jrt.InProcEventPlane())
        store = jrt.MemKVStore()
    worker_rt = await make_rt(store).start()
    frontend_rt = await make_rt(store).start()
    state = {"armed": False, "calls": []}
    served = await reg(worker_rt, _DiesOnce(engine, state, "a"), card)
    second_rt = second = None
    extra = (await serve_lora_endpoints(worker_rt, "dynamo", "backend", [engine]) if port
             else await _ref_lora_endpoints(worker_rt, engine))
    manager = mgr()
    watcher = await watcher_cls(frontend_rt, manager).start()
    service = svc_cls(manager, host="127.0.0.1", port=0)
    await service.start()
    base = f"http://127.0.0.1:{service.port}"
    templated = svc_cls(manager, host="127.0.0.1", port=0, request_template=template)
    await templated.start()
    results = {}
    try:
        for _ in range(200):
            if manager.get(M) and manager.get(M).client.instances:
                break
            await asyncio.sleep(0.02)
        results["load_lora"] = await _load_lora_via_endpoint(frontend_rt, adapter_path)
        async with aiohttp.ClientSession() as s:
            for name, method, path, body in CORPUS:
                if name in STOP_FROM:
                    body = _fill(body, _stop_string(results[STOP_FROM[name]][1]))
                results[name] = await _send(s, base, method, path, body)
            for name, method, path, body in TEMPLATE_CORPUS:
                results[name] = await _send(s, f"http://127.0.0.1:{templated.port}", method,
                                            path, body)
            # a second worker on the same engine; then one dies mid-stream
            second_rt = await make_rt(store).start()
            second = await reg(second_rt, _DiesOnce(engine, state, "b"), card)
            for _ in range(200):
                if len(manager.get(M).client.instances) == 2:
                    break
                await asyncio.sleep(0.02)
            state["calls"].clear()
            state["armed"] = True
            results["migrated"] = await _send(s, base, "POST", "/v1/completions", MIGRATED)
            results["undisturbed"] = await _send(s, base, "POST", "/v1/completions", MIGRATED)
            results["migration_calls"] = list(state["calls"])
            # every send dropped: worker-loss 503s trip the model's circuit,
            # then the frontend sheds without a send
            faults.disarm()
            faults.arm(DROP_ALL)
            await asyncio.sleep(CB_WINDOW + 0.1)
            try:
                for i in range(TRIPS):
                    results[f"trip_{i}"] = await _send(s, base, "POST", "/v1/chat/completions",
                                                       _chat(f"trip {i}", max_tokens=4))
                headers = {}
                results["circuit_open"] = await _send(s, base, "POST", "/v1/chat/completions",
                                                      _chat("shed", max_tokens=4), headers)
                results["circuit_headers"] = {k: headers.get(k) for k in (
                    "Retry-After", "Content-Type")}
                results["circuit_fired"] = list(faults.fired)
            finally:
                faults.disarm()
    finally:
        await templated.stop()
        await service.stop()
        await watcher.stop()
        for e in extra:
            await e.stop()
        await served.stop()
        if second is not None:
            await second.stop()
        if second_rt is not None:
            await second_rt.shutdown()
        engine.stop()
        await worker_rt.shutdown()
        await frontend_rt.shutdown()
    return results


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frontend")
    old = os.environ.get("DTPU_LORA_CACHE")
    os.environ["DTPU_LORA_CACHE"] = str(tmp / "lora_cache")
    os.environ["DTPU_CB_FRONTEND"] = f"window={CB_WINDOW}"
    try:
        w = Weights(MODEL)
        adapter = str(tmp / "ad.npz")
        np.savez(adapter, alpha=8.0, **_adapter_weights(w.tcfg, rank=4, seed=5, scale=2.0,
                                                        targets=("wq", "wk", "wv", "wo")))
        jengine = w.jax_engine(ENGINE, logits_processors=(
            ("ban", jlp.ban_tokens_processor(BANNED)),),
            guided_vocab=jguided.vocab_bytes_from_tokenizer(jllm.ByteTokenizer()))
        ref = asyncio.run(_run_stack(False, jengine, adapter))
        tengine = w.torch_engine(ENGINE, decode_steps=1, decode_pipeline=1,
                                 logits_processors=(("ban", tlp.ban_tokens_processor(BANNED)),),
                                 guided_vocab=tguided.vocab_bytes_from_tokenizer(
                                     ByteTokenizer()))
        port = asyncio.run(_run_stack(True, tengine, adapter))
    finally:
        os.environ.pop("DTPU_CB_FRONTEND", None)
        if old is None:
            os.environ.pop("DTPU_LORA_CACHE", None)
        else:
            os.environ["DTPU_LORA_CACHE"] = old
    return ref, port


def _norm(v):
    """Drop per-response ids and timestamps."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()
                if k not in ("id", "created", "created_at", "item_id")}
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


def _same(a, b, where="body"):
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (where, a, b)
        assert abs(a - b) <= 1e-4 + 1e-4 * abs(b), (where, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _by_choice(stream):
    """A multi-choice stream's chunks per choice index (arrival order across
    choices depends on the schedule), and the chunks without choices."""
    out = {}
    for c in stream:
        key = c["choices"][0]["index"] if c["choices"] else "usage"
        out.setdefault(key, []).append(c)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_bodies_equal_the_reference(bodies, name):
    ref, port = bodies
    (rs, rb), (ps, pb) = ref[name], port[name]
    assert ps == rs, (name, ps, pb, rb)
    if name == "models":
        assert [m["id"] for m in pb["data"]] == [m["id"] for m in rb["data"]] == [M]
        return
    if ps != 200:
        assert pb["error"]["type"] == rb["error"]["type"], (pb, rb)
        assert pb["error"]["code"] == rb["error"]["code"] == ps
        if name.startswith("trip_") or name == "circuit_open":
            assert ps == 503 and pb == rb
        if name == "circuit_open":
            assert port["circuit_headers"] == ref["circuit_headers"]
            assert port["circuit_headers"]["Retry-After"] == "2"
            assert "circuit open" in pb["error"]["message"]
            # the shed request made no send: two drops per tripping request
            assert port["circuit_fired"] == ref["circuit_fired"] == [
                ("request_plane.send", "drop", i) for i in range(1, 2 * TRIPS + 1)]
        return
    if isinstance(rb, dict) and "stream" in rb:
        assert pb["done"] and rb["done"]
        assert pb["events"] == rb["events"]
        if name.endswith("n2_stream"):
            _same(_norm(_by_choice(pb["stream"])), _norm(_by_choice(rb["stream"])), name)
        else:
            _same(_norm(pb["stream"]), _norm(rb["stream"]), name)
    else:
        _same(_norm(pb), _norm(rb), name)


def test_the_corpus_exercised_every_feature(bodies):
    """Guards the comparison against vacuous bodies: the adapter loaded in
    both, the guided answers parse and follow the schema, the processor
    banned its ids, a stop string cut a text short, logprobs came back and
    the two choices of n = 2 differ."""
    ref, port = bodies
    assert port["load_lora"]["ok"] and port["load_lora"]["slot"] == ref["load_lora"]["slot"]
    answer = json.loads(port["chat_guided_json"][1]["choices"][0]["message"]["content"])
    assert set(answer) == {"ok", "mood"} and answer["mood"] in ("happy", "sad")
    text = "".join(c["choices"][0]["delta"].get("content") or ""
                   for c in port["chat_response_format"][1]["stream"] if c["choices"])
    assert json.loads(text)["mood"] in ("happy", "sad")
    text = port["cmpl_processor"][1]["choices"][0]["text"]
    ban = re.sub(r"<unk:\d+>", "", text).encode()   # ids past the byte vocab
    assert text and all(b % 2 for b in ban if b < 128), text
    assert port["cmpl_processor"][1] != port["cmpl"][1]
    assert port["cmpl_lora"][1]["choices"][0]["text"]
    cut = port["cmpl_stop"][1]["choices"][0]
    assert cut["finish_reason"] == "stop"
    assert len(cut["text"]) < len(port["cmpl"][1]["choices"][0]["text"])
    lp = port["chat_logprobs"][1]["choices"][0]["logprobs"]["content"]
    assert len(lp) == 6 and all(len(e["top_logprobs"]) >= 1 for e in lp)
    texts = [c["text"] for c in port["cmpl_n2"][1]["choices"]]
    assert len(texts) == 2 and texts[0] != texts[1]
    assert len(port["embed_batch"][1]["data"][1]["embedding"]) == 16
    # /v1/responses: the text equals the chat answer's to the same message
    resp = port["responses_stream"][1]
    assert resp["events"][0] == "response.created" and resp["events"][-1] == (
        "response.completed")
    text = resp["stream"][-1]["response"]["output"][0]["content"][0]["text"]
    assert text == "".join(c["delta"] for c in resp["stream"]
                           if c["type"] == "response.output_text.delta")
    assert text and text == port["chat_greedy"][1]["choices"][0]["message"]["content"]
    assert port["responses"][1]["usage"]["output_tokens"] == 8
    # the template filled the model and max_completion_tokens; the request's
    # own fields won over it
    assert port["template_chat"][1]["model"] == M
    assert port["template_chat"][1]["usage"]["completion_tokens"] == 6
    assert port["template_request_wins"][1]["usage"]["completion_tokens"] == 3
    assert port["template_unknown_model"][0] == 404


def test_a_stream_whose_worker_dies_migrates_as_the_reference(bodies):
    """The request's first worker dies after 3 of 10 tokens; the second
    resumes it (prompt + the 3 tokens, max_tokens 7), and the client's
    stream, its usage and finish equal the reference's and the undisturbed
    run's (but for its cached prompt tokens)."""
    ref, port = bodies
    for res in (ref, port):
        (first, died), *rest = res["migration_calls"]
        assert died and [c for c in rest if c[1]] == []
        assert rest[0][0] != first          # the dead worker was excluded
        status, body = res["migrated"]
        assert status == 200 and body["done"]
        assert body["stream"][-1]["usage"]["completion_tokens"] == 10
        # the undisturbed run finds more of its prompt cached: the rest equal
        a, b = _norm(body), _norm(res["undisturbed"][1])
        for u in (a["stream"][-1]["usage"], b["stream"][-1]["usage"]):
            u.pop("cached_tokens")
        _same(a, b, "undisturbed")
    _same(_norm(port["migrated"][1]), _norm(ref["migrated"][1]), "migrated")


# -------------------------------------------------------------- the port alone
def _port_engine(steps=1):
    return Weights(MODEL).torch_engine(dict(num_blocks=256, block_size=4, max_batch_size=4,
                                            max_context=512, prefill_buckets=(16, 32, 64)),
                                       decode_steps=steps, decode_pipeline=1)


async def _port_stack(ttl=2.0, steps=1):
    store = MemKVStore()
    rts = [await DistributedRuntime(
        RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=ttl),
        store=store, event_plane=InProcEventPlane()).start() for _ in range(2)]
    engine = _port_engine(steps)
    served = await register_llm(rts[0], engine, ModelDeploymentCard(
        name=M, tokenizer="byte", context_length=512, kv_block_size=4))
    manager = ModelManager()
    watcher = await ModelWatcher(rts[1], manager).start()
    service = HttpService(manager, rts[1].metrics, host="127.0.0.1", port=0)
    await service.start()
    for _ in range(200):
        if manager.get(M) and manager.get(M).client.instances:
            break
        await asyncio.sleep(0.02)
    return rts, engine, served, manager, watcher, service


async def _models(base):
    async with aiohttp.ClientSession() as s:
        async with s.get(base + "/v1/models") as r:
            return [m["id"] for m in (await r.json())["data"]]


@pytest.mark.parametrize("steps", [1, 4])
def test_disconnect_mid_stream_frees_the_slot(steps):
    """At one decode step a tick and on horizons of 4."""

    async def main():
        rts, engine, served, manager, watcher, service = await _port_stack(steps=steps)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", service.port)
            body = json.dumps(_cmpl("tell me a long story", max_tokens=400, stream=True,
                                    ignore_eos=True)).encode()
            writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                         b"application/json\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
            await writer.drain()
            while b"data: " not in await reader.readline():
                pass
            assert service.inflight == 1 and any(s is not None for s in engine._slots)
            writer.close()
            for _ in range(500):
                if service.inflight == 0 and all(s is None for s in engine._slots):
                    break
                await asyncio.sleep(0.01)
            assert service.inflight == 0
            assert all(s is None for s in engine._slots)
            assert engine.allocator.active_blocks == 0
            assert engine.step_counts["decode"] + steps * engine.step_counts["horizon"] < 400
            metrics = service.metrics.expose().decode()
            assert 'dtpu_requests_total{dtpu_component="",dtpu_endpoint="",dtpu_namespace=' \
                   '"",model="tiny",status="499"} 1.0' in metrics
            assert "dtpu_inflight_requests{" in metrics and "} 0.0" in metrics
            async with aiohttp.ClientSession() as s:
                async with s.post(f"http://127.0.0.1:{service.port}/v1/completions",
                                  json=_cmpl("next", max_tokens=4)) as r:
                    assert r.status == 200
                    assert (await r.json())["choices"][0]["finish_reason"] == "length"
        finally:
            await service.stop()
            await watcher.stop()
            await served.stop()
            engine.stop()
            for rt in rts:
                await rt.shutdown()

    asyncio.run(main())


@pytest.mark.parametrize("how", ["stop", "lease"])
def test_worker_leaving_removes_the_model(how):
    """A stopped worker deletes its keys at once; a worker whose lease is no
    longer kept alive (a killed process) drops out after the lease TTL."""

    async def main():
        rts, engine, served, manager, watcher, service = await _port_stack(ttl=1.0)
        base = f"http://127.0.0.1:{service.port}"
        try:
            assert await _models(base) == [M]
            t0 = time.monotonic()
            if how == "stop":
                await served.stop()
            else:
                rts[0]._keepalive_task.cancel()
            for _ in range(400):
                if not await _models(base):
                    break
                await asyncio.sleep(0.02)
            assert await _models(base) == []
            gone = time.monotonic() - t0
            assert gone < (1.0 if how == "stop" else 4.0), gone
        finally:
            await service.stop()
            await watcher.stop()
            engine.stop()
            for rt in rts:
                await rt.shutdown()

    asyncio.run(main())


def _wait_line(proc, prefix, timeout=90.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"exited ({proc.poll()}) before {prefix}")
        if line.startswith(prefix):
            return line.strip()
    raise AssertionError(f"no {prefix} in {timeout} s")


def test_three_entry_points_serve_a_stream(tmp_path):
    import http.client

    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = []

    def start(*args):
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=str(tmp_path), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    try:
        store = start("dynamo_tpu_torch.runtime.discovery.netstore", "--host", "127.0.0.1",
                      "--port", "0")
        addr = _wait_line(store, "KVSTORE_READY").split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        worker = start("dynamo_tpu_torch.engine", *common, "--preset", "tiny", "--model", M,
                       "--device", "cpu", "--max-context", "256", "--num-blocks", "64",
                       "--decode-steps", "4", "--decode-pipeline", "1")
        front = start("dynamo_tpu_torch.frontend", *common, "--host", "127.0.0.1",
                      "--port", "0")
        port = int(_wait_line(front, "TORCH_FRONTEND_READY").rsplit(":", 1)[1])
        _wait_line(worker, "TORCH_ENGINE_READY")
        for _ in range(300):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", "/v1/models")
            if json.loads(conn.getresponse().read())["data"]:
                break
            time.sleep(0.05)
        conn.request("POST", "/v1/completions", json.dumps(_cmpl(
            "hello", max_tokens=9, stream=True, stream_options={"include_usage": True})),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        events = [line[6:] for line in resp.read().decode().split("\n\n")
                  if line.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert chunks[-2]["choices"][0]["finish_reason"] == "length"
        assert chunks[-1]["usage"]["completion_tokens"] == 9
        # horizons of 4: one chunk per engine output, fewer chunks than tokens
        assert len([c for c in chunks if c["choices"]]) < 9
        worker.send_signal(signal.SIGTERM)
        report = json.loads(_wait_line(worker, "TORCH_ENGINE_EXIT").split(" ", 1)[1])
        assert worker.wait(30) == 0
        assert report["busy_slots"] == 0 and report["steps"]["horizon"] > 0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/v1/models")
        assert json.loads(conn.getresponse().read())["data"] == []
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_a_stream_the_backend_ends_frees_the_engine_slot_at_once():
    """A stop string ends the stream in the Backend, which the engine was
    not told of: the Backend stops the request's context, so the engine
    frees the slot then, not 300 tokens later."""

    async def main():
        rts, engine, served, manager, watcher, service = await _port_stack(steps=4)
        base = f"http://127.0.0.1:{service.port}"
        try:
            async with aiohttp.ClientSession() as s:
                async with s.post(base + "/v1/completions",
                                  json=_cmpl("a stop string", max_tokens=12)) as r:
                    text = (await r.json())["choices"][0]["text"]
                stop = text[4:6]
                async with s.post(base + "/v1/completions", json=_cmpl(
                        "a stop string", max_tokens=300, stop=[stop])) as r:
                    body = await r.json()
            assert body["choices"][0]["finish_reason"] == "stop"
            for _ in range(200):
                if all(s is None for s in engine._slots):
                    break
                await asyncio.sleep(0.01)
            assert all(s is None for s in engine._slots)
            assert engine.allocator.active_blocks == 0
            assert 4 * engine.step_counts["horizon"] + engine.step_counts["decode"] < 60
        finally:
            await service.stop()
            await watcher.stop()
            await served.stop()
            engine.stop()
            for rt in rts:
                await rt.shutdown()

    asyncio.run(main())


def test_engine_refusals_carry_the_reference_codes():
    """The engine's refusals cross the request plane as the reference's
    typed codes: an unsupported feature is a 400 (invalid_request), a
    prompt past the KV pool a 400 (context_length), a grammar the engine
    rejects a 400 (guided_rejected)."""
    from dynamo_tpu_torch.engine.engine import GuidedRejectedError, UnsupportedRequestError
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.errors import ContextLengthError, http_status_for

    assert http_status_for(UnsupportedRequestError("x")) == (400, "invalid_request_error")
    assert http_status_for(GuidedRejectedError("x")) == (400, "invalid_request_error")
    engine = Weights(MODEL).torch_engine(dict(num_blocks=8, block_size=4, max_context=512,
                                              prefill_buckets=(16, 32, 64)),
                                         decode_steps=1, decode_pipeline=1)
    try:
        with pytest.raises(ContextLengthError, match="cannot fit the KV pool"):
            engine._check_request(PreprocessedRequest(request_id="r", model=M,
                                                      token_ids=list(range(100))))
    finally:
        engine.stop()


def test_health_live_and_the_busy_threshold():
    async def main():
        rts, engine, served, manager, watcher, service = await _port_stack()
        base = f"http://127.0.0.1:{service.port}"
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(base + "/health") as r:
                    assert await r.json() == {"status": "healthy", "models": [M]}
                async with s.get(base + "/live") as r:
                    assert await r.json() == {"status": "live"}
                async with s.get(base + "/v1/nope") as r:
                    assert r.status == 404
                async with s.get(base + "/v1/completions") as r:
                    assert r.status == 405
                service.busy_threshold = 0
                async with s.post(base + "/v1/completions", json=_cmpl("hi")) as r:
                    assert r.status == 503
                    assert (await r.json())["error"]["type"] == "service_unavailable"
        finally:
            await service.stop()
            await watcher.stop()
            await served.stop()
            engine.stop()
            for rt in rts:
                await rt.shutdown()

    asyncio.run(main())
