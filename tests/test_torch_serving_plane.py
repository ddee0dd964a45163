"""The parts of the port's serving plane against the reference's, on the CPU.

The machine the port serves on has no msgpack, aiohttp, pydantic or
prometheus_client, so the port carries its own codec, HTTP server,
request validators and metrics registry; here, where those packages are
installed, each is held to the reference:

- the MessagePack codec byte for byte against ``msgpack.packb(...,
  use_bin_type=True)`` and ``unpackb(..., raw=False)``: every edge of the
  smallest-encoding rules and hypothesis-drawn nested values; truncated,
  trailing and unsupported input raises;
- the stores: a FileKVStore directory written by either package reads back
  in the other; MemKVStore leases; the netstore's leases, TTL expiry and
  prefix watches, and its wire against the reference's client and server;
- the TCP request plane: streaming, a cancel reaching the handler's
  Context, NoResponders, and the reference's client on the port's server;
- the OpenAI validators against the reference's pydantic models on a
  corpus of valid and invalid bodies: the same accept / reject, and the
  same folded ``PreprocessedRequest``;
- the metrics text: the reference's sample names and labels;
- the Backend and delta generators on outputs that carry several tokens
  (a decode horizon's): the reference's chunks, one per output.
"""

import asyncio
import json
import math
import os
import re
import struct

import msgpack
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm import backend as jbackend
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm import preprocessor as jpre
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.llm.protocols import delta as jdelta
from dynamo_tpu.llm.protocols import openai as jopenai
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu.runtime.discovery import netstore as jnetstore
from dynamo_tpu.runtime.discovery import store as jstore
from dynamo_tpu.runtime.request_plane import tcp as jtcp
from dynamo_tpu_torch.llm import backend as tbackend
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm import preprocessor as tpre
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.llm.protocols import delta as tdelta
from dynamo_tpu_torch.llm.protocols import openai as topenai
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime import metrics as tmetrics
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.discovery import netstore as tnetstore
from dynamo_tpu_torch.runtime.discovery import store as tstore
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.errors import InvalidRequestError
from dynamo_tpu_torch.runtime.event_plane.base import InProcEventPlane
from dynamo_tpu_torch.runtime.request_plane import tcp as ttcp


def _ref_pack(v) -> bytes:
    return msgpack.packb(v, use_bin_type=True)


# ------------------------------------------------------------------- codec
EDGES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**63, 2**64 - 1, -1, -31, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -0.0, 1.5, -2.25e300, float("inf"), float("-inf"), 5e-324,
    "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65535, "a" * 65536, "ünï ☃ 𝄞",
    b"", b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536, bytearray(b"ab"),
    list(range(15)), list(range(16)), list(range(65535)), list(range(65536)), (1, "a"),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): None for i in range(65536)}, {b"k": [1, {"n": [None, 2.0]}]},
]


@pytest.mark.parametrize("value", EDGES, ids=lambda v: type(v).__name__ + (
    f"_{len(v)}" if hasattr(v, "__len__") else f"_{v!r}"[:24]))
def test_codec_bytes_equal_msgpack_at_every_edge(value):
    ref = _ref_pack(value)
    assert codec.packb(value) == ref
    assert codec.unpackb(ref) == msgpack.unpackb(ref, raw=False)


JSONISH = st.recursive(
    st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300),
    lambda children: st.lists(children, max_size=20)
    | st.dictionaries(st.text(max_size=20), children, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(JSONISH)
def test_codec_bytes_equal_msgpack_on_drawn_values(value):
    ref = _ref_pack(value)
    assert codec.packb(value) == ref
    assert codec.unpackb(ref) == msgpack.unpackb(ref, raw=False)


def test_codec_reads_the_formats_it_never_writes():
    # float32, and the shortest forms written by other packers
    assert codec.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    for raw, want in ((b"\xcc\x05", 5), (b"\xd0\x05", 5), (b"\xd9\x01a", "a"),
                      (b"\xdc\x00\x01\x01", [1]), (b"\xde\x00\x01\xa1a\x02", {"a": 2})):
        assert codec.unpackb(raw) == want == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("bad", [b"", b"\x92\x01", b"\xa5abc", b"\xcd\x01", b"\xc4\x05ab",
                                 b"\xdf\x00\x00\x00\x09", b"\x01\x02", b"\xc1",
                                 b"\x81\x01\x02", b"\xa2\xff\xfe"])
def test_codec_refuses_truncated_trailing_or_unsupported_input(bad):
    with pytest.raises(ValueError):
        codec.unpackb(bad)
    with pytest.raises(ValueError):
        msgpack.unpackb(bad, raw=False)


def test_codec_refuses_ext_types_that_no_frame_holds():
    assert isinstance(msgpack.unpackb(b"\xd4\x01\x00"), msgpack.ExtType)
    with pytest.raises(ValueError, match="unsupported format"):
        codec.unpackb(b"\xd4\x01\x00")


def test_codec_refuses_what_msgpack_refuses():
    for value, exc in ((2**64, OverflowError), (-2**63 - 1, OverflowError),
                       (object(), TypeError), ({1.5}, TypeError)):
        with pytest.raises(exc):
            codec.packb(value)
        with pytest.raises(exc):
            _ref_pack(value)


# ------------------------------------------------------------------- stores
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_file_store_directories_read_back_in_either_package(tmp_path, writer):
    a, b = (jstore, tstore) if writer == "reference" else (tstore, jstore)

    async def main():
        w, r = a.FileKVStore(str(tmp_path)), b.FileKVStore(str(tmp_path))
        lease = await w.create_lease(30.0)
        await w.put_obj("v1/mdc/ns/m/1", {"name": "m", "n": [1, 2.5, None, b"\x00"]},
                        lease.id)
        await w.put("plain", b"bytes")
        assert await r.get_obj("v1/mdc/ns/m/1") == {"name": "m", "n": [1, 2.5, None, b"\x00"]}
        assert await r.list_prefix("") == {"plain": b"bytes",
                                           "v1/mdc/ns/m/1": await w.get("v1/mdc/ns/m/1")}
        assert await r.keep_alive(lease.id)
        await r.revoke_lease(lease.id)
        assert await w.get("v1/mdc/ns/m/1") is None and await w.get("plain") == b"bytes"

    asyncio.run(main())
    names = sorted(os.listdir(tmp_path / "keys"))
    assert names == ["plain"]
    with open(tmp_path / "keys" / "plain", "rb") as f:
        assert f.read() == _ref_pack({"v": b"bytes", "lease": None})


def test_mem_store_leases_watches_and_expiry():
    async def main():
        s = tstore.MemKVStore()
        await s.put("a/1", b"x")
        w = await s.watch("a/")
        lease = await s.create_lease(0.3)
        await s.put("a/2", b"y", lease.id)
        await s.put("b/1", b"z", lease.id)
        evs = [await asyncio.wait_for(w.__anext__(), 2) for _ in range(2)]
        assert [(e.type.value, e.key) for e in evs] == [("put", "a/1"), ("put", "a/2")]
        ev = await asyncio.wait_for(w.__anext__(), 3)   # the lease lapses
        assert (ev.type.value, ev.key) == ("delete", "a/2")
        assert await s.list_prefix("") == {"a/1": b"x"}
        assert not await s.keep_alive(lease.id)
        await s.close()

    asyncio.run(main())


@pytest.mark.parametrize("server,client", [("port", "port"), ("port", "reference"),
                                           ("reference", "port")])
def test_netstore_leases_ttl_and_prefix_watches(server, client):
    srv_mod = tnetstore if server == "port" else jnetstore
    cli_mod = tnetstore if client == "port" else jnetstore

    async def main():
        srv = srv_mod.KVStoreServer("127.0.0.1", 0)
        addr = await srv.start()
        a, b = cli_mod.TcpKVStore(addr), cli_mod.TcpKVStore(addr)
        try:
            w = await b.watch("v1/")
            lease = await a.create_lease(0.5)
            await a.put_obj("v1/x", {"k": [1, "two"]}, lease.id)
            await a.put("other", b"o")
            ev = await asyncio.wait_for(w.__anext__(), 2)
            assert (ev.type.value, ev.key) == ("put", "v1/x")
            assert codec.unpackb(ev.value) == {"k": [1, "two"]}
            assert await b.get_obj("v1/x") == {"k": [1, "two"]}
            assert sorted(await b.list_prefix("")) == ["other", "v1/x"]
            for _ in range(3):
                await asyncio.sleep(0.2)
                assert await a.keep_alive(lease.id)
            assert await b.get("v1/x") is not None   # kept alive past its TTL
            ev = await asyncio.wait_for(w.__anext__(), 3)  # then lapses
            assert (ev.type.value, ev.key) == ("delete", "v1/x")
            assert not await a.keep_alive(lease.id)
            assert await b.get("other") == b"o"
        finally:
            await a.close()
            await b.close()
            await srv.stop()

    asyncio.run(main())


def test_event_plane_prefix_subscriptions():
    async def main():
        ep = InProcEventPlane()
        sub = await ep.subscribe("kv.")
        await ep.publish("kv.a", b"1")
        await ep.publish("metrics.a", b"2")
        assert await sub.next(1.0) == ("kv.a", b"1")
        assert await sub.next(0.05) is None
        await ep.close()

    asyncio.run(main())


def test_runtime_config_layers(monkeypatch, tmp_path):
    cfg_file = tmp_path / "c.json"
    cfg_file.write_text(json.dumps({"store": "file", "lease_ttl_s": "3"}))
    monkeypatch.setenv("DTPU_CONFIG", str(cfg_file))
    monkeypatch.setenv("DTPU_STORE_PATH", "/x")
    cfg = RuntimeConfig.from_env(host_ip="10.0.0.1")
    assert (cfg.store, cfg.store_path, cfg.lease_ttl_s, cfg.host_ip) == (
        "file", "/x", 3.0, "10.0.0.1")
    monkeypatch.setenv("DTPU_STORE", "tcp")
    assert RuntimeConfig.from_env(store="mem").store == "mem"
    assert RuntimeConfig.from_env().store == "tcp"


# ----------------------------------------------------------- request plane
async def _handler(request, ctx):
    if request.get("boom"):
        raise InvalidRequestError("bad option")
    for i in range(request["n"]):
        if ctx.is_stopped():
            yield {"cancelled_at": i}
            return
        yield {"i": i, "blob": b"\x00" * i}
        await asyncio.sleep(request.get("delay", 0))


@pytest.mark.parametrize("client", ["port", "reference"])
def test_tcp_plane_streams_cancels_and_reports(client):
    cli_mod = ttcp if client == "port" else jtcp

    async def main():
        server = ttcp.TcpRequestServer(_handler)
        addr = await server.start()
        cli = cli_mod.TcpClient()
        try:
            # two streams multiplexed on one connection
            s1 = await cli.call(addr, {"n": 5})
            s2 = await cli.call(addr, {"n": 3})
            got1 = [x async for x in s1]
            got2 = [x async for x in s2]
            assert [x["i"] for x in got1] == list(range(5)) and len(got2) == 3
            assert got1[4]["blob"] == b"\x00" * 4
            # a cancel reaches the handler's Context
            ctx = (Context if client == "port" else __import__(
                "dynamo_tpu.runtime.engine", fromlist=["Context"]).Context)()
            stream = await cli.call(addr, {"n": 1000, "delay": 0.005}, ctx)
            items = []
            async for x in stream:
                items.append(x)
                if len(items) == 3:
                    ctx.stop_generating()
            assert "cancelled_at" in items[-1] and len(items) < 50
            # a typed error keeps its code across the wire
            with pytest.raises(Exception) as e:
                _ = [x async for x in await cli.call(addr, {"boom": True})]
            assert getattr(e.value, "code", None) == "invalid_request"
            assert server.inflight == 0
        finally:
            await cli.close()
            await server.stop()
        # nobody listens there any more
        with pytest.raises(cli_mod.NoResponders):
            await cli_mod.TcpClient().call(addr, {"n": 1})

    asyncio.run(main())


def test_tcp_frames_are_the_references_bytes():
    msg = {"t": "req", "id": "abc", "body": {"token_ids": [1, 300, 70000], "x": 0.5}}

    class W:
        def __init__(self):
            self.data = b""

        def write(self, b):
            self.data += b

    port, ref = W(), W()
    ttcp._write_frame(port, msg)
    jtcp._write_frame(ref, msg)
    port = port.data
    assert port == ref.data
    assert struct.unpack(">I", port[:4])[0] == len(port) - 4
    assert ttcp.MAX_FRAME == jtcp.MAX_FRAME == 512 * 1024 * 1024


# -------------------------------------------------------- OpenAI validators
def _chat(**kw):
    return {"model": "m", "messages": [{"role": "user", "content": "hi there"}], **kw}


def _cmpl(**kw):
    return {"model": "m", "prompt": "hello", **kw}


CHAT_BODIES = [
    _chat(), _chat(max_tokens="5"), _chat(max_tokens=5.0), _chat(max_tokens=" 7 "),
    _chat(temperature=1, top_p=0.5, top_k=40, min_p=0.1, seed="7"),
    _chat(stop="x"), _chat(stop=["a", "bc"]), _chat(max_completion_tokens=9, max_tokens=3),
    _chat(logprobs=True, top_logprobs=2), _chat(logprobs=1.0), _chat(logprobs="true"),
    _chat(n="2"), _chat(presence_penalty=0.5, frequency_penalty=-1, repetition_penalty=1.1),
    _chat(ignore_eos="yes"), _chat(temperature=None, seed=None, stop=None),
    {"model": "m", "messages": [{"role": "user", "content": [
        {"type": "text", "text": "hi"}, {"type": "text", "text": " there"}]}]},
    {"model": "m", "foo": 1, "messages": [{"role": "user", "content": "x", "bar": [1]}]},
    {"model": "m", "messages": [{"role": "system", "content": "be brief"},
                                {"role": "user", "content": "q"},
                                {"role": "assistant", "content": None, "name": None},
                                {"role": "user", "content": "again"}]},
    _chat(guided_regex="[ab]+"), _chat(guided_choice=["x", "y"]),
    _chat(guided_json={"type": "object", "properties": {"a": {"type": "boolean"}},
                       "required": ["a"]}),
    _chat(guided_json='{"type": "string", "maxLength": 3}'),
    _chat(response_format={"type": "json_object"}),
    _chat(response_format={"type": "json_schema", "json_schema": {"schema": {
        "enum": ["a", "b"]}}}),
    _chat(lora="ad", logits_processors=["ban"]),
    _chat(stream=True, stream_options={"include_usage": "1"}),
    _chat(tools=[{"type": "function", "function": {"name": "f"}}], tool_choice="auto"),
    _chat(ignore_eos=True, max_tokens=100000),
    # invalid
    _chat(messages=[]), {"messages": [{"role": "user", "content": "x"}]},
    _chat(messages=[{"role": "bot", "content": "x"}]), _chat(max_tokens=0),
    _chat(max_tokens=5.5), _chat(temperature=2.5), _chat(top_p=0), _chat(top_k=-2),
    _chat(guided_regex="a", guided_choice=["a"]), _chat(top_logprobs=2),
    _chat(top_logprobs=2, logprobs=False), _chat(logprobs=21), _chat(stream=None),
    _chat(stream=2), _chat(n=17), _chat(n=None), _chat(messages=[{"role": "user",
                                                                   "content": 5}]),
    _chat(stop=[1]), _chat(user=5), _chat(model=5), _chat(response_format="json"),
    _chat(stream_options=3), _chat(modalities=["video"]), _chat(messages="hi"),
    _chat(guided_regex="("), _chat(modalities=["audio"]),
    _chat(messages=[{"role": "user", "content": "x" * 600}]), ["not", "an", "object"],
]
CMPL_BODIES = [
    _cmpl(), _cmpl(prompt=[104, 105]), _cmpl(prompt=["one"]), _cmpl(prompt=[1.0, 2.0]),
    _cmpl(prompt=["1", 2]), _cmpl(echo="1", logprobs=3), _cmpl(logprobs=0),
    _cmpl(stop="\n", max_tokens=4, seed=3, temperature=0.7), _cmpl(prompt=[[1, 2]]),
    _cmpl(prompt=None), _cmpl(prompt=[1, "a"]), _cmpl(logprobs=-1), _cmpl(prompt=5),
    _cmpl(echo=None), _cmpl(guided_json=[1]),
]
EMBED_BODIES = [
    {"model": "m", "input": "x"}, {"model": "m", "input": [[1, 2], [3]]},
    {"model": "m", "input": ["a", "b"], "encoding_format": "base64", "dimensions": "4"},
    {"model": "m", "input": "x", "encoding_format": "FLOAT"},
    {"model": "m", "input": "x", "dimensions": 0}, {"model": "m"},
]


def _card(mod):
    return mod.ModelDeploymentCard(name="m", tokenizer="byte", context_length=512)


def _fold(kind, body, openai, pre, card, tok):
    """('reject', None) | ('error', class name) | ('ok', folded request)."""
    cls = {"chat": openai.ChatCompletionRequest, "cmpl": openai.CompletionRequest,
           "embed": openai.EmbeddingRequest}[kind]
    try:
        req = (cls.model_validate(body) if openai is jopenai else cls.from_obj(body))
    except ValueError:
        return "reject", None
    if kind == "embed":
        return "ok", {k: getattr(req, k) for k in ("model", "input", "encoding_format",
                                                   "dimensions")}
    p = pre.OpenAIPreprocessor(card, tok)
    try:
        if kind == "chat":
            preq = p.preprocess_chat(req)
        else:
            prompt = req.prompt[0] if isinstance(req.prompt, list) and req.prompt and \
                isinstance(req.prompt[0], (str, list)) else req.prompt
            preq = p.preprocess_completion(req, prompt)
    except ValueError as e:
        return "error", type(e).__name__
    obj = preq.to_obj()
    obj.pop("request_id")
    extras = {k: getattr(req, k) for k in ("stream", "n", "echo") if hasattr(req, k)}
    return "ok", {**obj, **extras}


CORPUS = ([("chat", b) for b in CHAT_BODIES] + [("cmpl", b) for b in CMPL_BODIES]
          + [("embed", b) for b in EMBED_BODIES])


@pytest.mark.parametrize("kind,body", CORPUS, ids=[f"{k}{i}" for i, (k, _) in enumerate(CORPUS)])
def test_validators_and_fold_match_the_reference(kind, body):
    ref = _fold(kind, body, jopenai, jpre, _card(jcard), JByteTokenizer())
    port = _fold(kind, body, topenai, tpre, _card(tcard), ByteTokenizer())
    assert port == ref


def test_the_corpus_holds_both_outcomes():
    outcomes = [_fold(k, b, topenai, tpre, _card(tcard), ByteTokenizer())[0]
                for k, b in CORPUS]
    assert len(CORPUS) >= 30
    assert outcomes.count("ok") >= 15 and outcomes.count("reject") >= 15
    assert outcomes.count("error") >= 3


@pytest.mark.parametrize("body", [
    _chat(messages=[{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]}]),
    _chat(tool_choice="required", tools=[{"type": "function", "function": {"name": "f"}}]),
    _chat(tool_choice={"type": "function", "function": {"name": "f"}},
          tools=[{"type": "function", "function": {"name": "f", "parameters": {
              "type": "object", "properties": {"x": {"type": "integer"}}}}}]),
])
def test_port_refusals_name_the_roadmap(body):
    """The bodies the port once refused naming ROADMAP item 4b are served
    as the reference serves them: image parts (a 400 from both on a model
    whose card takes no images; tests/test_torch_media.py serves them on a
    vision card), and a forced tool_choice ("required", or a named
    function, whose soft grammar the folded request carries)."""
    req = topenai.ChatCompletionRequest.from_obj(body)
    if body.get("tool_choice") is None:
        with pytest.raises(InvalidRequestError, match="does not accept image input"):
            tpre.OpenAIPreprocessor(_card(tcard), ByteTokenizer()).preprocess_chat(req)
        port = _fold("chat", body, topenai, tpre, _card(tcard), ByteTokenizer())
        assert port == _fold("chat", body, jopenai, jpre, _card(jcard), JByteTokenizer())
        return
    port = _fold("chat", body, topenai, tpre, _card(tcard), ByteTokenizer())
    assert port == _fold("chat", body, jopenai, jpre, _card(jcard), JByteTokenizer())
    assert port[0] == "ok"
    assert (port[1]["sampling"].get("guided") is not None) == isinstance(
        body["tool_choice"], dict)


def test_response_objects_dump_as_the_reference():
    usage = dict(prompt_tokens=3, completion_tokens=2, total_tokens=5)
    lp = {"content": [{"token": "a", "logprob": -0.5, "bytes": [97], "top_logprobs": []}]}

    def build(m):
        return m.ChatCompletionResponse(
            id="x", created=1, model="m", usage=m.Usage(**usage),
            choices=[m.ChatChoice(index=0, finish_reason="stop", logprobs=lp,
                                  message=m.ChatResponseMessage(content="hi"))])

    assert build(topenai).to_obj() == build(jopenai).model_dump(exclude_none=True)
    chunk = dict(id="x", created=1, model="m", choices=[])
    assert json.loads(topenai.ChatCompletionChunk(**chunk).to_json()) == json.loads(
        jopenai.ChatCompletionChunk(**chunk).model_dump_json(exclude_none=True))
    assert topenai.ModelList(data=[topenai.ModelInfo(id="m")]).to_obj() == \
        jopenai.ModelList(data=[jopenai.ModelInfo(id="m")]).model_dump()


# ------------------------------------------------------------------ metrics
def _samples(text: str):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-z_]+)(\{.*\})? (\S+)$", line)
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        out[(name, labels)] = None if name.endswith("_created") else value
    return out


def _exercise(mod):
    scope = mod.MetricsScope()
    ep = scope.child(dtpu_namespace="ns", dtpu_component="backend", dtpu_endpoint="gen")
    c = scope.counter(mod.REQUESTS_TOTAL, "requests", extra_labels=("model", "status"))
    c.inc(model="m", status="200")
    c.inc(2, model="m", status="503")
    scope.gauge(mod.INFLIGHT_REQUESTS, "in-flight requests").set(3)
    h = scope.histogram(mod.TTFT_SECONDS, "time to first token",
                        extra_labels=("model", "sla_class"),
                        buckets=(0.01, 0.025, 0.5, 1e7))
    for v in (0.005, 0.3, 0.3, 50.0):
        h.observe(v, model="m", sla_class="")
    itl = ep.histogram(mod.ITL_SECONDS, "inter-token latency", extra_labels=("model",))
    itl.observe(0.002, model='q"uo\\te')
    ep.counter(mod.OUTPUT_TOKENS, "output tokens").inc(7)
    return scope.expose().decode()


def test_metrics_text_has_the_references_names_and_labels():
    port, ref = _exercise(tmetrics), _exercise(jmetrics)
    assert _samples(port) == _samples(ref)
    assert "dtpu_time_to_first_token_seconds_bucket" in port
    assert 'le="1e+07"' in port and 'le="+Inf"' in port
    for name in ("REQUESTS_TOTAL", "INFLIGHT_REQUESTS", "TTFT_SECONDS", "ITL_SECONDS",
                 "INPUT_TOKENS", "OUTPUT_TOKENS", "REQUEST_DURATION_SECONDS",
                 "RETRY_ATTEMPTS_TOTAL", "LABEL_MODEL", "LABEL_NAMESPACE"):
        assert getattr(tmetrics, name) == getattr(jmetrics, name)
    assert tmetrics.go_float(123456789.0) == "1.23456789e+08"
    assert math.isnan(float(tmetrics.go_float(float("nan"))))


# --------------------------------------------- Backend on horizon outputs
OUTPUTS = [  # one engine output per list: a horizon's tokens at once
    ([72, 101, 108], [-0.1, -0.2, -0.3]), ([108, 111, 44], [-0.4, -0.5, -0.6]),
    ([32, 0xE2, 0x82], [-0.7, -0.8, -0.9]), ([0xAC, 32, 83], [-1.0, -1.1, -1.2]),
    ([84, 79, 80], [-1.3, -1.4, -1.5]), ([33, 33, 257], [-1.6, -1.7, -1.8]),
]


class _HorizonEngine:
    def __init__(self, common):
        self.common = common

    async def generate(self, request, context):
        for toks, lps in OUTPUTS:
            yield self.common.BackendOutput(
                token_ids=list(toks), logprobs=list(lps),
                top_logprobs=[{t: lp, (t + 1) % 256: lp - 1.0} for t, lp in zip(toks, lps)],
                annotations={"cached_tokens": 0})


async def _chunks(backend, common, delta, tok, stop, logprobs, chat):
    req = common.PreprocessedRequest(
        request_id="r", model="m", token_ids=[1, 2, 3],
        stop=common.StopConditions(max_tokens=20, stop_strings=stop),
        sampling=common.SamplingOptions(temperature=0.0, logprobs=logprobs,
                                        want_logprobs=True),
        annotations={"input_tokens": 3})
    be = backend.Backend(_HorizonEngine(common), tok)
    ctx = (Context() if backend is tbackend else __import__(
        "dynamo_tpu.runtime.engine", fromlist=["Context"]).Context())
    gen = (delta.ChatDeltaGenerator("r", "m", include_usage=True) if chat
           else delta.CompletionDeltaGenerator("r", "m", include_usage=True))
    out = []
    async for item in be.generate(req.to_obj(), ctx):
        bo = common.BackendOutput.from_obj(codec.unpackb(codec.packb(item)))
        for c in gen.on_output(bo):
            out.append(json.loads(c.to_json() if backend is tbackend
                                  else c.model_dump_json(exclude_none=True)))
    for c in out:
        c.pop("created")
    return out


@pytest.mark.parametrize("chat", [True, False])
@pytest.mark.parametrize("stop", [[], ["STOP"], ["l,"], ["€ S"]])
def test_backend_and_delta_emit_one_chunk_per_horizon_output(chat, stop):
    port = asyncio.run(_chunks(tbackend, tcommon, tdelta, ByteTokenizer(), stop, 1, chat))
    ref = asyncio.run(_chunks(jbackend, jcommon, jdelta, JByteTokenizer(), stop, 1, chat))
    assert port == ref
    texts = [c["choices"][0].get("text") or c["choices"][0].get("delta", {}).get("content")
             for c in port if c["choices"]]
    assert len(port) <= len(OUTPUTS) + 3 and any(t and len(t) > 1 for t in texts)


# ------------------------------------------------- echo engine and operators
@pytest.mark.parametrize("ann,sampling", [({}, {}), ({}, {"logprobs": 2, "want_logprobs": True}),
                                          ({"op": "embed"}, {})])
def test_echo_engine_behind_the_backend_streams_the_references_outputs(ann, sampling):
    from dynamo_tpu.llm.engines import EchoEngine as JEcho
    from dynamo_tpu.runtime.engine import Context as JContext
    from dynamo_tpu_torch.llm.engines import EchoEngine

    async def run(engine, backend, common, tok, ctx):
        req = common.PreprocessedRequest(
            request_id="r", model="m", token_ids=list(b"hello, echo"), annotations=dict(ann),
            stop=common.StopConditions(max_tokens=6, stop_strings=["o,"]),
            sampling=common.SamplingOptions(**sampling))
        gen = engine.generate(req, ctx) if ann else backend.Backend(engine, tok).generate(
            req.to_obj(), ctx)
        return [o.to_obj() if hasattr(o, "to_obj") else o async for o in gen]

    port = asyncio.run(run(EchoEngine(), tbackend, tcommon, ByteTokenizer(), Context()))
    ref = asyncio.run(run(JEcho(), jbackend, jcommon, JByteTokenizer(), JContext()))
    assert port == ref and port


def test_fn_engine_operator_and_collect():
    from dynamo_tpu_torch.runtime.engine import AsyncEngine, FnEngine, Operator, collect

    async def gen(request, ctx):
        for i in range(request):
            if ctx.is_stopped():
                return
            yield i

    async def main():
        fn = FnEngine(gen, "count")
        assert isinstance(fn, AsyncEngine)
        assert await collect(Operator(fn).generate(3, Context())) == [0, 1, 2]
        ctx = Context()
        child = ctx.child()
        ctx.stop_generating()
        assert child.is_stopped() and await collect(fn.generate(3, child)) == []

    asyncio.run(main())


def test_task_tracker_cancels_and_awaits_at_shutdown():
    from dynamo_tpu_torch.runtime.tasks import TaskTracker

    async def main():
        tracker, ended = TaskTracker(), []

        async def work(name, s):
            try:
                await asyncio.sleep(s)
            finally:
                ended.append(name)

        quick = tracker.spawn(lambda: work("quick", 0), name="quick")
        slow = tracker.spawn(lambda: work("slow", 60), name="slow")
        await quick
        assert list(tracker._tasks) == ["slow"]
        tracker.shutdown()
        assert await tracker.join(5.0)
        assert slow.done and ended == ["quick", "slow"] and not tracker._tasks
        assert tracker.metrics.cancelled == 1 and tracker.metrics.ok == 1

    asyncio.run(main())


# ------------------------------------------------------------- retry policy
@pytest.mark.parametrize("fails, exc, want", [
    (0, ConnectionRefusedError, "ok"),
    (2, ConnectionRefusedError, "ok"),          # retried, then served
    (3, ConnectionRefusedError, "raised"),      # attempts exhausted
    (1, InvalidRequestError, "raised"),         # a typed 4xx-class error: no retry
    (1, KeyError, "raised"),                    # not transport-class: no retry
])
def test_retry_policy_backs_off_and_gives_up(monkeypatch, fails, exc, want):
    from dynamo_tpu_torch.runtime import resilience

    sleeps, calls = [], []

    async def fake_sleep(s):
        sleeps.append(s)

    async def fn(x):
        calls.append(x)
        if len(calls) <= fails:
            raise exc("down")
        return x + 1

    monkeypatch.setattr(resilience.asyncio, "sleep", fake_sleep)
    kw = dict(name="t", max_attempts=3, base_delay_s=0.5, max_delay_s=0.8, seed=7)
    policy = resilience.RetryPolicy(**kw)
    try:
        got = asyncio.run(policy.acall(fn, 41))
    except exc:
        got = "raised"
    assert (got == 42) == (want == "ok")
    retried = exc is ConnectionRefusedError
    assert len(calls) == (min(fails + 1, 3) if retried else 1)
    # the seeded decorrelated-jitter schedule, each delay in [base, cap]
    assert sleeps == list(resilience.RetryPolicy(**kw).delays())[:len(calls) - 1]
    assert all(0.5 <= d <= 0.8 for d in sleeps)


# ---------------------------------------------------------------- migration
# one script per case: each attempt's worker outputs (token lists) and how
# its stream ends: "finish" (length), "eof" (no finish: the worker died),
# "error" (an error finish), "drop" (the connection breaks mid-stream),
# "refused" (no stream at all); "stopped" kills the client's context first
MIGRATIONS = {
    "eof_then_finish": (1, [([[1], [2], [3]], "eof"), ([[4], [5]], "finish")]),
    "error_finish": (1, [([[1, 2], []], "error"), ([[3], [4], [5]], "finish")]),
    "drop": (1, [([[1], [2]], "drop"), ([[3, 4, 5]], "finish")]),
    "refused": (1, [([], "refused"), ([[1], [2], [3], [4], [5]], "finish")]),
    "twice": (2, [([[1]], "eof"), ([[2], [3]], "drop"), ([[4], [5]], "finish")]),
    "limit_0": (0, [([[1], [2]], "eof")]),
    "exhausted": (1, [([[1]], "eof"), ([[2]], "eof")]),
    "stopped": (1, [([[1], [2]], "stopped")]),
}


def _migrate(migration, common, tcp, engine_mod, limit, script):
    """Run ``script`` through one package's Migration; returns what each
    attempt was sent, what came out and how it ended."""
    sent, outs = [], []
    ctx = engine_mod.Context()

    class Stream:
        def __init__(self, items, how, iid):
            self.items, self.how, self.instance_id = items, how, iid

        def __aiter__(self):
            return self.gen()

        async def gen(self):
            n = 0
            for i, toks in enumerate(self.items):
                n += len(toks)
                last = i == len(self.items) - 1
                fin = {"finish": "length", "error": "error"}.get(self.how) if last else None
                yield common.BackendOutput(token_ids=list(toks), cumulative_tokens=n,
                                           finish_reason=fin).to_obj()
            if self.how == "drop":
                err = ConnectionError("connection lost")
                err.instance_id = self.instance_id
                raise err
            if self.how == "stopped":
                ctx.kill()

    async def send(req, context, excluded):
        k = len(sent)
        sent.append({"prior": list(req.prior_token_ids), "max_tokens": req.stop.max_tokens,
                     "excluded": list(excluded), "prompt": list(req.token_ids)})
        items, how = script[k]
        if how == "refused":
            err = tcp.NoResponders("no worker")
            err.instance_id = 100 + k
            raise err
        return Stream(items, how, 100 + k)

    async def main():
        req = common.PreprocessedRequest(request_id="r", model="m", token_ids=[7, 8, 9],
                                         stop=common.StopConditions(max_tokens=5))
        try:
            async for out in migration.Migration(send, limit).generate(req, ctx):
                outs.append((out.token_ids, out.cumulative_tokens, out.finish_reason))
        except Exception as e:
            return type(e).__name__
        return "returned"

    ended = asyncio.run(main())
    return sent, outs, ended


@pytest.mark.parametrize("case", list(MIGRATIONS))
def test_migration_resumes_as_the_reference(case):
    """Replays with the tokens so far as ``prior_token_ids``, max_tokens
    shrunk by them, the dead instance excluded, and usage counted from the
    original request; a spent limit raises; a killed client ends quietly."""
    from dynamo_tpu.llm import migration as jmig
    from dynamo_tpu.runtime import engine as jengine
    from dynamo_tpu_torch.llm import migration as tmig
    from dynamo_tpu_torch.runtime import engine as tengine

    limit, script = MIGRATIONS[case]
    port = _migrate(tmig, tcommon, ttcp, tengine, limit, script)
    ref = _migrate(jmig, jcommon, jtcp, jengine, limit, script)
    assert port == ref
    sent, outs, ended = port
    assert len(sent) == len(script)
    if ended == "returned" and case != "stopped":
        assert [t for o in outs for t in o[0]] == [1, 2, 3, 4, 5]
        assert outs[-1][1:] == (5, "length")
        done = 0
        for s, (items, how) in zip(sent, script):
            assert s["prior"] == [1, 2, 3, 4, 5][:done] and s["max_tokens"] == 5 - done
            done += sum(map(len, items))
        assert [s["excluded"] for s in sent][-1] == [100 + k for k in range(len(sent) - 1)]
    else:
        assert ended == ("returned" if case == "stopped" else "NoResponders")
